"""On-device STFT / iSTFT with exact scipy.signal semantics.

The reference pipeline computes features as ``scipy.signal.stft(...) / scale``
with ``scale = sqrt(1/hann.sum()**2) = 1/hann.sum()`` (reference
dataloader/data.py:37-38,58,78) and inverts with
``scipy.signal.istft(Z * scale, ...)`` (tester.py:149-157,186-198).  scipy's
stft divides the framed rFFT by ``win.sum()``, so the composition the
reference actually trains on is the *unnormalized* framed rFFT:

    Z[t, f] = rfft(hann * x[t*hop : t*hop + nperseg])[f]

and the inverse is plain windowed overlap-add normalized by the OLA'd squared
window.  We implement those directly (``stft_scaled`` / ``istft_scaled``) and
also the scipy-scaled variants (``stft`` / ``istft``) for drop-in parity
tests.

Everything here is jit-able, batched over arbitrary leading axes, and runs on
the device: framing is 4 static slices (nperseg == 4*hop), the FFT is XLA's rfft,
and overlap-add is a phase-decomposed shifted sum — no gathers, no scatters,
no host round trips (the reference runs all of this on CPU inside DataLoader
workers, SURVEY.md §3.2).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from misonet_tpu.config import StftConfig


def hann_periodic(length: int) -> np.ndarray:
    """Periodic Hann window, identical to scipy.signal.get_window('hann', N)
    (reference data.py:37)."""
    n = np.arange(length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / length)).astype(np.float64)


def matlab_scale(cfg: StftConfig) -> float:
    """sqrt(1/hann.sum()**2) — the reference's MATLAB-compat scale
    (data.py:38)."""
    return float(np.sqrt(1.0 / hann_periodic(cfg.length).sum() ** 2))


def _frame(x: jnp.ndarray, length: int, hop: int) -> jnp.ndarray:
    """[..., S] -> [..., T, length] sliding frames; S must satisfy
    (S - length) % hop == 0.  Uses the nperseg = r*hop decomposition: the
    signal is viewed as hop-sized blocks and each frame is r consecutive
    blocks, so framing is r static slices + a reshape (XLA-friendly, no
    gather)."""
    r, rem = divmod(length, hop)
    assert rem == 0, "nperseg must be a multiple of hop"
    num_frames = (x.shape[-1] - length) // hop + 1
    blocks = x.reshape(x.shape[:-1] + (x.shape[-1] // hop, hop))
    parts = [
        jax.lax.slice_in_dim(blocks, j, j + num_frames, axis=-2)
        for j in range(r)
    ]
    return jnp.stack(parts, axis=-2).reshape(x.shape[:-1] + (num_frames, length))


def _overlap_add(frames: jnp.ndarray, hop: int) -> jnp.ndarray:
    """[..., T, length] -> [..., (T-1)*hop + length] overlap-add.

    Phase decomposition: frame t's p-th hop-block lands on output block
    t + p, so the OLA is a sum of r shifted block streams — static pads and
    adds only."""
    *lead, num_frames, length = frames.shape
    r = length // hop
    out_blocks = num_frames + r - 1
    phases = frames.reshape(tuple(lead) + (num_frames, r, hop))
    total = jnp.zeros(tuple(lead) + (out_blocks, hop), frames.dtype)
    for p in range(r):
        pad = [(0, 0)] * len(lead) + [(p, out_blocks - num_frames - p), (0, 0)]
        total = total + jnp.pad(phases[..., p, :], pad)
    return total.reshape(tuple(lead) + (out_blocks * hop,))


@functools.partial(jax.jit, static_argnames=("length", "hop"))
def _stft_raw(x: jnp.ndarray, length: int, hop: int) -> jnp.ndarray:
    """Unnormalized framed rFFT with scipy boundary/padding conventions:
    pad length//2 zeros both ends (boundary='zeros'), pad tail to a whole
    number of hops (padded=True).  [..., S] -> [..., T, F] complex64."""
    half = length // 2
    padded = x.shape[-1] + 2 * half
    extra = (-(padded - length)) % hop
    pads = [(0, 0)] * (x.ndim - 1) + [(half, half + extra)]
    xp = jnp.pad(x.astype(jnp.float32), pads)
    win = jnp.asarray(hann_periodic(length), jnp.float32)
    frames = _frame(xp, length, hop) * win
    return jnp.fft.rfft(frames, axis=-1).astype(jnp.complex64)


@functools.partial(jax.jit, static_argnames=("length", "hop", "out_samples"))
def _istft_raw(
    z: jnp.ndarray, length: int, hop: int, out_samples: int
) -> jnp.ndarray:
    """Inverse of `_stft_raw`: windowed OLA / OLA(win^2), trim the length//2
    boundary padding, crop/zero-pad to ``out_samples``.
    [..., T, F] -> [..., out_samples] float32."""
    win = hann_periodic(length)
    num_frames = z.shape[-2]
    xsubs = jnp.fft.irfft(z, n=length, axis=-1).astype(jnp.float32)
    num = _overlap_add(xsubs * jnp.asarray(win, jnp.float32), hop)
    # OLA'd squared window is data independent -> computed in numpy, constant
    # folded by XLA (scipy.signal.istft computes the same norm on the fly).
    norm = np.zeros((num_frames - 1) * hop + length)
    for t in range(num_frames):
        norm[t * hop : t * hop + length] += win**2
    norm = np.where(norm > 1e-10, norm, 1.0)
    y = num / jnp.asarray(norm, jnp.float32)
    half = length // 2
    y = y[..., half:]
    if y.shape[-1] >= out_samples:
        return y[..., :out_samples]
    pads = [(0, 0)] * (y.ndim - 1) + [(0, out_samples - y.shape[-1])]
    return jnp.pad(y, pads)


@functools.partial(jax.jit, static_argnames=("length", "hop", "out_samples"))
def _istft_masked_raw(
    z: jnp.ndarray, t_valid: jnp.ndarray, length: int, hop: int,
    out_samples: int,
) -> jnp.ndarray:
    """`_istft_raw` with a TRACED valid-frame count: synthesizes exactly
    the first ``t_valid`` frames of a bucket-padded spectrogram (frames at
    index >= t_valid are masked from BOTH the OLA numerator and the
    window-energy envelope), so one compiled signature serves every
    utterance length inside a bucket.  Caller slices the host result to
    the true sample count."""
    win = jnp.asarray(hann_periodic(length), jnp.float32)
    num_frames = z.shape[-2]
    mask = (jnp.arange(num_frames) < t_valid).astype(jnp.float32)
    xsubs = jnp.fft.irfft(z, n=length, axis=-1).astype(jnp.float32)
    num = _overlap_add(xsubs * win * mask[:, None], hop)
    env = _overlap_add((win[None, :] ** 2) * mask[:, None], hop)
    env = jnp.where(env > 1e-10, env, 1.0)
    y = num / env
    half = length // 2
    y = y[..., half:]
    if y.shape[-1] >= out_samples:
        return y[..., :out_samples]
    pads = [(0, 0)] * (y.ndim - 1) + [(0, out_samples - y.shape[-1])]
    return jnp.pad(y, pads)


def istft_scaled_masked(
    z: jnp.ndarray, t_valid, cfg: StftConfig, out_samples: int
) -> jnp.ndarray:
    """Bucket-static synthesis of `stft_scaled` features: [..., T_b, F] with
    frames >= t_valid zero -> [..., out_samples] using only the first
    ``t_valid`` frames' window energy.  Matches ``istft_scaled`` of the
    t_valid-cropped spectrogram (tests/test_stft.py) without a compile per
    distinct utterance length."""
    return _istft_masked_raw(z, jnp.asarray(t_valid), cfg.length, cfg.hop,
                             out_samples)


def stft(x: jnp.ndarray, cfg: StftConfig) -> jnp.ndarray:
    """scipy-compatible STFT: [..., S] -> [..., T, F] complex64, scaled by
    1/win.sum() exactly like scipy.signal.stft (reference data.py:58)."""
    scale = 1.0 / hann_periodic(cfg.length).sum()
    return _stft_raw(x, cfg.length, cfg.hop) * jnp.float32(scale)


def istft(z: jnp.ndarray, cfg: StftConfig, out_samples: int) -> jnp.ndarray:
    """scipy-compatible iSTFT of `stft` output: [..., T, F] -> [..., S]."""
    scale = hann_periodic(cfg.length).sum()
    return _istft_raw(z * jnp.float32(scale), cfg.length, cfg.hop, out_samples)


def stft_scaled(x: jnp.ndarray, cfg: StftConfig) -> jnp.ndarray:
    """The reference's feature transform: scipy stft then /scale
    (data.py:77-78) == unnormalized framed rFFT.  [..., S] -> [..., T, F]."""
    return _stft_raw(x, cfg.length, cfg.hop)


def istft_scaled(z: jnp.ndarray, cfg: StftConfig, out_samples: int) -> jnp.ndarray:
    """The reference's synthesis transform: *scale then scipy istft
    (tester.py:151-155) == windowed OLA of irfft frames."""
    return _istft_raw(z, cfg.length, cfg.hop, out_samples)
