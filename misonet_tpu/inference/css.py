"""Continuous speech separation (CSS): block-wise long-form processing with
streaming covariance updates (BASELINE.json config 5).

The reference handles long recordings by time-chunking plus one
full-utterance SCM on the host (tester.py:426-441, SURVEY.md §5
"long-context").  This module is the streaming on-device generalization:
audio arrives in fixed 4 s blocks; each block runs the MISO1 decode; a
running exponentially-weighted (or cumulative) SCM pair per speaker feeds an
MVDR whose weights adapt as evidence accumulates; block outputs are either
concatenated edge-to-edge (``overlap=0`` — the reference's chunked
semantics, tester.py:949-967) or cross-fade overlap-added (``overlap>0``:
blocks advance by chunk-overlap samples and a triangular fade blends the
seams, suppressing block-boundary artifacts).  All state is a small pytree,
so the whole per-block update is one jitted function — usable online.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from misonet_tpu.beamforming.mvdr import (
    mvdr_weights,
    normalize_steering,
    phase_correct,
    principal_eigenvector,
)
from misonet_tpu.config import DatasetConfig, StftConfig
from misonet_tpu.inference.separate import align_slots, make_full_array_decode
from misonet_tpu.ops.complex_utils import ceinsum
from misonet_tpu.ops.stft import istft_scaled, stft_scaled


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["source_scm", "noise_scm", "frames", "prev_mag"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class CSSState:
    """Running per-speaker SCM accumulators + previous-block magnitudes for
    chaining speaker alignment across blocks."""

    source_scm: jnp.ndarray   # [S, F, C, C] complex
    noise_scm: jnp.ndarray    # [S, F, C, C]
    frames: jnp.ndarray       # [] f32
    prev_mag: jnp.ndarray     # [S, T, F] magnitude of last block's estimates


class StreamingCSS:
    def __init__(
        self,
        miso1_model,
        miso1_params,
        stft_cfg: StftConfig,
        ds_cfg: DatasetConfig,
        forget: float = 1.0,
    ):
        """forget=1.0 -> cumulative SCM (matches the reference's utterance
        SCM in the infinite-memory limit); <1.0 -> exponential forgetting
        for non-stationary scenes."""
        self.stft_cfg = stft_cfg
        self.ds = ds_cfg
        self.params = miso1_params
        self.forget = forget
        self.decode = make_full_array_decode(
            miso1_model, ds_cfg.num_ch_utilize, ds_cfg.ref_ch
        )
        self._step = self._build_step()

    def init_state(self, num_spks: int = 2) -> CSSState:
        cfg, ds = self.stft_cfg, self.ds
        f, c = cfg.num_bins, ds.num_ch_utilize
        t = cfg.num_frames(ds.chunk_samples)
        z = jnp.zeros((num_spks, f, c, c), jnp.complex64)
        return CSSState(z, z, jnp.float32(0.0), jnp.zeros((num_spks, t, f)))

    def _build_step(self):
        ref_ch = self.ds.ref_ch
        forget = self.forget
        stft_cfg = self.stft_cfg

        @jax.jit
        def step(params, state: CSSState, block_wave: jnp.ndarray):
            """block_wave [samples, C] -> (new_state, per-speaker bf stft
            [S, T, F], miso1 ref-ch stft [S, T, F])."""
            mix = stft_scaled(block_wave.T, stft_cfg)[None]   # [1, C, T, F]
            full = self.decode(params, mix)[0]                # [S, C, T, F]
            m_ref = full[:, ref_ch]                           # [S, T, F]

            # chain speaker order to previous block
            mag = jnp.sqrt(m_ref.real**2 + m_ref.imag**2)
            d = jnp.sum(
                jnp.abs(state.prev_mag[:, None] - mag[None, :]), axis=(-2, -1)
            )[None]
            has_history = state.frames > 0
            idx = jnp.where(
                has_history, align_slots(d)[0], jnp.arange(mag.shape[0])
            )
            full = jnp.take(full, idx, axis=0)
            m_ref = full[:, ref_ch]
            mag = jnp.sqrt(m_ref.real**2 + m_ref.imag**2)

            t = full.shape[-2]
            src = ceinsum("sctf,sdtf->sfcd", full, jnp.conj(full))
            noise_sig = mix[0][None] - full                   # [S, C, T, F]
            noi = ceinsum("sctf,sdtf->sfcd", noise_sig, jnp.conj(noise_sig))

            source_scm = forget * state.source_scm + src
            noise_scm = forget * state.noise_scm + noi
            frames = forget * state.frames + t

            r_s = 0.5 * (source_scm + jnp.conj(source_scm.swapaxes(-1, -2))) / frames
            r_n = 0.5 * (noise_scm + jnp.conj(noise_scm.swapaxes(-1, -2))) / frames

            d_vec = principal_eigenvector(r_s)
            d_vec = normalize_steering(d_vec, ref_ch)
            d_vec = phase_correct(d_vec)
            w = mvdr_weights(d_vec, r_n)                      # [S, F, C]
            bf = ceinsum("sfc,ctf->stf", jnp.conj(w), mix[0])

            new_state = CSSState(source_scm, noise_scm, frames, mag)
            return new_state, bf, m_ref

        return step

    def process_block(self, state: CSSState, block_wave: np.ndarray):
        """One block: returns (state, beamformed wave [S, samples],
        miso1 wave [S, samples])."""
        state, bf, m1 = self._step(
            self.params, state, jnp.asarray(block_wave)
        )
        n = block_wave.shape[0]
        return (
            state,
            np.asarray(istft_scaled(bf, self.stft_cfg, n)),
            np.asarray(istft_scaled(m1, self.stft_cfg, n)),
        )

    def process(self, wave: np.ndarray, overlap: int = 0):
        """Full long-form recording [samples, C] -> dict with stitched
        per-speaker 'beamformed' and 'miso1' waves [S, samples].

        ``overlap`` (samples, < chunk) turns on cross-fade stitching:
        blocks advance by ``chunk - overlap`` and a triangular fade blends
        each seam.  Block size stays fixed, so the jitted step keeps ONE
        signature either way."""
        from misonet_tpu.ops.chunk import split_chunks

        chunk = self.ds.chunk_samples
        state = self.init_state(self.ds.num_spks)
        if overlap == 0:
            pieces, gap = split_chunks(wave, chunk)
            bf_out, m1_out = [], []
            for p in pieces:
                state, bf, m1 = self.process_block(state, p)
                bf_out.append(bf)
                m1_out.append(m1)
            total = len(pieces) * chunk - gap
            bf = np.concatenate(bf_out, axis=-1)[:, :total]
            m1 = np.concatenate(m1_out, axis=-1)[:, :total]
            return {"beamformed": bf, "miso1": m1}

        assert 0 < overlap < chunk, (overlap, chunk)
        hop = chunk - overlap
        total = wave.shape[0]
        n_blocks = max(1, -(-max(total - overlap, 1) // hop))
        padded = np.pad(
            wave, [(0, (n_blocks - 1) * hop + chunk - total), (0, 0)]
        )
        bf_blocks, m1_blocks = [], []
        for i in range(n_blocks):
            seg = padded[i * hop : i * hop + chunk]
            state, bf, m1 = self.process_block(state, seg)
            bf_blocks.append(bf)
            m1_blocks.append(m1)
        return {
            "beamformed": crossfade_stitch(
                np.stack(bf_blocks), hop, total
            ),
            "miso1": crossfade_stitch(np.stack(m1_blocks), hop, total),
        }


def crossfade_stitch(blocks: np.ndarray, hop: int, total: int) -> np.ndarray:
    """Overlap-add [N, S, chunk] blocks advancing by ``hop`` with a
    triangular cross-fade over the ``chunk - hop`` overlap, normalized by
    the accumulated fade weights (so consistent blocks reconstruct their
    signal exactly, including at the edges)."""
    n, s, chunk = blocks.shape
    overlap = chunk - hop
    w = np.ones(chunk, blocks.dtype)
    if overlap > 0:
        ramp = (np.arange(1, overlap + 1) / (overlap + 1)).astype(blocks.dtype)
        w[:overlap] = ramp
        w[chunk - overlap :] = ramp[::-1]
    out = np.zeros((s, (n - 1) * hop + chunk), blocks.dtype)
    wsum = np.zeros(out.shape[-1], blocks.dtype)
    for i in range(n):
        out[:, i * hop : i * hop + chunk] += blocks[i] * w
        wsum[i * hop : i * hop + chunk] += w
    return (out / wsum[None])[:, :total]
