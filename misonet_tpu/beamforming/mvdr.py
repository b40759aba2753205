"""MVDR beamforming, batched and on device.

A batched JAX re-design of the reference's NumPy/LAPACK beamformer
(reference tester.py:637-794, duplicated at data.py:320-476 and
tester.py:1071-1228 — one canonical implementation here):

  reference (host, float64)            this module (device, complex64)
  ---------------------------------    ----------------------------------
  np.einsum SCM outer product          batched real einsums (ceinsum)
  np.linalg.eigh steering (:674)       fixed-iteration power iteration
                                       (only the principal eigenvector is
                                       consumed, tester.py:676-678)
  python loop PhaseCorrection (:729)   associative cumulative product of
                                       unit phasors over frequency
  numpy.linalg.solve weights (:788)    batched jnp.linalg.solve on
                                       [B, F, M, M] Hermitian+deltaI systems

All steps are jit-able with static shapes; the whole cascade
SCM -> steering -> weights -> apply is one fused XLA computation instead of
the reference's per-utterance host round trip (SURVEY.md §3.4 hot loop c).

Layout note: the reference permutes spectrograms to [B, F, C, T] before
beamforming (data.py:205-206); we keep the framework-canonical [B, C, T, F]
end to end.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from misonet_tpu.ops.complex_utils import ceinsum


def spatial_covariance(x: jnp.ndarray) -> jnp.ndarray:
    """Time-averaged spatial covariance per frequency.

    x: complex [B, C, T, F]  ->  R: complex [B, F, C, C]
    R[b,f] = (1/T) sum_t x[b,:,t,f] x[b,:,t,f]^H
    (reference get_spatial_covariance_matrix, tester.py:704-718,
    normalize=True)."""
    t = x.shape[2]
    r = ceinsum("bctf,bdtf->bfcd", x, jnp.conj(x)) / t
    return hermitize(r)


def hermitize(r: jnp.ndarray) -> jnp.ndarray:
    """0.5 * (R + R^H) — enforce Hermitian symmetry (tester.py:658)."""
    return 0.5 * (r + jnp.conj(jnp.swapaxes(r, -1, -2)))


def principal_eigenvector(r: jnp.ndarray, iterations: int = 100) -> jnp.ndarray:
    """Principal eigenvector of batched Hermitian PSD matrices
    [..., M, M] -> [..., M] via fixed-count power iteration.

    The reference computes a full eigh and keeps only the top eigenvector
    (tester.py:674-678); source SCMs are near rank-1 so power iteration
    converges geometrically with a large spectral gap, and the fixed trip
    count keeps the computation jit-static (SURVEY.md §7 hard parts).
    Iteration cost is negligible (per-frequency 6x6 matvecs vs M U-Net
    forwards per utterance); 100 trips also covers moderate spectral gaps
    — measured vs LAPACK eigh on unstructured random-model SCMs: max
    relative beamformer-output error 1.4 @ 30 trips, 4.4e-3 @ 100,
    3.2e-5 @ 300 (tests/test_pipeline_parity.py covers this numerically).
    The arbitrary global phase is irrelevant: the caller normalizes by the
    reference-mic component, which cancels it."""
    m = r.shape[-1]
    # Start from R @ 1 (one matvec ahead of a constant start; orthogonal to
    # the principal eigenvector only on a measure-zero set).
    v = jnp.sum(r, axis=-1)
    norm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    v = jnp.where(norm > 0, v / jnp.maximum(norm, 1e-30), jnp.ones_like(v) / m**0.5)

    def body(_, v):
        w = ceinsum("...ij,...j->...i", r, v)
        n = jnp.linalg.norm(w, axis=-1, keepdims=True)
        return jnp.where(n > 1e-30, w / jnp.maximum(n, 1e-30), v)

    return jax.lax.fori_loop(0, iterations, body, v)


def normalize_steering(d: jnp.ndarray, ref_ch: int = 0) -> jnp.ndarray:
    """Reference-mic normalization then sqrt(M/||d||) rescale, exactly the
    reference's chain (tester.py:685-689: divide by the ref-mic component,
    then multiply by sqrt(M / norm) — note norm, not norm^2)."""
    m = d.shape[-1]
    d = d / d[..., ref_ch : ref_ch + 1]
    norm = jnp.linalg.norm(d, axis=-1, keepdims=True)
    return d * jnp.sqrt(m / norm)


def phase_correct(d: jnp.ndarray) -> jnp.ndarray:
    """Inter-frequency phase correction (reference PhaseCorrection,
    tester.py:720-733): rotate each frequency's steering vector so adjacent
    frequencies are phase-aligned.

    The reference's sequential loop applies
        w[f] *= exp(-1j * angle(sum(w[f] * conj(w'[f-1]))))
    where w'[f-1] is the already-corrected predecessor.  Writing the
    correction as a unit phasor p[f], the recursion telescopes to
        p[f] = p[f-1] * conj(unit(s[f])),   s[f] = sum(w[f] * conj(w[f-1]))
    with s computed from *uncorrected* vectors — a cumulative product over
    frequency, evaluated here as an associative scan instead of a loop.

    d: [B, F, M] -> [B, F, M]."""
    s = jnp.sum(d[:, 1:] * jnp.conj(d[:, :-1]), axis=-1)  # [B, F-1]
    mag = jnp.abs(s)
    unit = jnp.where(mag > 0, s / jnp.maximum(mag, 1e-30), jnp.ones_like(s))
    factors = jnp.concatenate(
        [jnp.ones(s.shape[:1] + (1,), s.dtype), jnp.conj(unit)], axis=1
    )
    phasors = jax.lax.associative_scan(jnp.multiply, factors, axis=1)  # [B, F]
    return d * phasors[..., None]


def loaded_solve(
    noise_scm: jnp.ndarray, steering: jnp.ndarray, diag_load: float = 1e-6
) -> jnp.ndarray:
    """(Phi_n + delta*I)^-1 d for batched [..., M, M] Hermitian systems and
    [..., M] right-hand sides (reference tester.py:787-788).  Its ops
    carry the named scope ``loaded_solve`` in profiler traces."""
    m = steering.shape[-1]
    with jax.named_scope("loaded_solve"):
        rn = noise_scm + diag_load * jnp.eye(m, dtype=noise_scm.dtype)
        return jnp.linalg.solve(rn, steering[..., None])[..., 0]


def mvdr_weights(
    steering: jnp.ndarray, noise_scm: jnp.ndarray, diag_load: float = 1e-6
) -> jnp.ndarray:
    """w = (Phi_n + delta*I)^-1 d / (d^H (Phi_n + delta*I)^-1 d)
    (reference get_mvdr_beamformer, tester.py:777-791).

    steering [B, F, M], noise_scm [B, F, M, M] -> weights [B, F, M]."""
    numer = loaded_solve(noise_scm, steering, diag_load)
    denom = ceinsum("...m,...m->...", jnp.conj(steering), numer)
    return numer / denom[..., None]


def condition_covariance(r: jnp.ndarray, gamma: float) -> jnp.ndarray:
    """Covariance conditioning: (R + gamma*tr(R)/M * I) / (1 + gamma) —
    the reference's (unused-by-default) alternative to plain diagonal
    loading (tester.py:735-742)."""
    m = r.shape[-1]
    tr = jnp.trace(r, axis1=-2, axis2=-1).real[..., None, None]
    scaled_eye = (gamma * tr / m) * jnp.eye(m, dtype=r.dtype)
    return (r + scaled_eye) / (1.0 + gamma)


def blind_analytic_normalization(
    w: jnp.ndarray, noise_scm: jnp.ndarray, eps: float = 0.0
) -> jnp.ndarray:
    """BAN post-scaling of beamformer weights (tester.py:752-774):
    w * sqrt(|w^H Rn Rn w|) / |w^H Rn w|.  Optional distortion reduction."""
    rn_w = ceinsum("...ab,...b->...a", noise_scm, w)
    rn_rn_w = ceinsum("...ab,...b->...a", noise_scm, rn_w)
    nominator = jnp.abs(
        jnp.sqrt(ceinsum("...a,...a->...", jnp.conj(w), rn_rn_w))
    )
    denominator = jnp.abs(ceinsum("...a,...a->...", jnp.conj(w), rn_w))
    return w * (nominator / (denominator + eps))[..., None]


def normalize_unit_power(d: jnp.ndarray) -> jnp.ndarray:
    """Steering normalization variant dividing by d^H d (the reference's
    unused `normalize`, tester.py:744-750)."""
    power = jnp.sum(jnp.abs(d) ** 2, axis=-1, keepdims=True)
    return d / power


@functools.partial(jax.jit, static_argnames=("ref_ch", "power_iters"))
def mvdr_beamform(
    source: jnp.ndarray,
    mixture: jnp.ndarray,
    ref_ch: int = 0,
    diag_load: float = 1e-6,
    power_iters: int = 100,
) -> jnp.ndarray:
    """Full MVDR stage (reference Apply_Beamforming, tester.py:637-702).

    source:  per-speaker multi-channel estimate, complex [B, C, T, F]
             (the MISO1 circular-shift decode output)
    mixture: observed mixture, complex [B, C, T, F]
    Returns the beamformed single-channel estimate, complex [B, T, F].

    Steps: source SCM -> noise SCM from (mix - source) -> power-iteration
    steering -> ref-mic + sqrt(M/||d||) normalization -> phase correction ->
    diagonal-loaded Hermitian solve -> apply w^H y."""
    source_scm = spatial_covariance(source)
    noise_scm = spatial_covariance(mixture - source)

    d = principal_eigenvector(source_scm, power_iters)
    d = normalize_steering(d, ref_ch)
    d = phase_correct(d)

    w = mvdr_weights(d, noise_scm, diag_load)
    # y[b,t,f] = sum_c conj(w[b,f,c]) x[b,c,t,f]  (tester.py:793-794)
    return ceinsum("bfc,bctf->btf", jnp.conj(w), mixture)
