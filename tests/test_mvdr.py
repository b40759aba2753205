"""MVDR beamformer tests: numpy eigh/solve oracle parity + physical
simulation (reference Apply_Beamforming, tester.py:637-794)."""

import jax
import jax.numpy as jnp
import numpy as np

from misonet_tpu.beamforming import (
    mvdr_beamform,
    spatial_covariance,
    principal_eigenvector,
    phase_correct,
    mvdr_weights,
)
from misonet_tpu.beamforming.scm import (
    scm_partial,
    streaming_scm_update,
    scm_finalize,
    chunked_scm,
)

B, C, T, F = 2, 6, 40, 17


def _rand_c(rng, shape, scale=1.0):
    return (
        scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    ).astype(np.complex64)


# ---------------- numpy oracle (eigh/solve, float64) ----------------------

def oracle_mvdr(source, mixture, ref_ch=0, delta=1e-6):
    """Independent float64 implementation of the same math with LAPACK
    eigh/solve, mirroring the reference's numerical path."""
    src = source.astype(np.complex128)
    mix = mixture.astype(np.complex128)
    t = src.shape[2]

    def scm(x):
        r = np.einsum("bctf,bdtf->bfcd", x, x.conj()) / t
        return 0.5 * (r + r.conj().swapaxes(-1, -2))

    r_s = scm(src)
    r_n = scm(mix - src)
    bb, ff, m, _ = r_s.shape
    flat = r_s.reshape(-1, m, m)
    vals, vecs = np.linalg.eigh(flat)
    d = np.stack([vecs[i, :, np.argmax(vals[i])] for i in range(len(flat))])
    d = d.reshape(bb, ff, m)
    d = d / d[..., ref_ch : ref_ch + 1]
    for b in range(bb):
        for f in range(ff):
            d[b, f] *= np.sqrt(m / np.linalg.norm(d[b, f]))
    # sequential phase correction
    for b in range(bb):
        for f in range(1, ff):
            d[b, f] *= np.exp(
                -1j * np.angle(np.sum(d[b, f] * d[b, f - 1].conj()))
            )
    rn = r_n + delta * np.eye(m)
    numer = np.linalg.solve(rn, d[..., None])[..., 0]
    denom = np.einsum("...m,...m->...", d.conj(), numer)
    w = numer / denom[..., None]
    return np.einsum("bfc,bctf->btf", w.conj(), mix)


def _sim(rng, b=B):
    """Two far-field sources with random steering + diffuse noise."""
    steer = _rand_c(rng, (b, F, C))
    steer /= np.abs(steer[..., :1]) * np.sign(steer[..., :1].real + 1e-9)
    sig = _rand_c(rng, (b, T, F))
    source = np.einsum("bfc,btf->bctf", steer, sig).astype(np.complex64)
    noise = _rand_c(rng, (b, C, T, F), scale=0.1)
    return source, source + noise, sig


def test_mvdr_matches_oracle():
    rng = np.random.default_rng(0)
    source, mixture, _ = _sim(rng)
    ours = np.asarray(mvdr_beamform(jnp.asarray(source), jnp.asarray(mixture)))
    ref = oracle_mvdr(source, mixture)
    # complex64 power iteration vs float64 eigh: allow small tolerance
    np.testing.assert_allclose(ours, ref, atol=5e-3, rtol=5e-3)


def test_mvdr_recovers_source():
    """Beamforming toward a rank-1 source must suppress the added noise."""
    rng = np.random.default_rng(1)
    source, mixture, sig = _sim(rng)
    out = np.asarray(mvdr_beamform(jnp.asarray(source), jnp.asarray(mixture)))
    ref_img = source[:, 0]  # ref-mic source image [B, T, F]
    # The beamformer's response carries a per-frequency complex scale
    # (sqrt(M/||d||) steering rescale + phase correction), so compare after
    # the optimal per-frequency scaling.
    alpha = np.sum(np.conj(out) * ref_img, axis=1, keepdims=True) / (
        np.sum(np.abs(out) ** 2, axis=1, keepdims=True) + 1e-12
    )
    resid = np.abs(alpha * out - ref_img).mean()
    noise_in = np.abs(mixture[:, 0] - source[:, 0]).mean()
    assert resid < 0.5 * noise_in, (resid, noise_in)


def test_principal_eigenvector_matches_eigh():
    # Source SCMs are near rank-1 (one dominant direction), which is what
    # gives power iteration its fast geometric convergence; build matrices
    # with that structure: R = v v^H + 0.05 * A A^H.
    rng = np.random.default_rng(2)
    v = _rand_c(rng, (B, F, C))
    a = _rand_c(rng, (B, F, C, C), scale=0.05)
    r = np.einsum("...i,...j->...ij", v, v.conj()) + np.einsum(
        "...ij,...kj->...ik", a, a.conj()
    )
    ours = np.asarray(principal_eigenvector(jnp.asarray(r), iterations=30))
    flat = r.reshape(-1, C, C)
    vals, vecs = np.linalg.eigh(flat)
    top = np.stack([vecs[i, :, -1] for i in range(len(flat))]).reshape(B, F, C)
    # compare up to global phase: normalize both by first component
    ours_n = ours / ours[..., :1]
    top_n = top / top[..., :1]
    np.testing.assert_allclose(ours_n, top_n, atol=1e-3, rtol=1e-3)


def test_phase_correct_matches_sequential():
    rng = np.random.default_rng(3)
    d = _rand_c(rng, (B, F, C))
    ours = np.asarray(phase_correct(jnp.asarray(d)))
    seq = d.astype(np.complex128).copy()
    for b in range(B):
        for f in range(1, F):
            seq[b, f] *= np.exp(
                -1j * np.angle(np.sum(seq[b, f] * seq[b, f - 1].conj()))
            )
    np.testing.assert_allclose(ours, seq, atol=1e-4)


def test_mvdr_weights_unit_gain_on_steering():
    """MVDR constraint: w^H d == 1."""
    rng = np.random.default_rng(4)
    d = jnp.asarray(_rand_c(rng, (B, F, C)))
    a = _rand_c(rng, (B, F, C, C))
    rn = jnp.asarray(np.einsum("...ij,...kj->...ik", a, a.conj()))
    w = mvdr_weights(d, rn)
    gain = np.asarray(jnp.einsum("...m,...m->...", jnp.conj(w), d))
    np.testing.assert_allclose(gain, np.ones_like(gain), atol=1e-3)


def test_streaming_scm_equals_full():
    rng = np.random.default_rng(5)
    x = _rand_c(rng, (C, 3 * T, F))
    full = np.asarray(spatial_covariance(jnp.asarray(x[None])))[0]  # [F,C,C]
    blocks = jnp.asarray(x.reshape(C, 3, T, F).transpose(1, 0, 2, 3))  # [3,C,T,F]
    acc = scm_partial(blocks[0])
    acc = streaming_scm_update(acc, blocks[1])
    acc = streaming_scm_update(acc, blocks[2])
    np.testing.assert_allclose(np.asarray(scm_finalize(acc)), full, atol=1e-3)
    np.testing.assert_allclose(np.asarray(chunked_scm(blocks)), full, atol=1e-3)


def test_chunked_scm_psum_over_mesh():
    """Blocks sharded over the device mesh: psum-reduced SCM must equal the
    single-device result (collective accumulation, SURVEY.md §2.10.4)."""
    from jax.sharding import Mesh, PartitionSpec as P
    import numpy as onp

    devices = jax.devices()
    assert len(devices) == 8
    mesh = Mesh(onp.asarray(devices), ("blocks",))
    rng = np.random.default_rng(6)
    blocks = _rand_c(rng, (8, C, T, F))

    full = np.asarray(chunked_scm(jnp.asarray(blocks)))

    from jax import shard_map

    f = shard_map(
        lambda b: chunked_scm(b, axis_name="blocks"),
        mesh=mesh,
        in_specs=P("blocks"),
        out_specs=P(),
    )
    sharded = np.asarray(f(jnp.asarray(blocks)))
    np.testing.assert_allclose(sharded, full, atol=1e-3)
