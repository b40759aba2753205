"""The stock loaded Hermitian solve of the MVDR weights,
(Phi_n + delta*I)^-1 d (reference tester.py:787-788), against NumPy
float64 at the array sizes of the supported plans and their neighbours."""

import jax.numpy as jnp
import numpy as np
import pytest

from misonet_tpu.beamforming.mvdr import loaded_solve, mvdr_weights


def _case(m, seed, b=3, f=17, t=40):
    rng = np.random.default_rng(seed)
    noise = rng.standard_normal((b, f, m, t)) + 1j * rng.standard_normal((b, f, m, t))
    scm = np.einsum("bfmt,bfnt->bfmn", noise, noise.conj()) / t
    d = rng.standard_normal((b, f, m)) + 1j * rng.standard_normal((b, f, m))
    return scm, d


@pytest.mark.parametrize("diag", [1e-6, 1e-3, 1e-1])
@pytest.mark.parametrize("m", [2, 6, 8])
def test_loaded_solve_matches_numpy(m, diag):
    scm, d = _case(m, seed=m)
    ref = np.linalg.solve(scm + diag * np.eye(m), d[..., None])[..., 0]
    ours = np.asarray(loaded_solve(jnp.asarray(scm, jnp.complex64),
                                   jnp.asarray(d, jnp.complex64), diag))
    assert ours.dtype == np.complex64
    rel = np.linalg.norm(ours - ref) / np.linalg.norm(ref)
    assert rel < 1e-5, rel
    # the MVDR weights built on it satisfy the distortionless constraint
    w = np.asarray(mvdr_weights(jnp.asarray(d, jnp.complex64),
                                jnp.asarray(scm, jnp.complex64), diag))
    np.testing.assert_allclose(np.einsum("...m,...m->...", w.conj(), d), 1.0,
                               atol=1e-4)
