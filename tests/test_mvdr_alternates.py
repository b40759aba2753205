"""Tests for the MVDR alternates the reference carries but doesn't enable
by default (tester.py:735-774) plus norm-dispatch completeness."""

import jax
import jax.numpy as jnp
import numpy as np

from misonet_tpu.beamforming.mvdr import (
    blind_analytic_normalization,
    condition_covariance,
    normalize_unit_power,
)
from misonet_tpu.models.blocks import Norm


def _rand_c(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(
        np.complex64
    )


def test_condition_covariance():
    rng = np.random.default_rng(0)
    a = _rand_c(rng, (3, 5, 4, 4))
    r = jnp.asarray(np.einsum("...ij,...kj->...ik", a, a.conj()))
    out = np.asarray(condition_covariance(r, 1e-2))
    # oracle per the reference formula (tester.py:738-741)
    r_np = np.asarray(r)
    m = 4
    scale = 1e-2 * np.trace(r_np, axis1=-2, axis2=-1).real / m
    ref = (r_np + scale[..., None, None] * np.eye(m)) / (1 + 1e-2)
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_blind_analytic_normalization_scales_only():
    rng = np.random.default_rng(1)
    w = jnp.asarray(_rand_c(rng, (2, 5, 4)))
    a = _rand_c(rng, (2, 5, 4, 4))
    rn = jnp.asarray(np.einsum("...ij,...kj->...ik", a, a.conj()))
    out = np.asarray(blind_analytic_normalization(w, rn))
    # direction preserved: out = scalar * w per (b, f)
    ratio = out / np.asarray(w)
    np.testing.assert_allclose(
        ratio, ratio[..., :1] * np.ones_like(ratio), rtol=1e-4
    )
    assert np.isreal(ratio[0, 0, 0]) or abs(ratio[0, 0, 0].imag) < 1e-5


def test_normalize_unit_power():
    rng = np.random.default_rng(2)
    d = jnp.asarray(_rand_c(rng, (2, 5, 4)))
    out = np.asarray(normalize_unit_power(d))
    ref = np.asarray(d) / np.sum(np.abs(np.asarray(d)) ** 2, -1, keepdims=True)
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_batch_norm_dispatch():
    norm = Norm("BN")
    x = jax.random.normal(jax.random.key(0), (4, 16, 8)) * 3 + 1
    params = norm.init(jax.random.key(1), x.shape[-1])
    y = norm.apply(params, x)
    np.testing.assert_allclose(float(y.mean()), 0.0, atol=1e-4)
    np.testing.assert_allclose(float(y.std()), 1.0, atol=1e-2)


def test_channel_subsample(tmp_path):
    from misonet_tpu.data import ShardDataset
    from misonet_tpu.data.synthetic import synth_shard_dir

    shard_dir = synth_shard_dir(tmp_path, num_utts=1, num_samples=2000,
                                num_ch=6, chunk=2000, least=1000)
    full = ShardDataset(shard_dir)[0]["mix"]
    sub = ShardDataset(shard_dir, num_ch_utilize=3)[0]["mix"]
    assert full.shape[1] == 6 and sub.shape[1] == 3
    # [0:6:2] -> channels 0, 2, 4 (reference data.py:81)
    np.testing.assert_array_equal(sub, full[:, 0:6:2])
