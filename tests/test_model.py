"""MISO net architecture tests: shapes, frequency ladder, dtype policy
(reference model.py; channel plan NN_BSS.yml:120-123)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from misonet_tpu.config import ModelConfig
from misonet_tpu.models import make_miso1, make_miso2, make_miso3, enhance_input

CFG = ModelConfig(compute_dtype="float32")
B, C, T, F = 2, 6, 64, 129


def _complex_input(key, shape):
    kr, ki = jax.random.split(key)
    return jax.lax.complex(
        jax.random.normal(kr, shape), jax.random.normal(ki, shape)
    )


@pytest.fixture(scope="module")
def miso1_params():
    model = make_miso1(CFG)
    x = _complex_input(jax.random.key(0), (1, C, T, F))
    return model.init(jax.random.key(1), x)


def test_miso1_output_shape(miso1_params):
    model = make_miso1(CFG)
    x = _complex_input(jax.random.key(2), (B, C, T, F))
    y = model.apply(miso1_params, x)
    assert y.shape == (B, 2, T, F)
    assert y.dtype == jnp.complex64
    assert np.isfinite(np.asarray(y.real)).all()


def test_miso1_jit_and_grad(miso1_params):
    model = make_miso1(CFG)
    x = _complex_input(jax.random.key(3), (1, C, T, F))

    @jax.jit
    def loss_fn(params):
        y = model.apply(params, x)
        return jnp.sum(jnp.abs(y.real)) + jnp.sum(jnp.abs(y.imag))

    g = jax.grad(loss_fn)(miso1_params)
    leaves = jax.tree.leaves(g)
    assert all(np.isfinite(np.asarray(l)).all() for l in leaves)
    assert any(float(jnp.abs(l).sum()) > 0 for l in leaves)


def test_miso1_param_count(miso1_params):
    n = sum(np.prod(l.shape) for l in jax.tree.leaves(miso1_params))
    # U-Net + DenseBlocks + TCN at the reference channel plan lands in the
    # single-digit-millions range (SURVEY.md §2.10: ~5-10M params).
    assert 2e6 < n < 12e6, n


def test_miso2_shapes():
    model = make_miso2(CFG)
    mix = _complex_input(jax.random.key(4), (1, C, T, F))
    m1 = _complex_input(jax.random.key(5), (1, 2, T, F))
    bf = _complex_input(jax.random.key(6), (1, 2, T, F))
    x = enhance_input(mix, m1, bf)
    assert x.shape == (1, C + 4, T, F)  # model.py:173
    params = model.init(jax.random.key(7), x)
    y = model.apply(params, x)
    assert y.shape == (1, 2, T, F)


def test_miso3_shapes():
    model = make_miso3(CFG)
    mix = _complex_input(jax.random.key(8), (1, C, T, F))
    m1 = _complex_input(jax.random.key(9), (1, 1, T, F))
    bf = _complex_input(jax.random.key(10), (1, 1, T, F))
    x = enhance_input(mix, m1, bf)
    assert x.shape == (1, C + 2, T, F)  # model.py:290
    params = model.init(jax.random.key(11), x)
    y = model.apply(params, x)
    assert y.shape == (1, 1, T, F)


@pytest.mark.slow
def test_bf16_compute_dtype():
    cfg = ModelConfig(compute_dtype="bfloat16")
    model = make_miso1(cfg)
    x = _complex_input(jax.random.key(12), (1, C, T, F))
    params = model.init(jax.random.key(13), x)
    # params stay fp32
    assert all(l.dtype == jnp.float32 for l in jax.tree.leaves(params))
    y = model.apply(params, x)
    assert y.dtype == jnp.complex64
    assert np.isfinite(np.asarray(y.real)).all()


def test_conv_transpose_matches_torch_geometry():
    """Frequency ladder of the decoder: torch out = (in-1)*s - 2p + k
    (model.py:418-433)."""
    from misonet_tpu.models.blocks import ConvTranspose2dTorch

    for fin, stride, pad_expected in [(1, 1, 3), (3, 2, 7), (7, 2, 15), (127, 1, 129)]:
        m = ConvTranspose2dTorch(4, strides=(1, stride))
        x = jnp.ones((1, 5, fin, 3))
        p = m.init(jax.random.key(0), x.shape[-1])
        y = m.apply(p, x)
        assert y.shape == (1, 5, pad_expected, 4), (fin, stride, y.shape)
