"""Each plain-JAX block against a float64 NumPy reference written from the
reference model's definitions (reference model.py:401-632), independent of
the model code: explicit tap loops for convolutions, scatter-add for the
transposed convolution, and the textbook norm formulas."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from misonet_tpu.models.blocks import (
    ConvBlock,
    ConvTranspose2dTorch,
    DeconvBlock,
    DenseBlock,
    Norm,
    TemporalBlock,
)

TOL = dict(rtol=2e-4, atol=2e-4)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _randomize(params, seed):
    """Random values in place of the deterministic inits (zero biases, unit
    gammas, PReLU 0.25), so every parameter is exercised."""
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(treedef, [
        jnp.asarray(rng.standard_normal(np.shape(leaf)) * 0.5, jnp.float32)
        for leaf in leaves
    ])


# --- NumPy references ----------------------------------------------------


def np_conv2d(x, w, stride=(1, 1), pad=((1, 1), (0, 0))):
    """x [B, H, W, I], w [kh, kw, I, O]: cross-correlation, zero padding."""
    kh, kw = w.shape[:2]
    xp = np.pad(x, ((0, 0), *pad, (0, 0)))
    ho = (xp.shape[1] - kh) // stride[0] + 1
    wo = (xp.shape[2] - kw) // stride[1] + 1
    out = np.zeros((x.shape[0], ho, wo, w.shape[3]))
    for i in range(kh):
        for j in range(kw):
            patch = xp[:, i: i + stride[0] * ho: stride[0],
                       j: j + stride[1] * wo: stride[1]]
            out += patch @ w[i, j]
    return out


def np_conv_transpose(x, w, stride, pad=(1, 0)):
    """torch ConvTranspose2d: out[h*s + k - p] += x[h] @ w[k] (scatter)."""
    b, h, wd, _ = x.shape
    kh, kw = w.shape[:2]
    full = np.zeros((b, (h - 1) * stride[0] + kh, (wd - 1) * stride[1] + kw,
                     w.shape[3]))
    for i in range(h):
        for j in range(wd):
            for ki in range(kh):
                for kj in range(kw):
                    full[:, i * stride[0] + ki, j * stride[1] + kj] += (
                        x[:, i, j] @ w[ki, kj]
                    )
    return full[:, pad[0]: full.shape[1] - pad[0],
                pad[1]: full.shape[2] - pad[1]]


def np_elu(x):
    return np.where(x > 0, x, np.expm1(np.minimum(x, 0)))


def np_in(x, eps=1e-5):
    axes = tuple(range(1, x.ndim - 1))
    m = x.mean(axes, keepdims=True)
    v = ((x - m) ** 2).mean(axes, keepdims=True)
    return (x - m) / np.sqrt(v + eps)


def np_gln(x, g, b, eps=1e-8):
    m = x.mean((1, 2), keepdims=True)
    v = ((x - m) ** 2).mean((1, 2), keepdims=True)
    return g * (x - m) / np.sqrt(v + eps) + b


def np_dsconv(p, x, d):
    """depthwise k=3 dilated -> PReLU -> gLN -> pointwise; x [B, T, C]."""
    t = x.shape[1]
    xp = np.pad(x, ((0, 0), (d, d), (0, 0)))
    k = p["depthwise"]["kernel"][:, 0, :]                 # [3, C]
    y = sum(xp[:, i * d: i * d + t] * k[i] for i in range(3))
    a = p["PReLU_0"]["alpha"]
    y = np.where(y >= 0, y, a * y)
    y = np_gln(y, p["GlobalLayerNorm_0"]["gamma"], p["GlobalLayerNorm_0"]["beta"])
    return y @ p["pointwise"]["kernel"][0]


# --- tests ---------------------------------------------------------------


@pytest.mark.parametrize("stride", [(1, 1), (1, 2)], ids=["stride1", "stride2"])
def test_conv_block_matches_numpy(stride):
    x = np.random.default_rng(0).standard_normal((2, 7, 17, 5)).astype(np.float32)
    blk = ConvBlock(6, strides=stride)
    params = _randomize(blk.init(jax.random.key(0), 5), 1)
    ours = np.asarray(blk.apply(params, jnp.asarray(x)))
    p = _np(params)["Conv_0"]
    ref = np_in(np_elu(np_conv2d(x.astype(np.float64), p["kernel"], stride)
                       + p["bias"]))
    assert ours.shape == ref.shape == (2, 7, (17 - 3) // stride[1] + 1, 6)
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("stride", [(1, 1), (1, 2)], ids=["stride1", "stride2"])
def test_conv_transpose_matches_numpy(stride):
    x = np.random.default_rng(2).standard_normal((2, 5, 7, 4)).astype(np.float32)
    blk = ConvTranspose2dTorch(3, strides=stride)
    params = _randomize(blk.init(jax.random.key(1), 4), 3)
    ours = np.asarray(blk.apply(params, jnp.asarray(x)))
    p = _np(params)
    ref = np_conv_transpose(x.astype(np.float64), p["kernel"], stride) + p["bias"]
    # torch geometry: out = (in-1)*stride - 2*pad + kernel (model.py:418-433)
    assert ours.shape == (2, 5, (7 - 1) * stride[1] + 3, 3)
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("stride", [(1, 1), (1, 2)], ids=["stride1", "stride2"])
def test_deconv_block_matches_numpy(stride):
    x = np.random.default_rng(4).standard_normal((2, 6, 7, 8)).astype(np.float32)
    blk = DeconvBlock(4, strides=stride)
    params = _randomize(blk.init(jax.random.key(2), 8), 5)
    ours = np.asarray(blk.apply(params, jnp.asarray(x)))
    p = _np(params)["ConvTranspose2dTorch_0"]
    ref = np_in(np_elu(
        np_conv_transpose(x.astype(np.float64), p["kernel"], stride) + p["bias"]
    ))
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize(
    "in_ch,g1,g2", [(8, 8, 8), (16, 8, 16)], ids=["encoder", "decoder"]
)
def test_dense_block_matches_numpy(in_ch, g1, g2):
    """Encoder DenseBlocks keep the width (g1 = g2 = C); decoder ones take
    the skip concatenation 2C with growth C (model.py:437-482)."""
    x = np.random.default_rng(6).standard_normal((2, 6, 9, in_ch)).astype(np.float32)
    blk = DenseBlock(g1, g2)
    params = _randomize(blk.init(jax.random.key(3), in_ch), 7)
    ours = np.asarray(blk.apply(params, jnp.asarray(x)))
    p = _np(params)
    feats = x.astype(np.float64)
    for i in range(1, 6):
        y = np_conv2d(feats, p[f"conv{i}_kernel"], pad=((1, 1), (1, 1)))
        y = np_in(np_elu(y + p[f"conv{i}_bias"]))
        feats = np.concatenate([feats, y], axis=-1)
    assert ours.shape == (2, 6, 9, g2)
    np.testing.assert_allclose(ours, y, **TOL)


@pytest.mark.parametrize("dilation", [1, 64])
def test_temporal_block_matches_numpy(dilation):
    """TCN block at the first dilation and the last one of the 7-block
    repeat (2^6), where the padding exceeds a third of the sequence."""
    x = np.random.default_rng(8).standard_normal((2, 150, 8)).astype(np.float32)
    blk = TemporalBlock(8, dilation, norm_type="IN")
    params = _randomize(blk.init(jax.random.key(4), 8), 9)
    ours = np.asarray(blk.apply(params, jnp.asarray(x)))
    p = _np(params)
    y = x.astype(np.float64)
    for j in range(2):
        y = np_dsconv(p[f"DepthwiseSeparableConv_{j}"], np_elu(np_in(y)), dilation)
    np.testing.assert_allclose(ours, y + x, **TOL)


@pytest.mark.parametrize("kind", ["IN", "gLN", "cLN", "BN"])
def test_norm_matches_numpy(kind):
    x = np.random.default_rng(10).standard_normal((3, 20, 6)).astype(np.float32) * 3 + 1
    norm = Norm(kind)
    params = _randomize(norm.init(None, 6), 11)
    ours = np.asarray(norm.apply(params, jnp.asarray(x)))
    xd, p = x.astype(np.float64), _np(params)
    if kind == "IN":
        assert params == {}
        ref = np_in(xd)
    elif kind == "gLN":
        ref = np_gln(xd, p["gamma"], p["beta"])
    elif kind == "cLN":
        m = xd.mean(-1, keepdims=True)
        v = xd.var(-1, keepdims=True)
        ref = p["gamma"] * (xd - m) / np.sqrt(v + 1e-8) + p["beta"]
    else:
        m = xd.mean((0, 1), keepdims=True)
        v = xd.var((0, 1), keepdims=True)
        ref = p["gamma"] * (xd - m) / np.sqrt(v + 1e-5) + p["beta"]
    np.testing.assert_allclose(ours, ref, **TOL)
