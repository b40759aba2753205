"""Sequence-parallel TCN: time-axis sharding with halo exchange.

For long-form utterances whose frame count exceeds one device's memory, the
TCN bottleneck can run with its time axis sharded over a mesh axis
(SURVEY.md §5 long-context: receptive field ~2·sum(2^x)·2 frames, halo
exchange of the dilation depth per side).  This module reimplements the
TemporalConvNet forward (same parameters as models.blocks.TemporalConvNet —
the pytree produced by MISONet's init) as a shard_map-compatible function:

  * every dilated depthwise conv exchanges its `dilation` frames of halo
    with each neighbor via `jax.lax.ppermute` (edge shards zero-pad, which
    ppermute provides for free);
  * every normalization (outer IN / inner gLN) computes exact global
    statistics with `psum` of local (sum, sum-of-squares, count);
  * pointwise convs, PReLU and residuals are purely local.

Outputs match the unsharded TCN bit-for-tolerance (tests/test_tcn_sp.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from misonet_tpu.config import ModelConfig
from misonet_tpu.models.blocks import EPS_GLN, EPS_IN, TemporalConvNet


def _halo_exchange(x: jnp.ndarray, halo: int, axis: str) -> jnp.ndarray:
    """[B, T_loc, C] -> [B, T_loc + 2*halo, C]: receive `halo` trailing
    frames from the left neighbor and `halo` leading frames from the right
    neighbor; edges get zeros (the conv's zero padding)."""
    n = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)
    left_edge = x[:, :halo]
    right_edge = x[:, -halo:]
    # send my right edge to my right neighbor (their left halo), and my
    # left edge to my left neighbor (their right halo)
    from_left = jax.lax.ppermute(
        right_edge, axis, [(i, i + 1) for i in range(n - 1)]
    )
    from_right = jax.lax.ppermute(
        left_edge, axis, [(i + 1, i) for i in range(n - 1)]
    )
    del idx
    return jnp.concatenate([from_left, x, from_right], axis=1)


def _instance_norm_global(x: jnp.ndarray, axis: str) -> jnp.ndarray:
    """IN over the full (sharded) time axis per (batch, channel)."""
    s = jax.lax.psum(jnp.sum(x, axis=1, keepdims=True), axis)
    ss = jax.lax.psum(jnp.sum(x * x, axis=1, keepdims=True), axis)
    cnt = jax.lax.psum(jnp.asarray(x.shape[1], jnp.float32), axis)
    mean = s / cnt
    var = ss / cnt - mean**2
    return (x - mean) * jax.lax.rsqrt(var + EPS_IN)


def _gln_global(x: jnp.ndarray, gamma, beta, axis: str) -> jnp.ndarray:
    """gLN over (time, channel) per batch element, sharded time."""
    s = jax.lax.psum(jnp.sum(x, axis=(1, 2), keepdims=True), axis)
    ss = jax.lax.psum(jnp.sum(x * x, axis=(1, 2), keepdims=True), axis)
    cnt = jax.lax.psum(
        jnp.asarray(x.shape[1] * x.shape[2], jnp.float32), axis
    )
    mean = s / cnt
    var = ss / cnt - mean**2
    return gamma * (x - mean) / jnp.sqrt(var + EPS_GLN) + beta


def _dsconv(x: jnp.ndarray, p: dict, dilation: int, axis: str) -> jnp.ndarray:
    """Depthwise (k=3, dilated, halo-exchanged) -> PReLU -> gLN(global) ->
    pointwise.  x [B, T_loc, C]."""
    c = x.shape[-1]
    xe = _halo_exchange(x, dilation, axis)
    y = jax.lax.conv_general_dilated(
        xe,
        p["depthwise"]["kernel"],
        window_strides=(1,),
        padding="VALID",
        rhs_dilation=(dilation,),
        feature_group_count=c,
        dimension_numbers=("NHC", "HIO", "NHC"),
    )
    alpha = p["PReLU_0"]["alpha"]
    y = jnp.where(y >= 0, y, alpha * y)
    y = _gln_global(
        y, p["GlobalLayerNorm_0"]["gamma"], p["GlobalLayerNorm_0"]["beta"], axis
    )
    return jax.lax.conv_general_dilated(
        y,
        p["pointwise"]["kernel"],
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NHC", "HIO", "NHC"),
    )


def _tcn_local(params: dict, x: jnp.ndarray, cfg: ModelConfig, axis: str):
    """The shard-local TCN body (runs under shard_map)."""
    for r in range(cfg.tcn_repeats):
        for bix in range(cfg.tcn_blocks):
            p = params[f"repeat{r}_block{bix}"]
            residual = x
            y = _instance_norm_global(x, axis)
            y = jax.nn.elu(y)
            y = _dsconv(y, p["DepthwiseSeparableConv_0"], 2**bix, axis)
            y = _instance_norm_global(y, axis)
            y = jax.nn.elu(y)
            y = _dsconv(y, p["DepthwiseSeparableConv_1"], 2**bix, axis)
            x = y + residual
    return x


def tcn_time_sharded(
    tcn_params: dict,
    x: jnp.ndarray,
    cfg: ModelConfig,
    mesh: Mesh,
    axis: str | None = None,
):
    """Run the TCN with its time axis sharded over ``mesh``.

    tcn_params: the 'tcn' subtree of MISONet params
                (params['params']['tcn']) or a TemporalConvNet's init;
    x: [B, T, C] with T divisible by the mesh axis size.
    Returns [B, T, C] equal to the unsharded TemporalConvNet output."""
    axis = axis or mesh.axis_names[0]
    assert x.shape[1] % mesh.shape[axis] == 0, (
        f"T={x.shape[1]} must divide by mesh axis {mesh.shape[axis]}"
    )
    from jax import shard_map

    fn = shard_map(
        partial(_tcn_local, tcn_params, cfg=cfg, axis=axis),
        mesh=mesh,
        in_specs=P(None, axis, None),
        out_specs=P(None, axis, None),
    )
    return fn(x)


@dataclasses.dataclass(frozen=True)
class TemporalConvNetSP:
    """Sequence-parallel TemporalConvNet: same parameters/numerics as the
    local block (blocks.TemporalConvNet), time axis sharded over ``mesh``
    with halo exchange + collective norm statistics.  Selected by
    ModelConfig.sequence_parallel.  Stats run fp32 like the local path;
    convs too (the TCN is <5% of model FLOPs — long-form T is where this
    path matters)."""

    repeats: int
    blocks: int
    features: int
    norm_type: str
    mesh: Mesh
    axis: str | None = None

    def init(self, key, in_ch: int) -> dict:
        return TemporalConvNet(
            self.repeats, self.blocks, self.features, self.norm_type
        ).init(key, in_ch)

    def apply(self, params: dict, x: jnp.ndarray) -> jnp.ndarray:
        if self.norm_type != "IN":
            raise ValueError(
                "sequence-parallel TCN implements the production IN outer norm"
            )
        cfg = ModelConfig(
            tcn_repeats=self.repeats, tcn_blocks=self.blocks,
            tcn_channels=self.features, norm_type=self.norm_type,
        )
        y = tcn_time_sharded(
            params, x.astype(jnp.float32), cfg, self.mesh, self.axis
        )
        return y.astype(x.dtype)
