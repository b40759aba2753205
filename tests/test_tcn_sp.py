"""Sequence-parallel TCN vs the dense TemporalConvNet on the 8-device CPU
mesh: halo exchange + collective norm statistics must reproduce the
unsharded output exactly (SURVEY.md §5 long-context)."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from misonet_tpu.config import ModelConfig
from misonet_tpu.models.blocks import TemporalConvNet
from misonet_tpu.parallel import make_mesh
from misonet_tpu.parallel.tcn_sp import tcn_time_sharded

pytestmark = pytest.mark.slow

CFG = ModelConfig(tcn_repeats=2, tcn_blocks=4, tcn_channels=16)
B, T, C = 2, 256, 16  # T covers dilations up to 8 across 8 shards of 32


def test_sharded_tcn_matches_dense():
    model = TemporalConvNet(
        repeats=CFG.tcn_repeats,
        blocks=CFG.tcn_blocks,
        features=CFG.tcn_channels,
        norm_type="IN",
    )
    x = jax.random.normal(jax.random.key(0), (B, T, C))
    params = model.init(jax.random.key(1), C)
    dense = model.apply(params, x)

    mesh = make_mesh(axis="seq")
    assert mesh.size == 8
    sharded = tcn_time_sharded(params, x, CFG, mesh)
    np.testing.assert_allclose(
        np.asarray(sharded), np.asarray(dense), atol=2e-5, rtol=2e-5
    )


def test_sharded_tcn_large_dilation_spanning_shards():
    """Dilation 8 with 32-frame shards: halos cross shard boundaries."""
    cfg = ModelConfig(tcn_repeats=1, tcn_blocks=4, tcn_channels=8)
    model = TemporalConvNet(repeats=1, blocks=4, features=8, norm_type="IN")
    x = jax.random.normal(jax.random.key(2), (1, 128, 8))
    params = model.init(jax.random.key(3), 8)
    dense = model.apply(params, x)
    mesh = make_mesh(axis="seq")
    sharded = tcn_time_sharded(params, x, cfg, mesh)
    np.testing.assert_allclose(
        np.asarray(sharded), np.asarray(dense), atol=2e-5, rtol=2e-5
    )


def test_sequence_parallel_through_model():
    """ModelConfig.sequence_parallel routes MISONet's TCN bottleneck
    through the shard_map path with identical parameters and outputs
    (VERDICT r2 item 6c: reachable from config, through the full model)."""
    from misonet_tpu.models import make_miso1

    plan = dict(
        num_bottleneck=4,
        en_channels=(8, 8, 8, 16),
        de_channels=(16, 8, 8, 8),
        tcn_repeats=1,
        tcn_blocks=3,
        tcn_channels=16,
        compute_dtype="float32",
    )
    local = make_miso1(ModelConfig(**plan))
    mesh = make_mesh(axis="seq")
    sp = make_miso1(
        ModelConfig(**plan, sequence_parallel=True), sp_mesh=mesh
    )

    b, c, t, f = 2, 3, 64, 17  # T=64 -> 8 frames/shard, dilations to 4
    k1, k2 = jax.random.split(jax.random.key(4))
    mix = jax.lax.complex(
        jax.random.normal(k1, (b, c, t, f)), jax.random.normal(k2, (b, c, t, f))
    )
    params = local.init(jax.random.key(5), mix)
    # identical param trees: checkpoint interchange between the two paths
    sp_init = sp.init(jax.random.key(5), mix)
    assert jax.tree_util.tree_structure(params) == (
        jax.tree_util.tree_structure(sp_init)
    )

    out_local = local.apply(params, mix)
    out_sp = jax.jit(sp.apply)(params, mix)
    np.testing.assert_allclose(
        np.asarray(out_sp.real), np.asarray(out_local.real),
        atol=2e-4, rtol=2e-4,
    )
    np.testing.assert_allclose(
        np.asarray(out_sp.imag), np.asarray(out_local.imag),
        atol=2e-4, rtol=2e-4,
    )
