"""Train-step tests: loss decreases, DP sharding over the 8-device CPU mesh
matches single-device results (SURVEY.md §2.10 items 1-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from misonet_tpu.config import ModelConfig, OptimizerConfig
from misonet_tpu.models import make_miso1
from misonet_tpu.parallel import make_mesh, shard_batch, replicate
from misonet_tpu.train import (
    create_train_state,
    make_optimizer,
    make_separate_train_step,
    make_separate_eval_step,
)
from misonet_tpu.train.state import (
    PlateauScheduler,
    current_learning_rate,
    set_learning_rate,
)

# Small plan: frequency ladder 17 -> 15 -> 7 -> 3 -> 1 with 4 blocks.
SMALL = ModelConfig(
    num_bottleneck=4,
    en_channels=(8, 8, 8, 16),
    de_channels=(16, 8, 8, 8),
    tcn_repeats=1,
    tcn_blocks=2,
    tcn_channels=16,
    compute_dtype="float32",
)
B, C, T, F = 8, 3, 16, 17


def _batch(key):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    mix = jax.lax.complex(
        jax.random.normal(k1, (B, C, T, F)), jax.random.normal(k2, (B, C, T, F))
    )
    ref = jax.lax.complex(
        jax.random.normal(k3, (B, 2, T, F)) * 0.1,
        jax.random.normal(k4, (B, 2, T, F)) * 0.1,
    )
    return mix, ref


@pytest.fixture(scope="module")
def setup():
    model = make_miso1(SMALL)
    mix, ref = _batch(jax.random.key(0))
    params = model.init(jax.random.key(1), mix)
    opt = make_optimizer(OptimizerConfig(lr=1e-3))
    state = create_train_state(params, opt)
    return model, opt, state, mix, ref


def test_loss_decreases(setup):
    model, opt, state, mix, ref = setup
    state = jax.tree.map(jnp.copy, state)  # step donates its input state
    step = make_separate_train_step(model, opt)
    first = None
    for _ in range(5):
        state, metrics = step(state, mix, ref)
        if first is None:
            first = float(metrics["loss"])
    assert float(metrics["loss"]) < first
    assert np.isfinite(float(metrics["grad_norm"]))


def test_dp_matches_single_device(setup):
    """The same batch must produce the same loss whether the batch is
    sharded across the 8-device mesh or on a single device."""
    model, opt, _, mix, ref = setup
    params = model.init(jax.random.key(1), mix)
    mesh = make_mesh()
    assert mesh.size == 8

    single = make_separate_eval_step(model)
    loss_single, _ = single(params, mix, ref)

    sharded = make_separate_eval_step(model, mesh=mesh)
    p = replicate(params, mesh)
    smix, sref = shard_batch((mix, ref), mesh)
    loss_dp, est = sharded(p, smix, sref)
    np.testing.assert_allclose(float(loss_dp), float(loss_single), rtol=1e-4)
    assert est.shape == (B, 2, T, F)


def test_dp_train_step_runs_on_mesh(setup):
    model, opt, state, mix, ref = setup
    mesh = make_mesh()
    step = make_separate_train_step(model, opt, mesh=mesh)
    st = jax.tree.map(jnp.copy, state)
    st = replicate(st, mesh)
    smix, sref = shard_batch((mix, ref), mesh)
    st, metrics = step(st, smix, sref)
    assert np.isfinite(float(metrics["loss"]))


def test_plateau_scheduler():
    sch = PlateauScheduler(lr=1e-3, factor=0.5, patience=2, min_lr=1e-5)
    lrs = [sch.step(1.0) for _ in range(6)]  # no improvement after first
    # first epoch sets best; epochs 2-4 exceed patience -> halve at epoch 4
    assert lrs[0] == 1e-3 and min(lrs) < 1e-3
    for _ in range(20):
        sch.step(2.0)
    assert sch.lr >= 1e-5 and sch.should_stop


def test_learning_rate_injection(setup):
    model, opt, state, mix, ref = setup
    state = jax.tree.map(jnp.copy, state)  # step donates its input state
    assert current_learning_rate(state) == pytest.approx(1e-3)
    state = set_learning_rate(state, 5e-4)
    assert current_learning_rate(state) == pytest.approx(5e-4)
    step = make_separate_train_step(model, opt)
    state, _ = step(state, mix, ref)  # still runs after LR surgery
