"""npz checkpoints: exact round trip of the train state (params, the optax
state with inject_hyperparams, step) and metadata, restore into shapes from
jax.eval_shape, and trainer resume (reference trainer.py:54-71, :88-139)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from misonet_tpu.config import (DatasetConfig, ModelConfig, OptimizerConfig,
                                StftConfig, TrainerConfig)
from misonet_tpu.models import make_miso1
from misonet_tpu.train import (create_train_state, make_optimizer,
                               make_separate_train_step)
from misonet_tpu.train.state import current_learning_rate, set_learning_rate
from misonet_tpu.utils.checkpoint import (latest_checkpoint, load_checkpoint,
                                          save_checkpoint)

SMALL = ModelConfig(num_bottleneck=4, en_channels=(8, 8, 8, 16),
                    de_channels=(16, 8, 8, 8), tcn_repeats=1, tcn_blocks=2,
                    tcn_channels=16, compute_dtype="float32")


def _cx(key, shape):
    kr, ki = jax.random.split(key)
    return jax.lax.complex(jax.random.normal(kr, shape), jax.random.normal(ki, shape))


@pytest.fixture(scope="module")
def trained():
    """A state one Adam step in, with a plateau-reduced learning rate."""
    model = make_miso1(SMALL)
    mix, ref = _cx(jax.random.key(0), (2, 3, 8, 17)), _cx(jax.random.key(1), (2, 2, 8, 17))
    opt = make_optimizer(OptimizerConfig(lr=1e-3))
    state = create_train_state(model.init(jax.random.key(2), mix), opt)
    state, _ = make_separate_train_step(model, opt)(state, mix, ref)
    return model, opt, set_learning_rate(state, 2.5e-4), mix


def _leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype, k
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(k))


def test_round_trip_exact(trained, tmp_path):
    _, _, state, _ = trained
    meta = {"epoch": 3, "history": {"train": [1.5, 1.25]}, "lr": 2.5e-4,
            "best_val": np.float32(0.75)}
    path = save_checkpoint(tmp_path, "epoch003", state, meta)
    assert path.is_file() and not list(tmp_path.glob(".*tmp"))
    restored, got_meta = load_checkpoint(tmp_path, "epoch003", state)
    _leaves_equal(restored, state)
    assert int(restored.step) == 1
    assert current_learning_rate(restored) == pytest.approx(2.5e-4)
    assert got_meta == json.loads(json.dumps({**meta, "best_val": 0.75}))


def test_restore_into_eval_shape_target(trained, tmp_path):
    model, opt, state, mix = trained
    save_checkpoint(tmp_path, "best", state)
    target = jax.eval_shape(
        lambda x: create_train_state(model.init(jax.random.key(9), x), opt), mix
    )
    restored, meta = load_checkpoint(tmp_path, "best", target)
    assert meta == {}
    _leaves_equal(restored, state)
    # the restored state trains on (donation, LR surgery, optax state)
    step = make_separate_train_step(model, opt)
    nxt, metrics = step(restored, mix, _cx(jax.random.key(1), (2, 2, 8, 17)))
    assert int(nxt.step) == 2 and np.isfinite(float(metrics["loss"]))


def test_restore_rejects_mismatch(trained, tmp_path):
    model, opt, state, _ = trained
    save_checkpoint(tmp_path, "best", state)
    wider = make_miso1(ModelConfig(**{**SMALL.__dict__, "en_channels": (8, 8, 8, 16),
                                      "de_channels": (16, 8, 8, 12)}))
    other = jax.eval_shape(lambda: create_train_state(
        wider.init(jax.random.key(0), jax.ShapeDtypeStruct((1, 3, 8, 17), jnp.complex64)),
        opt))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(tmp_path, "best", other)
    with pytest.raises(KeyError, match="missing"):
        load_checkpoint(tmp_path, "best", {"extra": jnp.zeros(3), "state": state})


def test_latest_checkpoint_skips_metadata(trained, tmp_path):
    _, _, state, _ = trained
    assert latest_checkpoint(tmp_path / "absent") is None
    for epoch in (1, 4):
        save_checkpoint(tmp_path, f"epoch{epoch:03d}", state, {"epoch": epoch})
    save_checkpoint(tmp_path, "best", state, {"epoch": 4})
    assert latest_checkpoint(tmp_path) == "epoch004"


def test_trainer_resumes_from_checkpoint(tmp_path):
    from misonet_tpu.data.synthetic import synth_mixture
    from misonet_tpu.train.trainer import SeparationTrainer

    stft = StftConfig(length=32, overlap=24)
    items = [synth_mixture(i, num_samples=800, num_ch=3) for i in range(2)]
    data = [{k: np.stack([it[k] for it in items]) for k in items[0]}]
    model = make_miso1(SMALL)

    def trainer(epochs, resume=""):
        cfg = TrainerConfig(epochs=epochs, batch_size=2, print_freq=100,
                            checkpoint_every=1, save_folder=str(tmp_path),
                            resume=resume)
        return SeparationTrainer(model, cfg, OptimizerConfig(), stft,
                                 DatasetConfig(num_ch=3, num_ch_utilize=3),
                                 data, data)

    first = trainer(1)
    first.train()
    tag = latest_checkpoint(tmp_path)
    assert tag == "epoch000"
    second = trainer(2, resume=tag)
    second._init_state(data[0])
    assert second.start_epoch == 1
    assert second.history == first.history
    _leaves_equal(second.state, first.state)
