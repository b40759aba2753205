"""Train state, optimizer, LR scheduling.

Optimizer config follows the reference: Adam(lr 1e-3, wd 0) built in
run.py:215-218, optional grad-norm clipping (trainer.py:208-210), and a
ReduceLROnPlateau schedule (factor 0.5, patience 3, min_lr 5e-6;
run.py:219-223) stepped with the validation loss (trainer.py:141).

The plateau schedule is inherently host-driven (it depends on the validation
history), so the learning rate lives in the optimizer state via
``optax.inject_hyperparams`` and is overwritten between epochs — the train
step itself stays a single compiled function.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import optax

from misonet_tpu.config import OptimizerConfig


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["step", "params", "opt_state"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    params: Any
    opt_state: Any

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def make_optimizer(cfg: OptimizerConfig) -> optax.GradientTransformation:
    chain = []
    if cfg.clipping:
        chain.append(optax.clip_by_global_norm(cfg.max_norm))
    if cfg.name == "adam":
        opt = optax.inject_hyperparams(optax.adamw if cfg.weight_decay else optax.adam)(
            learning_rate=cfg.lr,
            **({"weight_decay": cfg.weight_decay} if cfg.weight_decay else {}),
        )
    elif cfg.name == "rmsprop":
        opt = optax.inject_hyperparams(optax.rmsprop)(learning_rate=cfg.lr)
    elif cfg.name == "sgd":
        opt = optax.inject_hyperparams(optax.sgd)(learning_rate=cfg.lr)
    else:
        raise ValueError(f"unsupported optimizer: {cfg.name}")
    chain.append(opt)
    transform = optax.chain(*chain)
    if cfg.guard_nans:
        # Reject non-finite updates instead of dropping into a debugger
        # (the reference's NaN handling is `pdb.set_trace()` inside forward,
        # model.py:109-110); raises after max_consecutive_nan_steps misses.
        transform = optax.apply_if_finite(
            transform, max_consecutive_errors=cfg.max_consecutive_nan_steps
        )
    return transform


def create_train_state(
    params, optimizer: optax.GradientTransformation
) -> TrainState:
    return TrainState(
        step=jnp.zeros((), jnp.int32),
        params=params,
        opt_state=optimizer.init(params),
    )


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Return a state whose injected learning rate is ``lr``.

    Rebuilds the inject_hyperparams node functionally (NamedTuple
    ``_replace`` / ``dataclasses.replace``) instead of mutating optax's
    state dict in place, so it stays correct under donated/jitted states
    and across optax versions."""
    def replace(node):
        hp = getattr(node, "hyperparams", None)
        if isinstance(hp, dict) and "learning_rate" in hp:
            new_hp = dict(hp)
            new_hp["learning_rate"] = jnp.asarray(
                lr, jnp.asarray(hp["learning_rate"]).dtype
            )
            if hasattr(node, "_replace"):          # NamedTuple state
                return node._replace(hyperparams=new_hp)
            if dataclasses.is_dataclass(node):
                return dataclasses.replace(node, hyperparams=new_hp)
            raise TypeError(
                f"unsupported inject_hyperparams state type {type(node)!r}"
            )
        return node

    new_opt = jax.tree.map(
        replace, state.opt_state,
        is_leaf=lambda n: hasattr(n, "hyperparams"),
    )
    return state.replace(opt_state=new_opt)


def current_learning_rate(state: TrainState) -> float:
    for node in jax.tree.leaves(
        state.opt_state, is_leaf=lambda n: hasattr(n, "hyperparams")
    ):
        if hasattr(node, "hyperparams"):
            return float(node.hyperparams["learning_rate"])
    raise ValueError("no injected learning rate found in optimizer state")


@dataclasses.dataclass
class PlateauScheduler:
    """ReduceLROnPlateau(mode=min): halve the LR when the monitored loss has
    not improved for ``patience`` epochs, floored at ``min_lr``
    (reference run.py:219-223).  Also tracks the early-stop counter the
    reference keeps in the trainer (NN_BSS.yml:143, trainer.py)."""

    lr: float
    factor: float = 0.5
    patience: int = 3
    min_lr: float = 5e-6
    early_stop_patience: int = 10

    best: float = float("inf")
    bad_epochs: int = 0
    epochs_since_best: int = 0

    def step(self, val_loss: float) -> float:
        """Record an epoch's validation loss; returns the (possibly reduced)
        learning rate to use next."""
        if val_loss < self.best:
            self.best = val_loss
            self.bad_epochs = 0
            self.epochs_since_best = 0
        else:
            self.bad_epochs += 1
            self.epochs_since_best += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
        return self.lr

    @property
    def should_stop(self) -> bool:
        return self.epochs_since_best >= self.early_stop_patience
