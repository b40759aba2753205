"""Jitted train/eval steps with data-parallel sharding baked in.

Each factory closes over the model + optimizer and returns a jit-compiled
step whose batch arguments are sharded over the mesh's ``data`` axis and
whose state is replicated; XLA's partitioner inserts the gradient psum over
the device interconnect.  On a single device the same code runs unchanged (DP from day one,
SURVEY.md §7 item 2).

Reference counterparts: Trainer_Separate._run_one_epoch per-batch body
(trainer.py:144-212) and Trainer_Enhance (trainer.py:353-442).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from misonet_tpu.config import StftConfig
from misonet_tpu.losses import loss_upit, loss_upit_overest, loss_enhance
from misonet_tpu.ops.stft import stft_scaled
from misonet_tpu.train.state import TrainState


def _shardings(mesh: Mesh | None, batch_args: int):
    if mesh is None:
        return None, None
    axis = mesh.axis_names[0]
    repl = NamedSharding(mesh, P())
    data = NamedSharding(mesh, P(axis))
    return repl, (repl,) + (data,) * batch_args


def _apply_update(
    state: TrainState, grads, optimizer: optax.GradientTransformation
):
    updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return state.replace(step=state.step + 1, params=params, opt_state=opt_state)


def make_separate_train_step(
    model, optimizer: optax.GradientTransformation, ref_ch: int = 0, mesh: Mesh | None = None
) -> Callable:
    """MISO1 training step.

    (state, mix [B,C,T,F] c64, ref [B,S,T,F] c64) -> (state, metrics).
    Rolls the mic axis so the reference channel is first (trainer.py:155),
    runs the forward, and minimizes the uPIT loss (trainer.py:159-173)."""

    def step(state: TrainState, mix: jnp.ndarray, ref: jnp.ndarray):
        mix = jnp.roll(mix, -ref_ch, axis=1)

        def loss_fn(params):
            est = model.apply(params, mix)
            return loss_upit(est, ref)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        new_state = _apply_update(state, grads, optimizer)
        metrics = {"loss": loss, "grad_norm": optax.global_norm(grads)}
        return new_state, metrics

    repl, data = _shardings(mesh, 2)
    return jax.jit(step, in_shardings=(repl, *data[1:]) if data else None,
                   donate_argnums=(0,))


def make_separate_eval_step(model, ref_ch: int = 0, mesh: Mesh | None = None) -> Callable:
    """(params, mix, ref) -> (loss, estimates) for validation
    (trainer.py:224 equivalent: same loss, no update)."""

    def step(params, mix: jnp.ndarray, ref: jnp.ndarray):
        mix = jnp.roll(mix, -ref_ch, axis=1)
        est = model.apply(params, mix)
        return loss_upit(est, ref), est

    repl, data = _shardings(mesh, 2)
    return jax.jit(step, in_shardings=(repl, *data[1:]) if data else None)


def make_separate_wave_train_step(
    model,
    optimizer: optax.GradientTransformation,
    stft_cfg: StftConfig,
    ref_ch: int = 0,
    mesh: Mesh | None = None,
    overest: bool = False,
) -> Callable:
    """MISO1 training step over *time-domain* batches: the STFT runs on
    device inside the same jitted computation as the forward/backward.

    The reference computes scipy STFTs in 70 DataLoader worker processes
    (data.py:58, NN_BSS.yml:96 — the CPU bottleneck, SURVEY.md §3.2); here
    the host ships raw audio and the featurization is fused into the step.

    (state, mix_wave [B, S, C] f32, ref_wave [B, num_spks, S] f32)
        -> (state, metrics).

    ``overest=True`` switches the criterion to loss_upit_overest (the
    reference's loss_uPIT_v1, criterion.py:65-119, commented out at
    trainer.py:176-178) and adds a traced ``alpha`` argument:
    (state, mix_wave, ref_wave, alpha) — one compiled signature for the
    whole per-epoch alpha schedule."""

    def step(state: TrainState, mix_wave, ref_wave, alpha=None):
        # [B, S, C] -> [B, C, S] -> stft [B, C, T, F] (data.py:77-79)
        mix = stft_scaled(mix_wave.transpose(0, 2, 1), stft_cfg)
        ref = stft_scaled(ref_wave, stft_cfg)  # [B, num_spks, T, F]
        mix = jnp.roll(mix, -ref_ch, axis=1)

        def loss_fn(params):
            est = model.apply(params, mix)
            if overest:
                return loss_upit_overest(est, ref, alpha)
            return loss_upit(est, ref)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        new_state = _apply_update(state, grads, optimizer)
        return new_state, {"loss": loss, "grad_norm": optax.global_norm(grads)}

    repl, data = _shardings(mesh, 2)
    shardings = (repl, *data[1:]) if data else None
    if overest and shardings is not None:
        shardings = shardings + (repl,)
    return jax.jit(step, in_shardings=shardings, donate_argnums=(0,))


def make_separate_wave_eval_step(
    model, stft_cfg: StftConfig, ref_ch: int = 0, mesh: Mesh | None = None
) -> Callable:
    """(params, mix_wave [B,S,C], ref_wave [B,spks,S]) -> (loss, est)."""

    def step(params, mix_wave: jnp.ndarray, ref_wave: jnp.ndarray):
        mix = stft_scaled(mix_wave.transpose(0, 2, 1), stft_cfg)
        ref = stft_scaled(ref_wave, stft_cfg)
        mix = jnp.roll(mix, -ref_ch, axis=1)
        est = model.apply(params, mix)
        return loss_upit(est, ref), est

    repl, data = _shardings(mesh, 2)
    return jax.jit(step, in_shardings=(repl, *data[1:]) if data else None)


def make_enhance_train_step(
    model, optimizer: optax.GradientTransformation, mesh: Mesh | None = None
) -> Callable:
    """MISO3 (per-speaker) training step.

    The reference runs one forward/backward/step per speaker sequentially
    (trainer.py:394-425, including the s2-pass s1_bf bug, SURVEY.md §7
    "faithful-vs-fixed") — here speakers are folded into the batch axis for
    one fused step with the *intended* per-speaker conditioning.

    (state, x [B,C+2,T,F] c64, ref [B,1,T,F] c64) -> (state, metrics),
    where the caller builds x with models.enhance_input per speaker and
    stacks speakers into B."""

    def step(state: TrainState, x: jnp.ndarray, ref: jnp.ndarray):
        def loss_fn(params):
            est = model.apply(params, x)
            return loss_enhance(est, ref)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        new_state = _apply_update(state, grads, optimizer)
        return new_state, {"loss": loss, "grad_norm": optax.global_norm(grads)}

    repl, data = _shardings(mesh, 2)
    return jax.jit(step, in_shardings=(repl, *data[1:]) if data else None,
                   donate_argnums=(0,))


def make_enhance_joint_train_step(
    model, optimizer: optax.GradientTransformation, mesh: Mesh | None = None
) -> Callable:
    """MISO2 (joint two-speaker) training step: single forward + uPIT loss
    (trainer.py:427-442).

    (state, x [B,C+2S,T,F] c64, ref [B,S,T,F] c64) -> (state, metrics)."""

    def step(state: TrainState, x: jnp.ndarray, ref: jnp.ndarray):
        def loss_fn(params):
            est = model.apply(params, x)
            return loss_upit(est, ref)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        new_state = _apply_update(state, grads, optimizer)
        return new_state, {"loss": loss, "grad_norm": optax.global_norm(grads)}

    repl, data = _shardings(mesh, 2)
    return jax.jit(step, in_shardings=(repl, *data[1:]) if data else None,
                   donate_argnums=(0,))
