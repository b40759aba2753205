"""Training loops: separation (MISO1) and enhancement (MISO2/MISO3) stages.

Reference counterparts: Trainer_Separate (trainer.py:22-223) and
Trainer_Enhance (trainer.py:225-514).  Differences by design:

* batches are time-domain waves; STFT is fused into the jitted step
  (the reference ran scipy STFT in 70 DataLoader workers);
* for the enhancement stage the frozen-MISO1 decode and the MVDR stage run
  on device inside a jitted feature step (the reference ran the model and
  NumPy MVDR inside DataLoader worker processes — data.py:148, :201-207,
  SURVEY.md §3.3), and the per-speaker MISO3 passes are folded into the
  batch axis (fixing the reference's s2-pass s1_bf bug, trainer.py:416, by
  construction);
* a real validation loader is used (the reference accidentally validates on
  the training loader — run.py:231, SURVEY.md §2.3);
* checkpointing (one .npz per tag) with periodic + best-model saves and
  resume.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Iterable

import jax
import jax.numpy as jnp
import numpy as np

from misonet_tpu.config import (
    DatasetConfig,
    ModelConfig,
    OptimizerConfig,
    StftConfig,
    TrainerConfig,
)
from misonet_tpu.inference.separate import make_full_array_decode, align_slots
from misonet_tpu.beamforming.mvdr import mvdr_beamform
from misonet_tpu.losses import magnitude_distance
from misonet_tpu.models import enhance_input
from misonet_tpu.ops.stft import stft_scaled
from misonet_tpu.parallel.mesh import replicate, shard_batch
from misonet_tpu.train.state import (
    PlateauScheduler,
    create_train_state,
    make_optimizer,
    set_learning_rate,
)
from misonet_tpu.train.steps import (
    make_enhance_train_step,
    make_enhance_joint_train_step,
    make_separate_wave_eval_step,
    make_separate_wave_train_step,
)
from misonet_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from misonet_tpu.utils.writer import MetricWriter


def _placer(mesh):
    """Host batch -> device arrays: sharded over the mesh's data axis
    straight from host memory when a mesh is given (no staging of the
    whole batch on the first device), else on the default device."""
    if mesh is None:
        return lambda tree: jax.tree.map(jnp.asarray, tree)
    return lambda tree: shard_batch(tree, mesh)


def _place_state(state, mesh):
    """A fresh or restored train state replicated over the mesh, typed as
    the train step's outputs are, so the step compiles once rather than
    once for the first state and again for every later one."""
    return state if mesh is None else replicate(state, mesh)


class SeparationTrainer:
    """MISO1 training (reference Trainer_Separate, trainer.py:22-223)."""

    def __init__(
        self,
        model,
        trainer_cfg: TrainerConfig,
        opt_cfg: OptimizerConfig,
        stft_cfg: StftConfig,
        ds_cfg: DatasetConfig,
        train_data: Iterable,
        val_data: Iterable,
        mesh=None,
        writer: MetricWriter | None = None,
    ):
        self.model = model
        self.cfg = trainer_cfg
        self.stft_cfg = stft_cfg
        self.ds_cfg = ds_cfg
        self.train_data = train_data
        self.val_data = val_data
        self.writer = writer
        self.mesh = mesh
        self.put = _placer(mesh)
        self.optimizer = make_optimizer(opt_cfg)
        self.scheduler = PlateauScheduler(
            lr=opt_cfg.lr,
            factor=opt_cfg.plateau_factor,
            patience=opt_cfg.plateau_patience,
            min_lr=opt_cfg.min_lr,
            early_stop_patience=trainer_cfg.early_stop_patience,
        )
        self.train_step = make_separate_wave_train_step(
            model, self.optimizer, stft_cfg,
            ref_ch=ds_cfg.ref_ch, mesh=mesh,
            overest=trainer_cfg.overest_alpha > 0.0,
        )
        self.eval_step = make_separate_wave_eval_step(
            model, stft_cfg, ref_ch=ds_cfg.ref_ch, mesh=mesh
        )
        self.state = None
        self.start_epoch = 0
        self.history: dict[str, list[float]] = {"train": [], "val": []}

    def _init_state(self, example_batch) -> None:
        # init reads only the probe's shape; jitted, params and optimizer
        # state are one compiled computation instead of one dispatch (and
        # one small compilation) per leaf
        probe = jax.eval_shape(
            lambda m: stft_scaled(m.transpose(0, 2, 1), self.stft_cfg),
            jax.ShapeDtypeStruct(np.shape(example_batch["mix"]), jnp.float32),
        )
        self.state = jax.jit(lambda k: create_train_state(
            self.model.init(k, probe), self.optimizer))(jax.random.key(0))
        ckdir = Path(self.cfg.save_folder)
        if self.cfg.resume:
            tag = self.cfg.resume
            self.state, meta = load_checkpoint(ckdir, tag, self.state)
            self.start_epoch = int(meta.get("epoch", -1)) + 1
            self.history = meta.get("history", self.history)
            self.scheduler.lr = float(meta.get("lr", self.scheduler.lr))
            self.scheduler.best = float(meta.get("best_val", self.scheduler.best))
        self.state = _place_state(self.state, self.mesh)

    def train(self) -> dict[str, list[float]]:
        if self.state is None:
            # init (and resume) before the epoch range is computed
            self._init_state(next(iter(self.train_data)))
        for epoch in range(self.start_epoch, self.cfg.epochs):
            t_epoch = time.perf_counter()
            train_loss = self._run_epoch(epoch, training=True)
            val_loss = self._run_epoch(epoch, training=False)
            self.history["train"].append(train_loss)
            self.history["val"].append(val_loss)

            lr = self.scheduler.step(val_loss)
            self.state = set_learning_rate(self.state, lr)
            if self.writer:
                self.writer.scalar("train/epoch_loss", train_loss, epoch)
                self.writer.scalar("val/epoch_loss", val_loss, epoch)
                self.writer.scalar("train/lr", lr, epoch)

            meta = {
                "epoch": epoch,
                "history": self.history,
                "lr": lr,
                "best_val": self.scheduler.best,
            }
            ckdir = Path(self.cfg.save_folder)
            if (epoch + 1) % self.cfg.checkpoint_every == 0:
                save_checkpoint(ckdir, f"epoch{epoch:03d}", self.state, meta)
            if val_loss <= self.scheduler.best:
                save_checkpoint(ckdir, "best", self.state, meta)

            print(
                f"epoch {epoch}: train {train_loss:.4f} val {val_loss:.4f} "
                f"lr {lr:.2e} ({time.perf_counter() - t_epoch:.1f}s)"
            )
            if self.cfg.early_stop and self.scheduler.should_stop:
                print(f"early stop at epoch {epoch}")
                break
        return self.history

    def _run_epoch(self, epoch: int, training: bool) -> float:
        data = self.train_data if training else self.val_data
        total, count = 0.0, 0
        for i, batch in enumerate(data):
            mix, ref = self.put((batch["mix"], batch["ref"]))
            if training:
                if self.writer:
                    self.writer.step_start()
                if self.cfg.overest_alpha > 0.0:
                    # reference's commented schedule: alpha=(epoch+1)*0.03
                    # (trainer.py:176), traced so the jit signature is one
                    alpha = jnp.float32((epoch + 1) * self.cfg.overest_alpha)
                    self.state, metrics = self.train_step(
                        self.state, mix, ref, alpha
                    )
                else:
                    self.state, metrics = self.train_step(self.state, mix, ref)
                loss = float(metrics["loss"])
                if self.writer:
                    audio_s = mix.shape[0] * mix.shape[1] / self.stft_cfg.fs
                    step = int(self.state.step)
                    self.writer.step_end(step, audio_s)
                    self.writer.scalar("train/loss", loss, step)
                    self.writer.scalar(
                        "train/grad_norm", float(metrics["grad_norm"]), step
                    )
                if i % self.cfg.print_freq == 0:
                    print(f"  epoch {epoch} batch {i}: loss {loss:.4f}")
            else:
                loss_val, est = self.eval_step(self.state.params, mix, ref)
                loss = float(loss_val)
                if self.writer and i == 0:
                    # first-val-batch spectrogram/audio logging
                    # (trainer.py:180-201 equivalent)
                    spec = np.asarray(est[0, 0])
                    self.writer.spectrogram("val/est_s0", spec, epoch)
                    self.writer.audio("val/est_s0", spec, epoch, mix.shape[1])
            total += loss
            count += 1
        return total / max(count, 1)


class EnhanceTrainer:
    """MISO2/MISO3 training over frozen MISO1 + on-device MVDR features
    (reference Trainer_Enhance, trainer.py:225-514).

    joint=False -> MISO3 per-speaker (speakers folded into batch);
    joint=True  -> MISO2 joint two-speaker."""

    def __init__(
        self,
        enhance_model,
        miso1_model,
        miso1_params,
        trainer_cfg: TrainerConfig,
        opt_cfg: OptimizerConfig,
        stft_cfg: StftConfig,
        ds_cfg: DatasetConfig,
        train_data: Iterable,
        val_data: Iterable,
        joint: bool = False,
        mesh=None,
        writer: MetricWriter | None = None,
    ):
        self.model = enhance_model
        self.joint = joint
        self.cfg = trainer_cfg
        self.stft_cfg = stft_cfg
        self.ds_cfg = ds_cfg
        self.train_data = train_data
        self.val_data = val_data
        self.writer = writer
        self.mesh = mesh
        self.put = _placer(mesh)
        self.optimizer = make_optimizer(opt_cfg)
        self.scheduler = PlateauScheduler(
            lr=opt_cfg.lr,
            factor=opt_cfg.plateau_factor,
            patience=opt_cfg.plateau_patience,
            min_lr=opt_cfg.min_lr,
            early_stop_patience=trainer_cfg.early_stop_patience,
        )
        if joint:
            self.train_step = make_enhance_joint_train_step(
                enhance_model, self.optimizer, mesh=mesh
            )
        else:
            self.train_step = make_enhance_train_step(
                enhance_model, self.optimizer, mesh=mesh
            )
        # frozen MISO1 weights: an argument of the feature step, placed
        # once (replicated over the mesh) instead of on every step
        self.miso1_params = (miso1_params if mesh is None
                             else replicate(miso1_params, mesh))
        self.feature_step = self._make_feature_step(miso1_model)
        self.precomputed_step = self._make_precomputed_step()
        from misonet_tpu.losses import loss_enhance, loss_upit
        from misonet_tpu.train.steps import _shardings

        _eval_loss = loss_upit if joint else loss_enhance

        def _eval_step(params, x, y):
            est = enhance_model.apply(params, x)
            return _eval_loss(est, y), est

        repl, data = _shardings(mesh, 2)
        self.eval_step = jax.jit(
            _eval_step, in_shardings=(repl, *data[1:]) if data else None
        )
        self.state = None
        self.start_epoch = 0
        self.history: dict[str, list[float]] = {"train": [], "val": []}

    def _make_feature_step(self, miso1_model):
        """Jitted frozen-stage features: (MISO1 params, wave batch) ->
        (mix_stft, ref_stft aligned, miso1_refch, bf) — the on-device
        replacement for the reference's in-DataLoader model inference +
        NumPy MVDR (data.py:148, :201-207).  The parameters are an argument,
        not constants baked into the program, so one compiled program
        serves any MISO1 checkpoint.  Named scopes (stft, miso1_decode,
        align, mvdr) label its ops in profiler traces."""
        ref_ch = self.ds_cfg.ref_ch
        decode = make_full_array_decode(
            miso1_model, self.ds_cfg.num_ch_utilize, ref_ch
        )
        stft_cfg = self.stft_cfg

        @jax.jit
        def features(miso1_params, mix_wave, ref_wave):
            with jax.named_scope("stft"):
                mix = stft_scaled(mix_wave.transpose(0, 2, 1), stft_cfg)
                ref = stft_scaled(ref_wave, stft_cfg)  # [B, S, T, F]
            with jax.named_scope("miso1_decode"):
                full = decode(miso1_params, mix)       # [B, S, C, T, F]
                miso1_ref = full[:, :, ref_ch]         # [B, S, T, F]
            with jax.named_scope("align"):
                # align references to MISO1 speaker order (data.py:154-182)
                dist = magnitude_distance(miso1_ref, ref)
                idx = align_slots(dist)
                ref_aligned = jnp.take_along_axis(
                    ref, idx[..., None, None], axis=1)
            with jax.named_scope("mvdr"):
                bf = jax.vmap(
                    lambda s: mvdr_beamform(s, mix, ref_ch=ref_ch),
                    in_axes=1,
                    out_axes=1,
                )(full)                                 # [B, S, T, F]
            return mix, ref_aligned, miso1_ref, bf

        return features

    def _make_precomputed_step(self):
        """Feature path for shards carrying precomputed MISO1/BF outputs
        (data/precompute.py; the reference's load_MISO1_Output /
        load_MVDR_Output modes, data.py:133-145, :190-199)."""
        stft_cfg = self.stft_cfg

        @jax.jit
        def features(mix_wave, ref_wave, miso1_ref, bf):
            mix = stft_scaled(mix_wave.transpose(0, 2, 1), stft_cfg)
            ref = stft_scaled(ref_wave, stft_cfg)
            dist = magnitude_distance(miso1_ref, ref)
            idx = align_slots(dist)
            ref_aligned = jnp.take_along_axis(ref, idx[..., None, None], axis=1)
            return mix, ref_aligned, miso1_ref, bf

        return features

    def _build_inputs(self, mix, ref_aligned, miso1_ref, bf):
        b, s, t, f = miso1_ref.shape
        if self.joint:
            x = enhance_input(mix, miso1_ref, bf)
            y = ref_aligned
        else:
            mix_rep = jnp.repeat(mix, s, axis=0)
            x = enhance_input(
                mix_rep,
                miso1_ref.reshape(b * s, 1, t, f),
                bf.reshape(b * s, 1, t, f),
            )
            y = ref_aligned.reshape(b * s, 1, t, f)
        return x, y

    def _features(self, batch):
        if "miso1" in batch:
            return self.precomputed_step(*self.put(
                (batch["mix"], batch["ref"], batch["miso1"], batch["bf"])
            ))
        return self.feature_step(self.miso1_params,
                                 *self.put((batch["mix"], batch["ref"])))

    def _init_state(self, example_batch) -> None:
        """Init params (and resume, reference trainer.py:54-71 — the
        reference resumes *both* trainers from model_load)."""
        x, _ = self._build_inputs(*self._features(example_batch))
        self.state = jax.jit(lambda k, x: create_train_state(
            self.model.init(k, x), self.optimizer))(jax.random.key(0), x)
        if self.cfg.resume:
            ckdir = Path(self.cfg.save_folder)
            self.state, meta = load_checkpoint(ckdir, self.cfg.resume, self.state)
            self.start_epoch = int(meta.get("epoch", -1)) + 1
            self.history = meta.get("history", self.history)
            self.scheduler.lr = float(meta.get("lr", self.scheduler.lr))
            self.scheduler.best = float(meta.get("best_val", self.scheduler.best))
        self.state = _place_state(self.state, self.mesh)

    def train(self) -> dict[str, list[float]]:
        if self.state is None:
            self._init_state(next(iter(self.train_data)))
        for epoch in range(self.start_epoch, self.cfg.epochs):
            tr = self._run_epoch(epoch, self.train_data, training=True)
            va = self._run_epoch(epoch, self.val_data, training=False)
            self.history["train"].append(tr)
            self.history["val"].append(va)
            lr = self.scheduler.step(va)
            self.state = set_learning_rate(self.state, lr)
            if self.writer:
                self.writer.scalar("train/epoch_loss", tr, epoch)
                self.writer.scalar("val/epoch_loss", va, epoch)
                self.writer.scalar("train/lr", lr, epoch)
            ckdir = Path(self.cfg.save_folder)
            meta = {"epoch": epoch, "history": self.history, "lr": lr,
                    "best_val": self.scheduler.best}
            if (epoch + 1) % self.cfg.checkpoint_every == 0:
                save_checkpoint(ckdir, f"epoch{epoch:03d}", self.state, meta)
            if va <= self.scheduler.best:
                save_checkpoint(ckdir, "best", self.state, meta)
            print(f"epoch {epoch}: train {tr:.4f} val {va:.4f} lr {lr:.2e}")
            if self.cfg.early_stop and self.scheduler.should_stop:
                break
        return self.history

    def _run_epoch(self, epoch: int, data: Iterable, training: bool) -> float:
        total, count = 0.0, 0
        for i, batch in enumerate(data):
            feats = self._features(batch)
            x, y = self._build_inputs(*feats)
            if training:
                if self.writer:
                    self.writer.step_start()
                self.state, metrics = self.train_step(self.state, x, y)
                loss = float(metrics["loss"])
                if self.writer:
                    b, n_samp = batch["mix"].shape[:2]
                    step = int(self.state.step)
                    self.writer.step_end(step, b * n_samp / self.stft_cfg.fs)
                    self.writer.scalar("train/loss", loss, step)
                if i % self.cfg.print_freq == 0:
                    print(f"  epoch {epoch} batch {i}: loss {loss:.4f}")
            else:
                loss_val, est = self.eval_step(self.state.params, x, y)
                loss = float(loss_val)
                if self.writer and i == 0:
                    self._log_eval_stages(epoch, batch, feats, est)
            total += loss
            count += 1
        return total / max(count, 1)

    def _log_eval_stages(self, epoch, batch, feats, est) -> None:
        """First-val-batch spectrogram/audio logging of every cascade stage
        — mixture / clean / MISO1 / beamformed / enhanced — the reference
        Trainer_Enhance's TensorBoard set (trainer.py:445-497)."""
        mix, ref_aligned, miso1_ref, bf = feats
        n_samp = int(batch["mix"].shape[1])
        est = est.reshape(-1, est.shape[-2], est.shape[-1])  # flatten spk dim
        stages = {
            "mix": np.asarray(mix[0, self.ds_cfg.ref_ch]),
            "clean_s0": np.asarray(ref_aligned[0, 0]),
            "miso1_s0": np.asarray(miso1_ref[0, 0]),
            "bf_s0": np.asarray(bf[0, 0]),
            "enhanced_s0": np.asarray(est[0]),
        }
        for tag, spec in stages.items():
            self.writer.spectrogram(f"val/{tag}", spec, epoch)
            self.writer.audio(f"val/{tag}", spec, epoch, n_samp)
