#!/usr/bin/env python
"""Full-cascade training demo: MISO1 -> MVDR -> MISO3 on synthetic mixtures.

Runs the reference pipeline's three stages (separation training, frozen-MISO1
MVDR beamforming, per-speaker enhancement training — reference run.py Train
MISO1 / Test Beamforming / Train MISO3) end to end on synthetic 6-channel
reverberant 2-speaker data, and reports stage-wise SI-SDR:

    mixture -> MISO1 -> MVDR beamformed -> MISO3 enhanced

This is the self-contained proof that the whole cascade (BASELINE.json
configs 2-4) learns and composes on the device.

Run:  python examples/train_cascade.py [--steps1 3000] [--steps3 2000]
      [--miso1-ckpt <dir>]   (reuse a train_synthetic.py checkpoint)
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from misonet_tpu.beamforming.mvdr import mvdr_beamform
from misonet_tpu.config import ModelConfig, OptimizerConfig, StftConfig
from misonet_tpu.data.synthetic import synth_mixture
from misonet_tpu.inference.separate import align_slots, make_full_array_decode
from misonet_tpu.losses import magnitude_distance
from misonet_tpu.metrics import numpy_si_sdr
from misonet_tpu.models import enhance_input, make_miso1, make_miso3
from misonet_tpu.ops.stft import istft_scaled, stft_scaled
from misonet_tpu.train import (
    create_train_state,
    make_enhance_train_step,
    make_optimizer,
    make_separate_wave_train_step,
)
from misonet_tpu.utils.cache import enable_compile_cache
from misonet_tpu.utils.checkpoint import load_checkpoint, save_checkpoint


def pit_si_sdr(est: np.ndarray, refs: np.ndarray) -> float:
    import itertools

    best = -np.inf
    for perm in itertools.permutations(range(refs.shape[0])):
        val = np.mean(
            [numpy_si_sdr(est[perm[s]], refs[s]) for s in range(refs.shape[0])]
        )
        best = max(best, val)
    return best


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps1", type=int, default=3000, help="MISO1 steps")
    ap.add_argument("--steps3", type=int, default=2000, help="MISO3 steps")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--train-utts", type=int, default=256)
    ap.add_argument("--eval-utts", type=int, default=8)
    ap.add_argument("--samples", type=int, default=32000)
    ap.add_argument("--miso1-ckpt", default="", help="skip MISO1 training")
    ap.add_argument("--save", default="")
    ap.add_argument(
        "--noise-sources", action="store_true",
        help="train on the legacy modulated-noise sources instead of "
        "harmonic pseudo-speech (data/synthetic.py voiced=True)",
    )
    ap.add_argument(
        "--joint", action="store_true",
        help="stage 3 trains MISO2 (joint two-speaker enhancement, "
        "reference enhance_mode='MISO2', run.py:117-125) instead of the "
        "per-speaker MISO3",
    )
    args = ap.parse_args()
    enable_compile_cache()
    voiced = not args.noise_sources

    stft_cfg = StftConfig()
    mcfg = ModelConfig()
    miso1 = make_miso1(mcfg)
    miso3 = make_miso3(mcfg)
    num_ch, ref_ch = 6, 0
    dev = jax.devices()[0]
    print(f"device={dev.platform}/{dev.device_kind} "
          f"compute={mcfg.compute_dtype}", flush=True)

    print(f"generating data (voiced={voiced})...", flush=True)
    train = [
        synth_mixture(i, args.samples, num_ch, voiced=voiced)
        for i in range(args.train_utts)
    ]
    evals = [
        synth_mixture(10_000 + i, args.samples, num_ch, voiced=voiced)
        for i in range(args.eval_utts)
    ]
    mix_dev = jnp.asarray(np.stack([d["mix"] for d in train]))  # [N, S, C]
    ref_dev = jnp.asarray(np.stack([d["ref"] for d in train]))  # [N, 2, S]

    @jax.jit
    def gather(idx):
        return jnp.take(mix_dev, idx, axis=0), jnp.take(ref_dev, idx, axis=0)

    # ---- stage 1: MISO1 separation training -----------------------------
    probe = stft_scaled(mix_dev[: args.batch].transpose(0, 2, 1), stft_cfg)
    params1 = jax.jit(miso1.init)(jax.random.key(0), probe)
    opt = make_optimizer(OptimizerConfig(lr=1e-3))
    state1 = create_train_state(params1, opt)
    if args.miso1_ckpt:
        ck = Path(args.miso1_ckpt)
        state1, _ = load_checkpoint(ck.parent, ck.name, state1)
        print(f"MISO1 restored from {args.miso1_ckpt}", flush=True)
    else:
        step1 = make_separate_wave_train_step(miso1, opt, stft_cfg)
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        for it in range(args.steps1):
            idx = jnp.asarray(rng.integers(0, args.train_utts, args.batch))
            mix_b, ref_b = gather(idx)
            state1, metrics = step1(state1, mix_b, ref_b)
            if it % 200 == 0 or it == args.steps1 - 1:
                print(
                    f"MISO1 step {it}: loss {float(metrics['loss']):.0f} "
                    f"({time.perf_counter() - t0:.0f}s)",
                    flush=True,
                )

    # ---- stage 2: frozen MISO1 full-array decode + MVDR features --------
    decode = make_full_array_decode(miso1, num_ch, ref_ch)
    miso1_params = state1.params

    @jax.jit
    def features(mix_wave, ref_wave):
        mix = stft_scaled(mix_wave.transpose(0, 2, 1), stft_cfg)
        ref = stft_scaled(ref_wave, stft_cfg)
        full = decode(miso1_params, mix)        # [B, S, C, T, F]
        m1 = full[:, :, ref_ch]                 # [B, S, T, F]
        dist = magnitude_distance(m1, ref)
        idx = align_slots(dist)
        ref_al = jnp.take_along_axis(ref, idx[..., None, None], axis=1)
        bf = jax.vmap(
            lambda s: mvdr_beamform(s, mix, ref_ch=ref_ch), in_axes=1, out_axes=1
        )(full)                                 # [B, S, T, F]
        return mix, ref_al, m1, bf

    # ---- stage 3: enhancement training ----------------------------------
    # per-speaker MISO3 (reference enhance_mode='MISO3') or joint MISO2
    # (--joint; reference enhance_mode='MISO2', both speakers estimated in
    # one forward under a uPIT loss, run.py:117-125 / trainer.py:427-442)
    if args.joint:
        from misonet_tpu.models import make_miso2
        from misonet_tpu.train import make_enhance_joint_train_step

        enh_model = make_miso2(mcfg)
        step3 = make_enhance_joint_train_step(enh_model, opt)
        stage3_name = "MISO2"
    else:
        enh_model = miso3
        step3 = make_enhance_train_step(miso3, opt)
        stage3_name = "MISO3"

    @jax.jit
    def build_enh_inputs(mix, ref_al, m1, bf):
        b, s, t, f = m1.shape
        if args.joint:
            # both speakers' MISO1 + BF condition ONE forward
            return enhance_input(mix, m1, bf), ref_al
        mix_rep = jnp.repeat(mix, s, axis=0)
        x = enhance_input(
            mix_rep, m1.reshape(b * s, 1, t, f), bf.reshape(b * s, 1, t, f)
        )
        y = ref_al.reshape(b * s, 1, t, f)
        return x, y

    state3 = None
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    for it in range(args.steps3):
        idx = jnp.asarray(rng.integers(0, args.train_utts, args.batch))
        mix_b, ref_b = gather(idx)
        x, y = build_enh_inputs(*features(mix_b, ref_b))
        if state3 is None:
            params3 = jax.jit(enh_model.init)(jax.random.key(1), x)
            state3 = create_train_state(params3, opt)
        state3, metrics = step3(state3, x, y)
        if it % 200 == 0 or it == args.steps3 - 1:
            print(
                f"{stage3_name} step {it}: loss {float(metrics['loss']):.0f} "
                f"({time.perf_counter() - t0:.0f}s)",
                flush=True,
            )

    # ---- evaluate all stages --------------------------------------------
    @jax.jit
    def eval_stages(mix_wave, ref_wave):
        n = mix_wave.shape[1]
        mix, ref_al, m1, bf = features(mix_wave, ref_wave)
        x, _ = build_enh_inputs(mix, ref_al, m1, bf)
        enh = enh_model.apply(state3.params, x)
        b, s = m1.shape[0], m1.shape[1]
        if not args.joint:                      # [B*S, 1, T, F] -> [B, S, ...]
            enh = enh.reshape(b, s, *enh.shape[2:])
        return (
            istft_scaled(m1, stft_cfg, n),
            istft_scaled(bf, stft_cfg, n),
            istft_scaled(enh, stft_cfg, n),
        )

    enh_key = stage3_name.lower()
    scores = {"mixture": [], "miso1": [], "mvdr": [], enh_key: []}
    for d in evals:
        refs = d["ref"]
        mix0 = d["mix"][:, ref_ch]
        scores["mixture"].append(pit_si_sdr(np.stack([mix0, mix0]), refs))
        m1w, bfw, enw = eval_stages(
            jnp.asarray(d["mix"][None]), jnp.asarray(d["ref"][None])
        )
        scores["miso1"].append(pit_si_sdr(np.asarray(m1w)[0], refs))
        scores["mvdr"].append(pit_si_sdr(np.asarray(bfw)[0], refs))
        scores[enh_key].append(pit_si_sdr(np.asarray(enw)[0], refs))

    print("\nstage-wise SI-SDR (dB), mean over eval utterances:", flush=True)
    for k in ("mixture", "miso1", "mvdr", enh_key):
        print(f"  {k:8s} {np.mean(scores[k]):7.2f}", flush=True)

    if args.save:
        save_checkpoint(args.save, "miso1", state1, {})
        save_checkpoint(args.save, enh_key, state3, {})
        print(f"checkpoints saved to {args.save}", flush=True)


if __name__ == "__main__":
    main()
