#!/usr/bin/env python
"""Host input-pipeline sustainment benchmark.

The reference burned 70 DataLoader workers on host STFT
(reference config/NN_BSS.yml:96).  This repo moved the STFT on
device and kept ONE producer thread (data/dataset.py Batcher) — this
script proves (or refutes) that the single-producer host path sustains
the fused train step's demand from REAL on-disk npz shards, not
HBM-staged batches:

  1. writes a synthetic shard corpus (production chunk geometry:
     32000 samples x 6 ch mix + 2 refs per npz);
  2. measures the pure host feed rate (ShardDataset -> Batcher iterate,
     no device work);
  3. runs the real fused train step fed by the Batcher and compares
     its step time against bench.py --train (device-staged batches).

Run:  python scripts/bench_input_pipeline.py [--utts 120] [--steps 100]
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



DATA = Path(__file__).resolve().parents[1] / ".bench_data"


def write_corpus(root: Path, utts: int, samples: int, num_ch: int) -> None:
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(utts):
        np.savez(
            root / f"utt{i:04d}_chunk000.npz",
            mix=rng.standard_normal((samples, num_ch)).astype(np.float32),
            ref1=rng.standard_normal(samples).astype(np.float32),
            ref2=rng.standard_normal(samples).astype(np.float32),
        )


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--utts", type=int, default=120)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--samples", type=int, default=32000)
    ap.add_argument("--dir", default=str(DATA / "feed"))
    args = ap.parse_args()

    from misonet_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    from misonet_tpu.config import ModelConfig, OptimizerConfig, StftConfig
    from misonet_tpu.data.dataset import Batcher, ShardDataset
    from misonet_tpu.models import make_miso1
    from misonet_tpu.ops.stft import stft_scaled
    from misonet_tpu.train import (
        create_train_state,
        make_optimizer,
        make_separate_wave_train_step,
    )

    root = Path(args.dir)
    if not (root.exists() and any(root.glob("*.npz"))):
        print(f"writing {args.utts} shards to {root} ...", flush=True)
        write_corpus(root, args.utts, args.samples, 6)
    ds = ShardDataset(root)
    bytes_per_batch = args.batch * args.samples * 8 * 4  # 6ch mix + 2 refs

    # ---- 1. pure host feed rate (no device work) ---------------------
    batcher = Batcher(ds, args.batch, shuffle=True, prefetch=4)
    n = 0
    t0 = time.perf_counter()
    for epoch in range(max(1, args.steps * args.batch // len(ds) + 1)):
        for b in batcher:
            n += 1
            if n >= args.steps:
                break
        if n >= args.steps:
            break
    dt = time.perf_counter() - t0
    feed_rate = n / dt
    print(
        f"host feed only: {feed_rate:.1f} batches/s "
        f"({feed_rate * bytes_per_batch / 1e6:.0f} MB/s)",
        flush=True,
    )

    # ---- 2. fused train step fed from disk ---------------------------
    stft_cfg = StftConfig()
    model = make_miso1(ModelConfig())
    probe = {"mix": ds[0]["mix"][None].repeat(args.batch, 0)}
    mix0 = jnp.asarray(probe["mix"]).transpose(0, 2, 1)
    params = jax.jit(model.init)(jax.random.key(0), stft_scaled(mix0, stft_cfg))
    opt = make_optimizer(OptimizerConfig(lr=1e-3))
    state = create_train_state(params, opt)
    step = make_separate_wave_train_step(model, opt, stft_cfg)

    def run(n_steps: int, warm: bool):
        nonlocal state
        done = 0
        t0 = time.perf_counter()
        while done < n_steps:
            for b in Batcher(ds, args.batch, shuffle=True, prefetch=4):
                state, metrics = step(
                    state, jnp.asarray(b["mix"]), jnp.asarray(b["ref"])
                )
                done += 1
                if done >= n_steps:
                    break
        jax.block_until_ready(state.params)
        return (time.perf_counter() - t0) / n_steps

    run(3, warm=True)  # compile + cache warmup
    per_step = run(args.steps, warm=False)
    # The disk-fed loop ends in block_until_ready, so this is the sustained
    # step time with the host feeding from disk; if it matches the
    # HBM-staged step time (bench.py --train), the host never starves
    # the device.
    print(
        f"disk-fed train loop: {per_step * 1e3:.1f} ms/step sustained "
        f"({1.0 / per_step:.1f} steps/s vs feed "
        f"{feed_rate:.1f} batches/s)",
        flush=True,
    )


if __name__ == "__main__":
    main()
