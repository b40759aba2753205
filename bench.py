"""Benchmark: MISO1 separation throughput in audio-seconds/s/chip on one GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "audio-s/s/chip", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": ...}}

Default workload is the reference pipeline's hot inference loop — the
MISO1 forward on 4-second 6-channel chunks ([B, 6, 501, 129] complex
spectrograms, SURVEY.md §3 hot-loop a).  ``--train`` times the production
training step instead (STFT + fwd + uPIT loss + grads + Adam, reference
trainer.py:144-212).  For the forward, ``vs_baseline`` compares against the
PyTorch reference model forward measured on a CPU (BENCH_BASELINE.json;
north star >= 8x, BASELINE.json); the reference publishes no training
throughput, so ``--train`` reports none.

Timing: warm-up calls compile, then the host clock runs around ``iters``
calls ended by ``jax.block_until_ready``.  The script refuses to run
without a GPU: a number from another backend is not this metric.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from misonet_tpu.config import ModelConfig, OptimizerConfig, StftConfig
from misonet_tpu.models import make_miso1
from misonet_tpu.utils.cache import enable_compile_cache


def main() -> None:
    train = "--train" in sys.argv[1:]
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {dev.platform!r}")
    enable_compile_cache()

    stft_cfg = StftConfig()
    chunk_seconds = 4.0
    n = int(chunk_seconds * stft_cfg.fs)
    t, f = stft_cfg.num_frames(n), stft_cfg.num_bins      # 501, 129
    b, c, iters = 8, 6, 20
    model = make_miso1(ModelConfig())                     # bf16 compute
    probe = jax.ShapeDtypeStruct((1, c, t, f), jnp.complex64)

    if train:
        from misonet_tpu.train import (create_train_state, make_optimizer,
                                       make_separate_wave_train_step)

        opt = make_optimizer(OptimizerConfig())
        state = jax.jit(lambda k: create_train_state(model.init(k, probe), opt))(
            jax.random.key(0))
        rng = np.random.default_rng(0)
        mix = jnp.asarray(rng.standard_normal((b, n, c), np.float32) * 0.1)
        ref = jnp.asarray(rng.standard_normal((b, 2, n), np.float32) * 0.1)
        step = make_separate_wave_train_step(model, opt, stft_cfg)
        for _ in range(2):
            state, _ = step(state, mix, ref)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for _ in range(iters):
            state, _ = step(state, mix, ref)
        jax.block_until_ready(state)
        metric = "miso1_train_step_throughput"
    else:
        params = jax.jit(model.init)(jax.random.key(0), probe)
        kr, ki = jax.random.split(jax.random.key(1))
        mix = jax.lax.complex(jax.random.normal(kr, (b, c, t, f)),
                              jax.random.normal(ki, (b, c, t, f)))
        fwd = jax.jit(model.apply)
        for _ in range(2):
            out = fwd(params, mix)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fwd(params, mix)
        jax.block_until_ready(out)
        metric = "miso1_separation_throughput"
    dt = (time.perf_counter() - t0) / iters

    audio_s_per_s = b * chunk_seconds / dt
    vs_baseline = None
    if not train:
        baseline = json.loads(
            (Path(__file__).parent / "BENCH_BASELINE.json").read_text()
        )["audio_seconds_per_s"]
        vs_baseline = round(audio_s_per_s / baseline, 2)
    print(json.dumps({
        "metric": metric,
        "value": round(audio_s_per_s, 2),
        "unit": "audio-s/s/chip",
        "vs_baseline": vs_baseline,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
