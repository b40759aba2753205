"""REVERB 2MIX geometry throughput (16 kHz, F=257, 8-level U-Net,
384-ch bottleneck, 8 mics — configs/reverb_2mix.yml): MISO1 forward and
fused train step on one device — a second geometry beside the 129-bin
SMS-WSJ plan.

Run:  python scripts/bench_reverb.py [--train]
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from misonet_tpu.config import OptimizerConfig, load_yaml
from misonet_tpu.models import make_miso1
from misonet_tpu.train import (
    create_train_state,
    make_optimizer,
    make_separate_wave_train_step,
)
from misonet_tpu.utils.cache import enable_compile_cache


def main() -> None:
    enable_compile_cache()
    train = "--train" in sys.argv[1:]
    cfg = load_yaml(
        Path(__file__).resolve().parents[1] / "configs" / "reverb_2mix.yml"
    )
    f = cfg.stft.num_bins            # 257
    b, c = 4, cfg.dataset.num_ch_utilize  # 8 mics
    chunk_s = float(cfg.dataset.chunk_time)
    samples = int(chunk_s * cfg.stft.fs)
    t = cfg.stft.num_frames(samples)  # 501 @ hop 128
    dev = jax.devices()[0]
    print(f"{dev.platform}/{dev.device_kind} B={b} C={c} T={t} F={f}",
          flush=True)

    model = make_miso1(cfg.miso1)
    probe = jax.ShapeDtypeStruct((1, c, t, f), jnp.complex64)
    params = jax.jit(lambda k: model.init(k, probe))(jax.random.key(0))
    au, iters = b * chunk_s, 10

    if train:
        rng = np.random.default_rng(0)
        mix_w = jnp.asarray(
            rng.standard_normal((b, samples, c)).astype(np.float32))
        ref_w = jnp.asarray(
            rng.standard_normal((b, 2, samples)).astype(np.float32))
        opt = make_optimizer(OptimizerConfig(lr=1e-3))
        state = jax.jit(lambda p: create_train_state(p, opt))(params)
        step = make_separate_wave_train_step(model, opt, cfg.stft)
        for _ in range(2):
            state, _ = step(state, mix_w, ref_w)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        for _ in range(iters):
            state, _ = step(state, mix_w, ref_w)
        jax.block_until_ready(state)
        name = "REVERB fused train step"
    else:
        kr, ki = jax.random.split(jax.random.key(1))
        mix = jax.lax.complex(jax.random.normal(kr, (b, c, t, f)),
                              jax.random.normal(ki, (b, c, t, f)))
        fwd = jax.jit(model.apply)
        jax.block_until_ready(fwd(params, mix))
        t0 = time.perf_counter()
        for _ in range(iters):
            y = fwd(params, mix)
        jax.block_until_ready(y)
        name = "REVERB MISO1 forward"
    dt = (time.perf_counter() - t0) / iters
    print(f"{name}: {dt*1e3:7.2f} ms  {au/dt:7.1f} audio-s/s", flush=True)


if __name__ == "__main__":
    main()
