"""Inference-pipeline throughput: the full-array circular-shift decode
(reference MISO1_Inference, tester.py:580-634 — M model forwards + PIT
alignment per chunk) in audio-s/s on one device.

This is the Tester hot loop a production deployment runs per utterance;
the forward bench times one plain forward, this times the whole decode
(M=6 rolled forwards batched into one, slot alignment included).

Run:  python scripts/bench_decode.py
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

from misonet_tpu.config import ModelConfig, StftConfig
from misonet_tpu.inference.separate import make_full_array_decode
from misonet_tpu.models import make_miso1
from misonet_tpu.utils.cache import enable_compile_cache


def main() -> None:
    enable_compile_cache()
    stft_cfg = StftConfig()
    t = stft_cfg.num_frames(int(4.0 * stft_cfg.fs))
    f = stft_cfg.num_bins
    b, c, iters = 4, 6, 10

    model = make_miso1(ModelConfig())
    kr, ki, kp = jax.random.split(jax.random.key(0), 3)
    mix = jax.lax.complex(
        jax.random.normal(kr, (b, c, t, f)), jax.random.normal(ki, (b, c, t, f))
    )
    params = jax.jit(model.init)(kp, mix[:1])
    decode = make_full_array_decode(model, c, ref_ch=0)

    jax.block_until_ready(decode(params, mix))      # compile + warm-up
    t0 = time.perf_counter()
    for _ in range(iters):
        out = decode(params, mix)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    dev = jax.devices()[0]
    print(
        f"{dev.device_kind}: full-array decode (B={b}, M={c} mics): "
        f"{dt*1e3:.2f} ms/batch = {b*4.0/dt:.1f} audio-s/s"
    )


if __name__ == "__main__":
    main()
