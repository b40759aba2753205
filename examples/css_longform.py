"""Long-form continuous speech separation (CSS) quality demo.

The reference handles long recordings only by time-chunking with one
host-side utterance SCM (tester.py:426-441); `inference/css.py` is the
streaming on-device generalization (BASELINE.json config 5).  This demo
records its *quality* on a long coherent scene, not just a smoke: a
60 s synthetic 6-channel 2-speaker mixture is processed block-by-block
(4 s blocks, running SCMs, adaptive MVDR), with and without cross-fade
overlap stitching, and scored stage-wise with PIT-SI-SDR.

Run (needs a trained MISO1 checkpoint from train_synthetic.py --save):
    python examples/train_synthetic.py --voiced --save model_result/synthetic
    python examples/css_longform.py --ckpt model_result/synthetic [--voiced]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from misonet_tpu.config import (
    DatasetConfig,
    ModelConfig,
    OptimizerConfig,
    StftConfig,
)
from misonet_tpu.data.synthetic import synth_mixture
from misonet_tpu.inference.css import StreamingCSS
from misonet_tpu.metrics import numpy_si_sdr
from misonet_tpu.models import make_miso1
from misonet_tpu.ops.stft import stft_scaled
from misonet_tpu.train import create_train_state, make_optimizer
from misonet_tpu.utils.cache import enable_compile_cache
from misonet_tpu.utils.checkpoint import load_checkpoint


def pit_si_sdr(est: np.ndarray, refs: np.ndarray) -> float:
    a = 0.5 * (numpy_si_sdr(est[0], refs[0]) + numpy_si_sdr(est[1], refs[1]))
    b = 0.5 * (numpy_si_sdr(est[0], refs[1]) + numpy_si_sdr(est[1], refs[0]))
    return float(max(a, b))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="model_result/synthetic")
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=20_000)
    ap.add_argument("--voiced", action="store_true")
    ap.add_argument("--forget", type=float, default=1.0)
    args = ap.parse_args()
    enable_compile_cache()

    stft_cfg = StftConfig()
    ds_cfg = DatasetConfig()
    n = int(args.seconds * ds_cfg.fs)
    print(f"platform={jax.devices()[0].platform} "
          f"scene={args.seconds:.0f}s x {ds_cfg.num_ch}ch", flush=True)

    scene = synth_mixture(args.seed, n, ds_cfg.num_ch, voiced=args.voiced)
    mix, refs = scene["mix"], scene["ref"]          # [S_amples, C], [2, N]

    model = make_miso1(ModelConfig(compute_dtype="bfloat16"))
    probe = stft_scaled(
        jnp.asarray(mix[: ds_cfg.chunk_samples][None].transpose(0, 2, 1)),
        stft_cfg,
    )
    params0 = jax.jit(model.init)(jax.random.key(0), probe)
    opt = make_optimizer(OptimizerConfig(lr=1e-3))
    target = jax.jit(lambda p: create_train_state(p, opt))(params0)
    state, meta = load_checkpoint(args.ckpt, "demo", target)
    print(f"restored {args.ckpt}/demo meta={meta}", flush=True)

    css = StreamingCSS(model, state.params, stft_cfg, ds_cfg,
                       forget=args.forget)
    base = pit_si_sdr(np.stack([mix[:, ds_cfg.ref_ch]] * 2), refs)

    for overlap in (0, ds_cfg.chunk_samples // 4):
        t0 = time.perf_counter()
        out = css.process(mix, overlap=overlap)
        dt = time.perf_counter() - t0
        m1 = pit_si_sdr(out["miso1"], refs)
        bf = pit_si_sdr(out["beamformed"], refs)
        tag = f"overlap={overlap}" + (" (cross-fade)" if overlap else "")
        print(f"{tag:26s}: mixture {base:6.2f}  miso1 {m1:6.2f}  "
              f"mvdr {bf:6.2f} dB   ({args.seconds/dt:.1f} audio-s/s)",
              flush=True)


if __name__ == "__main__":
    main()
