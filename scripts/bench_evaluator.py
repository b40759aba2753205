#!/usr/bin/env python
"""Corpus-scale evaluator throughput: the FULL
MISO1 -> MVDR -> MISO3 utterance evaluator (CascadeEvaluator) over a
synthetic on-disk corpus of varied-length utterances, serial vs the
threaded utterance pipeline (evaluate_corpus workers=2).

The reference's Tester_Beamforming runs M sequential CPU forwards per
chunk; this records the whole
evaluator — decode + utterance SCM/MVDR + per-chunk MISO3 + host
stitch/score — in audio-s/s and utterances/s on the device.

Run:  python scripts/bench_evaluator.py [--utts 16]
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

from misonet_tpu.config import DatasetConfig, ModelConfig, StftConfig
from misonet_tpu.data.extraction import ExtractionSpec
from misonet_tpu.data.wavio import write_wav
from misonet_tpu.inference.evaluate import CascadeEvaluator
from misonet_tpu.models import make_miso1, make_miso3
from misonet_tpu.utils.cache import enable_compile_cache

DATA = Path(__file__).resolve().parents[1] / ".bench_data"


def build_corpus(root: Path, utts: int, fs: int) -> list[ExtractionSpec]:
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    specs = []
    for i in range(utts):
        n = int(fs * (4.0 + 8.0 * rng.random()))  # 4-12 s
        mix = rng.standard_normal((n, 6)).astype(np.float32) * 0.1
        s0 = rng.standard_normal(n).astype(np.float32) * 0.1
        s1 = rng.standard_normal(n).astype(np.float32) * 0.1
        mp = root / f"utt{i:03d}_mix.wav"
        p0 = root / f"utt{i:03d}_s0.wav"
        p1 = root / f"utt{i:03d}_s1.wav"
        write_wav(mp, mix, fs)
        write_wav(p0, s0, fs)
        write_wav(p1, s1, fs)
        specs.append(
            ExtractionSpec(
                utt_id=f"utt{i:03d}", mix_path=str(mp),
                source_paths=[str(p0), str(p1)],
            )
        )
    return specs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--utts", type=int, default=16)
    ap.add_argument("--dir", default=str(DATA / "eval"))
    args = ap.parse_args()
    enable_compile_cache()

    stft_cfg = StftConfig()
    ds_cfg = DatasetConfig()
    mcfg = ModelConfig()
    miso1, miso3 = make_miso1(mcfg), make_miso3(mcfg)
    t, f = 16, stft_cfg.num_bins
    probe1 = jax.ShapeDtypeStruct((1, 6, t, f), jnp.complex64)
    probe3 = jax.ShapeDtypeStruct((1, 8, t, f), jnp.complex64)
    p1 = jax.jit(lambda k: miso1.init(k, probe1))(jax.random.key(0))
    p3 = jax.jit(lambda k: miso3.init(k, probe3))(jax.random.key(1))

    specs = build_corpus(Path(args.dir), args.utts, stft_cfg.fs)
    total_audio = 0.0
    from misonet_tpu.data.wavio import read_wav

    for s in specs:
        total_audio += read_wav(s.mix_path)[0].shape[0] / stft_cfg.fs

    ev = CascadeEvaluator(
        miso1, p1, stft_cfg, ds_cfg,
        enhance_model=miso3, enhance_params=p3,
        beamform_utterance=True,
    )
    # warmup: compile every bucket signature once
    ev.evaluate_corpus(specs, args.dir, write=False, workers=1)

    for workers in (1, 2, 4, 8):
        t0 = time.perf_counter()
        ev.evaluate_corpus(specs, args.dir, write=False, workers=workers)
        dt = time.perf_counter() - t0
        print(
            f"workers={workers}: {args.utts / dt:.2f} utts/s, "
            f"{total_audio / dt:.1f} audio-s/s "
            f"({dt / args.utts * 1e3:.0f} ms/utt, "
            f"{total_audio:.0f} s of audio in {dt:.1f} s)",
            flush=True,
        )


if __name__ == "__main__":
    main()
