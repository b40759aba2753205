#!/usr/bin/env python3
"""End-to-end smoke test of misonet_tpu on one NVIDIA GPU.

    python3 chip_smoke.py                # the one-card run
    python3 chip_smoke.py --four-cards   # data-parallel trainers on 4 cards

The one-card run drives the MISO1 -> MVDR -> MISO3 cascade at the full
SMS-WSJ width (configs/smswsj.yml: 6 mics, 8 kHz, 4 s chunks,
[B, 6, 501, 129] spectrograms, batch 20, 2.59M-parameter bf16 model with
random weights) through run.py's own entry points, in this process:

  extraction  synthetic 6-channel corpus (12 utterances of 6-10 s) -> shards
  train_miso1 -m Train -t MISO1, 2 epochs of 2 steps; every loss finite
  train_miso3 -m Train -t MISO3, 1 epoch of 2 steps (frozen-MISO1 decode
              and MVDR feature step on the card); every loss finite
  test_miso3  -m Test -t MISO3 on 2 utterances (CascadeEvaluator); every
              per-stage SI-SDR finite
  test_css    -m Test -t CSS on 1 utterance (StreamingCSS)

then checks what only the card can show:

  step_memory compiled.memory_analysis() of the MISO1 train step, rough
              train ms/step and eval-step (STFT + forward + loss) audio-s/s
              at batch 20, and the top device ops of one traced train step
              (the programs train_miso1 compiled, found again in the
              compile cache)
  mvdr_share  one traced call of the MISO3 trainer's feature step (STFT,
              full-array MISO1 decode, alignment, MVDR; B=20): device ms by
              named scope, and the loaded solve's share of the MVDR stage
  fwd_parity  MISO1 forward with the weights train_miso1 saved, float32
              on the GPU at HIGHEST matmul precision against float32 on the
              CPU backend of this process ([1, 6, 501, 129]): rel-L2 <=
              1e-4, since only the order of summation differs
  bf16_parity the bf16 forward against that float32 forward: rel-L2 <=
              3e-2 and correlation >= 0.999 (bf16 rounding through 7
              InstanceNorm levels)
  mvdr        the loaded Hermitian solve and the whole mvdr_beamform against
              a NumPy float64 oracle at B=8, F=129, M=6 and at F=257, M=8
              (complex64; the einsums run at HIGHEST precision): solve
              rel-L2 <= 1e-4, beamformer rel-L2 <= 1e-3
  reverb      one forward of the REVERB plan (configs/reverb_2mix.yml:
              16 kHz, 257 bins, 8 levels, 384-channel bottleneck) at T=64,
              random weights

``--four-cards`` runs only the data-parallel path and what it is compared
with, at the SMS-WSJ plan's widths (configs/smswsj.yml; random weights):
SeparationTrainer and EnhanceTrainer for 2 steps each on a 4-card mesh
(the config's batch of 20 four-second chunks, no validation), and one
float32 DP train step against the same global batch of 8 on one card
(SGD, HIGHEST precision): loss rel diff <= 1e-5, and every parameter
within 1e-4 of its leaf's largest update plus 1e-6 of the largest update
of all (DP changes only the order of the batch reduction).

Every phase prints its seconds and the XLA compilations it ran (a
compile-cache hit shows as a short one).  A failed phase raises, and the
script exits non-zero.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Work files go to .smoke_run/ in the checkout.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parent
WORK = ROOT / ".smoke_run"


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


COMPILES = None   # profiling.CompileLog of this process, set by main()


@contextlib.contextmanager
def phase(name: str):
    print(f"[{name}] start", flush=True)
    mark = COMPILES.mark() if COMPILES else 0
    t0 = time.perf_counter()
    yield
    took = time.perf_counter() - t0
    note = ""
    if COMPILES:
        done = COMPILES.since(mark)
        top = sorted(done, key=lambda e: -e[1])[:4]
        note = (f"; {len(done)} compiles, {sum(s for _, s in done):.1f} s"
                + "".join(f"; {n} {s:.1f} s" for n, s in top))
    print(f"[{name}] ok {took:.1f} s{note}", flush=True)


class _Tee(io.TextIOBase):
    """stdout that is also recorded, so printed losses can be checked."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.out.write(s)
        self.lines.append(s)
        return len(s)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.lines)


def run_module():
    """run.py, imported as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("misonet_run", ROOT / "run.py")
    run_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_mod)
    return run_mod


def run_cli(*args: str) -> str:
    """run.py's main() in this process; returns what it printed."""
    run_mod = run_module()
    tee = _Tee(sys.stdout)
    old = sys.argv
    sys.argv = ["run.py", *args]
    try:
        with contextlib.redirect_stdout(tee):
            run_mod.main()
    finally:
        sys.argv = old
    return tee.text()


def _floats(pattern: str, text: str) -> list[float]:
    return [float(v) for v in re.findall(pattern, text)]


def require_finite(name: str, values: list[float], at_least: int) -> None:
    if len(values) < at_least:
        raise RuntimeError(f"{name}: expected >= {at_least} values, got {values}")
    if not all(math.isfinite(v) for v in values):
        raise RuntimeError(f"{name}: non-finite values {values}")
    print(f"  {name}: {values}", flush=True)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check(name: str, value: float, op: str, limit: float) -> None:
    ok = value <= limit if op == "<=" else value >= limit
    print(f"  {name} = {value:.3e} (limit {op} {limit:g})", flush=True)
    if not ok:
        raise RuntimeError(f"{name} = {value} violates {op} {limit}")


def cx(key, shape):
    kr, ki = jax.random.split(key)
    return jax.lax.complex(jax.random.normal(kr, shape),
                           jax.random.normal(ki, shape))


def _dump_yaml(d: dict, indent: int = 0) -> str:
    """Block-mapping YAML for the subset config.parse_yaml reads."""
    out = []
    for k, v in d.items():
        pad = " " * indent
        if isinstance(v, dict):
            out.append(f"{pad}{k}:\n{_dump_yaml(v, indent + 2)}")
        elif isinstance(v, list):
            out.append(f"{pad}{k}: [{', '.join(json.dumps(x) if isinstance(x, str) else str(x) for x in v)}]")
        else:
            out.append(f"{pad}{k}: {json.dumps(v) if isinstance(v, str) else v}")
    return "\n".join(out)


# --------------------------------------------------------------------------
# one card: the cascade through run.py
# --------------------------------------------------------------------------


def write_corpus(root: Path, num_utts: int = 12, fs: int = 8000) -> None:
    """Synthetic SMS-WSJ-shaped corpus: 6-channel mixtures of two voiced
    sources, 6-10 s each, laid out as observation/ + speech_source/."""
    from misonet_tpu.data.synthetic import synth_mixture
    from misonet_tpu.data.wavio import write_wav

    rng = np.random.default_rng(0)
    for u in range(num_utts):
        # the two test utterances (utt00, utt01) share the evaluator's
        # 3-chunk length bucket, so its programs compile once
        n = int(fs * rng.uniform(8.0 if u < 2 else 6.0, 10.0))
        d = synth_mixture(u, num_samples=n, num_ch=6, voiced=True)
        write_wav(root / "observation" / f"utt{u:02d}.wav", d["mix"], fs)
        for s in range(2):
            write_wav(root / "speech_source" / f"utt{u:02d}_{s}.wav",
                      d["ref"][s], fs)


def smoke_config(work: Path) -> Path:
    from misonet_tpu.config import parse_yaml

    raw = parse_yaml((ROOT / "configs" / "smswsj.yml").read_text())
    raw["SMS_WSJ"].update(
        rootdir=f"{work}/corpus/",
        saved_tr_pickle_dir=f"{work}/shards/",
        saved_dt_pickle_dir=f"{work}/shards/",
    )
    raw["trainer_sp"].update(epochs=2, print_freq=1, check_point=[True, 1],
                             save_folder=f"{work}/model/miso1")
    raw["trainer_en"].update(epochs=1, print_freq=1, check_point=[True, 1],
                             save_folder=f"{work}/model/miso3",
                             MISO1_path=f"{work}/model/miso1/best")
    path = work / "smswsj_smoke.yml"
    path.write_text(_dump_yaml(raw) + "\n")
    return path


def cascade_phases(work: Path) -> Path:
    cfg = None
    with phase("extraction"):
        write_corpus(work / "corpus")
        cfg = smoke_config(work)
        out = run_cli("-c", str(cfg), "-m", "Extraction")
        n = len(list((work / "shards").glob("*.npz")))
        print(f"  {n} shards", flush=True)
        if n < 40:
            raise RuntimeError(f"expected >= 40 chunks, got {n}: {out}")

    with phase("train_miso1"):
        out = run_cli("-c", str(cfg), "-m", "Train", "-t", "MISO1",
                      "-n", str(work / "logs" / "miso1"))
        require_finite("MISO1 step losses",
                       _floats(r"batch \d+: loss (\S+)", out), 3)

    with phase("train_miso3"):
        out = run_cli("-c", str(cfg), "-m", "Train", "-t", "MISO3",
                      "-n", str(work / "logs" / "miso3"))
        require_finite("MISO3 step losses",
                       _floats(r"batch \d+: loss (\S+)", out), 2)

    with phase("test_miso3"):
        out = run_cli("-c", str(cfg), "-m", "Test", "-t", "MISO3",
                      "-n", str(work / "eval"), "--max-utts", "2")
        require_finite("per-stage SI-SDR (miso1, beamform, enhanced)",
                       _floats(r"'\w+': ([-+\w.]+)", out), 3)

    with phase("test_css"):
        out = run_cli("-c", str(cfg), "-m", "Test", "-t", "CSS",
                      "-n", str(work / "css"), "--max-utts", "1")
        require_finite("CSS per-stage PIT-SI-SDR",
                       _floats(r"'\w+': ([-+\w.]+)", out), 3)
    return cfg


# --------------------------------------------------------------------------
# one card: checks only the card can run
# --------------------------------------------------------------------------


def _shard_batch_of(cfg, b: int) -> dict:
    """The first ``b`` extracted chunks, as the trainers' Batcher yields them."""
    from misonet_tpu.data import Batcher, ShardDataset

    ds = ShardDataset(cfg.dataset.pickle_dir, cfg.dataset.num_spks)
    return next(iter(Batcher(ds, b, shuffle=False)))


def step_memory_phase(cfg_path: Path) -> None:
    """The MISO1 train and eval steps exactly as SeparationTrainer builds
    them for the smoke config, so train_miso1's compiled programs are
    found again in the compile cache instead of being compiled anew."""
    from misonet_tpu.config import load_yaml
    from misonet_tpu.models import make_miso1
    from misonet_tpu.train import (create_train_state, make_optimizer,
                                   make_separate_wave_eval_step,
                                   make_separate_wave_train_step)

    cfg = load_yaml(cfg_path)
    stft, ref_ch = cfg.stft, cfg.dataset.ref_ch
    b = cfg.trainer_sp.batch_size
    model = make_miso1(cfg.miso1)
    opt = make_optimizer(cfg.optimizer)
    batch = _shard_batch_of(cfg, b)
    mix_w, ref_w = jnp.asarray(batch["mix"]), jnp.asarray(batch["ref"])
    n = mix_w.shape[1]
    probe = jax.ShapeDtypeStruct(
        (b, mix_w.shape[2], stft.num_frames(n), stft.num_bins), jnp.complex64)
    state = jax.jit(lambda k: create_train_state(model.init(k, probe), opt))(
        jax.random.key(0))
    overest = cfg.trainer_sp.overest_alpha > 0.0
    extra = (jnp.float32(cfg.trainer_sp.overest_alpha),) if overest else ()
    step = make_separate_wave_train_step(model, opt, stft, ref_ch=ref_ch,
                                         overest=overest)

    t0 = time.perf_counter()
    compiled = step.lower(state, mix_w, ref_w, *extra).compile()
    print(f"  train step compile {time.perf_counter() - t0:.1f} s", flush=True)
    mem = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    print(f"  MISO1 train step memory_analysis (B={b}): " + ", ".join(
        f"{f}={getattr(mem, f)}" for f in fields), flush=True)

    for _ in range(2):
        state, m = compiled(state, mix_w, ref_w, *extra)
    jax.block_until_ready(state)
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = compiled(state, mix_w, ref_w, *extra)
    jax.block_until_ready(state)
    dt = (time.perf_counter() - t0) / iters
    require_finite("timed step loss", [float(m["loss"])], 1)
    print(f"  MISO1 train step B={b}: {dt * 1e3:.1f} ms/step, "
          f"{b * n / stft.fs / dt:.1f} audio-s/s", flush=True)

    from misonet_tpu.utils.profiling import top_ops, trace, trace_lines

    with trace(WORK / "trace"):
        state, m = compiled(state, mix_w, ref_w, *extra)
        jax.block_until_ready(state)
    lines = trace_lines(WORK / "trace")
    for name, agg in sorted(lines.items()):
        print(f"  trace line {name!r}: {len(agg)} ops, "
              f"{sum(agg.values()):.2f} ms", flush=True)
    for name, ms in top_ops(lines, 12):
        print(f"    {ms:8.3f} ms  {name[:100]}", flush=True)

    ev = make_separate_wave_eval_step(model, stft, ref_ch=ref_ch)
    jax.block_until_ready(ev(state.params, mix_w, ref_w))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = ev(state.params, mix_w, ref_w)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    print(f"  MISO1 eval step (STFT + forward + loss) B={b}: "
          f"{dt * 1e3:.1f} ms, {b * n / stft.fs / dt:.1f} audio-s/s",
          flush=True)
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak bytes in use: {stats.get('peak_bytes_in_use')}", flush=True)


def mvdr_share_phase(cfg_path: Path) -> None:
    """Device time of the MISO3 trainer's feature step by named scope, from
    one traced call built as run.py builds it (its compiled program is
    found again in the compile cache)."""
    from misonet_tpu.config import load_yaml
    from misonet_tpu.models import make_miso1, make_miso3
    from misonet_tpu.train.trainer import EnhanceTrainer
    from misonet_tpu.utils.profiling import scope_device_ms, trace

    cfg = load_yaml(cfg_path)
    miso1 = make_miso1(cfg.miso1)
    trainer = EnhanceTrainer(
        make_miso3(cfg.miso3), miso1, run_module()._load_miso1(cfg, miso1),
        cfg.trainer_en, cfg.optimizer, cfg.stft, cfg.dataset, [], [])
    batch = _shard_batch_of(cfg, cfg.trainer_en.batch_size)
    args = (trainer.miso1_params, *trainer.put((batch["mix"], batch["ref"])))
    compiled = trainer.feature_step.lower(*args).compile()
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    host_ms = (time.perf_counter() - t0) * 1e3
    for name, arr in zip(("mix", "ref_aligned", "miso1_ref", "bf"), out):
        if not bool(jnp.isfinite(arr.real).all() & jnp.isfinite(arr.imag).all()):
            raise RuntimeError(f"feature step output {name} is not finite")
    tdir = WORK / "trace_features"
    with trace(tdir):
        jax.block_until_ready(compiled(*args))
    hlo = compiled.as_text()
    (tdir / "features.hlo.txt").write_text(hlo)
    scopes = ("stft", "miso1_decode", "align", "mvdr", "loaded_solve")
    ms = scope_device_ms(tdir, hlo, scopes)
    print(f"  MISO3 feature step B={cfg.trainer_en.batch_size}: host clock "
          f"{host_ms:.3f} ms; device ms by scope: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()), flush=True)
    if ms["mvdr"] > 0 and ms["total"] > 0:
        print(f"  loaded solve: {100 * ms['loaded_solve'] / ms['mvdr']:.1f}% "
              f"of the MVDR stage, {100 * ms['loaded_solve'] / ms['total']:.2f}"
              f"% of the feature step (device time)", flush=True)
    else:
        # a measurement gap, not a fault of the step: say what the trace
        # holds (it is kept, with the program's HLO, under tdir)
        data = jax.profiler.ProfileData.from_file(
            str(sorted(tdir.glob("plugins/profile/*/*.xplane.pb"))[-1]))
        samples = [(plane.name, line.name, ev)
                   for plane in data.planes if plane.name.startswith("/device")
                   for line in plane.lines for ev in list(line.events)[:2]]
        for plane, line, ev in samples[:12]:
            print(f"  not attributed; {plane} / {line}: {ev.name[:60]} "
                  f"{dict(ev.stats)}", flush=True)


def parity_phases(cfg_path: Path) -> None:
    """Forward parities with the MISO1 weights train_miso1 saved (restored
    from the checkpoint: no init program to compile).  The bf16 forward
    runs at batch 6, the shape of the CSS decode's forward, whose
    compiled convolutions it shares; sample 0 is the float32 input."""
    from misonet_tpu.config import load_yaml
    from misonet_tpu.models import make_miso1

    cfg = load_yaml(cfg_path)
    x6 = cx(jax.random.key(2), (6, 6, 501, 129))
    x = x6[:1]
    f32 = make_miso1(dataclasses.replace(cfg.miso1, compute_dtype="float32"))
    params = run_module()._load_miso1(cfg, f32)

    with phase("fwd_parity"):
        with jax.default_matmul_precision("highest"):
            y_gpu = np.asarray(jax.jit(f32.apply)(params, x))
        cpu = jax.devices("cpu")[0]
        y_cpu = np.asarray(jax.jit(f32.apply)(
            jax.device_put(params, cpu), jax.device_put(x, cpu)))
        check("f32 GPU(HIGHEST) vs CPU rel-L2", rel_l2(y_gpu, y_cpu), "<=", 1e-4)

    with phase("bf16_parity"):
        bf16 = make_miso1(dataclasses.replace(cfg.miso1,
                                              compute_dtype="bfloat16"))
        y_bf = np.asarray(jax.jit(bf16.apply)(params, x6))[:1]
        check("bf16 vs f32 rel-L2", rel_l2(y_bf, y_gpu), "<=", 3e-2)
        corr = np.corrcoef(
            np.concatenate([y_bf.real.ravel(), y_bf.imag.ravel()]),
            np.concatenate([y_gpu.real.ravel(), y_gpu.imag.ravel()]),
        )[0, 1]
        check("bf16 vs f32 correlation", float(corr), ">=", 0.999)


def oracle_mvdr(source, mixture, delta=1e-6):
    """Float64 NumPy MVDR (eigh steering, sequential phase correction,
    LAPACK solve), independent of the code under test.  Returns
    (numerator solve [B, F, M], beamformed [B, T, F])."""
    src, mix = source.astype(np.complex128), mixture.astype(np.complex128)
    t = src.shape[2]

    def scm(x):
        r = np.einsum("bctf,bdtf->bfcd", x, x.conj()) / t
        return 0.5 * (r + r.conj().swapaxes(-1, -2))

    r_s, r_n = scm(src), scm(mix - src)
    m = r_s.shape[-1]
    _, vecs = np.linalg.eigh(r_s)
    d = vecs[..., -1]                                   # top eigenvector
    d = d / d[..., :1]
    d = d * np.sqrt(m / np.linalg.norm(d, axis=-1, keepdims=True))
    for f in range(1, d.shape[1]):
        s = np.sum(d[:, f] * d[:, f - 1].conj(), axis=-1, keepdims=True)
        d[:, f] *= np.exp(-1j * np.angle(s))
    rn = r_n + delta * np.eye(m)
    numer = np.linalg.solve(rn, d[..., None])[..., 0]
    w = numer / np.einsum("...m,...m->...", d.conj(), numer)[..., None]
    return rn, d, numer, np.einsum("bfc,bctf->btf", w.conj(), mix)


def mvdr_phase() -> None:
    from misonet_tpu.beamforming.mvdr import loaded_solve, mvdr_beamform

    rng = np.random.default_rng(4)
    for b, f, m, t in ((8, 129, 6, 501), (8, 257, 8, 501)):
        steer = rng.standard_normal((b, f, m)) + 1j * rng.standard_normal((b, f, m))
        sig = rng.standard_normal((b, t, f)) + 1j * rng.standard_normal((b, t, f))
        source = np.einsum("bfc,btf->bctf", steer, sig).astype(np.complex64)
        noise = 0.1 * (rng.standard_normal((b, m, t, f))
                       + 1j * rng.standard_normal((b, m, t, f)))
        mixture = (source + noise).astype(np.complex64)
        rn, d, numer_ref, y_ref = oracle_mvdr(source, mixture)

        numer = np.asarray(jax.jit(loaded_solve)(
            jnp.asarray(rn - 1e-6 * np.eye(m), jnp.complex64),
            jnp.asarray(d, jnp.complex64)))
        y = np.asarray(mvdr_beamform(jnp.asarray(source), jnp.asarray(mixture)))
        check(f"solve rel-L2 (F={f}, M={m})", rel_l2(numer, numer_ref),
              "<=", 1e-4)
        check(f"beamformer rel-L2 (F={f}, M={m})", rel_l2(y, y_ref),
              "<=", 1e-3)


def reverb_phase() -> None:
    from misonet_tpu.config import load_yaml
    from misonet_tpu.models import make_miso1

    cfg = load_yaml(ROOT / "configs" / "reverb_2mix.yml")
    model = make_miso1(cfg.miso1)
    x = cx(jax.random.key(5), (1, cfg.dataset.num_ch, 64, cfg.stft.num_bins))
    # random weights drawn on the host's CPU backend, where the init
    # program compiles several times faster than for the GPU
    with jax.default_device(jax.devices("cpu")[0]):
        params = jax.jit(model.init)(jax.random.key(6), np.asarray(x))
    params = jax.device_put(params, jax.devices()[0])
    y = jax.jit(model.apply)(params, x)
    if y.shape != (1, 2, 64, cfg.stft.num_bins):
        raise RuntimeError(f"REVERB forward shape {y.shape}")
    if not bool(jnp.isfinite(y.real).all() & jnp.isfinite(y.imag).all()):
        raise RuntimeError("REVERB forward is not finite")
    n = sum(v.size for v in jax.tree.leaves(params))
    print(f"  REVERB MISO1 ({n} params) forward {y.shape} finite", flush=True)


# --------------------------------------------------------------------------
# four cards: data-parallel trainers and the DP-vs-one-card comparison
# --------------------------------------------------------------------------


def _wave_batches(n_batches: int, b: int, seed: int, n: int) -> list[dict]:
    from misonet_tpu.data.synthetic import synth_mixture

    out = []
    for i in range(n_batches):
        items = [synth_mixture(seed + i * b + j, num_samples=n, num_ch=6,
                               voiced=True) for j in range(b)]
        out.append({k: np.stack([it[k] for it in items]) for k in items[0]})
    return out


def four_card_phases(cfg_path: Path) -> None:
    from misonet_tpu.config import OptimizerConfig, TrainerConfig, load_yaml
    from misonet_tpu.models import make_miso1, make_miso3
    from misonet_tpu.parallel.mesh import make_mesh, make_mesh_for_batch
    from misonet_tpu.train import (create_train_state, make_optimizer,
                                   make_separate_wave_train_step)
    from misonet_tpu.train.trainer import EnhanceTrainer, SeparationTrainer

    if len(jax.devices()) != 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {jax.devices()}")
    cfg = load_yaml(cfg_path)
    stft, ds, opt_cfg = cfg.stft, cfg.dataset, cfg.optimizer
    b, n = cfg.trainer_sp.batch_size, ds.chunk_samples
    mesh = make_mesh_for_batch(b)
    print(f"  mesh {dict(mesh.shape)} over {[d.id for d in mesh.devices]}",
          flush=True)
    data = _wave_batches(2, b, seed=100, n=n)
    tr_cfg = TrainerConfig(epochs=1, batch_size=b, print_freq=1,
                           checkpoint_every=1000,
                           save_folder=str(WORK / "dp_model"))

    with phase("dp_sharding"):
        trainer = SeparationTrainer(make_miso1(cfg.miso1), tr_cfg, opt_cfg,
                                    stft, ds, data, [], mesh=mesh)
        mix, ref = trainer.put((data[0]["mix"], data[0]["ref"]))
        for name, arr in (("mix", mix), ("ref", ref)):
            shards = arr.addressable_shards
            devs = {s.device.id for s in shards}
            rows = {s.data.shape[0] for s in shards}
            print(f"  {name} {arr.shape}: {len(shards)} shards on devices "
                  f"{sorted(devs)}, rows per shard {rows}", flush=True)
            if len(devs) != 4 or rows != {b // 4}:
                raise RuntimeError(f"{name} is not sharded 4 ways: {arr.sharding}")

    with phase("dp_separation_trainer"):
        out = _Tee(sys.stdout)
        with contextlib.redirect_stdout(out):
            trainer.train()
        require_finite("DP MISO1 step losses",
                       _floats(r"batch \d+: loss (\S+)", out.text()), 2)
        miso1_params = trainer.state.params

    with phase("dp_enhance_trainer"):
        enh = EnhanceTrainer(make_miso3(cfg.miso3), make_miso1(cfg.miso1),
                             miso1_params, dataclasses.replace(
                                 tr_cfg, save_folder=str(WORK / "dp_model3")),
                             opt_cfg, stft, ds, data, [], mesh=mesh)
        out = _Tee(sys.stdout)
        with contextlib.redirect_stdout(out):
            enh.train()
        require_finite("DP MISO3 step losses",
                       _floats(r"batch \d+: loss (\S+)", out.text()), 2)

    with phase("dp_vs_one_card"):
        bb = 8
        model = make_miso1(dataclasses.replace(cfg.miso1,
                                               compute_dtype="float32"))
        opt = make_optimizer(OptimizerConfig(name="sgd", lr=1e-2,
                                             guard_nans=False))
        batch = _wave_batches(1, bb, seed=200, n=n)[0]
        probe = jax.ShapeDtypeStruct(
            (1, ds.num_ch_utilize, stft.num_frames(n), stft.num_bins),
            jnp.complex64)
        p0 = jax.device_get(jax.jit(model.init)(jax.random.key(7), probe))
        with jax.default_matmul_precision("highest"):
            # the steps donate their state: each gets its own copy of p0
            one = make_separate_wave_train_step(model, opt, stft,
                                                ref_ch=ds.ref_ch)
            s1, m1 = one(create_train_state(jax.device_put(p0), opt),
                         jnp.asarray(batch["mix"]), jnp.asarray(batch["ref"]))
            mesh4 = make_mesh(4)
            from misonet_tpu.parallel import replicate, shard_batch

            dp = make_separate_wave_train_step(model, opt, stft,
                                               ref_ch=ds.ref_ch, mesh=mesh4)
            s4, m4 = dp(replicate(create_train_state(p0, opt), mesh4),
                        *shard_batch((batch["mix"], batch["ref"]), mesh4))
        l1, l4 = float(m1["loss"]), float(m4["loss"])
        print(f"  loss one card {l1:.6f}, four cards {l4:.6f}", flush=True)
        check("DP loss rel diff", abs(l4 - l1) / abs(l1), "<=", 1e-5)
        # DP changes only the order of the batch reduction, so a leaf may
        # differ by rounding relative to its own update, or - where its
        # gradient cancels to near zero - relative to the largest update
        p4, p1 = jax.tree.leaves(s4.params), jax.tree.leaves(s1.params)
        upd = [np.abs(np.asarray(a) - b).max() for a, b in zip(p1, jax.tree.leaves(p0))]
        scale = max(upd)
        worst = max(
            np.abs(np.asarray(a) - np.asarray(b)).max() / (1e-4 * u + 1e-6 * scale)
            for a, b, u in zip(p4, p1, upd)
        )
        check("DP params max |diff| / (1e-4 |leaf update| + 1e-6 |max update|)",
              float(worst), "<=", 1.0)


# --------------------------------------------------------------------------


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card data-parallel phases")
    args = ap.parse_args()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke.py needs an NVIDIA GPU; JAX found "
                 f"{dev.platform!r} ({dev.device_kind})")
    if not (ROOT / "misonet_tpu").is_dir():
        sys.exit("chip_smoke.py must run from a misonet_tpu checkout "
                 f"(no misonet_tpu/ next to {Path(__file__).name})")
    sys.path.insert(0, str(ROOT))
    from misonet_tpu.utils.cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    print(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}",
          flush=True)

    from misonet_tpu.utils.profiling import CompileLog

    global COMPILES
    COMPILES = CompileLog()
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir()
    t0 = time.perf_counter()
    if args.four_cards:
        four_card_phases(ROOT / "configs" / "smswsj.yml")
    else:
        cfg_path = cascade_phases(WORK)
        with phase("step_memory"):
            step_memory_phase(cfg_path)
        with phase("mvdr_share"):
            mvdr_share_phase(cfg_path)
        parity_phases(cfg_path)
        with phase("mvdr"):
            mvdr_phase()
        with phase("reverb"):
            reverb_phase()
    print(f"all phases ok in {time.perf_counter() - t0:.1f} s; "
          f"{len(COMPILES.events)} compiles, "
          f"{sum(s for _, s in COMPILES.events):.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main()
