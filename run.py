#!/usr/bin/env python
"""CLI entry point — the reference's run.py re-imagined.

Modes (reference run.py:278-292):
  Extraction   wav corpus -> chunked shards        (-m Extraction)
  Train        MISO1 / MISO2 / MISO3 training      (-m Train -t <stage>)
  Test         MISO1 / Beamforming / MISO2 / MISO3 (-m Test -t <stage>)
               + CSS: streaming block-wise long-form separation
               (beyond the reference; --css-overlap for cross-fade)

Usage:
  python run.py -c configs/smswsj.yml -m Train -t MISO1 -n logs/run1
  python run.py -c configs/smswsj.yml -m Test -t MISO3 -n logs/eval

The config YAML uses the reference's NN_BSS.yml layout (config.load_yaml).
Unlike the reference (which hard-codes NN_BSS.yml regardless of the flag,
run.py:290), the -c path is honored.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import jax


def main() -> None:
    ap = argparse.ArgumentParser(description="misonet_tpu")
    ap.add_argument(
        "-c",
        "--config",
        required=True,
        help="YAML config path, or a directory resolved with -d "
        "(reference run.py:280 takes a directory)",
    )
    ap.add_argument(
        "-d",
        "--dataset",
        default="SMS_WSJ",
        choices=["SMS_WSJ", "REVERB_2MIX", "RIR_mixing"],
        help="dataset name; with a -c directory selects <dir>/<dataset>.yml",
    )
    ap.add_argument(
        "-m", "--mode", required=True, choices=["Extraction", "Train", "Test"]
    )
    ap.add_argument(
        "-t",
        "--target",
        default="MISO1",
        choices=["MISO1", "Beamforming", "MISO2", "MISO3", "CSS"],
    )
    ap.add_argument(
        "-u",
        "--use-device",
        default=None,
        help="accepted for reference-CLI compatibility (run.py:284 gpu "
        "selector); device placement is JAX-managed here",
    )
    ap.add_argument("-n", "--logdir", default="logs/run")
    ap.add_argument("--max-utts", type=int, default=None)
    ap.add_argument(
        "--wav-subtype",
        default="PCM_16",
        choices=("PCM_16", "PCM_24"),
        help="output wav sample format; PCM_24 reproduces the reference's "
        "on-disk byte format (tester.py:157)",
    )
    ap.add_argument(
        "--eval-workers",
        type=int,
        default=2,
        help="utterances pipelined through the evaluator: one utterance's "
        "host half (wav IO/stitch/scoring) overlaps another's device half",
    )
    ap.add_argument(
        "--css-overlap",
        type=int,
        default=0,
        help="-t CSS: block overlap in samples (cross-fade stitching); "
        "0 = edge-to-edge blocks (the reference's chunked semantics)",
    )
    ap.add_argument(
        "--split",
        default=None,
        help="corpus split directory under rootdir (the reference walks "
        "fixed splits train_si284/cv_dev93/test_eval92, run.py:245-250); "
        "default: Test uses <test_file>, Extraction walks <tr_file> and "
        "<dev_file> when those split dirs exist",
    )
    args = ap.parse_args()

    from misonet_tpu.config import load_yaml
    from misonet_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()

    cfg_path = Path(args.config)
    if cfg_path.is_dir():
        names = {
            "SMS_WSJ": "smswsj.yml",
            "REVERB_2MIX": "reverb_2mix.yml",
            "RIR_mixing": "reverb_2mix.yml",  # premixed RIR shares the plan
        }
        cfg_path = cfg_path / names[args.dataset]
    cfg = load_yaml(cfg_path)

    if args.mode == "Extraction":
        _extract(cfg, args.split)
    elif args.mode == "Train":
        _train(cfg, args)
    else:
        _test(cfg, args)


def _split_root(ds, split: str | None) -> Path:
    """Resolve the corpus root for a split: <rootdir>/<split> when that
    split directory exists (reference layout, run.py:245-250), else the
    plain rootdir (flat single-directory corpora)."""
    root = Path(ds.root_dir)
    if split and (root / split / ds.mix_subdir).is_dir():
        return root / split
    return root


def _discover(cfg, split: str | None = None):
    """Dataset-specific corpus discovery (the reference dispatches per
    dataset in its Extraction branch, run.py:33-61)."""
    from misonet_tpu.data.extraction import discover_smswsj
    from misonet_tpu.data.reverb import discover_reverb_2mix, discover_rir_mixing

    ds = cfg.dataset
    root = Path(ds.root_dir)
    if ds.name == "REVERB_2MIX":
        # .lst scp file if present (REVERB_2MIX.py:120-138), else glob
        return discover_reverb_2mix(root / "list.lst", root, ds.num_spks)
    if ds.name == "RIR_mixing":
        return discover_rir_mixing(root, ds.num_spks)
    root = _split_root(ds, split)
    return discover_smswsj(
        root / ds.mix_subdir,
        root / ds.clean_subdir,
        ds.num_spks,
        early_dir=root / ds.early_subdir if ds.save_early else None,
        tail_dir=root / ds.tail_subdir if ds.save_tail else None,
        noise_dir=root / ds.noise_subdir if ds.save_noise else None,
    )


def _extract(cfg, split: str | None = None) -> None:
    import os

    from misonet_tpu.data.extraction import extract_corpus

    ds = cfg.dataset
    # the reference extracts the train and dev splits (SMS_WSJ.py:233-235);
    # walk each split that exists, landing train chunks in pickle_dir and
    # dev chunks in dev_pickle_dir.  --split restricts to one.
    jobs = [(split, ds.pickle_dir)] if split else [
        (ds.tr_file, ds.pickle_dir),
        (ds.dev_file, ds.dev_pickle_dir or ds.pickle_dir),
    ]
    ran_split = False
    for sp, out_dir in jobs:
        root = _split_root(ds, sp)
        if sp and root == Path(ds.root_dir) and not split:
            continue  # split dir absent -> flat corpus fallback below
        ran_split = True
        specs = _discover(cfg, sp)
        n = extract_corpus(
            specs, out_dir, ds.chunk_samples, ds.least_samples,
            workers=os.cpu_count() or 1,
        )
        print(f"extracted {n} chunks from {len(specs)} utterances "
              f"[{sp or 'all'}] -> {out_dir}")
    if not ran_split:
        specs = _discover(cfg)
        n = extract_corpus(
            specs, ds.pickle_dir, ds.chunk_samples, ds.least_samples,
            workers=os.cpu_count() or 1,
        )
        print(f"extracted {n} chunks from {len(specs)} utterances -> {ds.pickle_dir}")


def _make_loaders(cfg, trainer_cfg):
    from misonet_tpu.data import Batcher, ShardDataset

    ds = cfg.dataset
    train = Batcher(
        ShardDataset(ds.pickle_dir, ds.num_spks),
        trainer_cfg.batch_size,
        shuffle=True,
    )
    val_dir = ds.dev_pickle_dir or ds.pickle_dir
    val = Batcher(
        ShardDataset(val_dir, ds.num_spks), trainer_cfg.batch_size, shuffle=False
    )
    return train, val


def _load_miso1(cfg, model):
    """Cross-stage hand-off: restore frozen MISO1 params (run.py:101-109)."""
    from misonet_tpu.utils.checkpoint import load_checkpoint

    ckpt = Path(cfg.trainer_en.miso1_checkpoint)
    target = _state_shapes(cfg, model, cfg.dataset.num_ch_utilize)
    state, _ = load_checkpoint(ckpt.parent, ckpt.name, target)
    return state.params


def _state_shapes(cfg, model, num_ch: int):
    """Shapes and dtypes of a train state for ``model`` (no device work):
    the restore target of a checkpoint."""
    import jax.numpy as jnp

    from misonet_tpu.train.state import create_train_state, make_optimizer

    probe = jax.ShapeDtypeStruct((1, num_ch, 8, cfg.stft.num_bins),
                                 jnp.complex64)
    return jax.eval_shape(
        lambda x: create_train_state(
            model.init(jax.random.key(0), x), make_optimizer(cfg.optimizer)
        ),
        probe,
    )


def _train(cfg, args) -> None:
    from misonet_tpu.models import make_miso1, make_miso2, make_miso3
    from misonet_tpu.parallel.mesh import make_mesh_for_batch
    from misonet_tpu.train.trainer import EnhanceTrainer, SeparationTrainer
    from misonet_tpu.utils.writer import MetricWriter

    batch = cfg.trainer_sp.batch_size if args.target == "MISO1" else cfg.trainer_en.batch_size
    mesh = (
        make_mesh_for_batch(batch, cfg.mesh.num_devices)
        if len(jax.devices()) > 1
        else None
    )
    writer = MetricWriter(args.logdir, cfg.stft)

    if args.target == "MISO1":
        tr_cfg = cfg.trainer_sp
        train, val = _make_loaders(cfg, tr_cfg)
        trainer = SeparationTrainer(
            make_miso1(cfg.miso1),
            tr_cfg,
            cfg.optimizer,
            cfg.stft,
            cfg.dataset,
            train,
            val,
            mesh=mesh,
            writer=writer,
        )
    else:
        tr_cfg = cfg.trainer_en
        train, val = _make_loaders(cfg, tr_cfg)
        miso1 = make_miso1(cfg.miso1)
        miso1_params = _load_miso1(cfg, miso1)
        joint = args.target == "MISO2"
        model = (
            make_miso2(cfg.miso2) if joint else make_miso3(cfg.miso3)
        )
        trainer = EnhanceTrainer(
            model,
            miso1,
            miso1_params,
            tr_cfg,
            cfg.optimizer,
            cfg.stft,
            cfg.dataset,
            train,
            val,
            joint=joint,
            mesh=mesh,
            writer=writer,
        )
    trainer.train()


def _pit_np(est, refs) -> float:
    """Permutation-optimal mean SI-SDR, host-side numpy ([S, T] arrays)."""
    import itertools

    import numpy as np

    from misonet_tpu.metrics import numpy_si_sdr

    spks = range(est.shape[0])
    return float(max(
        np.mean([numpy_si_sdr(est[p[s]], refs[s]) for s in spks])
        for p in itertools.permutations(spks)
    ))


def _test_css(cfg, args) -> None:
    """-m Test -t CSS: stream each test utterance through the block-wise
    CSS pipeline (inference/css.py: running per-speaker SCMs + adaptive
    MVDR — beyond the reference, whose only long-form path is one
    host-side utterance SCM, tester.py:426-441).  Writes per-speaker
    MISO1 and Beamforming wavs and reports stage-wise PIT-SI-SDR."""
    import numpy as np

    from misonet_tpu.data.wavio import read_wav, write_wav
    from misonet_tpu.inference.css import StreamingCSS
    from misonet_tpu.models import make_miso1

    ds = cfg.dataset
    miso1 = make_miso1(cfg.miso1)
    css = StreamingCSS(miso1, _load_miso1(cfg, miso1), cfg.stft, ds)
    specs = _discover(cfg, args.split or ds.test_file)
    out = Path(args.logdir) / "wav_out"
    agg: dict[str, list[float]] = {"mixture": [], "miso1": [], "beamformed": []}
    for spec in specs[: args.max_utts]:
        mix, fs = read_wav(spec.mix_path)
        mix = mix[:, : ds.num_ch_utilize]
        res = css.process(mix, overlap=args.css_overlap)
        for stage in ("miso1", "beamformed"):
            for sp in range(res[stage].shape[0]):
                write_wav(
                    out / stage / f"{spec.utt_id}_{sp}.wav",
                    res[stage][sp], fs, subtype=args.wav_subtype,
                )
        if spec.source_paths:
            refs = np.stack([read_wav(p)[0] for p in spec.source_paths])
            n = min(refs.shape[-1], mix.shape[0])
            mix0 = np.stack([mix[:n, ds.ref_ch]] * refs.shape[0])
            agg["mixture"].append(_pit_np(mix0, refs[:, :n]))
            agg["miso1"].append(_pit_np(res["miso1"][:, :n], refs[:, :n]))
            agg["beamformed"].append(
                _pit_np(res["beamformed"][:, :n], refs[:, :n])
            )
    scores = {k: float(np.mean(v)) for k, v in agg.items() if v}
    print("mean PIT-SI-SDR per stage:", scores)


def _test(cfg, args) -> None:
    from misonet_tpu.inference.evaluate import CascadeEvaluator
    from misonet_tpu.models import make_miso1, make_miso2, make_miso3

    if args.target == "CSS":
        return _test_css(cfg, args)

    ds = cfg.dataset
    miso1 = make_miso1(cfg.miso1)
    miso1_params = _load_miso1(cfg, miso1)

    enhance_model = enhance_params = None
    joint = False
    if args.target in ("MISO2", "MISO3"):
        joint = args.target == "MISO2"
        enhance_model = make_miso2(cfg.miso2) if joint else make_miso3(cfg.miso3)
        # enhance params loaded from its own save_folder 'best'
        from misonet_tpu.utils.checkpoint import load_checkpoint

        cin = ds.num_ch_utilize + (2 * ds.num_spks if joint else 2)
        target = _state_shapes(cfg, enhance_model, cin)
        state, _ = load_checkpoint(cfg.trainer_en.save_folder, "best", target)
        enhance_params = state.params

    ev = CascadeEvaluator(
        miso1,
        miso1_params,
        cfg.stft,
        ds,
        enhance_model=enhance_model,
        enhance_params=enhance_params,
        joint=joint,
        beamform_utterance=args.target != "MISO1",
    )
    # Test mode walks the test split like the reference's tr_inference_flag
    # dispatch (run.py:245-250, tester.py:44-79); --split overrides.
    specs = _discover(cfg, args.split or ds.test_file)
    scores = ev.evaluate_corpus(
        specs, Path(args.logdir) / "wav_out", max_utts=args.max_utts,
        wav_subtype=args.wav_subtype, workers=args.eval_workers,
    )
    print("mean SI-SDR per stage:", scores)


if __name__ == "__main__":
    main()
