"""End-to-end CLI smoke test: Extraction -> Train(MISO1) -> Test over a tiny
synthetic corpus through run.py's code paths (reference run.py modes)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]

# tiny plan over a corpus at {root}/corpus (3 mics, 4 U-Net levels)
TINY_CONFIG = """SMS_WSJ:
  rootdir: {root}/corpus/
  fs: 8000
  chunk_time: 0.25
  least_time: 0.125
  num_spks: 2
  num_ch: 3
  num_ch_utilize: 3
  ref_ch: 0
  saved_tr_pickle_dir: {root}/shards/
  saved_dt_pickle_dir: {root}/shards/
STFT:
  fs: 8000
  window: hann
  length: 32
  overlap: 24
dataloader:
  Train:
    batch_size: 2
MISO_1:
  num_bottleneck: 4
  en_bottleneck_channels: [8, 8, 8, 16]
  de_bottleneck_channels: [16, 8, 8, 8]
  norm_type: IN
MISO_3:
  num_bottleneck: 4
  en_bottleneck_channels: [8, 8, 8, 16]
  de_bottleneck_channels: [16, 8, 8, 8]
  norm_type: IN
trainer_sp:
  epochs: 1
  print_freq: 100
  save_folder: {root}/model_result/miso1
  check_point: [True, 1]
trainer_en:
  epochs: 1
  print_freq: 100
  MISO1_path: {root}/model_result/miso1/best
  save_folder: {root}/model_result/miso3
  check_point: [True, 1]
optimizer:
  name: Adam
  lr: 0.001
scheduler:
  name: plateau
  factor: 0.5
  patience: 3
  min_lr: 0.000005
"""


def write_tiny_corpus(root: Path) -> Path:
    """3 utterances of 3-mic mixtures under root/corpus, plus the tiny
    config pointing at them; returns the config path."""
    from misonet_tpu.data.synthetic import synth_mixture
    from misonet_tpu.data.wavio import write_wav

    obs = root / "corpus" / "observation"
    src = root / "corpus" / "speech_source"
    obs.mkdir(parents=True)
    src.mkdir(parents=True)
    for u in range(3):
        d = synth_mixture(u, num_samples=2500, num_ch=3)
        write_wav(obs / f"utt{u}.wav", d["mix"], 8000)
        for s in range(2):
            write_wav(src / f"utt{u}_{s}.wav", d["ref"][s], 8000)

    cfg = root / "tiny.yml"
    cfg.write_text(TINY_CONFIG.format(root=root))
    return cfg


@pytest.fixture(scope="module")
def corpus_and_config(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    return root, write_tiny_corpus(root)


def _run(args, cwd):
    """Invoke run.py in-process (subprocess would lose the CPU conftest).
    Loaded by explicit path so a same-named module elsewhere on sys.path
    (e.g. the reference repo added by the parity test) can never shadow it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("misonet_run", ROOT / "run.py")
    run_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_mod)

    old = sys.argv
    sys.argv = ["run.py"] + args
    try:
        run_mod.main()
    finally:
        sys.argv = old


def test_cli_extraction(corpus_and_config):
    root, cfg = corpus_and_config
    _run(["-c", str(cfg), "-m", "Extraction"], ROOT)
    shards = list((root / "shards").glob("*.npz"))
    assert len(shards) >= 3


def test_cli_config_dir_resolution(corpus_and_config, monkeypatch):
    """-c <dir> -d <dataset> resolves <dir>/<dataset>.yml (the reference
    takes a config *directory*, run.py:280, but then ignores -d)."""
    root, cfg = corpus_and_config
    cfgdir = root / "cfgdir"
    cfgdir.mkdir(exist_ok=True)
    (cfgdir / "smswsj.yml").write_text(cfg.read_text())
    _run(["-c", str(cfgdir), "-d", "SMS_WSJ", "-m", "Extraction", "-u", "1"],
         ROOT)
    assert list((root / "shards").glob("*.npz"))


def test_cli_extraction_reverb(tmp_path):
    """-d REVERB_2MIX dispatches the REVERB corpus discovery (mixture
    '<utt>.wav' + '<utt>_s<k>.wav' sources at the corpus root)."""
    from misonet_tpu.data.synthetic import synth_mixture
    from misonet_tpu.data.wavio import write_wav

    corpus = tmp_path / "corpus"
    corpus.mkdir()
    for u in range(2):
        d = synth_mixture(u, num_samples=2500, num_ch=3)
        write_wav(corpus / f"utt{u}.wav", d["mix"], 8000)
        for s in range(2):
            write_wav(corpus / f"utt{u}_s{s}.wav", d["ref"][s], 8000)

    cfg = tmp_path / "reverb.yml"
    cfg.write_text(f"""
REVERB_2MIX:
  rootdir: {corpus}/
  fs: 8000
  chunk_time: 0.25
  least_time: 0.125
  num_spks: 2
  num_ch: 3
  saved_tr_pickle_dir: {tmp_path}/shards/
""")
    _run(["-c", str(cfg), "-d", "REVERB_2MIX", "-m", "Extraction"], ROOT)
    assert list((tmp_path / "shards").glob("*.npz"))


def test_cli_extraction_rir_mixing(tmp_path):
    """-d RIR_mixing dispatches the premixed-RIR discovery
    ('<utt>_mix.wav' + '<utt>_ref<k>.wav')."""
    from misonet_tpu.data.synthetic import synth_mixture
    from misonet_tpu.data.wavio import write_wav

    corpus = tmp_path / "corpus"
    corpus.mkdir()
    d = synth_mixture(0, num_samples=2500, num_ch=3)
    write_wav(corpus / "utt0_mix.wav", d["mix"], 8000)
    for s in range(2):
        write_wav(corpus / f"utt0_ref{s + 1}.wav", d["ref"][s], 8000)

    cfg = tmp_path / "rir.yml"
    cfg.write_text(f"""
RIR_mixing:
  rootdir: {corpus}/
  fs: 8000
  chunk_time: 0.25
  least_time: 0.125
  num_spks: 2
  num_ch: 3
  saved_tr_pickle_dir: {tmp_path}/shards/
""")
    _run(["-c", str(cfg), "-d", "RIR_mixing", "-m", "Extraction"], ROOT)
    assert list((tmp_path / "shards").glob("*.npz"))


@pytest.fixture()
def shards(corpus_and_config):
    """Ensure extraction has produced shards — keeps the slow train/test
    CLI tests self-contained when run without the (fast) extraction test
    (e.g. ``pytest -m slow``)."""
    root, cfg = corpus_and_config
    if not list((root / "shards").glob("*.npz")):
        _run(["-c", str(cfg), "-m", "Extraction"], ROOT)
    return root, cfg


@pytest.mark.slow
def test_cli_train_miso1(shards):
    root, cfg = shards
    _run(["-c", str(cfg), "-m", "Train", "-t", "MISO1",
          "-n", str(root / "logs")], ROOT)
    assert (root / "model_result/miso1/best").exists()


@pytest.mark.slow
def test_cli_test_miso1(shards):
    root, cfg = shards
    if not (root / "model_result/miso1/best").exists():
        # self-contained when run without test_cli_train_miso1 (-k/-x runs)
        _run(["-c", str(cfg), "-m", "Train", "-t", "MISO1",
              "-n", str(root / "logs")], ROOT)
    # tiny model config must also drive _load_miso1's probe width via config
    _run(["-c", str(cfg), "-m", "Test", "-t", "MISO1",
          "-n", str(root / "eval"), "--max-utts", "1",
          "--wav-subtype", "PCM_24"], ROOT)
    wavs = list((root / "eval" / "wav_out").rglob("*.wav"))
    assert len(wavs) >= 2
    # PCM_24 wavs read back identically to the int16 quantization
    from misonet_tpu.data.wavio import read_wav

    data, sr = read_wav(wavs[0])
    assert np.isfinite(data).all() and sr > 0


def test_cli_test_css(corpus_and_config):
    """-m Test -t CSS streams utterances through the block-wise CSS
    pipeline (run.py _test_css).  Fast: the MISO1 'best' checkpoint is
    synthesized (init + save) rather than trained."""
    root, cfg = corpus_and_config
    best = root / "model_result/miso1/best"
    if not best.exists():
        import jax
        import jax.numpy as jnp

        from misonet_tpu.config import load_yaml
        from misonet_tpu.models import make_miso1
        from misonet_tpu.train.state import create_train_state, make_optimizer
        from misonet_tpu.utils.checkpoint import save_checkpoint

        c = load_yaml(cfg)
        model = make_miso1(c.miso1)
        probe = jax.lax.complex(
            jnp.zeros((1, c.dataset.num_ch_utilize, 8, c.stft.num_bins)),
            jnp.zeros((1, c.dataset.num_ch_utilize, 8, c.stft.num_bins)),
        )
        params = model.init(jax.random.key(0), probe)
        state = create_train_state(params, make_optimizer(c.optimizer))
        save_checkpoint(best.parent, best.name, state, {})

    _run(["-c", str(cfg), "-m", "Test", "-t", "CSS",
          "-n", str(root / "css_eval"), "--max-utts", "2",
          "--css-overlap", "500"], ROOT)
    wavs = list((root / "css_eval" / "wav_out").rglob("*.wav"))
    # 2 utts x 2 speakers x 2 stages (miso1 + beamformed)
    assert len(wavs) == 8, wavs


def test_cli_runs_without_flax_orbax_yaml(tmp_path):
    """The main path imports none of flax, orbax or PyYAML: with the three
    blocked, Extraction -> Train MISO1 -> Test MISO1 runs end to end."""
    cfg = write_tiny_corpus(tmp_path)
    script = f"""
import sys
sys.modules["flax"] = sys.modules["orbax"] = sys.modules["yaml"] = None
sys.path.insert(0, {str(ROOT)!r})
import jax
jax.config.update("jax_platforms", "cpu")
import importlib.util
spec = importlib.util.spec_from_file_location("misonet_run", {str(ROOT / "run.py")!r})
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
for args in (["-m", "Extraction"], ["-m", "Train", "-t", "MISO1"],
             ["-m", "Test", "-t", "MISO1", "--max-utts", "1"]):
    sys.argv = ["run.py", "-c", {str(cfg)!r}, "-n", {str(tmp_path / "logs")!r}] + args
    run.main()
for name in ("flax", "orbax", "yaml"):
    assert sys.modules[name] is None, name
print("BLOCKED-IMPORT FLOW OK")
"""
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "BLOCKED-IMPORT FLOW OK" in proc.stdout
    assert (tmp_path / "model_result/miso1/best").is_file()
    assert list((tmp_path / "logs" / "wav_out").rglob("*.wav"))
