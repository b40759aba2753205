"""The parameter tree of MISO1/2/3 on the SMS-WSJ and REVERB plans keeps the
exact paths, shapes and dtypes that checkpoints were written with
(tests/fixtures/flax_param_tree.json, generated from the module tree the
models were first built as)."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from misonet_tpu.config import load_yaml
from misonet_tpu.models import make_miso1, make_miso2, make_miso3

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = json.loads((ROOT / "tests" / "fixtures" / "flax_param_tree.json").read_text())
PLANS = {"smswsj": "smswsj.yml", "reverb_2mix": "reverb_2mix.yml"}


@pytest.mark.parametrize("model", ["miso1", "miso2", "miso3"])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_param_tree_matches_fixture(plan, model):
    cfg = load_yaml(ROOT / "configs" / PLANS[plan])
    c, f, s = cfg.dataset.num_ch_utilize, cfg.stft.num_bins, cfg.dataset.num_spks
    net, cin = {
        "miso1": (make_miso1(cfg.miso1), c),
        "miso2": (make_miso2(cfg.miso2), c + 2 * s),
        "miso3": (make_miso3(cfg.miso3), c + 2),
    }[model]
    x = jax.ShapeDtypeStruct((1, cin, 8, f), jnp.complex64)
    tree = jax.eval_shape(net.init, jax.random.key(0), x)
    got = {
        "/".join(k.key for k in path): [list(v.shape), str(v.dtype)]
        for path, v in jax.tree_util.tree_leaves_with_path(tree)
    }
    want = FIXTURE[f"{plan}/{model}"]
    assert sorted(set(got) ^ set(want)) == []
    assert got == want
