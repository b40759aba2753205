"""The YAML-subset reader of config.py gives what yaml.safe_load gives on
every config layout the repo reads (reference NN_BSS.yml layout)."""

from pathlib import Path

import pytest

from misonet_tpu.config import parse_yaml
from test_cli import TINY_CONFIG

yaml = pytest.importorskip("yaml")

ROOT = Path(__file__).resolve().parents[1]
DOCS = {
    "smswsj": (ROOT / "configs" / "smswsj.yml").read_text(),
    "reverb_2mix": (ROOT / "configs" / "reverb_2mix.yml").read_text(),
    "cli_tiny": TINY_CONFIG.format(root="/data/run 1"),
}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_parse_yaml_matches_safe_load(name):
    assert parse_yaml(DOCS[name]) == yaml.safe_load(DOCS[name])


def test_parse_yaml_scalars_and_errors():
    text = """
top:
  a: 1   # trailing comment
  b: "x # not a comment"
  c: [True, 1]
  d: [False, ""]
  e:
  f: 0.000005
  g: -5.0
  h: data/x/
  i: yes
  j: 1e5
  k: []
other: plain text
"""
    assert parse_yaml(text) == yaml.safe_load(text)
    with pytest.raises(ValueError, match="YAML subset"):
        parse_yaml("a: 1\n  b: 2\n")
    with pytest.raises(ValueError, match="YAML subset"):
        parse_yaml("- item\n")
