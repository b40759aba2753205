"""Checkpoint / resume as one ``.npz`` per tag.

Reference counterpart: torch.save dicts of {model_state_dict, optimizer,
epoch, tr/val loss arrays} every N epochs + best-model save
(trainer.py:88-99, :126-139) and resume from config (trainer.py:54-71), plus
cross-stage hand-off of the frozen MISO1 parameters into enhancement
training/testing (run.py:101-109, :137-145).

Layout: ``<dir>/<tag>`` is an npz archive of the train state pytree
(params, opt_state, step), one array per leaf keyed by its tree path
(``jax.tree_util.keystr``); ``<dir>/<tag>.meta.json`` holds the host-side
metadata (epoch, loss history, scheduler state).  A save writes a
temporary file and renames it, so a crash never leaves a torn checkpoint
under the tag.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

_META = ".meta.json"


def save_checkpoint(
    directory: str | Path,
    tag: str,
    state: Any,
    metadata: dict | None = None,
) -> Path:
    """Save a pytree under <directory>/<tag> (e.g. 'epoch005', 'best')."""
    path = (Path(directory) / tag).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {
        jax.tree_util.keystr(k): np.asarray(v)
        for k, v in jax.tree_util.tree_leaves_with_path(jax.device_get(state))
    }
    tmp = path.with_name(f".{tag}.tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    if metadata is not None:
        meta = path.with_name(f"{tag}{_META}")
        meta_tmp = path.with_name(f".{tag}{_META}.tmp")
        meta_tmp.write_text(json.dumps(metadata, default=_json_default))
        os.replace(meta_tmp, meta)
    return path


def load_checkpoint(
    directory: str | Path, tag: str, target: Any
) -> tuple[Any, dict]:
    """Restore a pytree saved by save_checkpoint into the structure, shapes
    and dtypes of ``target`` (arrays, or jax.ShapeDtypeStruct leaves from
    jax.eval_shape).  Returns (state, metadata)."""
    path = (Path(directory) / tag).absolute()
    leaves, treedef = jax.tree_util.tree_flatten_with_path(target)
    restored = []
    with np.load(path) as data:
        missing = [jax.tree_util.keystr(k) for k, _ in leaves
                   if jax.tree_util.keystr(k) not in data.files]
        if missing:
            raise KeyError(f"{path}: no arrays for {missing[:5]} "
                           f"({len(missing)} leaves missing)")
        for k, ref in leaves:
            arr = data[jax.tree_util.keystr(k)]
            shape = tuple(getattr(ref, "shape", np.shape(ref)))
            if arr.shape != shape:
                raise ValueError(
                    f"{path}: {jax.tree_util.keystr(k)} has shape "
                    f"{arr.shape}, target {shape}"
                )
            restored.append(
                jnp.asarray(arr, dtype=getattr(ref, "dtype", np.result_type(ref)))
            )
    meta_path = path.with_name(f"{tag}{_META}")
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return jax.tree_util.tree_unflatten(treedef, restored), meta


def latest_checkpoint(directory: str | Path) -> str | None:
    """Most recent epochNNN tag in a checkpoint dir ('best' excluded)."""
    root = Path(directory)
    if not root.exists():
        return None
    epochs = sorted(
        p.name for p in root.iterdir()
        if p.name.startswith("epoch") and not p.name.endswith(_META)
    )
    return epochs[-1] if epochs else None


def _json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(type(o))
