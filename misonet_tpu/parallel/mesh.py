"""Device mesh and sharding layer.

The reference is strictly single-GPU (run.py:68: ``.cuda(gpu_num)``; no
torch.distributed anywhere — SURVEY.md §2.10).  Here distribution is a
first-class component: a 1-D ``data`` mesh over all devices, batches sharded
along it, parameters replicated, and gradient reduction left to XLA's
partitioner (it inserts the psum over the device interconnect from the sharding annotations —
the scaling-book recipe: pick a mesh, annotate shardings, let XLA insert
collectives).

The MISO nets are ~6M params and attention-free, so DP is the idiomatic
scale-out (SURVEY.md §2.10: TP/PP/EP explicitly out of scope).  Sequence
(time-axis) sharding for long-form input lives in beamforming/scm.py where
the collective accumulation actually needs it.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(num_devices: int = 0, axis: str = "data") -> Mesh:
    """1-D data-parallel mesh over the first ``num_devices`` devices
    (all visible devices when 0)."""
    devices = jax.devices()
    if num_devices:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (axis,))


def make_mesh_for_batch(batch_size: int, num_devices: int = 0, axis: str = "data") -> Mesh:
    """Data mesh whose size divides ``batch_size``: uses the largest
    divisor of the batch not exceeding the device count, so any batch size
    shards cleanly (jit requires the batch axis divisible by the mesh)."""
    avail = num_devices or len(jax.devices())
    size = 1
    for d in range(min(avail, batch_size), 0, -1):
        if batch_size % d == 0:
            size = d
            break
    return make_mesh(size, axis)


def data_spec(mesh: Mesh, ndim: int) -> NamedSharding:
    """Sharding for a batch-leading array: shard axis 0 over the data axis,
    replicate the rest."""
    axis = mesh.axis_names[0]
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def shard_batch(batch, mesh: Mesh):
    """Place every array in a pytree with its leading axis sharded over the
    mesh's data axis (per-host input sharding boundary)."""
    return jax.tree.map(
        lambda x: jax.device_put(x, data_spec(mesh, np.ndim(x))), batch
    )


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (params / optimizer state) across the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)
