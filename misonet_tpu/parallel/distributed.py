"""Multi-host bootstrap.

The reference has no distributed story (single GPU, SURVEY.md §2.10); this
is the multi-host entry: call :func:`initialize` once at process start on
every host of a multi-host job, then build the mesh with parallel.make_mesh()
(which sees all devices across hosts) and shard per-host input with
(host_index(), host_count()) in the data layer.

Environment conventions follow jax.distributed.initialize: set
JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID (a cluster
manager that JAX detects, such as SLURM, may supply them instead).
"""

from __future__ import annotations

import os

import jax


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize jax.distributed when running multi-process; no-op for
    single-process runs (so the same entry point works everywhere)."""
    num = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if num <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address
        or os.environ.get("JAX_COORDINATOR_ADDRESS"),
        num_processes=num,
        process_id=(
            process_id
            if process_id is not None
            else int(os.environ.get("JAX_PROCESS_ID", "0"))
        ),
    )


def host_index() -> int:
    return jax.process_index()


def host_count() -> int:
    return jax.process_count()
