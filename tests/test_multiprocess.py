"""True multi-process distributed coverage (SURVEY.md §4): two OS
processes bootstrap through ``parallel.distributed.initialize`` (env-var
plumbing: JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID)
on the CPU backend with 4 local devices each, build the 8-device global
mesh, run ONE DP train step on identical seeded data, and report the
loss — which must match the single-process 8-device mesh result exactly
(the gradient psum rides the distributed runtime instead of
shared-memory collectives).

This is the in-container correctness proxy for the multi-host pod path
(BASELINE.md north star: >=90% scaling at 2 hosts): the same bootstrap,
mesh construction, per-process data placement, and collective compilation
run here, minus the device interconnect.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.slow

_WORKER = """
import json, os, sys

sys.path.insert(0, os.getcwd())  # worker runs with cwd = repo root

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)

from misonet_tpu.parallel.distributed import initialize, host_index, host_count

initialize()  # reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
assert host_count() == 2, host_count()

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from misonet_tpu.config import ModelConfig, OptimizerConfig
from misonet_tpu.models import make_miso1
from misonet_tpu.parallel import make_mesh
from misonet_tpu.train import create_train_state, make_optimizer, make_separate_train_step

SMALL = ModelConfig(
    num_bottleneck=4,
    en_channels=(8, 8, 8, 16),
    de_channels=(16, 8, 8, 8),
    tcn_repeats=1,
    tcn_blocks=2,
    tcn_channels=16,
    compute_dtype="float32",
)
B, C, T, F = 8, 3, 16, 17

mesh = make_mesh()
assert mesh.devices.size == 8, mesh.devices

rng = np.random.default_rng(0)
mix = (rng.standard_normal((B, C, T, F)) + 1j * rng.standard_normal((B, C, T, F))).astype(np.complex64)
ref = ((rng.standard_normal((B, 2, T, F)) + 1j * rng.standard_normal((B, 2, T, F))) * 0.1).astype(np.complex64)

model = make_miso1(SMALL)
params = jax.jit(model.init)(jax.random.key(1), jnp.asarray(mix[:1]))
opt = make_optimizer(OptimizerConfig(lr=1e-3))
state = create_train_state(params, opt)

repl = NamedSharding(mesh, P())
data = NamedSharding(mesh, P(mesh.axis_names[0]))
# per-process data placement: each process owns its addressable row shards
state_g = jax.tree.map(
    lambda x: jax.make_array_from_process_local_data(repl, np.asarray(x)), state
)
local_rows = slice(host_index() * (B // 2), (host_index() + 1) * (B // 2))
mix_g = jax.make_array_from_process_local_data(data, mix[local_rows])
ref_g = jax.make_array_from_process_local_data(data, ref[local_rows])

step = make_separate_train_step(model, opt, mesh=mesh)
new_state, metrics = step(state_g, mix_g, ref_g)
loss = float(np.asarray(jax.device_get(metrics["loss"])))
gnorm = float(np.asarray(jax.device_get(metrics["grad_norm"])))
if host_index() == 0:
    print("RESULT " + json.dumps({"loss": loss, "grad_norm": gnorm}), flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _single_process_reference() -> dict:
    """Same step on this process's own 8-device mesh."""
    import jax
    import jax.numpy as jnp
    from misonet_tpu.config import ModelConfig, OptimizerConfig
    from misonet_tpu.models import make_miso1
    from misonet_tpu.parallel import make_mesh, replicate, shard_batch
    from misonet_tpu.train import (
        create_train_state,
        make_optimizer,
        make_separate_train_step,
    )

    small = ModelConfig(
        num_bottleneck=4,
        en_channels=(8, 8, 8, 16),
        de_channels=(16, 8, 8, 8),
        tcn_repeats=1,
        tcn_blocks=2,
        tcn_channels=16,
        compute_dtype="float32",
    )
    b, c, t, f = 8, 3, 16, 17
    rng = np.random.default_rng(0)
    mix = (
        rng.standard_normal((b, c, t, f)) + 1j * rng.standard_normal((b, c, t, f))
    ).astype(np.complex64)
    ref = (
        (rng.standard_normal((b, 2, t, f)) + 1j * rng.standard_normal((b, 2, t, f)))
        * 0.1
    ).astype(np.complex64)
    model = make_miso1(small)
    params = jax.jit(model.init)(jax.random.key(1), jnp.asarray(mix[:1]))
    opt = make_optimizer(OptimizerConfig(lr=1e-3))
    state = create_train_state(params, opt)
    mesh = make_mesh()
    state = replicate(state, mesh)
    smix, sref = shard_batch((jnp.asarray(mix), jnp.asarray(ref)), mesh)
    step = make_separate_train_step(model, opt, mesh=mesh)
    _, metrics = step(state, smix, sref)
    return {
        "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]),
    }


def test_two_process_dp_matches_single_process(tmp_path):
    port = _free_port()
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
        )
        # drop any inherited single-process device-count overrides
        env.pop("XLA_FLAGS", None)
        procs.append(
            subprocess.Popen(
                [sys.executable, str(worker)],
                env=env,
                cwd=str(Path(__file__).resolve().parent.parent),
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out)
        assert p.returncode == 0, out[-3000:]
    result = None
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                result = json.loads(line[len("RESULT "):])
    assert result is not None, outs[0][-2000:]

    ref = _single_process_reference()
    # identical data, identical init, same 8-device partitioning -> the
    # distributed gradient reduction must reproduce the single-process
    # numbers to float32 roundoff
    assert result["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    assert result["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-4)
