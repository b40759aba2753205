"""The trace reduction of utils/profiling.py on a small CPU trace."""

import jax
import jax.numpy as jnp
import pytest

from misonet_tpu.utils.profiling import (CompileLog, _scopes_of,
                                         event_hlo_op, hlo_op_names,
                                         scope_device_ms, top_ops, trace,
                                         trace_lines)


def test_trace_lines_and_top_ops(tmp_path):
    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((128, 128))
    jax.block_until_ready(f(x))
    with trace(tmp_path):
        for _ in range(3):
            jax.block_until_ready(f(x))
    lines = trace_lines(tmp_path, plane_prefix="/host:CPU")
    assert lines and all(v >= 0 for agg in lines.values() for v in agg.values())
    top = top_ops(lines, n=5)
    assert 0 < len(top) <= 5
    assert [ms for _, ms in top] == sorted((ms for _, ms in top), reverse=True)
    assert top_ops({"XLA Ops": {"a": 1.0, "b": 3.0}, "Other": {"c": 9.0}}) == [
        ("b", 3.0), ("a", 1.0)]


def _scoped(x):
    with jax.named_scope("outer"):
        y = jnp.sin(x)
        with jax.named_scope("inner"):
            y = jnp.linalg.solve(y + 3.0 * jnp.eye(x.shape[0]), x)
    return jax.vmap(lambda r: r @ x)(y)


def test_scope_device_ms_splits_by_named_scope(tmp_path):
    f = jax.jit(_scoped)
    x = jnp.ones((64, 64))
    compiled = f.lower(x).compile()
    jax.block_until_ready(compiled(x))
    with trace(tmp_path):
        jax.block_until_ready(compiled(x))
    names = hlo_op_names(compiled.as_text())
    assert any("inner" in v.split("/") for v in names.values())
    ms = scope_device_ms(tmp_path, compiled.as_text(), ("outer", "inner"),
                         plane_prefix="/host:CPU", line_prefix="tf_XLA")
    assert ms["total"] > 0 and ms["inner"] > 0
    assert ms["inner"] <= ms["outer"] <= ms["total"]


@pytest.mark.parametrize("op_name, scope", [
    ("jit(f)/mvdr/vmap(jit(mvdr_beamform))/loaded_solve/lu", "loaded_solve"),
    ("jit(step)/transpose(jvp(enc0_dense))/conv", "enc0_dense"),
    ("jit(features)/vmap(mvdr)/dot_general", "mvdr"),
])
def test_scopes_of_unwraps_transforms(op_name, scope):
    assert scope in _scopes_of(op_name)
    assert "loaded" not in _scopes_of(op_name)


def test_compile_log_records_each_program():
    log = CompileLog()
    try:
        mark = log.mark()
        jax.jit(lambda x: x * 3.0 + 1.0)(jnp.ones(7))
        jax.jit(lambda x: jnp.cos(x))(jnp.ones(5))
        got = log.since(mark)
    finally:
        log.close()
    assert len(got) >= 2
    assert all(isinstance(n, str) and s >= 0 for n, s in got)
    n = len(log.events)
    jax.jit(lambda x: x - 2.0)(jnp.ones(3))
    assert len(log.events) == n      # closed: no longer listening


@pytest.mark.parametrize("stats, kernel, op", [
    ({"hlo_op": "command_buffer"}, "loop_add_fusion_3", "loop_add_fusion.3"),
    ({"hlo_op": "command_buffer"}, "wrapped_transpose", "wrapped_transpose"),
    ({"hlo_op": "command_buffer"}, "void gemmSN_NN_kernel<float>", None),
    ({"hlo_op": "fusion.2"}, "any_kernel", "fusion.2"),
    ({"correlation_id": 12}, "memcpy32_post", None),
])
def test_event_hlo_op_resolves_command_buffer_kernels(stats, kernel, op):
    known = {"loop_add_fusion.3": "a", "wrapped_transpose": "b", "fusion.2": "c"}
    assert event_hlo_op(stats, kernel, known) == op
