"""Tracing / profiling utilities.

The reference's only performance instrumentation is wall-clock ms/batch
prints (trainer.py:216-221).  Here: jax.profiler trace capture around any
code region (viewable in TensorBoard/Perfetto/XProf), a step timer that
reports the north-star audio-seconds/s metric, and device memory stats.
"""

from __future__ import annotations

import contextlib
import re
import time
from pathlib import Path

import jax


@contextlib.contextmanager
def trace(logdir: str | Path):
    """Capture a device trace for the enclosed region:

        with profiling.trace("logs/profile"):
            state, metrics = train_step(state, mix, ref)
            jax.block_until_ready(metrics)
    """
    Path(logdir).mkdir(parents=True, exist_ok=True)
    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Rolling throughput tracker: feed (seconds_of_audio) per step, read
    audio-seconds/s/chip (BASELINE.json north-star metric)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.samples: list[tuple[float, float]] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, audio_seconds: float) -> float:
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.samples.append((dt, audio_seconds))
        if len(self.samples) > self.window:
            self.samples.pop(0)
        return dt

    def discard(self) -> float:
        """Stop timing WITHOUT adding a sample to the throughput window
        (for steps with unknown audio content, which would otherwise
        deflate audio_seconds_per_second)."""
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return dt

    @property
    def audio_seconds_per_second(self) -> float:
        if not self.samples:
            return 0.0
        dt = sum(s[0] for s in self.samples)
        au = sum(s[1] for s in self.samples)
        return au / dt if dt > 0 else 0.0


def trace_lines(logdir: str | Path, plane_prefix: str = "/device:GPU"):
    """Events of the newest jax.profiler trace under ``logdir``, grouped
    by line ("XLA Ops", "XLA Modules", one line per CUDA stream, ...) of
    every plane whose name starts with ``plane_prefix``:
    {line name: {event name: total ms}}."""
    paths = sorted(Path(logdir).glob("plugins/profile/*/*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir}")
    data = jax.profiler.ProfileData.from_file(str(paths[-1]))
    lines: dict[str, dict[str, float]] = {}
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            agg = lines.setdefault(line.name, {})
            for ev in line.events:
                agg[ev.name] = agg.get(ev.name, 0.0) + ev.duration_ns / 1e6
    return lines


def top_ops(lines: dict[str, dict[str, float]], n: int = 10) -> list[tuple[str, float]]:
    """The ``n`` longest ops of a trace_lines() result, from its "XLA Ops"
    line (one event per HLO op) when present, else from all lines."""
    ops = lines.get("XLA Ops")
    if ops is None:
        ops = {}
        for agg in lines.values():
            for k, v in agg.items():
                ops[k] = ops.get(k, 0.0) + v
    return sorted(ops.items(), key=lambda kv: -kv[1])[:n]


_HLO_OP_NAME = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?metadata=\{[^}]*?op_name="([^"]*)"',
    re.M,
)


def hlo_op_names(hlo_text: str) -> dict[str, str]:
    """HLO instruction -> its ``op_name`` metadata, the jax.named_scope path
    (e.g. ``jit(features)/mvdr/.../loaded_solve/lu``), read from the text
    of a compiled program (``compiled.as_text()``)."""
    return {m[1]: m[2] for m in _HLO_OP_NAME.finditer(hlo_text)}


def event_hlo_op(stats: dict, kernel: str, known: dict) -> str | None:
    """The HLO op of ``known`` (op -> anything) a trace event ran for: its
    ``hlo_op`` stat.  Kernels replayed from a command buffer (a CUDA graph)
    carry only ``hlo_op=command_buffer``; XLA names their kernels after
    the fusion (``loop_add_fusion_3`` for ``loop_add_fusion.3``)."""
    op = stats.get("hlo_op")
    if op in known:
        return op
    for name in (re.sub(r"_(\d+)$", r".\1", kernel), kernel):
        if name in known:
            return name
    return None


def _scopes_of(op_name: str) -> set[str]:
    """Scope names on an op_name path, with transform wrappers such as
    ``vmap(...)`` or ``transpose(jvp(...))`` taken off."""
    return {re.sub(r"^(?:[\w.]+\()+", "", part).rstrip(")")
            for part in op_name.split("/")}


def scope_device_ms(
    logdir: str | Path,
    hlo_text: str,
    scopes: tuple[str, ...],
    plane_prefix: str = "/device:GPU",
    line_prefix: str = "Stream",
) -> dict[str, float]:
    """Device time of one traced program split by named scope.

    Each event of the newest trace under ``logdir`` (kernels on the lines
    starting with ``line_prefix`` of the planes starting with
    ``plane_prefix``) names the HLO op it ran for (``event_hlo_op``);
    ``hlo_text`` gives that op's scope path.  Returns {scope: ms} for
    each of ``scopes``, plus ``total`` (every event of an op of this
    program) and ``unattributed`` (events naming no op of it)."""
    paths = sorted(Path(logdir).glob("plugins/profile/*/*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir}")
    names = hlo_op_names(hlo_text)
    out = dict.fromkeys((*scopes, "total", "unattributed"), 0.0)
    data = jax.profiler.ProfileData.from_file(str(paths[-1]))
    for plane in data.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            if not line.name.startswith(line_prefix):
                continue
            for ev in line.events:
                ms = ev.duration_ns / 1e6
                op = event_hlo_op(dict(ev.stats), ev.name, names)
                if op not in names:
                    out["unattributed"] += ms
                    continue
                out["total"] += ms
                on_path = _scopes_of(names[op])
                for s in scopes:
                    if s in on_path:
                        out[s] += ms
    return out


class CompileLog:
    """Seconds of every XLA compilation in this process, by program, from
    jax.monitoring (a persistent-cache hit shows as a short compile).
    ``mark()`` then ``since(mark)`` gives one stretch of work's compiles;
    ``close()`` stops listening."""

    _EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        self.events: list[tuple[str, float]] = []
        jax.monitoring.register_event_duration_secs_listener(self._record)

    def _record(self, event: str, seconds: float, **kw) -> None:
        if event == self._EVENT:
            self.events.append((str(kw.get("fun_name", "?")), seconds))

    def mark(self) -> int:
        return len(self.events)

    def since(self, mark: int = 0) -> list[tuple[str, float]]:
        return self.events[mark:]

    def close(self) -> None:
        jax.monitoring.unregister_event_duration_listener(self._record)


def device_memory_stats() -> dict:
    """Per-device memory stats where the backend exposes them."""
    out = {}
    for d in jax.devices():
        try:
            out[str(d)] = d.memory_stats()
        except Exception:
            out[str(d)] = None
    return out
