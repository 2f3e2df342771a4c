"""Profiling / tracing — formalizing the reference's stdout stage timers.

The reference prints per-stage wall-times around every CUDA wrapper
(myApp.cu:885-907: updatePrimaryRayDirection / getSampleColors /
blendSampleColors) and the octree build time (myApp.cu:308-312).  Here the
same intent is covered by:

  * :class:`StageTimer` — named wall-clock stages with a report table
    (blocks on device results so times are real).
  * :func:`trace` — context manager around ``jax.profiler`` traces for
    XLA timeline capture (viewable in XProf/TensorBoard).
  * :func:`time_frames` — median device time of a jitted call, and
    :func:`require_gpu` / :func:`card_info` for the scripts that measure
    on the card (chip_smoke.py, bench.py).
"""

from __future__ import annotations

import contextlib
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Tuple

import jax


class StageTimer:
    def __init__(self) -> None:
        self.stages: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        out = {}
        try:
            yield out
        finally:
            for v in out.values():
                jax.block_until_ready(v)
            self.stages.append((name, time.perf_counter() - t0))

    def record(self, name: str, seconds: float) -> None:
        self.stages.append((name, seconds))

    def report(self) -> str:
        width = max((len(n) for n, _ in self.stages), default=5)
        lines = [f"{n:<{width}}  {t * 1e3:10.2f} ms" for n, t in self.stages]
        total = sum(t for _, t in self.stages)
        lines.append(f"{'total':<{width}}  {total * 1e3:10.2f} ms")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.stages)


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (open in XProf / TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_frames(fn: Callable, *args, frames: int = 5,
                warmup: int = 1) -> Tuple[float, List[float]]:
    """(median ms, all ms) of ``fn(*args)`` over ``frames`` calls after
    ``warmup`` untimed ones; each call is timed to ``block_until_ready``."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def require_gpu() -> None:
    """Exit with an error unless JAX's default device is a GPU: numbers
    taken anywhere else are not numbers of the card."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"error: no GPU found (JAX's default device is {dev.platform!r}); "
            "this script measures the card and does not run elsewhere")


def card_info() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` lines, one per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_time_by_op(trace_dir: str, top: int = 8) -> Dict[str, object]:
    """Reduce the newest ``jax.profiler`` trace under ``trace_dir``: the
    device time (ms) of each operation summed over the GPU stream lines,
    the device busy time, and the window from first start to last end."""
    import glob
    import os

    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    data = ProfileData.from_file(max(paths, key=os.path.getmtime))
    per_op: Dict[str, float] = {}
    spans = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                per_op[ev.name] = per_op.get(ev.name, 0.0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        raise ValueError("the trace holds no GPU stream events")
    spans.sort()
    busy, end = 0.0, spans[0][0]
    for a, b in spans:  # union of the intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    window = spans[-1][1] - spans[0][0]
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_ms": busy / 1e6, "window_ms": window / 1e6,
            "ops_ms": {k: round(v / 1e6, 4) for k, v in ops}}
