"""Render statistics and profiling (SURVEY.md §5).

The reference only has TODO hooks (ProfilePhase / STAT_COUNTER comments,
film.rs:314, light.rs:47-49).  Here: a process-wide counter registry plus
a ``jax.profiler`` trace context for device timeline capture.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

_lock = threading.Lock()
_counters: dict = defaultdict(int)
_timers: dict = defaultdict(float)


def count(name: str, n: int = 1) -> None:
    with _lock:
        _counters[name] += n


@contextlib.contextmanager
def timed(name: str):
    t0 = time.time()
    try:
        yield
    finally:
        with _lock:
            _timers[name] += time.time() - t0


def timed_add(name: str, seconds: float) -> None:
    with _lock:
        _timers[name] += seconds


def snapshot() -> dict:
    with _lock:
        return {"counters": dict(_counters), "timers": dict(_timers)}


def reset() -> None:
    with _lock:
        _counters.clear()
        _timers.clear()


def report(out=None) -> str:
    """Human-readable stats dump (the analogue of pbrt's PrintStats)."""
    snap = snapshot()
    lines = ["Statistics:"]
    for k in sorted(snap["counters"]):
        lines.append(f"  {k:<40} {snap['counters'][k]:>15,}")
    for k in sorted(snap["timers"]):
        lines.append(f"  {k:<40} {snap['timers'][k]:>12.3f} s")
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a jax.profiler trace (view with TensorBoard/XProf)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
