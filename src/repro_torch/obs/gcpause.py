"""Python's garbage collections, timed: a ``gc.callbacks`` hook, installed
when ``obs`` is imported.

Each collection lands in the histogram ``gc_pause_ms{gen=<0|1|2>}`` and bumps
``gc_collections{gen=...}``. While a ``torch.profiler`` capture runs, the
collection also runs inside a ``py.gc`` ``record_function`` range from its
start to its stop, so that a device trace names the host's pause (an idle gap
of the card inside it, or a range it stretches).

The hook does what a span's exit does and no more: it stamps
``time.perf_counter_ns`` and queues its bookkeeping (``registry._queued``).
It takes no lock, never applies the queue (a collection can start while the
registry holds its lock) and writes no ring event, so the event sets of the
spans around it stay as they were. A collection that starts while recording
is off records nothing.
"""
from __future__ import annotations

import gc

import torch

from . import registry as _reg
from . import spans as _spans

RANGE = "py.gc"
_LABELS = tuple({"gen": str(g)} for g in range(3))
_open = None       # (t0 ns, generation, record_function or None) of the running collection


def _apply(labels: dict, ms: float) -> None:
    _reg.add_now("gc_collections", labels)
    _reg.observe_now("gc_pause_ms", labels, ms)


def _on_gc(phase: str, info: dict) -> None:
    global _open
    if phase == "start":
        if not _reg._enabled:
            return
        ranged = None
        if _spans._profiling():
            ranged = torch.profiler.record_function(RANGE)
            ranged.__enter__()
        _open = (_spans._now(), info["generation"], ranged)
        return
    frame = _open
    if frame is None:
        return
    _open = None
    t0, gen, ranged = frame
    ms = (_spans._now() - t0) / 1e6
    if ranged is not None:
        ranged.__exit__(None, None, None)
    _reg._queued.append((_apply, (_LABELS[gen], ms)))


gc.callbacks.append(_on_gc)
