"""Exporters: Chrome ``trace_event`` JSON (Perfetto-loadable) and JSONL. The
port of ``repro/obs/trace.py``, with the same schema.

The span layer's event ring is exporter-agnostic; this module turns it into
artifacts:

  * :func:`chrome_trace` / :func:`write_chrome_trace` — the Chrome trace
    format (``chrome://tracing`` / https://ui.perfetto.dev): complete events
    (``ph="X"``) with microsecond ``ts``/``dur``, one row per thread.
    Runtime spans export under category ``span``; spans entered while a CUDA
    graph is captured or ``torch.compile`` traces export under ``jit-trace``
    (the reference's category for trace-time spans, kept so the schema is
    the same).
  * :func:`write_jsonl` — one JSON object per line, for ad-hoc grepping and
    downstream joins.

Both take an explicit event list or default to the live ring, and write
``ts`` on the clock of ``torch.profiler``'s Chrome traces (kineto's), the
Unix epoch: the Chrome document in microseconds past its
``baseTimeNanoseconds`` (kineto's own key, whole seconds), each JSONL event in
microseconds since the epoch. The spans stamp ``time.perf_counter_ns``; one
``(time.time_ns(), time.perf_counter_ns())`` pair read at export moves them.
Deliberate difference: the reference writes the ring's ``ts`` as it is.
"""
from __future__ import annotations

import json
import time

from . import spans as _spans

_META_KEYS = ("pid", "tid")
_NS_PER_S = 1_000_000_000


def _epoch_ns() -> int:
    """The Unix-epoch time of ``perf_counter_ns``'s zero, in ns."""
    return time.time_ns() - time.perf_counter_ns()


def chrome_trace(events: list[dict] | None = None,
                 metadata: dict | None = None) -> dict:
    """Build the ``{"traceEvents": [...]}`` document from span events."""
    events = _spans.events() if events is None else events
    zero = _epoch_ns()
    base = zero // _NS_PER_S * _NS_PER_S
    shift_us = (zero - base) / 1e3
    out = []
    threads = {}
    for ev in events:
        out.append({
            "name": ev["name"], "cat": ev["cat"], "ph": "X",
            "ts": ev["ts"] + shift_us, "dur": ev["dur"],
            "pid": ev["pid"], "tid": ev["tid"],
            "args": {**ev.get("args", {}),
                     "depth": ev.get("depth", 0),
                     "parent": ev.get("parent")},
        })
        threads.setdefault((ev["pid"], ev["tid"]), len(threads))
    for (pid, tid), i in threads.items():
        out.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                    "args": {"name": f"obs-{i}"}})
    doc = {"traceEvents": out, "displayTimeUnit": "ms", "baseTimeNanoseconds": base}
    if metadata:
        doc["otherData"] = metadata
    return doc


def write_chrome_trace(path: str, events: list[dict] | None = None,
                       metadata: dict | None = None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(events, metadata), f)
    return path


def write_jsonl(path: str, events: list[dict] | None = None) -> str:
    events = _spans.events() if events is None else events
    shift_us = _epoch_ns() / 1e3
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps({**ev, "ts": ev["ts"] + shift_us}) + "\n")
    return path
