"""The benchmark's yardstick: the table of peaks, the bytes an operation needs,
the window statistics, and the reduction of a ``torch.profiler`` Chrome trace
to device intervals. It imports nothing of the program.

Trace conventions (kineto's Chrome trace): complete events (``ph`` ``X``)
with ``ts`` and ``dur`` in microseconds on one clock for host and device.
Device work is the ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events; a
device op belongs to a named range when its launch (``cuda_runtime`` or
``cuda_driver``, matched by ``correlation``) lies inside a host
``user_annotation`` event of that name on the same thread, or else when it
lies inside the range's device projection (``gpu_user_annotation``).
"""
from __future__ import annotations

import math

# HBM bandwidth by the name torch.cuda.get_device_name() gives (datasheet,
# dense, at the card's full power limit; the run prints the card's limit)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
DEVICE_CATS = frozenset(("kernel", "gpu_memcpy", "gpu_memset"))
LAUNCH_CATS = frozenset(("cuda_runtime", "cuda_driver"))
WINDOW_RANGE = "fzbench.window"    # the profiled passes
SIZE_RANGE = "fzbench.size"        # the size read after a compress call
WAIT_RANGE = "fzbench.wait"        # the stream wait after a decompress call


def op_bytes(raw: int, stored: int) -> int:
    """Least bytes a compress or decompress call moves: the side it reads once
    and the side it writes once (raw field and stored container)."""
    return raw + stored


def p95(values) -> float:
    """Nearest-rank 95th percentile: the smallest value with at least 95% of
    the values at or below it."""
    xs = sorted(values)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


# ---------------------------------------------------------------------------
# intervals
# ---------------------------------------------------------------------------

def union(intervals) -> list[tuple[float, float]]:
    """Merge overlapping (start, end) intervals, in order."""
    out: list[list[float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def clip(merged, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in merged if b > lo and a < hi]


def length(merged) -> float:
    return sum(b - a for a, b in merged)


def gaps(merged, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no merged interval covers."""
    out, t = [], lo
    for a, b in clip(merged, lo, hi):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def _complete(events):
    return [e for e in events if e.get("ph", "X") == "X" and "dur" in e]


def device_ops(events) -> list[dict]:
    return [e for e in _complete(events) if e.get("cat") in DEVICE_CATS]


def interval(e: dict) -> tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def window(events) -> tuple[float, float] | None:
    """(start, end) in microseconds of the profiled passes' range."""
    rs = [e for e in _complete(events) if e.get("cat") == "user_annotation"
          and e.get("name") == WINDOW_RANGE]
    return interval(rs[0]) if rs else None


def host_ranges(events, name: str, cat: str = "user_annotation") -> list[dict]:
    """The ranges called ``name`` inside the window (the profiler also records
    a warm pass before it, whose first call waits on the profiler's start)."""
    w = window(events)
    return [e for e in _complete(events) if e.get("cat") == cat and e.get("name") == name
            and (w is None or w[0] <= interval(e)[0] <= w[1])]


def ops_in_range(events, name: str) -> list[dict]:
    """The device ops launched inside a host range called ``name``."""
    evs = _complete(events)
    launches = {e["args"]["correlation"]: e for e in evs
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    host = [(interval(e), (e.get("pid"), e.get("tid"))) for e in host_ranges(evs, name)]
    dev = [interval(e) for e in host_ranges(evs, name, "gpu_user_annotation")]
    out = []
    for op in device_ops(evs):
        launch = launches.get(op.get("args", {}).get("correlation"))
        if launch is not None:
            t0, t1 = interval(launch)
            inside = any(a <= t0 and t1 <= b and who == (launch.get("pid"), launch.get("tid"))
                         for (a, b), who in host)
        else:
            t0, t1 = interval(op)
            inside = any(a <= t0 and t1 <= b for a, b in dev)
        if inside:
            out.append(op)
    return out


def busy(events, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] in which some device op ran."""
    return length(clip(union(interval(e) for e in device_ops(events)), lo, hi))


def breakdown(events, span: str, n: int = 10) -> dict:
    """The ``n`` device ops that took most time inside the window, and the
    ``n`` longest idle gaps there, each named by what the host was doing at
    its middle: inside the program's ``span``, in the harness's size read or
    stream wait, or between calls."""
    w = window(events)
    if w is None:
        return {"device_ops": [], "idle_gaps": []}
    lo, hi = w
    by_name: dict[str, float] = {}
    for e in device_ops(events):
        a, b = interval(e)
        if b > lo and a < hi:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + (min(b, hi) - max(a, lo)) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    phases = [(interval(e), e["name"]) for e in _complete(events)
              if e.get("cat") == "user_annotation" and e["name"] in (span, SIZE_RANGE, WAIT_RANGE)]

    def doing(t: float) -> str:
        for (a, b), name in phases:
            if a <= t <= b:
                return f"in {name}"
        return "between calls"
    holes = sorted(gaps(union(interval(e) for e in device_ops(events)), lo, hi),
                   key=lambda g: g[0] - g[1])[:n]
    return {"device_ops": [[name, s] for name, s in top],
            "idle_gaps": [[doing((a + b) / 2), (b - a) / 1e6] for a, b in holes]}


# ---------------------------------------------------------------------------
# what the metric readers share
# ---------------------------------------------------------------------------

def window_gbps(record: dict, direction: str) -> float | None:
    """Raw bytes of every call completed in the window over its wall time."""
    if record["direction"] != direction or not record["calls"]:
        return None
    return sum(c["raw"] for c in record["calls"]) / record["window_s"] / 1e9


def span_mean_ms(record: dict, span: str) -> float | None:
    """Mean host ms a call of one of the program's ``obs`` spans."""
    snap = record.get("obs") or {}
    hist = snap.get("histograms", {}).get(f"span_ms{{span={span}}}")
    calls = snap.get("counters", {}).get(f"span_calls{{span={span}}}")
    if not hist or not calls:
        return None
    return hist["sum"] / calls


def launches_per_call(record: dict, span: str) -> float | None:
    events = record.get("events") or []
    calls = len(host_ranges(events, span))
    ops = ops_in_range(events, span)
    return len(ops) / calls if calls and ops else None


def roofline_pct(record: dict, span: str) -> float | None:
    """The least time of the profiled calls' bytes at the card's HBM
    bandwidth, over the device time (union of device ops) inside ``span``."""
    peak = record.get("hbm_bytes_per_s")
    ops = ops_in_range(record.get("events") or [], span)
    if not peak or not ops or not record.get("profiled"):
        return None
    device_s = length(union(interval(e) for e in ops)) / 1e6
    least_s = sum(op_bytes(c["raw"], c["stored"]) for c in record["profiled"]) / peak
    return 100.0 * least_s / device_s


def idle_pct(record: dict, direction: str) -> float | None:
    """Share of the profiled window's wall time with no device op running."""
    events = record.get("events") or []
    w = window(events)
    if record["direction"] != direction or w is None or not device_ops(events):
        return None
    return 100.0 * (1.0 - busy(events, *w) / (w[1] - w[0]))
