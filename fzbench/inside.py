"""What the readers of the program's own spans and counters share: the device
time inside a stage's profiler ranges, the card's idle time inside the entry
point's ranges, and the window's counters a call. It imports nothing of the
program. Where the program has no such span, range or counter, each returns
None and raises nothing."""
from __future__ import annotations

from . import yardstick


def stage_device_ms(record: dict, stage: str) -> float | None:
    """Device ms a call (the union of the op intervals) of the ops launched
    inside the profiled window's ``stage`` ranges."""
    events = record.get("events") or []
    calls = len(yardstick.host_ranges(events, stage))
    ops = yardstick.ops_in_range(events, stage)
    if not calls or not ops:
        return None
    return yardstick.length(yardstick.union(yardstick.interval(e) for e in ops)) / calls / 1e3


def idle_in_call_ms(record: dict, span: str) -> float | None:
    """Ms a call of the window's ``span`` host ranges in which no device op of
    the call ran, over the ranges. A call's ops are those launched inside its
    range (the loop starts a call only once the card has finished the last),
    moved onto the host's clock by the least shift that starts none of them
    before its launch: kineto's device timestamps can run ahead of the host's
    by tens to hundreds of microseconds, drifting through a trace."""
    events = record.get("events") or []
    ranges = yardstick.host_ranges(events, span)
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in yardstick.LAUNCH_CATS and "correlation" in e.get("args", {})}
    pairs = [(launches[c], op) for op in yardstick.device_ops(events)
             if (c := op.get("args", {}).get("correlation")) in launches]
    if not ranges or not pairs:
        return None
    idle = 0.0
    for r in ranges:
        a, b = yardstick.interval(r)
        who = (r.get("pid"), r.get("tid"))
        mine = [(float(launch["ts"]), op) for launch, op in pairs
                if a <= float(launch["ts"]) <= b and (launch.get("pid"), launch.get("tid")) == who]
        shift = max([0.0] + [t - float(op["ts"]) for t, op in mine])
        merged = yardstick.union((t0 + shift, t1 + shift)
                                 for t0, t1 in (yardstick.interval(op) for _, op in mine))
        idle += yardstick.length(yardstick.gaps(merged, a, b))
    return idle / len(ranges) / 1e3


def _total(section: dict, name: str, where: str = "") -> float:
    """Sum of the labelled series ``name{...}`` whose labels hold ``where``."""
    return sum(v for k, v in section.items()
               if k.startswith(name + "{") and where in k)


def per_call(record: dict, op: str, total: float) -> float | None:
    """``total`` over the window's ``fz_dispatches{op=...}``."""
    counters = (record.get("obs") or {}).get("counters", {})
    calls = _total(counters, "fz_dispatches", f"op={op},")
    return total / calls if calls else None


def host_syncs(record: dict, op: str) -> float | None:
    """``fz_host_syncs`` (every site) a call of ``op`` in the window."""
    counters = (record.get("obs") or {}).get("counters", {})
    if not any(k.startswith("fz_host_syncs{") for k in counters):
        return None
    return per_call(record, op, _total(counters, "fz_host_syncs"))


def gc_ms(record: dict, op: str) -> float | None:
    """Ms a call of ``op`` of the window's Python collections (``gc_pause_ms``)."""
    hists = (record.get("obs") or {}).get("histograms", {})
    pauses = [h["sum"] for k, h in hists.items() if k.startswith("gc_pause_ms{")]
    return per_call(record, op, sum(pauses)) if pauses else None
