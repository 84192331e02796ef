"""StepReport: join span timings with byte attribution. The port of
``repro/obs/report.py``.

Two datasets side by side: wall-clock per named region (the span histograms)
and, where the caller has them, bytes moved per named region (a plain
``{tag: bytes}`` dict, or ``launch.hlo_cost.analyze(...)["cross_pod_by_tag"]``'s
``{tag: {collective: bytes}}`` form, whose bucket tags are a part of the
hops' span names ``dist.bucket<i>_reduce``). Difference from the reference:
a dict leaf that matches by part of a span's name is summed too (the
reference's sum of such hits fails on dicts). :func:`step_report` performs that join: one row per span name with
call count, p50/p99/max milliseconds, total time, and — where a byte tag
matches the span name (exact, or the tag appearing in the span's dotted
name) — the attributed bytes and the implied effective bandwidth.

Rendered with :meth:`StepReport.render` as an aligned text table, or shipped
machine-readable via :meth:`StepReport.to_dict` (this is what
``--metrics-out`` embeds next to the raw registry snapshot).
"""
from __future__ import annotations

import dataclasses
import re

from . import registry as _reg

_SPAN_KEY = re.compile(r"^span_ms\{span=(.+)\}$")


@dataclasses.dataclass
class StepReport:
    rows: list[dict]
    meta: dict

    def to_dict(self) -> dict:
        return {"rows": self.rows, "meta": self.meta}

    def render(self) -> str:
        if not self.rows:
            return "(no spans recorded)"
        hdr = f"{'span':40s} {'calls':>7s} {'p50ms':>9s} {'p99ms':>9s} " \
              f"{'maxms':>9s} {'totalms':>10s} {'bytes':>12s} {'GB/s':>7s}"
        lines = [hdr, "-" * len(hdr)]
        for r in self.rows:
            by = f"{r['bytes']:.3e}" if r.get("bytes") else ""
            bw = f"{r['gbps']:.2f}" if r.get("gbps") else ""
            lines.append(
                f"{r['span'][:40]:40s} {r['calls']:7d} {r['p50_ms']:9.3f} "
                f"{r['p99_ms']:9.3f} {r['max_ms']:9.3f} {r['total_ms']:10.1f} "
                f"{by:>12s} {bw:>7s}")
        return "\n".join(lines)


def _find_bytes(span_name: str, bytes_by_tag: dict) -> float | None:
    if span_name in bytes_by_tag:
        v = bytes_by_tag[span_name]
    else:
        hits = [_leaf_bytes(v) for t, v in bytes_by_tag.items() if t in span_name]
        if not hits:
            return None
        v = sum(hits)
    return float(_leaf_bytes(v))


def _leaf_bytes(v) -> float:
    """A tag's bytes: a number, or ``{collective: bytes}`` (the cost model's
    ``cross_pod_by_tag`` leaf form), summed."""
    return sum(v.values()) if isinstance(v, dict) else v


def step_report(registry: _reg.Registry | None = None,
                bytes_by_tag: dict | None = None,
                meta: dict | None = None) -> StepReport:
    """Build the per-span table from a registry snapshot.

    ``bytes_by_tag``: optional ``{tag: bytes}`` (or ``{tag: {collective:
    bytes}}``) to join byte counts onto span rows.
    """
    snap = (registry or _reg.DEFAULT).snapshot()
    bytes_by_tag = bytes_by_tag or {}
    rows = []
    for key, h in sorted(snap["histograms"].items()):
        m = _SPAN_KEY.match(key)
        if not m:
            continue
        name = m.group(1)
        calls = snap["counters"].get(f"span_calls{{span={name}}}", h["count"])
        row = {"span": name, "calls": calls, "p50_ms": h["p50"],
               "p99_ms": h["p99"], "max_ms": h["max"], "total_ms": h["sum"]}
        b = _find_bytes(name, bytes_by_tag)
        if b is not None:
            # ``b`` is bytes per execution of the tagged region; the span's
            # total covers ``calls`` executions
            row["bytes"] = b
            if h["sum"] > 0:
                row["gbps"] = b * calls / (h["sum"] / 1e3) / 1e9
        rows.append(row)
    return StepReport(rows=rows, meta=meta or {})
