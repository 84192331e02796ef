"""What the readers of K6's column passes share: the device time of the
``scan_columns`` launches inside the program's ``fz.stage.fused_decompress``
ranges, and how near they run to their least time. Both read the profiler's
trace alone, so a program or record without ``fz_column_passes`` reads too.
It imports nothing of the program. Where the program lacks the range or the
kernel, each returns None and raises nothing."""
from __future__ import annotations

import torch

from . import fields, yardstick

STAGE = "fz.stage.fused_decompress"
KERNEL = "scan_columns"     # in the name of every column pass's kernel
PASS_BYTES = 8              # a pass reads and writes each element once, 4 bytes each way


def _element_bytes() -> int | None:
    """Bytes an element of a raw field. A record carries no dtype, so this
    holds only while the harness makes fields of one dtype (``fields.DTYPES``)."""
    sizes = {torch.finfo(getattr(torch, d)).bits // 8 for d in fields.DTYPES}
    return sizes.pop() if len(sizes) == 1 else None


def _ops(record: dict) -> tuple[int, list[dict]]:
    """(calls, the column passes' device ops) of the profiled window."""
    events = record.get("events") or []
    calls = len(yardstick.host_ranges(events, STAGE))
    return calls, [e for e in yardstick.ops_in_range(events, STAGE) if KERNEL in e["name"]]


def _device_us(ops: list[dict]) -> float:
    return yardstick.length(yardstick.union(yardstick.interval(e) for e in ops))


def device_ms(record: dict) -> float | None:
    """Device ms a call of the column passes (the union of their intervals)."""
    calls, ops = _ops(record)
    return _device_us(ops) / calls / 1e3 if calls and ops else None


def roofline_pct(record: dict) -> float | None:
    """The profiled calls' least column-pass time (``PASS_BYTES`` an element a
    pass at the card's HBM bandwidth) over the passes' device time, in %. The
    passes a call are the ``scan_columns`` launches over the calls."""
    peak = record.get("hbm_bytes_per_s")
    size = _element_bytes()
    calls, ops = _ops(record)
    if not peak or not size or not calls or not ops or not record.get("profiled"):
        return None
    elements = sum(c["raw"] for c in record["profiled"]) / size
    return 100.0 * len(ops) / calls * PASS_BYTES * elements / peak / (_device_us(ops) / 1e6)
