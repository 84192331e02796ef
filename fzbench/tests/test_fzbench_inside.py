"""The readers of the program's own spans and counters (``fzbench/inside.py``):
exact arithmetic on a hand-made trace and snapshot, nothing (and no error)
where a program lacks the span or counter, and the records of card runs kept
under ``data/`` (trimmed to their first four profiled calls)."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from fzbench import inside, yardstick

from .conftest import ROOT

DATA = Path(__file__).resolve().parent / "data"


def _reader(name):
    from fzbench import harness
    return harness.Bench(ROOT).reader(name)


def _x(cat, name, ts, dur, corr=None, pid=1, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(stage="fz.stage.resolve_eb", skew=0.0):
    """Two fz.compress calls in the window [0, 300]: each resolves its bound
    (two reductions in the first, one in the second) and launches K4, its
    first op starting as it is launched; a warm call before the window, which
    no reader counts. ``skew``: the device ops' clock runs that far ahead."""
    evs = [
        _x("user_annotation", "fz.compress", -100, 50),
        _x("user_annotation", stage, -95, 10),
        _x("cuda_runtime", "cudaLaunchKernel", -94, 2, corr=9),
        _x("kernel", "amax", -80, 30, corr=9, pid=0, tid=7),
        _x("user_annotation", "fzbench.window", 0, 300),
        _x("user_annotation", "fz.compress", 0, 100),
        _x("user_annotation", stage, 5, 25),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 2, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 25, 2, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 50, 2, corr=3),
        _x("kernel", "amax", 10, 20, corr=1, pid=0, tid=7),
        _x("kernel", "amin", 40, 15, corr=2, pid=0, tid=7),
        _x("kernel", "k4", 60, 30, corr=3, pid=0, tid=7),
        _x("user_annotation", "fzbench.size", 100, 40),
        _x("user_annotation", "fz.compress", 200, 60),
        _x("user_annotation", stage, 202, 8),
        _x("cuda_runtime", "cudaLaunchKernel", 205, 2, corr=4),
        _x("cuda_runtime", "cudaLaunchKernel", 215, 2, corr=5),
        _x("kernel", "amax", 205, 10, corr=4, pid=0, tid=7),
        _x("kernel", "k4", 230, 20, corr=5, pid=0, tid=7),
        _x("user_annotation", "fzbench.size", 260, 30),
    ]
    for e in evs:
        if e["cat"] in yardstick.DEVICE_CATS:
            e["ts"] -= skew
    return evs


def test_stage_device_time_is_the_union_of_its_ops_a_call():
    rec = {"events": _trace()}
    # [10, 30] + [40, 55] in the first call, [205, 215] in the second: 45 us over 2 calls
    assert _reader("resolve_eb_ms.compress")(rec) == pytest.approx(0.0225)
    assert _reader("dual_quantize_ms.compress")(rec) is None
    rec = {"events": _trace("fz.stage.dual_quantize")}
    assert _reader("dual_quantize_ms.compress")(rec) == pytest.approx(0.0225)
    assert _reader("resolve_eb_ms.compress")(rec) is None
    assert inside.stage_device_ms({}, "fz.stage.resolve_eb") is None


@pytest.mark.parametrize("skew", [0.0, 100.0, 310.5])
def test_idle_in_call_is_each_ranges_gaps(skew):
    rec = {"events": _trace(skew=skew)}
    # [0, 100]: idle [0, 10], [30, 40], [55, 60], [90, 100] = 35; [200, 260]:
    # [200, 205], [215, 230], [250, 260] = 30; the warm call is not counted. A
    # device clock ahead of the host's is moved back onto it
    assert _reader("idle_in_call_ms.compress")(rec) == pytest.approx(0.0325)
    assert _reader("resolve_eb_ms.compress")(rec) == pytest.approx(0.0225)
    assert _reader("idle_in_call_ms.decompress")(rec) is None
    no_ops = [e for e in _trace() if e["cat"] not in yardstick.DEVICE_CATS]
    assert inside.idle_in_call_ms({"events": no_ops}, "fz.compress") is None


def _snap(**extra):
    counters = {"fz_dispatches{op=compress,path=fused}": 8,
                "fz_dispatches{op=decompress,path=fused}": 3,
                "fz_host_syncs{site=used_bytes}": 16, "fz_host_syncs{site=dual_quantize}": 8,
                "span_calls{span=fz.used_bytes}": 8}
    hists = {"gc_pause_ms{gen=0}": {"sum": 0.4, "count": 20},
             "gc_pause_ms{gen=2}": {"sum": 1.2, "count": 1},
             "span_ms{span=fz.used_bytes}": {"sum": 6.0, "count": 8}}
    return {"counters": {**counters, **extra}, "histograms": hists}


def test_counters_a_call():
    rec = {"obs": _snap()}
    assert _reader("host_syncs.compress")(rec) == 3.0
    assert _reader("size_read_ms.compress")(rec) == 0.75
    assert _reader("gc_ms.compress")(rec) == pytest.approx(1.6 / 8)
    assert _reader("gc_ms.decompress")(rec) == pytest.approx(1.6 / 3)
    # a label that only starts like the op is not the op's
    rec = {"obs": _snap(**{"fz_dispatches{op=compress_more,path=fused}": 8})}
    assert _reader("host_syncs.compress")(rec) == 3.0


def test_a_program_without_the_spans_and_counters_reads_nothing():
    """The parent's program: no stage leaf, size-read span, sync counter or
    GC histogram. Each new reader returns None, and none raises."""
    snap = {"counters": {"fz_dispatches{op=compress,path=fused}": 8,
                         "span_calls{span=fz.compress}": 8},
            "histograms": {"span_ms{span=fz.compress}": {"sum": 3.0, "count": 8}}}
    events = [e for e in _trace() if not e["name"].startswith("fz.stage")]
    rec = {"direction": "compress", "obs": snap, "events": events}
    for name in ("resolve_eb_ms.compress", "dual_quantize_ms.compress", "size_read_ms.compress",
                 "host_syncs.compress", "gc_ms.compress", "gc_ms.decompress"):
        assert _reader(name)(rec) is None, name
    assert _reader("host_syncs.compress")({}) is None
    assert _reader("gc_ms.compress")({"obs": {}}) is None


RECORDED = sorted(DATA.glob("*.record.json"))


@pytest.mark.parametrize("path", RECORDED, ids=[p.name.split(".record")[0] for p in RECORDED])
def test_recorded_card_runs(path):
    """Records the readers saw in card runs (``--trace 1``): each new metric
    of the cell reads a value, the others nothing; the sync count is exact and
    the idle time in a call lies within the call's host range."""
    rec = json.loads(path.read_text())
    cell = path.name.split(".record")[0]
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in manifest["per_layer"]:
        value = _reader(m["name"])(rec)
        if cell in m.get("workloads", []):
            assert value is not None and value >= 0, m["name"]
        elif m["name"].endswith((".compress", ".decompress")) and \
                not m["name"].endswith("." + rec["direction"]):
            assert value is None, m["name"]
    if rec["direction"] == "compress":
        strict = "strict" in cell
        assert _reader("host_syncs.compress")(rec) == (3.0 if strict else 2.0)
        assert (_reader("dual_quantize_ms.compress")(rec) is None) != strict
    span = f"fz.{rec['direction']}"
    ranges = yardstick.host_ranges(rec["events"], span)
    longest = max(yardstick.interval(r)[1] - yardstick.interval(r)[0] for r in ranges) / 1e3
    assert 0 <= _reader(f"idle_in_call_ms.{rec['direction']}")(rec) <= longest
