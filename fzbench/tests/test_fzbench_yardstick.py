"""The metric arithmetic on hand-made records and a synthetic Chrome trace."""
from __future__ import annotations

import math

import pytest

from fzbench import yardstick

from .conftest import ROOT


def _reader(name):
    from fzbench import harness
    return harness.Bench(ROOT).reader(name)


def _record(direction="compress", ms=None, raw=1000, stored=250, window_s=2.0):
    ms = ms if ms is not None else [1.0] * 10
    return {"direction": direction, "window_s": window_s, "setup_s": 7.5,
            "calls": [{"field": i % 6, "raw": raw, "stored": stored, "ms": m}
                      for i, m in enumerate(ms)]}


def test_window_rate_is_all_bytes_over_the_window():
    rec = _record(ms=[1.0] * 40, raw=5_000_000, stored=1_250_000, window_s=0.25)
    assert _reader("compress_GBps")(rec) == pytest.approx(40 * 5e6 / 0.25 / 1e9)
    assert _reader("decompress_GBps")(rec) is None
    assert _reader("decompress_GBps")(_record("decompress")) == pytest.approx(1e4 / 2 / 1e9)
    assert _reader("ratio")(rec) == pytest.approx(4.0)
    assert _reader("setup_s")(rec) == 7.5


def test_p95_is_over_every_call():
    assert yardstick.p95(range(1, 101)) == 95
    assert yardstick.p95(range(1, 21)) == 19
    assert yardstick.p95([3.0]) == 3.0
    # 19 fast calls and one slow: the slow one is past the 95th percentile
    assert yardstick.p95([1.0] * 19 + [50.0]) == 1.0
    # a tail of 10 slow calls in 100 shows, whatever order the calls came in
    tail = [1.0] * 90 + [9.0] * 10
    assert _reader("call_ms_p95")(_record(ms=tail[::-1])) == 9.0


def test_union_of_overlapping_intervals_and_gaps():
    merged = yardstick.union([(5, 6), (0, 2), (1, 3), (6, 7), (2.5, 2.7)])
    assert merged == [(0, 3), (5, 7)]
    assert yardstick.length(merged) == 5
    assert yardstick.gaps(merged, 0, 10) == [(3, 5), (7, 10)]
    assert yardstick.clip(merged, 1, 6) == [(1, 3), (5, 6)]


def _trace():
    """Two fz.compress calls on (pid 1, tid 1) inside the profiled window
    [0, 300]: three kernels launched inside the ranges (two overlapping), one
    memset launched outside them, one kernel launched by an unknown thread
    whose device projection lies in a range; and a warm call before the
    window, which no reader counts."""
    def x(cat, name, ts, dur, corr=None, pid=1, tid=1):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    return [
        x("user_annotation", "fz.compress", -100, 40),
        x("cuda_runtime", "cudaLaunchKernel", -90, 5, corr=5),
        x("kernel", "k4", -80, 40, corr=5, pid=0, tid=7),
        x("gpu_user_annotation", "fz.compress", -80, 40, pid=0, tid=7),
        x("user_annotation", "fzbench.window", 0, 300),
        x("user_annotation", "fz.compress", 0, 100),
        x("user_annotation", "fzbench.size", 100, 40),
        x("user_annotation", "fz.compress", 200, 60),
        x("user_annotation", "fzbench.size", 260, 30),
        x("gpu_user_annotation", "fz.compress", 215, 50, pid=0, tid=7),
        x("cuda_runtime", "cudaLaunchKernel", 10, 5, corr=1),
        x("cuda_runtime", "cudaLaunchKernel", 50, 5, corr=2),
        x("cuda_runtime", "cudaMemsetAsync", 150, 2, corr=4),
        x("cuda_runtime", "cudaLaunchKernel", 205, 5, corr=3),
        x("kernel", "k4", 20, 40, corr=1, pid=0, tid=7),
        x("kernel", "amax", 40, 50, corr=2, pid=0, tid=7),
        x("gpu_memset", "Memset", 150, 20, corr=4, pid=0, tid=7),
        x("kernel", "k4", 220, 40, corr=3, pid=0, tid=7),
        x("kernel", "k6", 230, 10, corr=99, pid=0, tid=7),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 10, "id": 1},
    ]


def test_device_ops_are_attributed_to_their_range():
    ev = _trace()
    names = sorted(e["name"] for e in yardstick.ops_in_range(ev, "fz.compress"))
    assert names == ["amax", "k4", "k4", "k6"]
    rec = {"events": ev}
    assert yardstick.launches_per_call(rec, "fz.compress") == 2.0
    assert yardstick.launches_per_call(rec, "fz.decompress") is None


def test_roofline_over_the_union_of_kernel_time():
    ev = _trace()
    rec = {"direction": "compress", "events": ev, "hbm_bytes_per_s": 3.35e12,
           "profiled": [{"raw": 1_000_000, "stored": 250_000}] * 2}
    # device time inside the ranges: [20, 90] and [220, 260] -> 110 us, not 150
    want = 100 * (2.5e6 / 3.35e12) / 110e-6
    assert yardstick.roofline_pct(rec, "fz.compress") == pytest.approx(want)
    assert _reader("kernel_roofline.compress")(rec) == pytest.approx(want)
    assert yardstick.roofline_pct(dict(rec, hbm_bytes_per_s=None), "fz.compress") is None
    assert yardstick.roofline_pct(dict(rec, events=[]), "fz.compress") is None


def test_idle_share_and_breakdown():
    ev = _trace()
    busy = 70 + 20 + 40          # [20, 90], [150, 170], [220, 260] within [0, 300]
    assert yardstick.busy(ev, 0, 300) == busy
    rec = {"direction": "compress", "events": ev}
    assert _reader("device_idle.compress")(rec) == pytest.approx(100 * (1 - busy / 300))
    assert _reader("device_idle.decompress")(rec) is None
    no_ops = [e for e in ev if e.get("cat") not in yardstick.DEVICE_CATS]
    assert yardstick.idle_pct({"direction": "compress", "events": no_ops}, "compress") is None
    b = yardstick.breakdown(ev, "fz.compress")
    assert b["device_ops"][0] == ["k4", pytest.approx(80e-6)]
    assert len(b["device_ops"]) == 4
    gaps = b["idle_gaps"]
    assert [g[0] for g in gaps] == ["in fzbench.size", "between calls", "in fzbench.size",
                                    "in fz.compress"]
    assert gaps[0][1] == pytest.approx(60e-6) and math.isclose(sum(g[1] for g in gaps),
                                                               (300 - busy) / 1e6)


def test_host_ms_reads_the_program_span():
    snap = {"histograms": {"span_ms{span=fz.compress}": {"sum": 12.0, "count": 8}},
            "counters": {"span_calls{span=fz.compress}": 8}}
    assert _reader("host_ms.compress")({"obs": snap}) == 1.5
    assert _reader("host_ms.decompress")({"obs": snap}) is None
