"""The readers of K6's column passes (``fzbench/columns.py``) on a hand-made
trace and snapshot, nothing (and no error) where the program lacks the
counter or the range; and the cells added with them, ``qmcpack-288.decompress``
and ``hacc-280m.compress``, at tiny sizes on the CPU: sound runs are correct,
the control is not."""
from __future__ import annotations

import json

import pytest
import torch

from fzbench import columns, control, harness

from .conftest import ROOT, cpu_run

NEW_CELLS = ["qmcpack-288.decompress", "hacc-280m.compress"]


def _reader(name):
    return harness.Bench(ROOT).reader(name)


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _call(t, corr, passes=("scan_columns<false>", "scan_columns<true>")):
    """One fz.decompress call at ``t``: K6's row pass, then its column passes
    of 20 us each, back to back."""
    evs = [_x("user_annotation", "fz.decompress", t, 100),
           _x("user_annotation", columns.STAGE, t + 5, 30),
           _x("cuda_runtime", "cudaLaunchKernel", t + 6, 2, corr=corr),
           _x("kernel", "fz::decode_scan_rows", t + 10, 20, corr=corr)]
    for k, name in enumerate(passes):
        evs += [_x("cuda_runtime", "cudaLaunchKernel", t + 8 + 2 * k, 2, corr=corr + k + 1),
                _x("kernel", f"void fz::{name}(unsigned int*, int)", t + 30 + 20 * k, 20,
                   corr=corr + k + 1)]
    return evs


def _record(counters=None, events=True):
    """Two profiled calls of 1e6 float32 elements in the window [0, 400], a
    warm call before it; the window's snapshot: 3 calls, 2 passes each."""
    evs = (_call(-200, 100) + [_x("user_annotation", "fzbench.window", 0, 400)]
           + _call(0, 1) + _call(200, 10)) if events else []
    if counters is None:
        counters = {"fz_column_passes{stash=1}": 3, "fz_column_passes{stash=0}": 3}
    return {"direction": "decompress", "events": evs, "hbm_bytes_per_s": 1e12,
            "profiled": [{"raw": 4_000_000, "stored": 1}] * 2,
            "obs": {"counters": {"fz_dispatches{op=decompress,path=fused}": 3, **counters}}}


def test_column_passes_device_time_and_roofline():
    rec = _record()
    # two passes of 20 us back to back a call; the row pass and the warm call are not counted
    assert _reader("scan_columns_ms.decompress")(rec) == pytest.approx(0.040)
    # least: 2 passes x 8 bytes x 1e6 elements at 1e12 B/s = 16 us a call, of 40
    assert _reader("scan_columns_roofline.decompress")(rec) == pytest.approx(40.0)
    # one pass a call: half the least time over half the device time
    one = _record()
    one["events"] = [e for e in one["events"] if "scan_columns<true>" not in e["name"]]
    assert _reader("scan_columns_ms.decompress")(one) == pytest.approx(0.020)
    assert _reader("scan_columns_roofline.decompress")(one) == pytest.approx(40.0)


def test_a_program_without_the_counter_or_the_passes_reads_nothing():
    """The parent's program has the leaf and the kernels but no
    ``fz_column_passes``: both read from the trace alone. A 1-D field has no
    column pass, and a record without a trace reads nothing."""
    rec = _record(counters={})
    assert _reader("scan_columns_ms.decompress")(rec) == pytest.approx(0.040)
    assert _reader("scan_columns_roofline.decompress")(rec) == pytest.approx(40.0)
    one_d = _record()
    one_d["events"] = [e for e in one_d["events"] if "scan_columns" not in e["name"]]
    assert _reader("scan_columns_ms.decompress")(one_d) is None
    assert _reader("scan_columns_roofline.decompress")(one_d) is None
    for rec in ({}, {"obs": {}}, _record(events=False)):
        assert _reader("scan_columns_ms.decompress")(rec) is None
        assert _reader("scan_columns_roofline.decompress")(rec) is None


@pytest.mark.parametrize("workload", NEW_CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_runs_of_the_new_cells_are_correct(tiny_root, workload, trace):
    out = cpu_run(tiny_root, workload, trace=trace)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert all(c["value"] == 0 and c["limit"] == 0 for c in out["checks"].values())
    direction = workload.rsplit(".", 1)[1]
    assert f"{direction}_GBps" in out["metrics"] or trace
    if trace:
        assert f"host_ms.{direction}" in out["metrics"]


@pytest.mark.parametrize("workload", NEW_CELLS)
@pytest.mark.parametrize("seed", [11, 2**31 + 12])
def test_the_control_is_not_correct_in_the_new_cells(tiny_root, workload, seed):
    out = control.run_control(harness.Bench(tiny_root), workload, seed, 0.3,
                              torch.device("cpu"))
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values()), out["checks"]


def test_recorded_card_runs_read_their_passes():
    """The card records under ``data/``: QMCPACK counts one stashed and one
    unstashed pass a call, as many as its trace launches, and runs them well
    under their roofline; Nyx's record, taken before the counter, launches two
    passes a call, which run near their roofline."""
    data = ROOT / "fzbench" / "tests" / "data"

    def launched(rec):
        calls, ops = columns._ops(rec)
        return len(ops) / calls

    qmc = json.loads((data / "qmcpack-288.decompress.record.json").read_text())
    counters = qmc["obs"]["counters"]
    calls = counters["fz_dispatches{op=decompress,path=fused}"]
    assert counters["fz_column_passes{stash=1}"] == counters["fz_column_passes{stash=0}"] == calls
    assert launched(qmc) == 2
    assert 30 <= columns.roofline_pct(qmc) <= 60
    nyx = json.loads((data / "nyx-512.decompress.record.json").read_text())
    assert launched(nyx) == 2
    assert 75 <= columns.roofline_pct(nyx) <= 85
