"""The spans and counters inside the port's FZ call, on the CPU.

* **Stage leaves by route.** Paper mode (relative bound): ``fz.stage.resolve_eb``
  then K4's ``fz.stage.fused_compress``; ``compress_with_eb`` resolves nothing;
  strict mode: strict K4's ``fz.stage.fused_compress`` with ``outliers=`` (the
  channel's slots; on the CPU its plain version, ``dual_quantize`` then K5's,
  runs inside it); the staged route: ``fz.stage.quantize`` and
  ``fz.stage.shuffle_encode``.
  ``used_bytes()`` is the leaf ``fz.used_bytes``, outside the entry span.
* **The entry span holds the whole call**: a slowed input preparation or route
  lookup (monkeypatched) lies inside it, for every entry point.
* **Host syncs by site** (``fz_host_syncs``) for one compress and its size read:
  paper 2, strict 3 (the plain version's ``nonzero``; strict K4 reads nothing
  on the card), staged strict 4; the other plain versions count nothing (K4
  and K5 read nothing on the card).
* **Nothing recorded** under ``obs.disabled()`` or at trace time.
* **GC**: a forced collection counts in ``gc_collections`` / ``gc_pause_ms``,
  writes no ring event, and shows as a ``py.gc`` range inside the enclosing
  span's range in a CPU ``torch.profiler`` trace.
* **One clock**: an obs span's start, from the Chrome document and from the
  JSONL file, each with its base added, agrees within 1 ms with its
  ``record_function`` range in the profiler's export of the same run.

The registry and the ring are process-global: each test resets them before and
after (other files share the worker under ``--dist loadfile``).
"""
import gc
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import fz
from repro_torch.obs import spans

N = 40_000


@pytest.fixture(autouse=True)
def clean_obs():
    obs.reset()
    obs.clear_events()
    yield
    obs.reset()
    obs.clear_events()


def _field(n: int = N) -> torch.Tensor:
    """A rough 1-D field (log of a lognormal, as the HACC proxy) whose strict
    bound of rel 1e-5 overflows some codes."""
    rng = np.random.default_rng(7)
    return torch.from_numpy(np.log1p(rng.lognormal(0.0, 2.0, n)).astype(np.float32))


PAPER = fz.FZConfig(exact_outliers=False)
STRICT = fz.FZConfig(eb=1e-5)
STAGED = fz.FZConfig(exact_outliers=False, kernel_mode="staged")
STAGED_STRICT = fz.FZConfig(eb=1e-5, kernel_mode="staged")
ABS = fz.FZConfig(eb_mode="abs", exact_outliers=False)

ROUTES = {
    "paper-rel": (PAPER, False, "fused",
                  ["fz.stage.resolve_eb", "fz.stage.fused_compress"], "fz.stage.fused_decompress"),
    "paper-abs": (ABS, True, "fused", ["fz.stage.fused_compress"], "fz.stage.fused_decompress"),
    "strict": (STRICT, False, "fused", ["fz.stage.resolve_eb", "fz.stage.fused_compress"],
               "fz.stage.fused_decompress"),
    "staged": (STAGED, False, "staged",
               ["fz.stage.resolve_eb", "fz.stage.quantize", "fz.stage.shuffle_encode"],
               "fz.stage.unshuffle"),
}


def _compress(cfg, with_eb=False):
    x = _field()
    if with_eb:
        return fz.compress_with_eb(x, 1e-2, cfg, device="cpu")
    return fz.compress(x, cfg, device="cpu")


@pytest.mark.parametrize("route", list(ROUTES))
def test_stage_leaves_of_each_route(route):
    cfg, with_eb, path, stages, decode_stage = ROUTES[route]
    c = _compress(cfg, with_eb)
    c.used_bytes()
    fz.decompress(c, cfg, device="cpu")
    evs = spans.events()
    assert all(e["cat"] == "span" for e in evs)
    under = {}
    for e in evs:
        under.setdefault(e["parent"], []).append(e)
    assert [e["name"] for e in under["fz.compress"]] == stages
    assert [e["name"] for e in under["fz.decompress"]] == [decode_stage]
    assert all(e["args"] == {"backend": "cpu", **_outliers(e, cfg)} for e in under["fz.compress"])
    assert [e["name"] for e in under[None]] == ["fz.compress", "fz.used_bytes", "fz.decompress"]
    top = {e["name"]: e for e in under[None]}
    assert top["fz.compress"]["args"] == {"n": N, "path": path}
    assert top["fz.decompress"]["args"] == {"n": N, "path": path}
    # the stages run in turn, inside the entry span
    leaves = under["fz.compress"]
    for a, b in zip(leaves, leaves[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    outer = top["fz.compress"]
    assert outer["ts"] <= leaves[0]["ts"]
    assert leaves[-1]["ts"] + leaves[-1]["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    if route == "strict":
        assert int(c.n_outliers) > 0          # the channel is in use


def _outliers(stage: dict, cfg) -> dict:
    """The ``outliers=`` attribute a compress leaf carries: strict K4's slots."""
    if stage["name"] == "fz.stage.fused_compress" and cfg.exact_outliers:
        return {"outliers": cfg.outlier_capacity(N)}
    return {}


def test_strict_leaf_carries_its_outlier_slots():
    """Strict mode's one leaf says how many outlier slots its channel has; paper
    mode's K4 leaf says nothing of outliers."""
    for cfg, want in ((STRICT, {"backend": "cpu", "outliers": N // 256}),
                      (fz.FZConfig(eb=1e-5, outlier_frac=1 / 64),
                       {"backend": "cpu", "outliers": N // 64}),
                      (PAPER, {"backend": "cpu"})):
        obs.clear_events()
        _compress(cfg)
        (stage,) = [e for e in spans.events() if e["name"] == "fz.stage.fused_compress"]
        assert stage["args"] == want


PAUSE_S = 0.03


def _slowed(fn):
    def slow(*args, **kwargs):
        time.sleep(PAUSE_S)
        return fn(*args, **kwargs)
    return slow


def _batch_rows():
    return _field(4 * 4096).reshape(4, 4096)


ENTRIES = {
    "compress/_as_input": ("_as_input", "fz.compress", {"n": N, "path": "fused"},
                           lambda: fz.compress(_field(), PAPER, device="cpu")),
    "compress/_resolved": ("_resolved", "fz.compress", {"n": N, "path": "fused"},
                           lambda: fz.compress(_field(), PAPER, device="cpu")),
    "compress_with_eb/_as_input": ("_as_input", "fz.compress", {"n": N, "path": "fused"},
                                   lambda: fz.compress_with_eb(_field(), 1e-2, ABS, device="cpu")),
    "decompress/_resolved": ("_resolved", "fz.decompress", {"n": N, "path": "fused"},
                             lambda c: fz.decompress(c, PAPER, device="cpu")),
    "compress_batch/_resolved": ("_resolved", "fz.compress_batch",
                                 {"rows": 4, "path": "fused"},
                                 lambda: fz.compress_batch_with_eb(_batch_rows(), 1e-2, ABS,
                                                                   device="cpu")),
    "decompress_batch/_resolved": ("_resolved", "fz.decompress_batch",
                                   {"rows": 4, "path": "fused"},
                                   lambda c: fz.decompress_batch(c, ABS, device="cpu")),
}


@pytest.mark.parametrize("case", list(ENTRIES))
def test_entry_span_holds_input_preparation_and_routing(case, monkeypatch):
    """The entry span opens at the call's first line: a slowed input
    preparation or route lookup lies inside it, and the span still carries the
    call's size and route."""
    target, name, attrs, call = ENTRIES[case]
    args = ()
    if name == "fz.decompress":
        args = (fz.compress(_field(), PAPER, device="cpu"),)
    elif name == "fz.decompress_batch":
        args = (fz.compress_batch_with_eb(_batch_rows(), 1e-2, ABS, device="cpu"),)
    obs.clear_events()
    monkeypatch.setattr(fz, target, _slowed(getattr(fz, target)))
    call(*args)
    (ev,) = [e for e in spans.events() if e["name"] == name]
    assert ev["dur"] >= PAUSE_S * 1e6
    assert ev["args"] == attrs


SYNCS = {
    "paper": (PAPER, {"used_bytes": 2}),
    "strict": (STRICT, {"used_bytes": 2, "dual_quantize": 1}),
    "staged-strict": (STAGED_STRICT, {"used_bytes": 2, "dual_quantize": 1, "compact_blocks": 1}),
}


def _syncs_by_site() -> dict:
    return {k.removeprefix("fz_host_syncs{site=").removesuffix("}"): v
            for k, v in obs.snapshot()["counters"].items() if k.startswith("fz_host_syncs{")}


@pytest.mark.parametrize("route", list(SYNCS))
def test_host_syncs_by_site(route):
    cfg, want = SYNCS[route]
    c = _compress(cfg)
    assert _syncs_by_site() == {k: v for k, v in want.items() if k != "used_bytes"}
    c.used_bytes()
    assert _syncs_by_site() == want
    fz.decompress(c, cfg, device="cpu")          # a decompress reads nothing on the host
    assert _syncs_by_site() == want


@pytest.mark.parametrize("off", ["disabled", "trace_time"])
def test_nothing_recorded_when_off(off, monkeypatch):
    """Under ``obs.disabled()`` no span, sync count or collection is recorded;
    at trace time (a capture, monkeypatched) no runtime span and no sync count."""
    gc.disable()             # only the collection the test forces
    try:
        if off == "disabled":
            with obs.disabled():
                _compress(STAGED_STRICT).used_bytes()
                gc.collect()
        else:
            monkeypatch.setattr(spans, "trace_time", lambda: True)
            _compress(STAGED_STRICT).used_bytes()
    finally:
        gc.enable()
    snap = obs.snapshot()
    assert not any(k.startswith(("fz_host_syncs", "fz_dispatches", "span_calls"))
                   for k in snap["counters"])
    if off == "disabled":
        assert not any(k.startswith("gc_") for k in {**snap["counters"], **snap["histograms"]})
        assert spans.events() == []
    else:
        assert {e["cat"] for e in spans.events()} == {"jit-trace"}


def test_gc_collection_is_counted_and_ranged_under_the_profiler(tmp_path):
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.span("outer"):
                gc.collect()
    finally:
        gc.enable()
    snap = obs.snapshot()
    assert snap["counters"]["gc_collections{gen=2}"] == 1
    pause = snap["histograms"]["gc_pause_ms{gen=2}"]
    assert pause["count"] == 1 and pause["sum"] > 0
    assert [e["name"] for e in spans.events()] == ["outer"]     # no ring event of its own
    path = tmp_path / "prof.json"
    prof.export_chrome_trace(str(path))
    ranges = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"}
    outer, pause_range = ranges["outer"], ranges["py.gc"]
    assert outer["ts"] <= pause_range["ts"]
    assert pause_range["ts"] + pause_range["dur"] <= outer["ts"] + outer["dur"]
    assert pause_range["dur"] >= pause["sum"] * 1e3 * 0.5


def test_obs_traces_share_the_profilers_clock(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("clocked"):
            time.sleep(0.002)
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    obs.write_chrome_trace(str(tmp_path / "obs.json"))
    obs.write_jsonl(str(tmp_path / "obs.jsonl"))
    kin = json.loads((tmp_path / "prof.json").read_text())
    (k,) = [e for e in kin["traceEvents"]
            if e.get("cat") == "user_annotation" and e["name"] == "clocked"]
    k_ns = kin["baseTimeNanoseconds"] + k["ts"] * 1e3
    doc = json.loads((tmp_path / "obs.json").read_text())
    (o,) = [e for e in doc["traceEvents"] if e["name"] == "clocked"]
    assert doc["baseTimeNanoseconds"] % 1_000_000_000 == 0
    o_ns = doc["baseTimeNanoseconds"] + o["ts"] * 1e3
    (line,) = [json.loads(s) for s in (tmp_path / "obs.jsonl").read_text().splitlines()]
    j_ns = line["ts"] * 1e3
    assert abs(o_ns - k_ns) < 1e6 and abs(j_ns - k_ns) < 1e6
    assert abs(o["dur"] - k["dur"]) < 1e3


def test_no_byte_histograms_a_call():
    """A call fills its dispatch counter and no fz histogram."""
    c = _compress(PAPER)
    fz.decompress(c, PAPER, device="cpu")
    fz.compress_batch_with_eb(_batch_rows(), 1e-2, ABS, device="cpu")
    snap = obs.snapshot()
    assert not any(k.startswith("fz_") for k in snap["histograms"])
    assert snap["counters"]["fz_dispatches{op=compress,path=fused}"] == 2
    assert snap["counters"]["fz_dispatches{op=decompress,path=fused}"] == 1
