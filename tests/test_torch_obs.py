"""The port's ``obs`` layer on the CPU: the 20 cases of ``tests/test_obs.py`` on
``repro_torch.obs``, and parity with the reference's ``repro.obs``.

* **Ported cases.** Registry semantics, histogram quantiles against numpy,
  span nesting and reentrancy, the Chrome trace schema, JSONL, sentinel
  sampling / violations / rounding allowance / drift / scheduler gauges, the
  step report. The reference's two jit cases become trace-time cases: the
  port's predicate (``spans.trace_time``: a CUDA graph capture or a
  ``torch.compile`` trace) is monkeypatched, since neither runs here. The
  tracer case becomes the device-read case: a tensor attribute is rendered
  from its shape, dtype and device, never through ``Tensor.__str__``.
* **Parity, exact.** One seeded numpy stream of counter, gauge and histogram
  operations (values include 0, negatives and 1e-12) through both packages'
  registries gives equal snapshots, percentiles included; the same sentinel
  calls give equal snapshots and ``violations()``; ``chrome_trace`` and
  ``step_report`` of one event list and one registry are equal; the public
  names are the reference's.
* ``obs.cli``: the three flags write their files on the CPU.

Both registries and event rings are reset around every test: other test
files share the process under ``--dist loadfile``.
"""
import inspect
import json

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro_torch import obs
from repro_torch.obs import cli as obs_cli
from repro_torch.obs import sentinels, spans


@pytest.fixture(autouse=True)
def clean_obs():
    """Each test sees fresh registries + event rings (process-global state)."""
    for m in (obs, jobs):
        m.reset()
        m.clear_events()
    yield
    for m in (obs, jobs):
        m.reset()
        m.clear_events()


# -- registry ----------------------------------------------------------------

def test_counter_gauge_identity_and_labels():
    c1 = obs.counter("reqs", op="compress")
    c1.inc()
    c1.inc(4)
    # same (name, labels) -> same instance; different labels -> different
    assert obs.counter("reqs", op="compress") is c1
    assert obs.counter("reqs", op="decompress") is not c1
    assert c1.value == 5
    g = obs.gauge("depth")
    g.set(3)
    g.max(1)          # high-water keeps the larger
    assert g.value == 3.0
    g.max(9)
    assert g.value == 9.0
    snap = obs.snapshot()
    assert snap["counters"]["reqs{op=compress}"] == 5
    assert snap["counters"]["reqs{op=decompress}"] == 0
    assert snap["gauges"]["depth"] == 9.0
    json.dumps(snap)   # snapshot must be JSON-ready


def test_metric_kind_collision_raises():
    obs.counter("x")
    with pytest.raises(TypeError):
        obs.gauge("x")


def test_disabled_suspends_all_recording():
    with obs.disabled():
        obs.counter("c").inc()
        obs.gauge("g").set(5)
        obs.histogram("h").observe(1.0)
        with obs.span("quiet"):
            pass
    snap = obs.snapshot()
    assert snap["counters"]["c"] == 0
    assert snap["gauges"]["g"] == 0.0
    assert snap["histograms"]["h"]["count"] == 0
    assert spans.events() == []
    obs.counter("c").inc()     # re-enabled on exit
    assert obs.counter("c").value == 1


def test_histogram_percentiles_vs_numpy():
    rng = np.random.default_rng(0)
    for name, data in [
        ("lognorm", rng.lognormal(0.0, 2.0, 5000)),
        ("uniform", rng.uniform(0.5, 100.0, 5000)),
        ("heavy", rng.pareto(1.5, 5000) + 1.0),
    ]:
        h = obs.histogram(name)
        for v in data:
            h.observe(v)
        assert h.count == len(data)
        assert h.min == data.min() and h.max == data.max()
        assert h.sum == pytest.approx(data.sum())
        for q in (10, 50, 90, 99):
            exact = float(np.percentile(data, q))
            est = h.percentile(q)
            # log-bucketed at base 2**(1/8) -> ~9% relative resolution
            assert est == pytest.approx(exact, rel=0.12), (name, q)
        assert h.percentile(0) == data.min()
        assert h.percentile(100) == data.max()


def test_histogram_zero_and_negative_do_not_blow_up():
    h = obs.histogram("edge")
    h.observe(0.0)
    h.observe(-3.0)
    h.observe(2.0)
    assert h.count == 3
    assert h.percentile(100) == 2.0
    assert h.percentile(0) == -3.0


# -- spans -------------------------------------------------------------------

def test_span_nesting_depth_parent_and_timing():
    with obs.span("outer", job=1):
        assert spans.current_stack() == ("outer",)
        with obs.span("inner"):
            assert spans.current_stack() == ("outer", "inner")
    assert spans.current_stack() == ()
    evs = spans.events()
    # inner closes first
    assert [e["name"] for e in evs] == ["inner", "outer"]
    inner, outer = evs
    assert inner["depth"] == 1 and inner["parent"] == "outer"
    assert outer["depth"] == 0 and outer["parent"] is None
    assert outer["dur"] >= inner["dur"] > 0
    # temporal nesting: inner's window sits inside outer's
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert outer["args"]["job"] == 1
    assert obs.counter("span_calls", span="outer").value == 1
    h = obs.DEFAULT.find("span_ms", span="outer")
    assert h is not None and h.count == 1


def test_span_reentrant_and_exception_safe():
    s = obs.span("recurse")

    def go(n):
        with s:
            if n:
                go(n - 1)

    go(3)
    assert obs.counter("span_calls", span="recurse").value == 4
    assert spans.current_stack() == ()
    with pytest.raises(ValueError):
        with obs.span("boom"):
            raise ValueError("x")
    assert spans.current_stack() == ()       # stack restored on exception
    assert obs.counter("span_calls", span="boom").value == 1


def test_span_decorator():
    @obs.span("deco")
    def f(x):
        return x + 1

    assert f(1) == 2 and f(2) == 3
    assert obs.counter("span_calls", span="deco").value == 2


class _NoStr(torch.Tensor):
    """A tensor whose values must not be read: rendering it raises."""

    def __str__(self):
        raise AssertionError("Tensor.__str__ called on a span attribute")

    __repr__ = __str__

    def __format__(self, spec):
        raise AssertionError("Tensor.__format__ called on a span attribute")


def test_span_attrs_never_read_tensor_values():
    """The port's counterpart of the reference's tracer case: ``str()`` of a
    CUDA tensor copies it to the host (a sync inside every span), so a tensor
    attribute is rendered from its shape, dtype and device only."""
    t = torch.zeros(3, 5, dtype=torch.bfloat16).as_subclass(_NoStr)
    with obs.span("attrs", val=t, n=7):
        pass
    (ev,) = [e for e in spans.events() if e["name"] == "attrs"]
    assert ev["args"] == {"val": "Tensor[3, 5] bfloat16 cpu", "n": 7}
    json.dumps(ev)


def test_span_trace_time_discipline_no_runtime_events_and_capture_counter(monkeypatch):
    """A span entered while a CUDA graph is captured (the port's counterpart of
    a jit trace) records only ``span_traces`` and one ``jit-trace`` event; a
    replay runs no Python and records nothing. ``span_traces`` counts captures."""
    monkeypatch.setattr(spans, "trace_time", lambda: True)

    def capture(x):
        with obs.span("graph.body"):
            return x * 2 + 1

    x = torch.arange(8, dtype=torch.float32)
    torch.testing.assert_close(capture(x), 2 * x + 1)       # capture #1
    evs = [e for e in spans.events() if e["name"] == "graph.body"]
    assert len(evs) == 1 and evs[0]["cat"] == "jit-trace"
    assert obs.counter("span_traces", span="graph.body").value == 1
    assert obs.counter("span_calls", span="graph.body").value == 0
    assert obs.DEFAULT.find("span_ms", span="graph.body") is None
    # a second capture (another shape) counts again: the capture detector
    capture(torch.arange(16, dtype=torch.float32))
    assert obs.counter("span_traces", span="graph.body").value == 2
    assert len([e for e in spans.events() if e["name"] == "graph.body"]) == 2


def test_span_runtime_wrapper_contains_trace_time_events(monkeypatch):
    """A runtime span around a capture temporally contains the trace-time
    event of the span captured inside it."""
    capturing = [False]
    monkeypatch.setattr(spans, "trace_time", lambda: capturing[0])
    with obs.span("wrapper"):
        capturing[0] = True
        with obs.span("stage"):
            pass
        capturing[0] = False
    evs = {e["name"]: e for e in spans.events()}
    w, s = evs["wrapper"], evs["stage"]
    assert w["cat"] == "span" and s["cat"] == "jit-trace"
    assert s["parent"] == "wrapper" and s["depth"] == 1
    assert w["ts"] <= s["ts"]
    assert s["ts"] + s["dur"] <= w["ts"] + w["dur"] + 1e-6


def test_span_enters_record_function_only_at_runtime_under_a_profiler(monkeypatch):
    """``record_function`` ranges are entered while a profiler capture runs, and
    never for a trace-time span; no CUDA is touched without a card."""
    entered = []

    class Spy:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Spy)
    with obs.span("idle"):
        pass
    monkeypatch.setattr(spans, "_profiling", lambda: True)
    with obs.span("profiled"):
        pass
    monkeypatch.setattr(spans, "trace_time", lambda: True)
    with obs.span("captured"):
        pass
    assert entered == ["profiled"]


def test_span_pushes_nvtx_ranges_only_under_a_tool(monkeypatch):
    """NVTX ranges go out on a card with an NVTX tool injected (Nsight), at
    runtime only; without a tool spans make no NVTX call."""
    calls = []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda n: calls.append(("push", n)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: calls.append(("pop",)))
    with obs.span("quiet"):
        pass
    assert calls == [] and not spans._nvtx()
    monkeypatch.setattr(spans, "_nvtx", lambda: True)
    with obs.span("outer"):
        with obs.span("inner"):
            pass
    assert calls == [("push", "outer"), ("push", "inner"), ("pop",), ("pop",)]
    calls.clear()
    monkeypatch.setattr(spans, "trace_time", lambda: True)
    with obs.span("captured") as s:
        pass
    assert calls == [] and s.runtime is False


def test_fz_entry_points_count_nothing_at_trace_time(monkeypatch):
    """Under a capture the fz entry points count no dispatch: their spans and
    the stage spans inside them record trace-time events only."""
    import repro_torch as rt
    x = np.linspace(-1, 1, 5000, dtype=np.float32)
    cfg = rt.FZConfig(exact_outliers=False)
    monkeypatch.setattr(spans, "trace_time", lambda: True)
    rt.decompress(rt.compress(x, cfg, device="cpu"), cfg, device="cpu")
    snap = obs.snapshot()["counters"]
    assert not any(k.startswith(("fz_dispatches", "span_calls")) for k in snap)
    assert snap["span_traces{span=fz.compress}"] == snap["span_traces{span=fz.decompress}"] == 1
    evs = spans.events()
    assert {e["name"] for e in evs} == {"fz.compress", "fz.decompress", "fz.stage.resolve_eb",
                                        "fz.stage.fused_compress", "fz.stage.fused_decompress"}
    assert all(e["cat"] == "jit-trace" for e in evs)
    monkeypatch.undo()
    rt.compress(x, cfg, device="cpu")
    assert obs.counter("fz_dispatches", op="compress", path="fused").value == 1


def test_span_names_reach_the_torch_profiler():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("profiled.region"):
            torch.ones(4).sum()
    assert any(e.key == "profiled.region" for e in prof.key_averages())


def test_queued_span_bookkeeping_is_applied_before_every_read():
    """A span's exit queues its metrics and event; any read of the registry or
    the ring applies the queue first (whatever ``enabled()`` says then), and
    the queue never holds more than ``QUEUE_LIMIT`` updates."""
    reg = obs.registry
    with obs.span("q"):
        pass
    assert len(reg._queued) == 1
    with obs.disabled():
        assert obs.counter("span_calls", span="q").value == 1
    assert not reg._queued
    n = 3 * reg.QUEUE_LIMIT + 5
    for _ in range(n):
        with obs.span("q"):
            pass
        assert len(reg._queued) < reg.QUEUE_LIMIT
    assert [e["name"] for e in spans.events()].count("q") == n + 1
    assert obs.snapshot()["counters"]["span_calls{span=q}"] == n + 1
    assert obs.DEFAULT.find("span_ms", span="q").count == n + 1


def test_ring_bounded_under_flood():
    spans.set_ring_capacity(512)
    try:
        n = 1_000_000
        for i in range(n):
            spans._record(f"e{i}", "span", float(i), 1.0, 0, None, {})
        evs = spans.events()
        assert len(evs) == 512 == spans.ring_capacity()
        # ring keeps the newest events
        assert evs[0]["name"] == f"e{n - 512}"
        assert evs[-1]["name"] == f"e{n - 1}"
    finally:
        spans.set_ring_capacity(spans.DEFAULT_RING_CAPACITY)


# -- chrome trace ------------------------------------------------------------

def test_chrome_trace_schema(tmp_path):
    with obs.span("a"):
        with obs.span("b"):
            pass
    path = tmp_path / "trace.json"
    obs.write_chrome_trace(str(path), metadata={"run": "unit"})
    doc = json.loads(path.read_text())
    assert doc["displayTimeUnit"] == "ms"
    assert doc["otherData"] == {"run": "unit"}
    evs = doc["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    ms = [e for e in evs if e["ph"] == "M"]
    assert {e["name"] for e in xs} == {"a", "b"}
    for e in xs:
        for k in ("name", "cat", "ph", "ts", "dur", "pid", "tid", "args"):
            assert k in e
        assert isinstance(e["ts"], float) and isinstance(e["dur"], float)
        assert e["dur"] >= 0
    assert ms and all(e["name"] == "thread_name" for e in ms)
    # every X event's (pid, tid) has a thread_name metadata row
    assert {(e["pid"], e["tid"]) for e in xs} <= {(e["pid"], e["tid"])
                                                  for e in ms}


def test_write_jsonl(tmp_path):
    with obs.span("x"):
        pass
    p = tmp_path / "events.jsonl"
    obs.write_jsonl(str(p))
    lines = [json.loads(line) for line in p.read_text().splitlines()]
    assert len(lines) == 1 and lines[0]["name"] == "x"


# -- sentinels ---------------------------------------------------------------

def test_sentinel_eb_sampling_first_then_every_nth():
    old = sentinels.CONFIG
    sentinels.configure(sentinels.SentinelConfig(eb_sample_every=4))
    try:
        picks = [sentinels.should_check_eb("t") for _ in range(9)]
        assert picks == [True, False, False, False,
                         True, False, False, False, True]
    finally:
        sentinels.configure(old)


def test_sentinel_eb_violation_trips_assert_healthy():
    assert sentinels.check_error_bound("kv_cold", max_err=1e-4, eb_abs=1e-3)
    sentinels.assert_healthy()               # in-bound check: healthy
    assert not sentinels.check_error_bound("kv_cold", max_err=5e-3,
                                           eb_abs=1e-3)
    assert obs.violations() == {"sentinel_eb_violations{tier=kv_cold}": 1}
    with pytest.raises(sentinels.HealthError):
        sentinels.assert_healthy()


def test_sentinel_eb_f32_rounding_allowance():
    # max_err just over eb but within the |x|*2^-22 rounding allowance
    eb = 1e-3
    max_abs = 1e4
    allowance = max_abs * 2.0 ** -22
    assert sentinels.check_error_bound("t", eb * 1.0005 + allowance * 0.5,
                                       eb, max_abs)
    assert not sentinels.check_error_bound("t", eb + allowance * 3, eb,
                                           max_abs)


def test_sentinel_ratio_drift_flags_after_warmup_only():
    for _ in range(5):
        sentinels.note_ratio("wire", 4.0)
    assert obs.violations() == {}
    sentinels.note_ratio("wire", 100.0)      # >4x the EWMA -> drift
    assert obs.violations() == {"sentinel_ratio_drift{tier=wire}": 1}
    sentinels.assert_healthy()               # drift alone is not fatal...
    with pytest.raises(sentinels.HealthError):
        sentinels.assert_healthy(strict_drift=True)   # ...unless strict


def test_sentinel_scheduler_gauges():
    sentinels.note_scheduler(waiting=3, running=2, parked=1,
                             oldest_wait_steps=7)
    sentinels.note_scheduler(waiting=0, running=2, parked=0,
                             oldest_wait_steps=2)
    snap = obs.snapshot()["gauges"]
    assert snap["sched_waiting{subsystem=kvpool}"] == 0
    assert snap["sched_oldest_wait_steps{subsystem=kvpool}"] == 2
    assert snap["sched_max_wait_steps{subsystem=kvpool}"] == 7  # high-water


# -- step report -------------------------------------------------------------

def test_step_report_joins_spans_with_bytes():
    with obs.span("dist.bucket0_reduce"):
        pass
    rep = obs.step_report(bytes_by_tag={"bucket0_reduce": 1 << 20},
                          meta={"step": 3})
    (row,) = [r for r in rep.rows if r["span"] == "dist.bucket0_reduce"]
    assert row["calls"] == 1
    assert row["bytes"] == 1 << 20
    assert row["gbps"] > 0
    assert "dist.bucket0_reduce" in rep.render()


# -- parity with the reference -----------------------------------------------

NAMES = ["reqs", "depth", "lat_ms", "span_ms", "span_calls"]
LABELS = [{}, {"op": "compress"}, {"op": "decompress", "path": "fused"},
          {"span": "fz.compress"}, {"pool": "pool0", "tier": "kv_cold"}]
EDGE_VALUES = [0.0, -3.5, 1e-12, -1e-12, 1e-13, 2.0 ** -40, 1e12, 7.0]


def _op_stream(seed: int, n: int = 3000):
    """A seeded stream of (kind, name, labels, value) operations. Each name has
    one kind (the registry rejects a second), labels vary freely."""
    rng = np.random.default_rng(seed)
    kinds = {"reqs": "counter", "span_calls": "counter", "depth": "gauge",
             "lat_ms": "histogram", "span_ms": "histogram"}
    ops = []
    for _ in range(n):
        name = NAMES[rng.integers(len(NAMES))]
        labels = LABELS[rng.integers(len(LABELS))]
        kind = kinds[name]
        if rng.random() < 0.3:
            v = EDGE_VALUES[rng.integers(len(EDGE_VALUES))]
        else:
            v = float(rng.lognormal(0.0, 3.0) * rng.choice([-1.0, 1.0, 1.0, 1.0]))
        if kind == "counter":
            ops.append(("inc", name, labels, int(rng.integers(0, 5))))
        elif kind == "gauge":
            ops.append(("set" if rng.random() < 0.5 else "max", name, labels, v))
        else:
            ops.append(("observe", name, labels, v))
        if rng.random() < 0.01:
            ops.append(("toggle", None, None, None))
    return ops


def _apply(mod, reg, ops):
    """Run the stream on ``reg`` (a registry of package ``mod``); ``toggle``
    flips the package's global recording switch."""
    for op, name, labels, v in ops:
        if op == "toggle":
            mod.set_enabled(not mod.enabled())
        elif op == "inc":
            reg.counter(name, **labels).inc(v)
        elif op in ("set", "max"):
            getattr(reg.gauge(name, **labels), op)(v)
        else:
            reg.histogram(name, **labels).observe(v)
    mod.set_enabled(True)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_equals_the_reference(seed):
    ops = _op_stream(seed)
    ours, theirs = obs.Registry(), jobs.Registry()
    _apply(obs, ours, ops)
    _apply(jobs, theirs, ops)
    snap = ours.snapshot()
    assert snap == theirs.snapshot()
    assert snap["histograms"] and snap["gauges"] and snap["counters"]
    for (name, lk), h in ours._metrics.items():
        if isinstance(h, obs.registry.Histogram):
            jh = theirs._metrics[(name, lk)]
            for q in (0, 1, 10, 25, 50, 75, 90, 99, 99.9, 100):
                assert h.percentile(q) == jh.percentile(q), (name, lk, q)
            assert h.buckets == jh.buckets


def _sentinel_calls(mod):
    """One fixed sequence of sentinel calls on package ``mod``'s default registry."""
    s = mod.sentinels
    picks = [s.should_check_eb(t) for t in ["kv_cold"] * 40 + ["kv_cold_entropy"] * 3]
    results = [s.check_error_bound("kv_cold", e, 1e-3, m)
               for e, m in [(1e-4, 0.0), (1e-3, 10.0), (1.0006e-3, 1e4), (2e-3, 1.0),
                            (0.0, 0.0), (1.0011e-3, 0.0)]]
    for r in [4.0, 4.5, 3.9, 4.1, 30.0, 0.5, 4.0, 1e-12, 0.0]:
        s.note_ratio("kv_cold", r)
    for r in [2.0, 2.0, 2.0, 2.1]:
        s.note_ratio("kv_cold_entropy", r)
    s.note_scheduler(waiting=3, running=2, parked=1, oldest_wait_steps=7)
    s.note_scheduler(waiting=0, running=4, parked=0, oldest_wait_steps=2)
    return picks, results


def test_sentinels_equal_the_reference():
    old = (sentinels.CONFIG, jobs.sentinels.CONFIG)
    try:
        for mod in (obs, jobs):
            mod.sentinels.configure(mod.sentinels.SentinelConfig(eb_sample_every=5))
        assert _sentinel_calls(obs) == _sentinel_calls(jobs)
        assert obs.snapshot() == jobs.snapshot()
        v = obs.violations()
        assert v == jobs.violations() and v
        for mod in (obs, jobs):
            with pytest.raises(mod.HealthError, match="sentinel_eb_violations"):
                mod.assert_healthy()
    finally:
        sentinels.configure(old[0])
        jobs.sentinels.configure(old[1])


def test_exporters_equal_the_reference(monkeypatch):
    # one event list, recorded by the port's spans; one registry, filled by
    # the op stream plus those spans. The port's document is the reference's
    # on the Unix-epoch clock: each ts moved by the epoch time of
    # perf_counter's zero past the whole-second base the document declares
    from repro_torch.obs import trace
    with obs.span("engine.serve", requests=3):
        with obs.span("sched.step", step=1):
            with obs.span("kvpool.park", pages=2):
                pass
    events = spans.events() + [{"name": "fz.stage.x", "cat": "jit-trace", "ts": 1.5,
                                "dur": 0.25, "pid": 1, "tid": 2}]
    meta = {"arch": "yi-6b", "device": "cuda:0"}
    zero = 1_790_000_123_456_789_000
    monkeypatch.setattr(trace, "_epoch_ns", lambda: zero)

    def on_epoch(doc):
        for e in doc["traceEvents"]:
            if e["ph"] == "X":
                e["ts"] += 456_789.0
        return {**doc, "baseTimeNanoseconds": 1_790_000_123_000_000_000}
    assert obs.chrome_trace(events, meta) == on_epoch(jobs.chrome_trace(events, meta))
    assert obs.chrome_trace(events) == on_epoch(jobs.chrome_trace(events))

    ours, theirs = obs.Registry(), jobs.Registry()
    ops = _op_stream(3, 500) + [("observe", "span_ms", {"span": "dist.bucket0_reduce"}, 2.5),
                                ("inc", "span_calls", {"span": "dist.bucket0_reduce"}, 4)]
    _apply(obs, ours, ops)
    _apply(jobs, theirs, ops)
    for tags in (None, {"bucket0_reduce": 1 << 20, "fz.compress": {"ag": 10, "rs": 5}}):
        a = obs.step_report(ours, bytes_by_tag=tags, meta={"step": 3})
        b = jobs.step_report(theirs, bytes_by_tag=tags, meta={"step": 3})
        assert a.to_dict() == b.to_dict() and a.render() == b.render()
    assert obs.step_report(obs.Registry()).render() == "(no spans recorded)"


def test_public_names_are_the_reference():
    names = {n for n, v in vars(jobs).items()
             if not n.startswith("_") and not inspect.ismodule(v)}
    assert set(obs.__all__) == names
    assert all(hasattr(obs, n) for n in obs.__all__)
    assert obs.SentinelConfig() == obs.SentinelConfig(**{
        f: getattr(jobs.SentinelConfig(), f) for f in jobs.SentinelConfig.__dataclass_fields__})
    assert spans.DEFAULT_RING_CAPACITY == jobs.spans.DEFAULT_RING_CAPACITY == 65_536


# -- cli ----------------------------------------------------------------------

def test_cli_writes_trace_metrics_and_profile_on_the_cpu(tmp_path):
    import argparse
    p = argparse.ArgumentParser()
    obs_cli.add_args(p)
    args = p.parse_args(["--trace-out", str(tmp_path / "t.json"),
                         "--metrics-out", str(tmp_path / "m.json"),
                         "--profile-dir", str(tmp_path / "prof")])
    obs_cli.start(args, device="cpu")
    with obs.span("cli.run"):
        torch.ones(8).sum()
    obs_cli.finish(args, metadata={"run": "cli"})
    doc = json.loads((tmp_path / "t.json").read_text())
    assert doc["otherData"] == {"run": "cli"}
    assert "cli.run" in {e["name"] for e in doc["traceEvents"]}
    metrics = json.loads((tmp_path / "m.json").read_text())
    assert metrics["sentinel_violations"] == {}
    assert metrics["counters"]["span_calls{span=cli.run}"] == 1
    prof = json.loads((tmp_path / "prof" / obs_cli.PROFILE_FILE).read_text())
    assert any(e.get("cat") == "user_annotation" and e["name"] == "cli.run"
               for e in prof["traceEvents"])
    assert args.profiler is None
    obs_cli.finish(p.parse_args([]))          # no flags: nothing to write
