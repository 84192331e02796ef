"""The port's ``obs`` registry against its serving stack, and against the
reference's, on the CPU.

The eight cases of ``tests/test_obs_integration.py`` on the port's glm4-9b
smoke trace (the kernel route, whose wrappers run their plain versions here):

  * ``PoolStats`` / ``TraceStats`` are views of the registry, field for field;
  * ``fz_dispatches{op=...}`` equals the pool's ``*_dispatches``;
  * the trace samples at least one park-time error-bound check and ends with
    zero violations; the scheduler gauges are written;
  * spans nest ``engine.serve > sched.step > kvpool.* > fz.* > fz.stage.*``
    (the stage spans are runtime spans here: the port has no jit);
  * the Chrome export of the run holds ``engine.serve`` and ``sched.step``;
  * two pools in one process never cross-count.

Against the reference (parity):

  * the seeded 5-request ``tracegen`` trace through both engines on the plain
    route (``use_kernels=False``: both label the fz path ``reference``), the
    reference's parameters carried over with ``interop.params_from_reference``:
    after the ``pool=`` / ``batcher=`` instance labels are stripped, every
    ``kvpool_*``, ``sched_*``, ``fz_dispatches``, ``entropy_stage`` and
    ``sentinel_eb_checks`` / ``_considered`` / ``sentinel_ratio_samples``
    counter is equal, and so are the ``sched_*`` gauges. Not compared:
    ``span_*`` (timing), ``tune_*`` (the tuner is not ported) and the float
    gauges, which follow K/V that differ in the last bits
    (``tests/test_torch_serve.py``);
  * the pool alone, given identical K/V from numpy, float32 and bfloat16,
    plain and entropy-coded cold tier, on both of the port's routes: the same
    counters, and the sentinel and high-water gauges
    (``sentinel_eb_last_max_err``, ``sentinel_ratio_last``, the EWMA) exactly.

The engine holds the bound itself: a park whose check fails (a wrong
reconstruction, or a bound lowered under the check) makes the scheduler's
per-step ``assert_healthy()`` raise ``HealthError``.

On jax 0.9 the reference needs two aliases; the module-scoped fixture sets
them in a ``MonkeyPatch.context()`` around the reference's run only, so the
trace runs once per file. Each fixture resets the registries it reads.
"""
import json
import re

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import obs as jobs
from repro.models import zoo as jzoo
from repro_torch import configs, interop, obs
from repro_torch.core import fz
from repro_torch.models import zoo
from repro_torch.obs import spans
from repro_torch.serve import Engine, PoolConfig
from repro_torch.serve.kvpool import PagePool, Request, tracegen
from repro_torch.serve.kvpool.pool import _POOL_METRICS
from repro_torch.serve.kvpool.scheduler import _SCHED_METRICS

L, KVH, HD = 2, 2, 8
PARITY_COUNTERS = ("kvpool_", "sched_", "fz_dispatches", "entropy_stage",
                   "sentinel_eb_checks", "sentinel_eb_considered", "sentinel_ratio_samples")


def _fz_count(snap, op):
    return sum(v for k, v in snap["counters"].items()
               if k.startswith(f"fz_dispatches{{op={op},"))


def _strip(key: str) -> str:
    """``name{a=1,pool=pool3}`` -> ``name{a=1}``: the instance labels go."""
    m = re.fullmatch(r"([^{]+)(?:\{(.*)\})?", key)
    name, labels = m.group(1), m.group(2)
    kept = [kv for kv in (labels.split(",") if labels else [])
            if not kv.startswith(("pool=", "batcher="))]
    return name + ("{" + ",".join(kept) + "}" if kept else "")


def _parity_view(snap, gauges=()):
    """The compared counters (and the named gauge families), instance labels stripped."""
    out = {}
    for key, v in snap["counters"].items():
        if key.startswith(PARITY_COUNTERS):
            out[_strip(key)] = v
    for key, v in snap["gauges"].items():
        if key.startswith(gauges):
            out["gauge:" + _strip(key)] = v
    return out


def _reset(*mods):
    for m in mods:
        m.reset()
        m.clear_events()


@pytest.fixture(scope="module")
def served():
    """One full serve trace of the port (tight pool: parking + cold reads +
    resumes) against a fresh registry; every test below reads this run."""
    _reset(obs)
    cfg = configs.get("glm4-9b", smoke=True)
    model = zoo.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    pool_cfg = PoolConfig(num_pages=6, page_size=8, seq_capacity=48, cold_after=2, eb=1e-4)
    eng = Engine(model, params, pool=pool_cfg, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(req_id=i, tokens=rng.integers(0, cfg.vocab, (s,), dtype=np.int32),
                    n_new=5, priority=p)
            for i, (s, p) in enumerate(zip([5, 11, 8, 16, 3], [0, 1, 0, 2, 1]))]
    outputs, stats, pool = eng.serve(reqs, max_batch=2)
    # the views are read before the registry is reset for the next file
    out = (outputs, stats, pool, obs.snapshot(), spans.events(), obs.violations(),
           pool.stats)
    _reset(obs)
    return out


def test_trace_completes_with_compression_exercised(served):
    outputs, stats, pool, snap, _, _, _ = served
    assert stats.completed == 5
    assert stats.pool_compressions >= 1, "trace never parked a page"
    assert stats.pool_decompressions >= 1, "trace never read a cold page"
    assert snap["gauges"]["engine_serve_tokens"] == sum(len(v) for v in outputs.values())
    assert snap["gauges"]["engine_serve_tokens_per_s"] > 0


def test_pool_stats_parity_with_registry(served):
    _, _, pool, snap, _, _, ps = served
    for field, (kind, name) in _POOL_METRICS.items():
        kinds = snap["counters"] if kind == "counter" else snap["gauges"]
        reg_val = kinds.get(f"{name}{{pool={pool._obs_id}}}", 0)
        assert getattr(ps, field) == int(reg_val), field
    assert ps.compressions > 0 and ps.high_water_bytes > 0


def test_trace_stats_parity_with_registry(served):
    _, stats, pool, snap, _, _, ps = served
    # one batcher ran against this registry epoch (a counter the trace never
    # touched is simply absent -> the snapshot field must be 0)
    for field, name in _SCHED_METRICS.items():
        reg_vals = [v for k, v in snap["counters"].items()
                    if k.startswith(f"{name}{{batcher=")]
        assert len(reg_vals) <= 1, name
        assert getattr(stats, field) == (reg_vals[0] if reg_vals else 0), field
    # pool-derived mirror fields
    assert stats.pool_compressions == ps.compressions
    assert stats.pool_decompressions == ps.decompressions
    assert stats.decompress_dispatches == ps.decompress_dispatches
    assert stats.cow_promotions == ps.cow_promotions
    assert stats.high_water_used_bytes == ps.high_water_bytes


def test_fz_dispatch_counters_match_pool_accounting(served):
    _, stats, pool, snap, _, _, ps = served
    assert _fz_count(snap, "decompress") == ps.decompress_dispatches
    assert _fz_count(snap, "compress") == ps.compress_dispatches
    # per-container counts are >= dispatches (batching) and > 0
    assert ps.decompressions >= ps.decompress_dispatches > 0
    assert ps.compressions >= ps.compress_dispatches > 0
    # the kernel route labels its dispatches "fused"
    assert all("path=fused" in k for k in snap["counters"] if k.startswith("fz_dispatches"))


def test_sentinels_sampled_and_healthy_on_real_path(served):
    _, _, _, snap, _, violations, _ = served
    assert snap["counters"].get(
        "sentinel_eb_checks{tier=kv_cold}", 0) >= 1, \
        "no park-time roundtrip was ever sampled"
    assert violations == {}
    assert snap["gauges"]["sentinel_eb_last_max_err{tier=kv_cold}"] > 0
    # the sampled roundtrips also fed the ratio drift EWMA
    assert snap["counters"].get(
        "sentinel_ratio_samples{tier=kv_cold}", 0) >= 1
    # scheduler health gauges were written
    assert "sched_running{subsystem=kvpool}" in snap["gauges"]


def test_span_nesting_on_real_path(served):
    _, _, _, snap, events, _, _ = served
    parents = {}
    for ev in events:
        parents.setdefault(ev["name"], set()).add(ev["parent"])
    assert "engine.serve" in parents
    assert parents["sched.step"] == {"engine.serve"}
    # pool work happens inside a scheduler step
    pool_spans = {n for n in parents
                  if n.startswith("kvpool.")} & {"kvpool.park",
                                                 "kvpool.cold_read",
                                                 "kvpool.gather"}
    assert pool_spans == {"kvpool.park", "kvpool.cold_read", "kvpool.gather"}
    # cold reads issued by a gather nest under it; everything pool-side
    # ultimately hangs off a scheduler step
    for n in pool_spans:
        assert parents[n] <= {"sched.step", "kvpool.gather"}, (n, parents[n])
    assert "sched.step" in parents["kvpool.gather"]
    # fz wrapper spans nest under the pool spans that issued them; the pool's
    # size reads (its high-water bytes) are the fz.used_bytes leaves, two
    # host syncs each
    fz_spans = {n for n in parents if n.startswith("fz.") and not n.startswith("fz.stage")}
    assert fz_spans == {"fz.compress", "fz.compress_batch", "fz.decompress",
                        "fz.decompress_batch", "fz.used_bytes"}
    fz_parents = set().union(*(parents[n] for n in fz_spans - {"fz.used_bytes"}))
    assert fz_parents & {"kvpool.park", "kvpool.cold_read"}
    size_reads = [e for e in events if e["name"] == "fz.used_bytes"]
    assert 2 * len(size_reads) == snap["counters"]["fz_host_syncs{site=used_bytes}"]
    # the port has no jit: stage spans run at runtime, under the fz span of
    # every metered call, labeled with where they ran (the plain versions:
    # "cpu"); the sentinel's unmetered decode runs its stage right under the
    # park it checks
    stage_events = [e for e in events if e["name"].startswith("fz.stage")]
    assert {e["name"] for e in stage_events} == {"fz.stage.fused_compress",
                                                 "fz.stage.fused_decompress"}
    assert all(e["cat"] == "span" and e["args"] == {"backend": "cpu"} for e in stage_events)
    under = {e["parent"] for e in stage_events}
    assert under & fz_spans and under <= fz_spans | {"kvpool.park"}
    assert all(e["name"] == "fz.stage.fused_decompress" for e in stage_events
               if e["parent"] == "kvpool.park")
    assert all(e["cat"] == "span" for e in events)
    assert snap["counters"]["span_calls{span=sched.step}"] == len(
        [e for e in events if e["name"] == "sched.step"])


def test_chrome_trace_export_of_real_run(served, tmp_path):
    _, _, _, _, events, _, _ = served
    path = str(tmp_path / "serve_trace.json")
    obs.write_chrome_trace(path, events=events)
    doc = json.loads(open(path).read())
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"engine.serve", "sched.step"} <= names


def test_two_pools_never_cross_count():
    """Per-instance pool labels: work in one pool is invisible to another."""
    cfg = PoolConfig(num_pages=4, page_size=4, seq_capacity=16,
                     eb=1e-3, eb_mode="abs", dtype="float32")
    a = PagePool(cfg, n_layers=L, n_kv_heads=KVH, head_dim=HD, device="cpu")
    b = PagePool(cfg, n_layers=L, n_kv_heads=KVH, head_dim=HD, device="cpu")
    assert a._obs_id != b._obs_id
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.standard_normal((L, 1, 8, KVH, HD)).astype(np.float32))
    a.write_prefill(seq=0, k=k, v=-k, length=8, step=0)
    a.compress_pages([p.page_id for p in a.pages_of(0)])
    assert a.stats.compressions >= 1
    assert b.stats.compressions == 0
    assert b.stats.compress_dispatches == 0


# -- parity with the reference --------------------------------------------------

def _trace():
    return tracegen.generate(tracegen.TraceGenConfig(seed=0, n_requests=5))


POOL_CFG = dict(num_pages=6, page_size=8, seq_capacity=32, cold_after=2, eb=1e-4)


@pytest.fixture(scope="module")
def both_traces():
    """The seeded 5-request trace through the reference's engine, then the
    port's, both on the plain route, each against a fresh registry."""
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    from repro import serve as jserve
    jcfg = jconfigs.get("yi-6b", smoke=True)
    jm = jzoo.build(jcfg)
    jp = jm.init(jax.random.key(0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        jreqs = [jserve.kvpool.Request(req_id=r.req_id, tokens=r.tokens, n_new=r.n_new,
                                       priority=r.priority, arrive_at=r.arrive_at)
                 for r in _trace()]
        _reset(jobs)
        jeng = jserve.Engine(jm, jp, pool=jserve.kvpool.PoolConfig(**POOL_CFG))
        _, jstats, _ = jeng.serve(jreqs, max_batch=2)
        jsnap = jobs.snapshot()
        _reset(jobs)
    jax.clear_caches()
    params = interop.params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    eng = Engine(zoo.build(configs.get("yi-6b", smoke=True)), params, device="cpu",
                 pool=PoolConfig(**POOL_CFG, use_kernels=False))
    _reset(obs)
    _, stats, _ = eng.serve(_trace(), max_batch=2)
    snap = obs.snapshot()
    _reset(obs)
    return jsnap, jstats, snap, stats


def test_seeded_trace_counters_equal_the_reference(both_traces):
    jsnap, jstats, snap, stats = both_traces
    ours, theirs = _parity_view(snap, ("sched_",)), _parity_view(jsnap, ("sched_",))
    assert ours == theirs
    # the trace parks, reads cold pages, samples the bound, shares prefixes
    for key in ("kvpool_compressions", "kvpool_decompressions", "sched_tiered_pages",
                "sched_prefix_hits", "kvpool_cow_promotions",
                "fz_dispatches{op=compress,path=reference}",
                "fz_dispatches{op=decompress,path=reference}",
                "sentinel_eb_checks{tier=kv_cold}", "gauge:sched_max_wait_steps{subsystem=kvpool}"):
        assert key in ours, key
    assert ours["sentinel_eb_checks{tier=kv_cold}"] >= 1
    assert not any(k.startswith("sentinel_eb_violations") for k in snap["counters"])
    assert stats.completed == jstats.completed == 5


def _kv(seed, S):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((L, 1, S, KVH, HD)).astype(np.float32),
            rng.standard_normal((L, 1, S, KVH, HD)).astype(np.float32))


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernel-route"])
@pytest.mark.parametrize("cold_entropy", [False, True], ids=["containers", "entropy-blobs"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_telemetry_equals_the_reference(monkeypatch, dtype, cold_entropy, use_kernels):
    """Identical K/V from numpy through both pools: the same counters and the
    same sentinel and high-water gauges, exactly."""
    import jax._src.core as jcore
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
    from repro.serve import kvpool as jkvpool
    kw = dict(num_pages=8, page_size=4, seq_capacity=24, eb=1e-3, eb_mode="rel",
              dtype=dtype, cold_entropy=cold_entropy)
    _reset(obs, jobs)
    jpool = jkvpool.PagePool(jkvpool.PoolConfig(**kw), n_layers=L, n_kv_heads=KVH, head_dim=HD)
    tpool = PagePool(PoolConfig(**kw, use_kernels=use_kernels), n_layers=L, n_kv_heads=KVH,
                     head_dim=HD, device="cpu")
    k, v = _kv(0, 12)
    k2, v2 = _kv(1, 8)
    for pool, arr in ((jpool, jnp.asarray), (tpool, torch.from_numpy)):
        pool.write_prefill(0, arr(k), arr(v), 11, step=0)
        pool.write_prefill(1, arr(k2), arr(v2), 8, step=0)
        pids = [p.page_id for p in pool.pages_of(0)]
        pool.compress_pages(pids[:2])          # batched park: sampled (the first)
        pool.compress_page(pids[2])
        pool.compress_pages([p.page_id for p in pool.pages_of(1)])
        pool.gather_pages([0, 1, None])        # cold reads of every parked page
        pool.page_data(pids[0])
    try:
        snap, jsnap = obs.snapshot(), jobs.snapshot()
    finally:
        _reset(obs, jobs)
        jax.clear_caches()
    gauges = ("sentinel_", "kvpool_high_water_", "kvpool_lanes")
    ours, theirs = _parity_view(snap, gauges), _parity_view(jsnap, gauges)
    if use_kernels:      # the port's kernel route labels its dispatches "fused"
        ours = {key.replace("path=fused", "path=reference"): v for key, v in ours.items()}
    assert ours == theirs
    tier = "kv_cold_entropy" if cold_entropy else "kv_cold"
    assert ours[f"sentinel_eb_checks{{tier={tier}}}"] == 1     # the first park
    assert ours[f"gauge:sentinel_eb_last_max_err{{tier={tier}}}"] > 0
    assert ours[f"gauge:sentinel_ratio_last{{tier={tier}}}"] > 1
    if cold_entropy:
        assert any(key.startswith("entropy_stage{op=decode") for key in ours)


@pytest.mark.parametrize("fault", ["wrong-reconstruction", "lowered-bound"])
def test_a_park_that_breaks_the_bound_stops_the_engine(monkeypatch, fault):
    """The sentinel check of a park fails, and the scheduler's per-step
    ``assert_healthy()`` raises ``HealthError`` in that step."""
    if fault == "wrong-reconstruction":
        real = fz.decompress_unmetered

        def decompress_unmetered(c, cfg, *, device="cuda"):
            return real(c, cfg, device=device) + 1.0
        monkeypatch.setattr(fz, "decompress_unmetered", decompress_unmetered)
    else:
        real = PagePool._sentinel_check

        def sentinel_check(self, flat, page):
            eb = self.eb_abs
            self.eb_abs = eb * 1e-3          # the check holds the page to a 1000x tighter bound
            try:
                real(self, flat, page)
            finally:
                self.eb_abs = eb
        monkeypatch.setattr(PagePool, "_sentinel_check", sentinel_check)
    _reset(obs)
    cfg = configs.get("yi-6b", smoke=True)
    model = zoo.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(model, params, device="cpu", pool=PoolConfig(**POOL_CFG))
    pool = eng.make_pool()
    pool_ids = [pool._obs_id]
    try:
        with pytest.raises(obs.HealthError, match="sentinel_eb_violations"):
            eng.serve(_trace(), max_batch=2, pool=pool)
        assert obs.violations() == {"sentinel_eb_violations{tier=kv_cold}": 1}
        # it stopped in the step of the first park, before the trace completed
        snap = obs.snapshot()["counters"]
        assert snap["kvpool_compress_dispatches{pool=" + pool_ids[-1] + "}"] == 1
        assert sum(v for key, v in snap.items() if key.startswith("sched_completed")) < 5
    finally:
        _reset(obs)
