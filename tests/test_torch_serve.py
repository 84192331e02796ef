"""The port's KV pool, scheduler and engine against the reference, on the CPU.

* **The pool, given identical K/V from numpy** (float32 and bfloat16 slabs,
  the plain and the entropy-coded cold tier): page tables, refcounts, slot
  states, ``gather``/``gather_pages`` contents, parked containers
  (``interop.to_numpy``) and blobs, and the byte accounting are identical to
  the reference's, bit for bit, through prefill, suffix writes, prefix
  sharing with copy-on-write, tiering, promotion and appends. The port runs
  its default kernel route (the plain versions on the CPU), the reference its
  plain route.
* Park -> resume through pages is bit-identical to the port's whole-cache
  oracle (``compress_cache``/``decompress_cache``) at the same bound.
* Paging without compression is token-exact against the port's own
  ``generate`` (as ``tests/test_kvpool.py`` pins the reference).
* **A seeded 5-request ``tracegen`` trace** through the port's
  ``Engine.serve`` and the reference's, both on the plain route, with the
  reference's parameters carried over: every scheduling count of
  ``TraceStats`` and the TTFT/ITL steps are identical, and the generated
  tokens agree in at least 90% of places (the reference's own bar in
  ``tests/test_kvpool.py``: bfloat16 logits differ in the last bits, so a
  near-tie can break the other way). The kernel route's stats equal the
  plain route's.
* ``python -m repro_torch.launch.serve --smoke --device cpu`` in both modes,
  with ``--trace-out`` and ``--metrics-out``: both files are written.

On jax 0.9 the reference needs two aliases; the ``ref`` fixture sets them for
one test and clears JAX's caches afterwards, so no other test sees them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import zoo as jzoo
from repro_torch import configs, interop
from repro_torch.launch import serve as launch_serve
from repro_torch.models import zoo
from repro_torch.serve import (Engine, KVCompressionConfig, compress_cache,
                               decompress_cache)
from repro_torch.serve.kvpool import PagePool, PoolConfig, Request, TieredPolicy
from repro_torch.serve.kvpool import tracegen

L, KVH, HD = 2, 2, 8     # tiny cache geometry for pool-only tests

# TraceStats fields the scheduler decides (every count; the byte high-water
# marks depend on the compressed sizes of K/V that differ in the last bits)
SCHED_FIELDS = ("decode_steps", "admissions", "preemptions", "resumes", "completed",
                "tiered_pages", "pool_compressions", "pool_decompressions", "prefix_hits",
                "prefill_tokens", "prefill_tokens_saved", "cow_promotions",
                "shared_cold_reads_deduped", "decompress_dispatches", "ttft_steps",
                "itl_steps")


@pytest.fixture
def ref(monkeypatch):
    """The reference's serve package with the jax 0.9 aliases, for one test."""
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
    from repro import serve
    yield serve
    jax.clear_caches()


def _kv(seed, S):
    """Prefill-shaped k/v (L, 1, S, KVH, HD) as float32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((L, 1, S, KVH, HD)).astype(np.float32),
            rng.standard_normal((L, 1, S, KVH, HD)).astype(np.float32))


def _tok(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((L, KVH, HD)).astype(np.float32),
            rng.standard_normal((L, KVH, HD)).astype(np.float32))


def _same(a, b):
    """Bit-identical arrays (bfloat16 compared by its float32 value, which is exact)."""
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    a = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    b = b.astype(np.float32) if b.dtype.name == "bfloat16" else b
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a.astype(np.float64), b.astype(np.float64))


def _assert_pools_equal(jpool, tpool):
    assert tpool.seq_pages == jpool.seq_pages
    assert tpool.seq_len == jpool.seq_len
    assert tpool.free_slots == jpool.free_slots
    assert tpool.slot_states() == jpool.slot_states()
    assert sorted(tpool.pages) == sorted(jpool.pages)
    for pid, jp in jpool.pages.items():
        tp = tpool.pages[pid]
        assert (tp.slot, tp.refs, tp.last_write, tp.state) == \
            (jp.slot, jp.refs, jp.last_write, jp.state), pid
        assert (tp.blob is None) == (jp.blob is None) and tp.blob == jp.blob, pid
        if jp.comp is not None:
            got = interop.to_numpy(tp.comp)
            for f, leaf in got.items():
                np.testing.assert_array_equal(leaf, np.asarray(getattr(jp.comp, f)), f)
            assert (tp.comp.shape, tp.comp.dtype_name) == (jp.comp.shape, jp.comp.dtype_name)
    for name in ("raw_bytes_in_use", "compressed_used_bytes", "compressed_wire_bytes",
                 "used_bytes", "live_demand_bytes", "logical_demand_bytes",
                 "logical_page_refs", "compression_ratio"):
        assert getattr(tpool, name)() == getattr(jpool, name)(), name
    assert tpool.slot_bytes == jpool.slot_bytes
    js, ts = jpool.stats, tpool.stats
    for f in dataclasses.fields(ts):
        assert getattr(ts, f.name) == getattr(js, f.name), f.name
    lanes = list(tpool.seq_pages) + [None]
    jg, tg = jpool.gather_pages(lanes), tpool.gather_pages(lanes)
    for key in ("k", "v", "length"):
        _same(tg[key], jg[key])
    jc, tc = jpool.gather(lanes), tpool.gather(lanes)
    for key in ("k", "v", "length"):
        _same(tc[key], jc[key])


@pytest.mark.parametrize("cold_entropy", [False, True], ids=["containers", "entropy-blobs"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_is_bit_identical_to_the_reference(ref, dtype, cold_entropy):
    kvpool = ref.kvpool
    kw = dict(num_pages=8, page_size=4, seq_capacity=24, eb=1e-3, eb_mode="rel",
              dtype=dtype, cold_entropy=cold_entropy)
    jpool = kvpool.PagePool(kvpool.PoolConfig(**kw), n_layers=L, n_kv_heads=KVH, head_dim=HD)
    tpool = PagePool(PoolConfig(**kw), n_layers=L, n_kv_heads=KVH, head_dim=HD, device="cpu")
    assert tpool.cfg.use_kernels and not jpool.cfg.use_kernels
    tokens = np.arange(100, 111, dtype=np.int32)            # 11-token prompt

    def both(fn_j, fn_t):
        a, b = fn_j(jpool), fn_t(tpool)
        assert a == b
        return a

    k, v = _kv(0, 12)
    both(lambda p: p.write_prefill(0, jnp.asarray(k), jnp.asarray(v), 11, step=0),
         lambda p: p.write_prefill(0, torch.from_numpy(k), torch.from_numpy(v), 11, step=0))
    both(lambda p: p.insert_prompt(0, tokens, 0), lambda p: p.insert_prompt(0, tokens, 0))
    _assert_pools_equal(jpool, tpool)
    # tier down two pages in one batched call and one page alone
    pids = [p.page_id for p in tpool.pages_of(0)]
    jpool.compress_pages(pids[:2])
    tpool.compress_pages(pids[:2])
    jpool.compress_page(pids[2])
    tpool.compress_page(pids[2])
    _assert_pools_equal(jpool, tpool)
    # a second request shares 10 of the prompt's tokens: map + CoW of the tail
    prompt2 = np.concatenate([tokens[:10], [7, 8, 9]]).astype(np.int32)
    jm, tm = jpool.match_prefix(prompt2), tpool.match_prefix(prompt2)
    assert (tm.matched_tokens, tm.pids) == (jm.matched_tokens, jm.pids) == (10, jm.pids)
    both(lambda p: p.admit_slot_demand(jm, 13), lambda p: p.admit_slot_demand(tm, 13))
    both(lambda p: p.map_prefix(1, jm, 1), lambda p: p.map_prefix(1, tm, 1))
    ks, vs = _kv(1, 4)
    both(lambda p: p.write_suffix(1, jnp.asarray(ks), jnp.asarray(vs), 3, step=1),
         lambda p: p.write_suffix(1, torch.from_numpy(ks), torch.from_numpy(vs), 3, step=1))
    _assert_pools_equal(jpool, tpool)
    # decode appends: into a cold private tail (promotion), across a page edge
    for step in range(2, 5):
        for seq in (0, 1):
            kt, vt = _tok(10 * step + seq)
            both(lambda p: p.tail_slot_demand(seq), lambda p: p.tail_slot_demand(seq))
            both(lambda p: p.append_token(seq, jnp.asarray(kt), jnp.asarray(vt), step),
                 lambda p: p.append_token(seq, torch.from_numpy(kt), torch.from_numpy(vt),
                                          step))
    _assert_pools_equal(jpool, tpool)
    for pid in (pids[0], tpool.seq_pages[1][-1]):
        _same(tpool.page_data(pid), jpool.page_data(pid))
    # the policy's cooling + reclaim pass, then the drain
    pol = TieredPolicy(cold_after=2)
    jpol = kvpool.TieredPolicy(cold_after=2)
    protect = pol.tail_pages(tpool, [0, 1])
    assert protect == jpol.tail_pages(jpool, [0, 1])
    both(lambda p: jpol.tier(p, 6, protect), lambda p: pol.tier(p, 6, protect))
    both(lambda p: jpol.reclaim(p, 8, set()), lambda p: pol.reclaim(p, 8, set()))
    _assert_pools_equal(jpool, tpool)
    for p in (jpool, tpool):
        p.free_seq(0)
        p.free_seq(1)
        p.release_prefix_cache()
    _assert_pools_equal(jpool, tpool)
    assert not tpool.pages and tpool.n_free_slots() == 8


def test_park_resume_bit_identical_to_whole_cache():
    """Page-granular park at a shared absolute bound reconstructs bit-identically
    to the whole-cache ``compress_cache``/``decompress_cache`` oracle."""
    S = 16
    pool = PagePool(PoolConfig(num_pages=8, page_size=4, seq_capacity=16, eb=1e-3,
                               eb_mode="abs", dtype="float32"),
                    n_layers=L, n_kv_heads=KVH, head_dim=HD, device="cpu")
    k, v = (torch.from_numpy(a) for a in _kv(7, S))
    assert pool.write_prefill(0, k, v, S, step=0)
    pool.compress_pages([p.page_id for p in pool.pages_of(0)])
    assert pool.n_free_slots() == 8
    krec, vrec, _ = pool.materialize(0)
    kcfg = KVCompressionConfig(enabled=True, eb=1e-3, eb_mode="abs", min_leaf_size=1)
    whole = decompress_cache(compress_cache(
        {"k": k, "v": v, "length": torch.full((1,), S, dtype=torch.int32)}, kcfg), kcfg)
    assert torch.equal(krec[:, :, :S], whole["k"])
    assert torch.equal(vrec[:, :, :S], whole["v"])
    assert pool.stats.compressions == 4 and pool.stats.compress_dispatches == 1


@pytest.fixture(scope="module")
def engines():
    """(reference model, reference params, port model, port params) at the smoke config."""
    jcfg = jconfigs.get("yi-6b", smoke=True)
    jm = jzoo.build(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = interop.params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, zoo.build(configs.get("yi-6b", smoke=True)), tp


def _requests(lens, n_new, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return [Request(req_id=i, tokens=rng.integers(0, vocab, (s,), dtype=np.int32),
                    n_new=n_new) for i, s in enumerate(lens)]


@pytest.mark.parametrize("use_kernels", [False, True])
def test_paging_without_compression_is_exact(engines, use_kernels):
    """No page ever tiers down: the plain route is token-exact against the
    port's own ``generate``; the kernel route (paged decode, K7's plain
    version here) agrees in at least 90% of tokens."""
    _, _, model, params = engines
    eng = Engine(model, params, device="cpu",
                 pool=PoolConfig(num_pages=16, page_size=8, seq_capacity=48,
                                 cold_after=10**6, eb=1e-4, use_kernels=use_kernels))
    assert eng.paged_decode_enabled == use_kernels
    reqs = _requests([7, 12], n_new=6)
    outputs, stats, pool = eng.serve(reqs, max_batch=2)
    assert stats.pool_compressions == 0 and stats.completed == 2
    assert not pool.pages and pool.n_free_slots() == 16
    agree = []
    for r in reqs:
        oracle, _ = eng.generate({"tokens": torch.from_numpy(r.tokens)[None]}, r.n_new)
        if not use_kernels:
            np.testing.assert_array_equal(oracle[0].numpy(), outputs[r.req_id])
        agree.append(float((oracle[0].numpy() == outputs[r.req_id]).mean()))
    assert float(np.mean(agree)) >= 0.9, agree


def _trace():
    return tracegen.generate(tracegen.TraceGenConfig(seed=0, n_requests=5))


def _pool_cfg(**kw):
    return dict(num_pages=6, page_size=8, seq_capacity=32, cold_after=2, eb=1e-4, **kw)


def test_seeded_trace_matches_the_reference(ref, engines):
    jm, jp, model, params = engines
    jreqs = [ref.kvpool.Request(req_id=r.req_id, tokens=r.tokens, n_new=r.n_new,
                                priority=r.priority, arrive_at=r.arrive_at) for r in _trace()]
    jeng = ref.Engine(jm, jp, pool=ref.kvpool.PoolConfig(**_pool_cfg()))
    jout, jstats, jpool = jeng.serve(jreqs, max_batch=2)

    eng = Engine(model, params, device="cpu", pool=PoolConfig(**_pool_cfg(use_kernels=False)))
    out, stats, pool = eng.serve(_trace(), max_batch=2)
    for f in SCHED_FIELDS:
        assert getattr(stats, f) == getattr(jstats, f), f
    # the trace exercises tiering, cold reads, prefix sharing and CoW
    assert stats.tiered_pages > 0 and stats.pool_decompressions > 0
    assert stats.prefix_hits > 0 and stats.cow_promotions > 0
    assert not pool.pages and pool.n_free_slots() == 6
    agree = [float((out[i] == np.asarray(jout[i])).mean()) for i in jout]
    assert sorted(out) == sorted(jout) and float(np.mean(agree)) >= 0.9, agree
    # the byte high-water marks agree to within the compressed sizes' jitter
    assert stats.high_water_demand_bytes == jstats.high_water_demand_bytes
    assert stats.high_water_logical_bytes == jstats.high_water_logical_bytes
    assert abs(stats.high_water_used_bytes / jstats.high_water_used_bytes - 1) < 0.02

    # the kernel route (K7 and K4/K6, their plain versions here) schedules alike
    keng = Engine(model, params, device="cpu", pool=PoolConfig(**_pool_cfg()))
    kout, kstats, _ = keng.serve(_trace(), max_batch=2)
    for f in SCHED_FIELDS:
        assert getattr(kstats, f) == getattr(stats, f), f
    agree = [float((kout[i] == out[i]).mean()) for i in out]
    assert float(np.mean(agree)) >= 0.9, agree
    summary = tracegen.latency_summary(kstats)
    assert summary == tracegen.latency_summary(jstats)


@pytest.mark.parametrize("cold_entropy", [False, True])
@pytest.mark.parametrize("prefix_mode", ["copy", "off"])
def test_seeded_trace_prefix_modes_match_the_reference(ref, engines, prefix_mode,
                                                       cold_entropy, record_property):
    """The seed-0 trace at ``prefix_mode`` copy and off, cold pages entropy-coded
    or not: every scheduling count equals the reference's, tokens agree."""
    jm, jp, model, params = engines
    kw = dict(prefix_mode=prefix_mode, cold_entropy=cold_entropy)
    jreqs = [ref.kvpool.Request(req_id=r.req_id, tokens=r.tokens, n_new=r.n_new,
                                priority=r.priority, arrive_at=r.arrive_at) for r in _trace()]
    jeng = ref.Engine(jm, jp, pool=ref.kvpool.PoolConfig(**_pool_cfg(**kw)))
    jout, jstats, _ = jeng.serve(jreqs, max_batch=2)
    eng = Engine(model, params, device="cpu",
                 pool=PoolConfig(**_pool_cfg(use_kernels=False, **kw)))
    out, stats, pool = eng.serve(_trace(), max_batch=2)
    for f in SCHED_FIELDS:
        assert getattr(stats, f) == getattr(jstats, f), f
    assert stats.tiered_pages > 0 and not pool.pages
    assert (stats.prefix_hits > 0) == (prefix_mode != "off")
    agree = float(np.mean([float((out[i] == np.asarray(jout[i])).mean()) for i in jout]))
    record_property("token_agreement", agree)
    assert sorted(out) == sorted(jout) and agree >= 0.9, agree


def test_preemption_parks_the_lowest_priority(engines):
    _, _, model, params = engines
    eng = Engine(model, params, device="cpu",
                 pool=PoolConfig(num_pages=2, page_size=8, seq_capacity=32,
                                 cold_after=100, eb=1e-4))
    pool = eng.make_pool()
    from repro_torch.serve.kvpool.scheduler import PARKED, RUNNING, SeqRecord, \
        ContinuousBatcher
    batcher = ContinuousBatcher(eng, pool, max_batch=2)
    reqs = [dataclasses.replace(r, priority=p)
            for r, p in zip(_requests([8, 8], n_new=6), (3, 1))]
    batcher.recs = {r.req_id: SeqRecord(req=r) for r in reqs}
    batcher.step(1, {})
    assert batcher.stats.preemptions >= 1
    assert batcher.recs[1].state == PARKED and batcher.recs[0].state == RUNNING
    assert all(p.comp is not None for p in pool.pages_of(1))


def test_overlong_request_rejected_up_front(engines):
    _, _, model, params = engines
    eng = Engine(model, params, device="cpu",
                 pool=PoolConfig(num_pages=4, page_size=8, seq_capacity=16, eb=1e-4))
    with pytest.raises(ValueError, match="seq_capacity"):
        eng.serve(_requests([12], n_new=8), max_batch=1)


@pytest.mark.parametrize("mode", [["--paged"], ["--paged", "--no-kernels"],
                                  ["--kv-compress"]])
def test_launcher_on_the_cpu(mode, capsys, tmp_path):
    import json
    from repro_torch import obs
    obs.reset()
    obs.clear_events()
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    out = launch_serve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                             "--prompt-len", "24", "--tokens", "6", *mode,
                             "--trace-out", str(trace), "--metrics-out", str(metrics)])
    text = capsys.readouterr().out
    assert "yi-6b-smoke" in text and "on cpu" in text
    doc = json.loads(trace.read_text())
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert doc["otherData"]["arch"] == "yi-6b-smoke" and doc["otherData"]["device"] == "cpu"
    snap = json.loads(metrics.read_text())
    assert snap["sentinel_violations"] == {}
    if "--paged" in mode:
        assert out["stats"].completed == 2 and out["stats"].decode_steps > 0
        assert all(len(t) == 6 for t in out["outputs"].values())
        assert {"engine.serve", "sched.step", "kvpool.gather"} <= names
        assert snap["gauges"]["engine_serve_tokens"] == 12
    else:
        assert tuple(out["tokens"].shape) == (2, 6) and out["parked_bytes"] > 0
        assert {"engine.prefill", "engine.park", "engine.resume"} <= names
    obs.reset()
    obs.clear_events()
