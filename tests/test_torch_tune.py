"""The port's tuner (``repro_torch.tune``) on the CPU, and against the reference's.

The cases of ``tests/test_tune.py`` on the port's CPU route (the wrappers'
plain versions): cache round trip, schema bump, corrupt and truncated files,
bucket collapsing, a second run with zero measurements, the parity gate
rejecting a seeded wrong candidate (a fake op, a wrong fz decode, a compress
that breaks the bound), the fallback order (fused first on both backends: a
deliberate difference), a cached winner overriding it, "auto" resolution, the
budget skip (as ``smem-overflow``: no launch of the port overflows the H100 at
the reference's 1M-element point), skips recorded in the entry, and the CLI's
JSON, run twice.

Against the JAX package (the ``ref`` fixture sets the jax 0.9 aliases for one
test): ``shape_bucket`` / ``cache_key`` over n in 0..2^27, cache files
byte-identical and loadable both ways, the FZ tuning context bit-equal and its
reference-route container field for field, the "auto" containers and
reconstructions, the two packages' parity-gate verdicts, and the plain decode
attention within 2e-4.

No test writes the default cache path: each one points the process at
``tmp_path`` (``dispatch.configure``) and resets afterwards.
"""
import json
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch import configs, obs
from repro_torch import tune
from repro_torch.analysis.kernelspec import KernelSpec
from repro_torch.core import fz
from repro_torch.kernels import ref as kref
from repro_torch.models import attention, zoo
from repro_torch.serve import Engine, PoolConfig
from repro_torch.tune import cache as tcache
from repro_torch.tune import dispatch, impls, registry, tuner

CPU = torch.device("cpu")
QUIET = dict(k=1, warmup=0, log=lambda *a: None, device="cpu")


@pytest.fixture
def tmp_cache(tmp_path):
    """Point the process-wide dispatch cache at a throwaway file."""
    tc = dispatch.configure(tmp_path / "tune_cache.json")
    yield tc
    dispatch.reset()


@pytest.fixture
def ref(monkeypatch, tmp_path):
    """The reference's tune package with the jax 0.9 aliases, its cache at a
    throwaway file, for one test."""
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
    from repro import tune as jtune
    jtune.dispatch.configure(tmp_path / "ref_tune_cache.json")
    yield jtune
    jtune.dispatch.reset()
    jax.clear_caches()


def _fake_op(name, impls=("ref", "fast")):
    """Register a trivial op (instant candidates, bit-identity gate)."""
    def make_context(*, n, dtype, device):
        return {"n": n, "dtype": dtype, "device": device,
                "x": torch.arange(16, dtype=torch.float32)}

    def parity(ctx, out, ref_out):
        return None if torch.equal(out, ref_out) else "mismatch"

    registry.register_op(registry.OpSpec(
        name=name, reference="ref", make_context=make_context,
        parity=parity, gate="bit-identity"))
    for impl in impls:
        def make_runner(ctx, impl=impl):
            return lambda: ctx["x"] * 2.0
        registry.register(registry.Candidate(op=name, impl=impl, make_runner=make_runner))


@pytest.fixture
def fake_op():
    name = "test.fake"
    _fake_op(name)
    yield name
    registry._OPS.pop(name, None)
    registry._CANDS.pop(name, None)


def _counters(prefix):
    return {k: v for k, v in obs.snapshot()["counters"].items() if k.startswith(prefix)}


def _delta(before, after):
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


# ---------------------------------------------------------------------------
# the cases of tests/test_tune.py on the port's CPU route
# ---------------------------------------------------------------------------

def test_shape_bucket_powers_of_two():
    assert tcache.shape_bucket(1) == 1
    assert tcache.shape_bucket(4096) == 4096
    assert tcache.shape_bucket(4097) == 8192
    assert tcache.shape_bucket(50_000) == 65_536
    assert tcache.shape_bucket(25_000_000) == 1 << 25
    key = tcache.cache_key("cpu", "fz.compress", 50_000, "float32", "cpu")
    assert key == "cpu|fz.compress|pow2:65536|float32|cpu"


def test_cache_roundtrip_persistence(tmp_path):
    path = tmp_path / "tc.json"
    tc = tcache.TuneCache(path).load()
    assert tc.status == "missing" and len(tc) == 0
    key = tcache.cache_key("cpu", "op", 4096, "float32", "cpu")
    tc.put(key, {"impl": "staged", "measured_us": {"staged": 1.0}})
    tc.save()
    tc2 = tcache.TuneCache(path).load()
    assert tc2.status == "ok"
    assert tc2.get(key)["impl"] == "staged"


def test_cache_schema_bump_invalidates(tmp_path):
    path = tmp_path / "tc.json"
    doc = {"schema": tcache.SCHEMA_VERSION + 1, "entries": {"k": {"impl": "fused"}}}
    path.write_text(json.dumps(doc))
    tc = tcache.TuneCache(path).load()
    assert tc.status == "schema-mismatch" and len(tc) == 0


@pytest.mark.parametrize("blob", [b"{not json", b"", b"[1,2,3]", b"\x00\xff"])
def test_cache_corrupt_file_recovers(tmp_path, blob):
    path = tmp_path / "tc.json"
    path.write_bytes(blob)
    tc = tcache.TuneCache(path).load()
    assert len(tc) == 0          # never raises, loads empty
    tc.put("k", {"impl": "staged"})
    tc.save()                    # rewrites a clean file
    assert tcache.TuneCache(path).load().status == "ok"


def test_default_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv(tcache.ENV_VAR, raising=False)
    assert tcache.default_path().parts[-2:] == ("repro_torch", "tune_cache.json")
    monkeypatch.setenv(tcache.ENV_VAR, str(tmp_path / "x.json"))
    assert tcache.default_path() == tmp_path / "x.json"
    assert tcache.ENV_VAR == "REPRO_TORCH_TUNE_CACHE"


def test_truncated_cache_retunes_cleanly(tmp_path, fake_op):
    path = tmp_path / "tc.json"
    tc = dispatch.configure(path)
    try:
        entry, measured = tuner.tune_op(fake_op, n=64, dtype="float32", cache=tc, **QUIET)
        assert measured and entry["impl"] in ("ref", "fast")
        # truncate the file mid-stream, then reload: the tuner must measure
        # again (clean retune) and write a valid file back
        path.write_bytes(path.read_bytes()[: path.stat().st_size // 2])
        tc = dispatch.configure(path)
        entry2, measured2 = tuner.tune_op(fake_op, n=64, dtype="float32", cache=tc, **QUIET)
        assert measured2
        assert tcache.TuneCache(path).load().status == "ok"
    finally:
        dispatch.reset()


def test_shape_bucket_collapsing(tmp_cache, fake_op):
    _, measured = tuner.tune_op(fake_op, n=3000, dtype="float32", cache=tmp_cache, **QUIET)
    assert measured
    # 3000 and 4096 share the pow2:4096 bucket -> pure cache hit
    _, measured2 = tuner.tune_op(fake_op, n=4096, dtype="float32", cache=tmp_cache, **QUIET)
    assert not measured2
    # a different bucket tunes afresh
    _, measured3 = tuner.tune_op(fake_op, n=8192, dtype="float32", cache=tmp_cache, **QUIET)
    assert measured3


def test_second_run_zero_measurements(tmp_cache, fake_op):
    workloads = [(fake_op, 64, "float32"), (fake_op, 256, "float32")]
    s1 = tuner.ensure_tuned(workloads, cache=tmp_cache, **QUIET)
    assert s1["misses"] == 2 and s1["measurements"] > 0
    s2 = tuner.ensure_tuned(workloads, cache=tmp_cache, **QUIET)
    assert s2["hits"] == 2 and s2["misses"] == 0 and s2["measurements"] == 0
    assert s2["backend"] == "cpu" and s2["arch"] == "cpu"


def test_parity_gate_rejects_wrong_candidate(tmp_cache, fake_op):
    def make_runner(ctx):
        return lambda: ctx["x"] * -1.0   # instant, structurally right, wrong
    evil = registry.Candidate(op=fake_op, impl="evil", make_runner=make_runner)
    with registry.scoped(evil):
        entry, _ = tuner.tune_op(fake_op, n=64, dtype="float32", cache=tmp_cache, **QUIET)
    assert entry["impl"] != "evil"
    assert "evil" in entry["rejected"]
    assert "evil" not in entry["measured_us"]   # never even timed


def test_parity_gate_rejects_wrong_fz_decode(tmp_cache):
    """The seeded wrong-output candidate on the real fz.decompress op: zeroed
    reconstructions are instant but fail bit-identity."""
    evil = impls.evil_candidate("fz.decompress")
    with registry.scoped(evil):
        entry, _ = tuner.tune_op("fz.decompress", n=4096, dtype="float32", cache=tmp_cache,
                                 **QUIET)
    assert entry["impl"] != "evil"
    assert "bit-identical" in entry["rejected"]["evil"]
    assert entry["gate"] == "bit-identity"
    assert set(entry["measured_us"]) == {"reference", "staged", "fused"}


def test_compress_parity_gate_is_error_bound(tmp_cache):
    evil = impls.evil_candidate("fz.compress")
    with registry.scoped(evil):
        entry, _ = tuner.tune_op("fz.compress", n=4096, dtype="float32", cache=tmp_cache,
                                 **QUIET)
    assert entry["impl"] != "evil"
    assert "error bound" in entry["rejected"]["evil"]
    assert entry["gate"] == "error-bound"


def test_a_raising_candidate_propagates(tmp_cache, fake_op):
    def make_runner(ctx):
        def run():
            raise RuntimeError("launch failed")
        return run
    with registry.scoped(registry.Candidate(op=fake_op, impl="broken", make_runner=make_runner)):
        with pytest.raises(RuntimeError, match="launch failed"):
            tuner.tune_op(fake_op, n=64, dtype="float32", cache=tmp_cache, **QUIET)


def test_fallback_ordering(tmp_cache):
    """No cache entry: fused first on both backends (a deliberate difference:
    the reference puts staged first on its interpret and gpu backends)."""
    assert dispatch.backend(CPU) == "cpu" and dispatch.backend("cuda") == "cuda"
    assert dispatch.arch(CPU) == "cpu"
    assert dispatch.FZ_FALLBACK == ("fused", "staged", "reference")
    assert tune.resolve_fz("compress", 4096, "float32", CPU) == "fused"
    assert tune.resolve_fz("decompress", 4096, "float32", CPU) == "fused"
    # untuned decode attention honors the explicit kernel request
    assert tune.decode_attention_impl(4096, "bfloat16", CPU) == "kernel"


def test_cached_winner_overrides_fallback(tmp_cache):
    key = tcache.cache_key("cpu", "fz.decompress", 4096, "float32", "cpu")
    tmp_cache.put(key, {"impl": "staged"})
    dispatch.invalidate_memo()
    assert tune.resolve_fz("decompress", 4096, "float32", CPU) == "staged"
    # another backend's entry is not this one's
    assert tune.resolve_fz("decompress", 4096, "float32", CPU) == "staged"
    tmp_cache.put(tcache.cache_key("cpu", "decode_attention", 4096, "bfloat16", "cpu"),
                  {"impl": "jnp"})
    dispatch.invalidate_memo()
    assert tune.decode_attention_impl(4096, torch.bfloat16, CPU) == "jnp"


def test_auto_resolution_in_fzconfig(tmp_cache):
    """kernel_mode="auto" is the default and resolves at the entry point; the
    resolved config is concrete (never "auto")."""
    cfg = fz.FZConfig(eb=1e-3, use_kernels=True, exact_outliers=False)
    assert cfg.kernel_mode == "auto"
    r = fz._resolved(cfg, "compress", 4096, "float32", CPU)
    assert r.kernel_mode in ("staged", "fused")
    # reference winner maps to use_kernels=False
    key = tcache.cache_key("cpu", "fz.compress", 4096, "float32", "cpu")
    tmp_cache.put(key, {"impl": "reference"})
    dispatch.invalidate_memo()
    r2 = fz._resolved(cfg, "compress", 4096, "float32", CPU)
    assert not r2.use_kernels
    # non-auto and non-kernel configs pass through untouched
    explicit = fz.FZConfig(eb=1e-3, use_kernels=True, kernel_mode="fused", exact_outliers=False)
    assert fz._resolved(explicit, "compress", 4096, "float32", CPU) is explicit
    # internal callers take "auto" as the static fallback's first route
    assert fz._fused(cfg) and fz._path(cfg) == "fused"


def test_cached_staged_winner_routes_auto_through_staged(tmp_cache, monkeypatch):
    """With a cached ``staged`` winner an "auto" call goes through the staged
    wrappers (their plain versions here) and ``fz_dispatches{path=staged}``
    counts it."""
    x = np.cumsum(np.random.default_rng(5).standard_normal(5000).astype(np.float32))
    for op in ("fz.compress", "fz.decompress"):
        tmp_cache.put(tcache.cache_key("cpu", op, x.size, "float32", "cpu"), {"impl": "staged"})
    dispatch.invalidate_memo()
    calls = []
    for name in ("lorenzo_quant_ref", "bitshuffle_flag_ref", "bitunshuffle_ref",
                 "fused_compress_ref", "fused_shuffle_encode_ref", "fused_decompress_ref"):
        def spy(*args, _name=name, _fn=getattr(kref, name), **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(kref, name, spy)
    cfg = rt.FZConfig(exact_outliers=False)
    before = _counters("fz_dispatches")
    c = rt.compress(x, cfg, device="cpu")
    y = rt.decompress(c, cfg, device="cpu")
    assert calls == ["lorenzo_quant_ref", "bitshuffle_flag_ref", "bitunshuffle_ref"]
    assert _delta(before, _counters("fz_dispatches")) == {
        "fz_dispatches{op=compress,path=staged}": 1,
        "fz_dispatches{op=decompress,path=staged}": 1}
    plain = rt.FZConfig(exact_outliers=False, use_kernels=False)
    assert torch.equal(y, rt.decompress(rt.compress(x, plain, device="cpu"), plain,
                                        device="cpu"))


def test_dispatch_counts_each_resolution_and_nothing_at_trace_time(tmp_cache, monkeypatch):
    before = _counters("tune_")
    tune.resolve_fz("compress", 4096, "float32", CPU)
    tune.resolve_fz("compress", 4000, "float32", CPU)       # the same bucket: memoized
    assert _delta(before, _counters("tune_")) == {
        "tune_cache{result=miss,site=dispatch}": 2,
        "tune_selected{impl=fused,op=fz.compress,site=dispatch}": 2}
    monkeypatch.setattr(dispatch.spans, "trace_time", lambda: True)
    before = _counters("tune_")
    assert tune.resolve_fz("compress", 4096, "float32", CPU) == "fused"
    assert _counters("tune_") == before
    monkeypatch.undo()
    with obs.disabled():
        tune.resolve_fz("compress", 4096, "float32", CPU)
    assert _counters("tune_") == before


def test_budget_skip_smem_overflow():
    """analysis integration: the port's own launches are not skipped at the
    reference's 1M-element point (where the reference's fused megakernels
    overflow VMEM) and at 2^26 -- here their shared bytes are not measured,
    the card holds them to the limit (``chip_smoke.py`` phase 13); a launch
    asking for more shared memory than a CTA can have is skipped, not
    measured."""
    for op in ("fz.compress", "fz.decompress"):
        cands = {c.impl: c for c in registry.candidates(op)}
        for n in (4096, 1 << 20, 1 << 26):
            for mode in ("paper", "strict"):
                ctx = {"n": n, "dtype": "float32", "shape": (n,), "strict": mode == "strict",
                       "container": SimpleNamespace(outlier_idx=torch.zeros(n // 256))}
                for impl in ("fused", "staged", "reference"):
                    assert tuner._budget_skip(cands[impl], ctx) is None
    huge = registry.Candidate(op="fz.compress", impl="huge", make_runner=None,
                              kernel_specs=lambda ctx: [_overflow_spec()])
    why = tuner._budget_skip(huge, {"n": 4096, "dtype": "float32"})
    assert why is not None and "smem-overflow" in why


def test_tuner_records_skips_in_entry(tmp_cache, fake_op):
    cand = registry._CANDS[fake_op]["fast"]
    skipping = registry.Candidate(op=fake_op, impl="huge", make_runner=cand.make_runner,
                                  kernel_specs=lambda ctx: [_overflow_spec()])
    with registry.scoped(skipping):
        entry, _ = tuner.tune_op(fake_op, n=64, dtype="float32", cache=tmp_cache, **QUIET)
    assert "huge" in entry["skipped"] and "smem-overflow" in entry["skipped"]["huge"]
    assert "huge" not in entry["measured_us"]


@pytest.fixture
def on_the_card(monkeypatch):
    """The tuner's backend label set to ``cuda`` (the card's rules) while the
    tensors stay on the CPU."""
    monkeypatch.setattr(dispatch, "backend", lambda device="cuda": "cuda")
    monkeypatch.setattr(dispatch, "arch", lambda device="cuda": "NVIDIA_H100_80GB_HBM3")


def test_on_the_card_the_plain_route_is_measured_never_chosen(tmp_cache, fake_op,
                                                             on_the_card):
    slow = registry.Candidate(op=fake_op, impl="fast", make_runner=lambda ctx: lambda: (
        time.sleep(0.002), ctx["x"] * 2.0)[1])
    with registry.scoped(slow):
        entry, measured = tuner.tune_op(fake_op, n=64, dtype="float32", cache=tmp_cache,
                                        **QUIET)
    assert measured and entry["backend"] == "cuda"
    assert entry["measured_us"]["ref"] < entry["measured_us"]["fast"]
    assert entry["impl"] == "fast"
    # decode attention: the kernel, whatever the plain route measured
    entry, _ = tuner.tune_op("decode_attention", n=4096, dtype="float32", cache=tmp_cache,
                             **QUIET)
    assert entry["impl"] == "kernel" and set(entry["measured_us"]) == {"jnp", "kernel"}


@pytest.mark.parametrize("fault", ["rejected", "skipped"])
def test_on_the_card_a_skipped_or_rejected_kernel_route_raises(tmp_cache, fake_op,
                                                               on_the_card, fault):
    if fault == "rejected":
        bad = registry.Candidate(op=fake_op, impl="bad",
                                 make_runner=lambda ctx: lambda: ctx["x"] * -1.0)
    else:
        bad = registry.Candidate(op=fake_op, impl="bad",
                                 make_runner=registry._CANDS[fake_op]["fast"].make_runner,
                                 kernel_specs=lambda ctx: [_overflow_spec()])
    with registry.scoped(bad):
        with pytest.raises(tuner.TuneError, match="on the card") as err:
            tuner.tune_op(fake_op, n=64, dtype="float32", cache=tmp_cache, **QUIET)
    assert set(getattr(err.value, fault)) == {"bad"}
    assert "bad" not in err.value.measured_us and len(tmp_cache) == 0


def test_dispatch_refuses_a_cached_plain_route_on_the_card(tmp_cache, monkeypatch):
    monkeypatch.setattr(dispatch, "arch", lambda device="cuda": "NVIDIA_H100_80GB_HBM3")
    card = torch.device("cuda")
    for op, impl, n, dtype in (("fz.compress", "reference", 4096, "float32"),
                               ("decode_attention", "jnp", 4096, "bfloat16")):
        tmp_cache.put(tcache.cache_key("cuda", op, n, dtype, "NVIDIA_H100_80GB_HBM3"),
                      {"impl": impl})
    dispatch.invalidate_memo()
    with pytest.raises(ValueError, match="plain route 'reference'"):
        tune.resolve_fz("compress", 4096, "float32", card)
    with pytest.raises(ValueError, match="plain route 'jnp'"):
        tune.decode_attention_impl(4096, "bfloat16", card)
    assert tune.resolve_fz("decompress", 4096, "float32", card) == "fused"   # untuned


@pytest.mark.parametrize("mode", ["paper", "strict"])
@pytest.mark.parametrize("shape", [(12000,), (40, 300), (6, 40, 50)])
def test_fz_context_takes_the_callers_shape_and_mode(tmp_cache, shape, mode):
    """A 1-3D field in either mode: the same draws reshaped, every route through
    its gate on that shape and mode, the geometry kept in the entry."""
    n = int(np.prod(shape))
    flat = impls._fz_context(n=n, dtype="float32", device="cpu")
    ctx = impls._fz_context(n=n, dtype="float32", device="cpu", shape=shape, mode=mode)
    assert ctx["data"].shape == shape and torch.equal(ctx["data"].reshape(-1), flat["data"])
    assert ctx["strict"] == (mode == "strict") and ctx["container"].shape == shape
    assert ctx["ref_cfg"].exact_outliers == ctx["strict"] and not flat["ref_cfg"].exact_outliers
    for op in ("fz.compress", "fz.decompress"):
        entry, _ = tuner.tune_op(op, n=n, dtype="float32", cache=tmp_cache, force=True,
                                 geometry={"shape": shape, "mode": mode}, **QUIET)
        assert not entry["rejected"] and set(entry["measured_us"]) == {
            "reference", "staged", "fused"}
        assert entry["geometry"] == {"shape": shape, "mode": mode}
    with pytest.raises(ValueError, match="mode"):
        impls._fz_context(n=n, dtype="float32", device="cpu", mode="exact")


@pytest.mark.parametrize("batch", [1, 3])
def test_engine_attention_workload_is_its_paged_route(tmp_cache, monkeypatch, batch):
    """The engine's tuning point carries its geometry; both candidates then
    run ``paged_decode_attention`` over pages of the pool's size, as the
    engine's decode step does, and agree within the gate."""
    from repro_torch.serve.kvpool import attention as paged
    cfg = configs.get("yi-6b", smoke=True)
    model = zoo.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    pool = PoolConfig(num_pages=4, page_size=4, seq_capacity=16)
    op, n, dtype, geometry = Engine(model, params, pool=pool,
                                    device="cpu").attention_workload(batch=batch)
    assert (op, n, dtype) == ("decode_attention", 16 * cfg.n_kv_heads * cfg.hd, "bfloat16")
    assert geometry == {"kvh": cfg.n_kv_heads, "g": cfg.n_heads // cfg.n_kv_heads,
                        "d": cfg.hd, "page_size": 4, "batch": batch}
    ctx = impls._attn_context(n=n, dtype=dtype, device="cpu", **geometry)
    assert ctx["k_pages"].shape == (batch, 4, 4, cfg.n_kv_heads, cfg.hd)
    assert ctx["q"].shape == (batch, cfg.n_heads, cfg.hd)
    routes = []
    real = paged.paged_decode_attention
    monkeypatch.setattr(paged, "paged_decode_attention",
                        lambda *a, **kw: routes.append(kw["use_kernels"]) or real(*a, **kw))
    summary = tuner.ensure_tuned([(op, n, dtype, geometry)], cache=tmp_cache, **QUIET)
    r = summary["results"][0]
    assert not r["rejected"] and r["geometry"] == geometry
    assert set(r["measured_us"]) == {"jnp", "kernel"} and {False, True} <= set(routes)


def _overflow_spec():
    return KernelSpec(name="seeded", module="fz_compress.cu", symbol="encode_tiles",
                      grid=(1,), threads=256, dynamic_smem=300 * 1024, point="seeded")


def test_cli_smoke_json(tmp_path, capsys):
    from repro_torch.tune import __main__ as cli
    cache_path = str(tmp_path / "cli_cache.json")
    args = ["--smoke", "--cache", cache_path, "--json", "--device", "cpu"]
    try:
        assert cli.main(args) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["misses"] == len(out["results"]) == len(cli.SMOKE_WORKLOADS)
        assert out["backend"] == "cpu" and out["measurements"] > 0
        assert all(not r["rejected"] and not r["skipped"] for r in out["results"])
        assert cli.main(args) == 0
        out2 = json.loads(capsys.readouterr().out)
        assert out2["measurements"] == 0 and out2["misses"] == 0
        assert out2["hits"] == len(cli.SMOKE_WORKLOADS)
        hits = "tune_cache{result=hit,site=tuner}"     # process-wide counters: the delta
        assert out2["counters"][hits] - out["counters"].get(hits, 0) == len(cli.SMOKE_WORKLOADS)
        assert cli.main(["--dump", "--cache", cache_path]) == 0
        assert "fz.decompress" in capsys.readouterr().out
    finally:
        dispatch.reset()


def test_engine_resolves_decode_attention_once(tmp_cache, monkeypatch):
    """The engine asks the tuner at construction (the pool's cache size and
    type); a cached ``jnp`` winner sends paged decode through the plain
    partials, the kernel otherwise."""
    cfg = configs.get("yi-6b", smoke=True)
    model = zoo.build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    pool = PoolConfig(num_pages=4, page_size=4, seq_capacity=16)
    n = tune.attn_cache_elems(pool.seq_capacity, cfg.n_kv_heads, cfg.hd)
    assert Engine(model, params, pool=pool, device="cpu").decode_attention == "kernel"
    assert Engine(model, params, device="cpu").decode_attention is None
    assert Engine(model, params, pool=PoolConfig(num_pages=4, page_size=4, seq_capacity=16,
                                                 use_kernels=False),
                  device="cpu").decode_attention is None
    tmp_cache.put(tcache.cache_key("cpu", "decode_attention", n, "bfloat16", "cpu"),
                  {"impl": "jnp"})
    dispatch.invalidate_memo()
    eng = Engine(model, params, pool=pool, device="cpu")
    assert eng.decode_attention == "jnp" and eng.paged_decode_enabled
    seen = []
    monkeypatch.setattr(zoo.Model, "decode_paged",
                        lambda self, p, pages, t, use_kernels: seen.append(use_kernels))
    eng.decode_step_paged({}, torch.zeros(1, dtype=torch.int32))
    assert seen == [False]


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

def _ns():
    rng = np.random.default_rng(0)
    pows = [1 << e for e in range(28)]
    return sorted({0, *pows, *(p - 1 for p in pows), *(p + 1 for p in pows),
                   *rng.integers(0, 1 << 27, size=200).tolist()})


def test_bucket_and_key_agree_with_reference(ref):
    for n in _ns():
        assert tcache.shape_bucket(n) == ref.shape_bucket(n), n
        assert tcache.cache_key("cpu", "fz.compress", n, "bfloat16", "cpu") == \
            ref.cache_key("cpu", "fz.compress", n, "bfloat16", "cpu"), n
    assert tcache.SCHEMA_VERSION == ref.SCHEMA_VERSION


def test_cache_files_byte_identical_and_interchangeable(ref, tmp_path):
    entries = {tcache.cache_key("cuda", op, n, dt, "NVIDIA_H100_80GB_HBM3"): {
        "impl": "fused", "measured_us": {"fused": 12.5, "reference": 99.0, "staged": 40.25},
        "skipped": {}, "rejected": {"evil": "decode not bit-identical"}, "bucket": n,
        "dtype": dt, "op": op, "k": 3, "warmup": 1}
        for op in ("fz.compress", "fz.decompress") for n in (4096, 1 << 25)
        for dt in ("float32", "bfloat16")}
    mine, theirs = tcache.TuneCache(tmp_path / "port.json"), ref.TuneCache(tmp_path / "ref.json")
    for key, e in entries.items():
        mine.put(key, e)
        theirs.put(key, e)
    mine.save()
    theirs.save()
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert ref.TuneCache(tmp_path / "port.json").load().entries == entries
    assert tcache.TuneCache(tmp_path / "ref.json").load().entries == entries


def _assert_same(jarr, t):
    a = np.asarray(jarr)
    b = t.detach().cpu()
    b = b.view(torch.int16).numpy().view(np.uint16) if b.dtype == torch.bfloat16 else b.numpy()
    if a.dtype == jnp.bfloat16:
        a = a.view(np.uint16)
    assert a.shape == b.shape
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


@pytest.mark.parametrize("n,dtype", [(4096, "float32"), (5000, "bfloat16")])
def test_fz_context_equals_reference(ref, n, dtype):
    from repro.tune import impls as jimpls
    jctx = jimpls._fz_context(n=n, dtype=dtype)
    ctx = impls._fz_context(n=n, dtype=dtype, device="cpu")
    _assert_same(jctx["data"], ctx["data"])
    for f in fz.FZCompressed.FIELDS:
        _assert_same(getattr(jctx["container"], f), getattr(ctx["container"], f))
    assert jctx["container"].dtype_name == ctx["container"].dtype_name
    assert tuple(jctx["container"].shape) == ctx["container"].shape


def test_auto_containers_equal_reference(ref, tmp_cache):
    """Untuned "auto" on both packages (the reference takes its staged
    fallback here, the port its fused one): the same containers and
    reconstructions, and each the plain route's."""
    from repro.core import fz as jfz
    x = np.cumsum(np.random.default_rng(3).standard_normal(4096).astype(np.float32)) * 0.1
    jauto = jfz.FZConfig(eb=1e-3, use_kernels=True, exact_outliers=False)
    auto = rt.FZConfig(eb=1e-3, exact_outliers=False)
    jc = jfz.compress(jnp.asarray(x), jauto)
    c = rt.compress(x, auto, device="cpu")
    for f in fz.FZCompressed.FIELDS:
        _assert_same(getattr(jc, f), getattr(c, f))
    _assert_same(jfz.decompress(jc, jauto), rt.decompress(c, auto, device="cpu"))


@pytest.mark.parametrize("op", ["fz.compress", "fz.decompress"])
def test_parity_gate_verdicts_equal_reference(ref, op):
    from repro.tune import impls as jimpls
    n = 4096
    jctx, ctx = jimpls._fz_context(n=n, dtype="float32"), impls._fz_context(
        n=n, dtype="float32", device="cpu")
    jspec, spec = jimpls.registry.op(op), registry.op(op)

    def outputs(mod, context):
        cands = {c.impl: c for c in mod.registry.candidates(op)}
        good = cands["reference"].make_runner(context)()
        bad = mod.evil_candidate(op).make_runner(context)()
        return good, bad
    jgood, jbad = outputs(jimpls, jctx)
    good, bad = outputs(impls, ctx)
    for jout, out in ((jgood, good), (jbad, bad)):
        jv, v = jspec.parity(jctx, jout, jgood), spec.parity(ctx, out, good)
        assert (jv is None) == (v is None), (jv, v)
    assert spec.parity(ctx, good, good) is None and spec.parity(ctx, bad, good) is not None


def test_plain_decode_attention_agrees_with_reference(ref):
    from repro.models.attention import decode_attention as jdecode
    rng = np.random.default_rng(7)
    b, s, kvh, g, d = impls._attn_geometry(4096)
    q = rng.standard_normal((b, kvh * g, d), dtype=np.float32)
    k = rng.standard_normal((b, s, kvh, d), dtype=np.float32)
    v = rng.standard_normal((b, s, kvh, d), dtype=np.float32)
    length = np.array([s, s // 2], np.int32)
    want = np.asarray(jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(length)))
    got = attention.decode_attention(*(torch.from_numpy(t) for t in (q, k, v, length)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def test_attention_context_and_gate_on_the_cpu(tmp_cache):
    """decode_attention tunes on the CPU: the kernel route's plain version
    passes the gate against the plain attention, in f32 and bf16."""
    for dtype in ("float32", "bfloat16"):
        entry, measured = tuner.tune_op("decode_attention", n=4096, dtype=dtype,
                                        cache=tmp_cache, **QUIET)
        assert measured and not entry["rejected"] and set(entry["measured_us"]) == {
            "jnp", "kernel"}
        assert entry["gate"] == "tolerance"
    ctx = impls._attn_context(n=4096, dtype="float32", device="cpu")
    assert ctx["geometry"] == (2, 32, 2, 2, 64) and ctx["q"].shape == (2, 4, 64)
