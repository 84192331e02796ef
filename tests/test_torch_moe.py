"""The port's MoE decoders (dbrx-132b, llama4-scout-17b-a16e) against the reference, on the CPU.

The reference runs in this process with the two jax 0.9 aliases (the
function-scoped ``ref`` fixture, or a module-scoped ``MonkeyPatch.context()``
where a fixture outlives one test). Parameters come from the reference's
``model.init(jax.random.key(0))`` and are carried over bit for bit with
``interop.params_from_reference`` (the router float32, the rest bfloat16);
inputs are numpy arrays from a seed.

Tolerances (each measured on this box, then pinned with room):

* **routing on exactly representable inputs** (small integers times powers
  of two, so every float32 partial sum of the router logits is exact): the
  top-k indices, the one-hot slots (positions and drops) and the dispatch
  mask are equal to the reference's, bit for bit, ties included; the combine
  weights and the output ``ROUTE_TOL`` 1e-6 (float32 ``exp`` of another
  library, measured 6e-8) and ``OUT_TOL`` 0.0625 (bfloat16, measured 0.0156),
  ``aux`` 1e-6 relative;
* **random inputs at the SMOKE size**: indices equal wherever the reference's
  logits hold no near tie (adjacent sorted logits among the top k + 1 closer
  than one bfloat16 ulp), outputs ``OUT_TOL`` where a token's kept experts
  are the same, ``aux`` 1e-3 relative;
* **float32 ``forward_train``** against the compiled reference: loss 2e-5
  relative, every gradient leaf 2e-5 of its max |g| (measured 1.7e-6);
* **bfloat16 ``forward_train``** against the reference run op by op
  (``jax.disable_jit``): loss ``BF16_LOSS_TOL`` 5e-4 absolute (measured
  1e-5), each gradient leaf ``GRAD_TOL`` 0.05 of its max |g| (measured 0.04),
  as the dense test. The compiled reference keeps some bfloat16 chains in
  float32 and so differs from its own op-by-op run by up to 1e-2 in the
  loss: a rounding on the other side moves a router logit across a near tie
  and a token takes another expert. The port's eager ops round where the
  op-by-op reference does (measured 1e-5 to 4e-4 from it, 3e-4 to 1e-2 from
  the compiled one);
* **logits** of prefill / decode / paged decode / suffix prefill: ``LOGIT_TOL``
  0.125 absolute, as the dense test (measured 0.031);
* **the reference's ``Trainer``** run op by op against the port's, 4 steps:
  loss 1e-3 relative (measured 2.3e-5; 1.2e-3 from the compiled ``Trainer``).
  The reference's ``Trainer`` donates the float32 router twice (its AdamW
  master copy of a float32 leaf is the leaf itself, ``repro/optim/adamw.py:31``,
  and XLA refuses the double donation), so the test hands it a copy of its
  optimizer state first.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import nn as jnn
from repro.models import zoo as jzoo
from repro_torch import configs, interop, obs, pytree
from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe, zoo
from repro_torch.serve import Engine
from repro_torch.serve.kvpool import PoolConfig, pages_from_cache, tracegen

MOE_ARCHS = ["dbrx-132b", "llama4-scout-17b-a16e"]
VLM_ARCH = "qwen2-vl-72b"
RECURRENT_AUDIO_ARCHS = ["rwkv6-3b", "zamba2-2.7b", "whisper-tiny"]
ROUTE_TOL = 1e-6
OUT_TOL = 0.0625
LOGIT_TOL = 0.125
BF16_LOSS_TOL = 5e-4
GRAD_TOL = 0.05
STEP_LOSS_RTOL = 1e-3
SCHED_FIELDS = ("decode_steps", "admissions", "preemptions", "resumes", "completed",
                "tiered_pages", "pool_compressions", "pool_decompressions", "prefix_hits",
                "prefill_tokens", "prefill_tokens_saved", "cow_promotions",
                "shared_cold_reads_deduped", "decompress_dispatches", "ttft_steps",
                "itl_steps")


def _aliases(mp):
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    mp.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
    mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)


@pytest.fixture
def ref(monkeypatch):
    """The reference's model zoo with the jax 0.9 aliases, for one test."""
    _aliases(monkeypatch)
    yield jzoo
    jax.clear_caches()


@pytest.fixture(scope="module", params=MOE_ARCHS)
def models(request):
    """(reference model, its params, port model, the same params in the port)."""
    arch = request.param
    jm = jzoo.build(jconfigs.get(arch, smoke=True))
    jp = jm.init(jax.random.key(0))
    tp = interop.params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, zoo.build(configs.get(arch, smoke=True)), tp


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [*MOE_ARCHS, VLM_ARCH, *RECURRENT_AUDIO_ARCHS])
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(arch, smoke):
    """``CONFIG`` and ``SMOKE`` field for field, every field of the reference's
    schema."""
    j, t = jconfigs.get(arch, smoke=smoke), configs.get(arch, smoke=smoke)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (t.hd, t.attention_free, t.supports_long_context) == \
        (j.hd, j.attention_free, j.supports_long_context)
    jm, m = jzoo.build(j), zoo.build(t)
    assert m.param_count() == jm.param_count()
    assert m.active_param_count() == jm.active_param_count()


@pytest.mark.parametrize("arch", RECURRENT_AUDIO_ARCHS)
def test_recurrent_and_audio_archs_build(arch):
    """They resolve, full and SMOKE, and build without the page-native paths, as
    the reference's gate (``repro/models/zoo.py:159``); their own tests are
    ``tests/test_torch_ssm.py`` and ``tests/test_torch_audio.py``."""
    for smoke in (False, True):
        cfg = configs.get(arch, smoke=smoke)
        assert cfg.family == jconfigs.get(arch).family
        model = zoo.build(cfg)
        assert model.decode_paged is None and model.prefill_suffix is None


def test_full_width_two_layer_counts():
    """The parameter counts of the published widths cut to 2 layers, as
    ``chip_smoke.py`` phase 16 serves them, equal to the reference's."""
    want = {"dbrx-132b": 7_751_301_120, "llama4-scout-17b-a16e": 6_473_180_160,
            VLM_ARCH: 4_246_773_760}
    for arch, n in want.items():
        cfg = dataclasses.replace(configs.get(arch), n_layers=2)
        jcfg = dataclasses.replace(jconfigs.get(arch), n_layers=2)
        assert zoo.build(cfg).param_count() == jzoo.build(jcfg).param_count() == n


def test_params_carry_over_with_a_float32_router(models):
    jm, jp, m, tp = models
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    names = {jax.tree_util.keystr(p) for p, _ in jleaves}
    assert {"['layers']['router']", "['layers']['we_gate']"} <= names
    assert [k for k, _ in pytree.leaves_with_keys(tp)] == \
        [jax.tree_util.keystr(p) for p, _ in jleaves]
    for path, leaf in jleaves:
        node = tp
        for key in path:
            node = node[key.key]
        want = torch.float32 if path[-1].key == "router" else torch.bfloat16
        assert node.dtype == want and tuple(node.shape) == leaf.shape
        a = np.asarray(leaf)
        bits = np.int32 if want == torch.float32 else np.int16
        tbits = torch.int32 if want == torch.float32 else torch.int16
        assert np.array_equal(a.view(bits), node.view(tbits).numpy())
    specs, jspecs = m.param_specs(), jm.param_specs()
    assert specs["layers"]["router"] == jspecs["layers"]["router"]
    assert specs["layers"]["we_down"] == jspecs["layers"]["we_down"]


# ---------------------------------------------------------------------------
# top-k and routing
# ---------------------------------------------------------------------------

def test_top_k_breaks_ties_as_lax_top_k():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 4, (64, 16)).astype(np.float32) * 0.25   # many ties
    scores[0] = 0.5                                                   # all tied
    for k in (1, 2, 4, 16):
        jv, ji = jax.lax.top_k(jnp.asarray(scores), k)
        tv, ti = moe.top_k(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _capture(mp):
    """Record the reference's ``top_k`` results and ``einsum`` operands."""
    seen = {"top_k": [], "einsum": []}
    top_k, einsum = jax.lax.top_k, jnp.einsum

    def rec_top_k(x, k):
        out = top_k(x, k)
        seen["top_k"].append(out)
        return out

    def rec_einsum(spec, *ops, **kw):
        out = einsum(spec, *ops, **kw)
        seen["einsum"].append((spec, ops, out))
        return out
    mp.setattr(jax.lax, "top_k", rec_top_k)
    mp.setattr(jnp, "einsum", rec_einsum)
    return seen


def _ref_route(lp, h, cfg):
    """The reference's ``moe_apply`` run eagerly, with its routing: idx, the
    one-hot slots (G, g, k, C), dispatch and combine."""
    with pytest.MonkeyPatch.context() as mp:
        seen = _capture(mp)
        y, aux = jmoe.moe_apply(lp, h, cfg)
    (_, idx), = seen["top_k"]
    by_spec = {spec: (ops, out) for spec, ops, out in seen["einsum"]}
    (m, oh_pos), dispatch = by_spec["gtke,gtkc->gtec"]
    _, combine = by_spec["gtk,gtke,gtkc->gtec"]
    return {"y": y, "aux": aux, "idx": idx, "oh_pos": oh_pos, "dispatch": dispatch,
            "combine": combine}


def _moe_cfgs(**kw):
    base = dict(arch_id="t", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                d_ff=64, vocab=128, n_experts=4, top_k=2, capacity_factor=1.0)
    base.update(kw)
    from repro.configs.base import ArchConfig as JArchConfig
    return JArchConfig(**base), ArchConfig(**base)


def _port_route(lp, h, cfg):
    B, S, d = h.shape
    T = B * S
    g = moe._group_size(T)
    C = max(1, int(g * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return moe.route(lp, h.reshape(T // g, g, d), cfg, C)


@pytest.mark.parametrize("top_k,cf", [(2, 0.5), (2, 1.25), (1, 0.5), (4, 1.0)])
def test_routing_exact_on_representable_inputs(ref, top_k, cf):
    """Inputs in small integers times powers of two: every partial sum of the
    router logits is exact in float32, so both packages see the same logits.
    Experts 1 and 3 have equal router columns (a tie on every token) and one
    token is all zeros (all experts tied); capacity drops at cf 0.5."""
    jcfg, cfg = _moe_cfgs(top_k=top_k, capacity_factor=cf)
    rng = np.random.default_rng(1)
    router = rng.integers(-2, 3, (32, 4)).astype(np.float32) * 0.25
    router[:, 3] = router[:, 1]
    h = rng.integers(-3, 4, (2, 16, 32)).astype(np.float32) * 0.5
    h[0, 5] = 0.0
    w = {name: rng.standard_normal(shape).astype(np.float32) * 0.2
         for name, shape in (("we_gate", (4, 32, 64)), ("we_up", (4, 32, 64)),
                             ("we_down", (4, 64, 32)))}
    jlp = {"router": jnp.asarray(router), **{k: jnp.asarray(v, jnp.bfloat16)
                                             for k, v in w.items()}}
    tlp = {"router": torch.from_numpy(router), **{k: torch.from_numpy(v).to(torch.bfloat16)
                                                  for k, v in w.items()}}
    jh, th = _bf16(h)
    want = _ref_route(jlp, jh, jcfg)
    got = _port_route(tlp, th, cfg)
    np.testing.assert_array_equal(got["idx"].numpy(), np.asarray(want["idx"]))
    np.testing.assert_array_equal(got["oh_pos"].numpy(), np.asarray(want["oh_pos"]))
    np.testing.assert_array_equal(got["dispatch"].numpy(), np.asarray(want["dispatch"]))
    np.testing.assert_allclose(got["combine"].numpy(), np.asarray(want["combine"]),
                               atol=ROUTE_TOL)
    idx = got["idx"].numpy()[0]
    if top_k >= 2:
        assert list(idx[5][:2]) == [0, 1]                 # the all-tied token: lowest first
        both = (idx == 1).any(-1) & (idx == 3).any(-1)
        assert both.any()
        for row in idx[both]:                             # 1 always before its twin 3
            assert list(row).index(1) < list(row).index(3)
    assert not (idx == 3).any(-1)[~(idx == 1).any(-1)].any()   # 3 never without 1
    drops = 1 - got["oh_pos"].numpy().sum(-1)
    if cf == 0.5:
        assert drops.sum() > 0
    y, aux = moe.moe_apply(tlp, th, cfg)
    np.testing.assert_allclose(f32(y), f32(want["y"]), atol=OUT_TOL)
    np.testing.assert_allclose(float(aux), float(want["aux"]), rtol=1e-6)


def test_moe_routing_respects_capacity():
    """The port's counterpart of ``tests/test_substrate.py::test_moe_routing_respects_capacity``,
    on the port's own init, with each expert's slots counted."""
    cfg = ArchConfig(arch_id="t", family="moe", n_layers=1, d_model=32, n_heads=2,
                     n_kv_heads=2, d_ff=64, vocab=128, n_experts=4, top_k=2,
                     capacity_factor=1.0)
    from repro_torch.models import nn as tnn
    params = tnn.init_tree(moe.moe_defs(cfg), torch.Generator().manual_seed(0), device="cpu")
    lp = {k: v[0] for k, v in params.items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16, 32))
                         .astype(np.float32)).to(torch.bfloat16)
    y, aux = moe.moe_apply(lp, x, cfg)
    assert y.shape == x.shape
    assert float(aux) >= 1.0 - 1e-3  # load-balance loss lower bound at E*mean
    r = _port_route(lp, x, cfg)
    C = r["dispatch"].shape[-1]
    assert C == 16
    per_slot = r["dispatch"].sum(1)                       # (G, E, C): tokens a slot
    assert per_slot.max() <= 1
    assert int(r["dispatch"].sum()) == int(r["keep"].sum()) <= 2 * 32


def test_random_smoke_inputs_route_as_the_reference(ref, models, record_property):
    """Random bfloat16 inputs through layer 0 of the SMOKE config: indices equal
    wherever the reference's logits hold no near tie, outputs within
    ``OUT_TOL`` at tokens whose kept experts agree; the share of tokens with
    the same route is reported."""
    jm, jp, m, tp = models
    cfg, jcfg = m.cfg, jm.cfg
    h = np.random.default_rng(2).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    jh, th = _bf16(h)
    jlp = jax.tree.map(lambda a: a[0], jp["layers"])
    tlp = {k: v[0] for k, v in tp["layers"].items()}
    want = _ref_route(jlp, jh, jcfg)
    got = _port_route(tlp, th, cfg)
    logits = f32(jnn.dense(jh, jlp["router"])).reshape(-1, cfg.n_experts)
    srt = -np.sort(-logits, axis=-1)[:, :cfg.top_k + 1]
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(srt[:, :-1]), 1e-30))) - 7)
    near = (srt[:, :-1] - srt[:, 1:] <= ulp).any(-1)
    gi, wi = got["idx"].numpy().reshape(-1, cfg.top_k), np.asarray(want["idx"]).reshape(
        -1, cfg.top_k)
    same = (gi == wi).all(-1)
    record_property("same_route_share", float(same.mean()))
    print(f"{cfg.arch_id}: same route in {same.mean():.4f} of {same.size} tokens, "
          f"{near.sum()} near ties")
    assert same[~near].all()
    kept = lambda d: (d.sum(-1) > 0).reshape(-1, cfg.n_experts)     # noqa: E731
    agree = (kept(got["dispatch"].numpy()) == kept(np.asarray(want["dispatch"]))).all(-1)
    y, aux = moe.moe_apply(tlp, th, cfg)
    diff = np.abs(f32(y) - f32(want["y"])).reshape(-1, cfg.d_model)
    assert agree.mean() >= 0.9 and diff[agree].max() <= OUT_TOL
    np.testing.assert_allclose(float(aux), float(want["aux"]), rtol=1e-3)


# ---------------------------------------------------------------------------
# forward passes (SMOKE, params carried over)
# ---------------------------------------------------------------------------

def _prompt(seed=0, B=2, S=24):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, (B, S), dtype=np.int32), np.asarray([S, S - 7], np.int32)


def _prefill_both(models):
    jm, jp, m, tp = models
    toks, lengths = _prompt()
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks), "lengths": jnp.asarray(lengths)})
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks),
                            "lengths": torch.from_numpy(lengths)})
    return (jl, jc), (tl, tc)


def _loss_and_grads_both(jm, jp, m, tp, arr, eager):
    """The reference compiled, or op by op (``jax.disable_jit``); the port eagerly."""
    jb = {"tokens": jnp.asarray(arr[:, :-1]), "labels": jnp.asarray(arr[:, 1:])}
    with jax.disable_jit(eager):
        (jl, jaux), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(jp, jb)
    flat = [p.detach().requires_grad_(True) for p in pytree.leaves(tp)]
    loss, aux = m.train_loss(pytree.unflatten(tp, flat),
                             {"tokens": torch.from_numpy(arr[:, :-1].copy()),
                              "labels": torch.from_numpy(arr[:, 1:].copy())})
    grads = torch.autograd.grad(loss, flat)
    assert float(loss.detach()) > float(aux["xent"].detach())    # the aux term is in the loss
    return (float(jl), float(jaux["xent"]), jg), (float(loss.detach()), float(aux["xent"]),
                                                  grads)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_loss_and_grads(ref, models, dtype):
    jm, jp, m, tp = models
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        tp = pytree.tree_map(lambda t: t.to(torch.float32), tp)
    arr = np.random.default_rng(0).integers(0, 512, (4, 33)).astype(np.int32)
    (jl, jx, jg), (tl, tx, tg) = _loss_and_grads_both(jm, jp, m, tp, arr,
                                                      eager=dtype == "bfloat16")
    if dtype == "float32":
        assert abs(tl - jl) <= 2e-5 * abs(jl) and abs(tx - jx) <= 2e-5 * abs(jx)
        for g, w in zip(tg, jax.tree.leaves(jg)):
            assert g.dtype == torch.float32
            assert np.abs(f32(g) - f32(w)).max() <= 2e-5 * np.abs(f32(w)).max()
    else:
        assert abs(tl - jl) <= BF16_LOSS_TOL and abs(tx - jx) <= BF16_LOSS_TOL
        assert [g.dtype for g in tg] == [t.dtype for t in pytree.leaves(tp)]
        for g, w in zip(tg, jax.tree.leaves(jg)):
            assert np.abs(f32(g) - f32(w)).max() <= GRAD_TOL * np.abs(f32(w)).max()


def test_forward_prefill(ref, models):
    (jl, jc), (tl, tc) = _prefill_both(models)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL)
    assert tc["k"].shape == jc["k"].shape and tc["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc["length"]))
    # the first layer's K/V see only the embedding: bit-identical
    np.testing.assert_array_equal(f32(tc["k"][0]), f32(jc["k"][0]))
    np.testing.assert_allclose(f32(tc["v"]), f32(jc["v"]), atol=LOGIT_TOL)


def _jcache(tc):
    return {"k": jnp.asarray(f32(tc["k"]), jnp.bfloat16),
            "v": jnp.asarray(f32(tc["v"]), jnp.bfloat16),
            "length": jnp.asarray(tc["length"].numpy())}


def test_forward_decode(ref, models):
    """Teacher-forced from the port's cache; ``positions`` is ignored outside M-RoPE."""
    jm, jp, m, tp = models
    _, (_, tc) = _prefill_both(models)
    jcache, tcache = _jcache(tc), dict(tc)
    for tok in ([5, 7], [300, 2], [11, 511]):
        tok = np.asarray(tok, np.int32)
        jl, jcache = jm.decode(jp, jcache, jnp.asarray(tok))
        tl, tcache = m.decode(tp, tcache, torch.from_numpy(tok))
        np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL)
        np.testing.assert_array_equal(tcache["length"].numpy(), np.asarray(jcache["length"]))
    pos = torch.zeros((2, 3, 1), dtype=torch.int32)
    tl2, _ = m.decode(tp, tc, torch.tensor([5, 7], dtype=torch.int32), positions=pos)
    tl1, _ = m.decode(tp, tc, torch.tensor([5, 7], dtype=torch.int32))
    assert torch.equal(tl1, tl2)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_decode_paged(ref, models, use_kernels):
    jm, jp, m, tp = models
    _, (_, tc) = _prefill_both(models)
    L = tc["k"].shape[0]
    kp, vp = zip(*(pages_from_cache(tc["k"][i], tc["v"][i], 8) for i in range(L)))
    pages = {"k": torch.stack(kp), "v": torch.stack(vp), "length": tc["length"]}
    jpages = {"k": jnp.asarray(f32(pages["k"]), jnp.bfloat16),
              "v": jnp.asarray(f32(pages["v"]), jnp.bfloat16),
              "length": jnp.asarray(pages["length"].numpy())}
    tok = np.asarray([5, 7], np.int32)
    jl, (jk, _) = jm.decode_paged(jp, jpages, jnp.asarray(tok), use_kernels=False)
    tl, (tk, _) = m.decode_paged(tp, pages, torch.from_numpy(tok), use_kernels=use_kernels)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL)
    np.testing.assert_array_equal(f32(tk[0]), f32(jk[0]))
    # the paged step equals the contiguous step on the same cache: the two
    # lanes form the same MoE group in both
    cl, _ = m.decode(tp, tc, torch.from_numpy(tok))
    np.testing.assert_allclose(f32(tl), f32(cl), atol=LOGIT_TOL)


def test_forward_prefill_suffix(ref, models):
    jm, jp, m, tp = models
    toks, _ = _prompt(2, B=1, S=24)
    _, pre = m.prefill(tp, {"tokens": torch.from_numpy(toks[:, :16])})
    pre["length"] = torch.tensor([16], dtype=torch.int32)
    suf = np.zeros((1, 16), np.int32)
    suf[0, :8] = toks[0, 16:]
    batch = {"tokens": suf, "lengths": np.asarray([8], np.int32)}
    jl, jc = jm.prefill_suffix(jp, _jcache(pre), {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tcache = m.prefill_suffix(tp, pre, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL)
    assert tcache["length"].tolist() == [24] == np.asarray(jc["length"]).tolist()
    assert tcache["k"].shape == jc["k"].shape


# ---------------------------------------------------------------------------
# serving, training, launchers
# ---------------------------------------------------------------------------

def _pool_cfg(**kw):
    return dict(num_pages=6, page_size=8, seq_capacity=32, cold_after=2, eb=1e-4, **kw)


def test_seeded_trace_matches_the_reference(monkeypatch):
    """dbrx SMOKE through ``Engine.serve`` over the seeded 5-request trace: every
    scheduling count equals the reference's, tokens agree in >= 90% of places,
    and the kernel route (the plain versions here) schedules alike."""
    _aliases(monkeypatch)
    from repro import serve as jserve
    jm = jzoo.build(jconfigs.get("dbrx-132b", smoke=True))
    jp = jm.init(jax.random.key(0))
    tp = interop.params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    model = zoo.build(configs.get("dbrx-132b", smoke=True))
    trace = lambda: tracegen.generate(tracegen.TraceGenConfig(seed=0, n_requests=5))  # noqa
    jreqs = [jserve.kvpool.Request(req_id=r.req_id, tokens=r.tokens, n_new=r.n_new,
                                   priority=r.priority, arrive_at=r.arrive_at)
             for r in trace()]
    jeng = jserve.Engine(jm, jp, pool=jserve.kvpool.PoolConfig(**_pool_cfg()))
    jout, jstats, _ = jeng.serve(jreqs, max_batch=2)
    eng = Engine(model, tp, device="cpu", pool=PoolConfig(**_pool_cfg(use_kernels=False)))
    out, stats, pool = eng.serve(trace(), max_batch=2)
    for f in SCHED_FIELDS:
        assert getattr(stats, f) == getattr(jstats, f), f
    assert stats.tiered_pages > 0 and stats.pool_decompressions > 0 and stats.prefix_hits > 0
    assert not pool.pages and pool.n_free_slots() == 6
    agree = [float((out[i] == np.asarray(jout[i])).mean()) for i in jout]
    assert sorted(out) == sorted(jout) and float(np.mean(agree)) >= 0.9, agree
    keng = Engine(model, tp, device="cpu", pool=PoolConfig(**_pool_cfg()))
    assert keng.paged_decode_enabled
    kout, kstats, _ = keng.serve(trace(), max_batch=2)
    for f in SCHED_FIELDS:
        assert getattr(kstats, f) == getattr(stats, f), f
    jax.clear_caches()


@pytest.fixture(scope="module")
def dbrx_ref_history():
    """The reference's ``Trainer`` at dbrx SMOKE, 4 steps op by op, run once."""
    with pytest.MonkeyPatch.context() as mp:
        _aliases(mp)
        from repro.configs.base import ShapeConfig as JShape
        from repro.data.tokens import TokenStream as JStream
        from repro.launch import mesh as jmesh
        from repro.train import TrainConfig as JTrainConfig
        from repro.train.trainer import Trainer as JTrainer
        jm = jzoo.build(jconfigs.get("dbrx-132b", smoke=True))
        jp = jm.init(jax.random.key(0))
        tp = interop.params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
        jt = JTrainer(jm, JShape("tiny", 32, 4, "train"), jmesh.make_local_mesh(),
                      JTrainConfig(), stream=JStream(512, 32, 4, seed=0))
        jt.opt = jax.tree.map(jnp.array, jt.opt)     # master["router"] is params["router"]
        with jax.disable_jit():
            hist = jt.run(4)
        jax.clear_caches()
    return hist, tp


def test_trainer_matches_reference(dbrx_ref_history):
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch import mesh as lmesh
    from repro_torch.train import TrainConfig, Trainer
    want, tp = dbrx_ref_history
    owns = lmesh.start_local_group("cpu")
    obs.reset()
    obs.clear_events()
    try:
        cfg = configs.get("dbrx-132b", smoke=True)
        t = Trainer(zoo.build(cfg), ShapeConfig("tiny", 32, 4, "train"),
                    lmesh.make_local_mesh(device="cpu"), TrainConfig(),
                    stream=TokenStream(cfg.vocab, 32, 4, seed=0), init_params=tp,
                    device="cpu")
        got = t.run(4)
    finally:
        obs.reset()
        obs.clear_events()
        if owns:
            dist.destroy_process_group()
    assert [a["step"] for a in got] == [b["step"] for b in want] == [0, 1, 2, 3]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=STEP_LOSS_RTOL)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launch_serve_paged_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve as launch_serve
    obs.reset()
    out = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--paged",
                             "--prompt-len", "24", "--tokens", "6"])
    text = capsys.readouterr().out
    assert f"{arch}-smoke: 2 requests" in text and "on cpu" in text
    assert out["stats"].completed == 2 and out["stats"].decode_steps > 0
    assert all(len(t) == 6 for t in out["outputs"].values())
    obs.reset()
    obs.clear_events()


def test_launch_train_on_the_cpu(capsys):
    import torch.distributed as dist
    from repro_torch.launch import train as launch_train
    obs.reset()
    hist = launch_train.main(["--arch", "dbrx-132b", "--smoke", "--steps", "2", "--seq", "32",
                              "--batch", "4", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert not dist.is_initialized()
    assert lines[0].startswith("dbrx-132b-smoke: 1.0M params")
    assert [m["step"] for m in hist] == [0, 1] and all(np.isfinite(m["loss"]) for m in hist)
    obs.reset()
    obs.clear_events()
