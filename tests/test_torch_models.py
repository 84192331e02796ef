"""The port's dense decoder against the reference, on the CPU, at the Yi-6B smoke config.

``configs.get("yi-6b", smoke=True)``: 2 layers, d_model 128, 4 heads, 2 KV
heads, head_dim 32, vocab 512. The reference's parameters come from
``model.init(jax.random.key(0))`` and are carried over bit for bit with
``interop.params_from_reference``; the same tokens go to both models
(teacher-forced), made from a seed with numpy.

Tolerances:

* float32 layer math (RoPE, flash / prefix / decode attention): 2e-4, float32
  sums in another order;
* ``rms_norm``, ``dense`` and ``silu`` on bfloat16: exact (same rounding
  places);
* bfloat16 model logits: ``LOGIT_TOL`` = 0.125 absolute at logits of
  magnitude about 3. The first layer's K/V are bit-identical; from the
  second layer on, the reference's compiled layer loop and the port's eager
  ops round some bfloat16 activations on the other side, a few bfloat16 ulps
  (0.0156 each at magnitude 2-4) by the logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jatt
from repro.models import nn as jnn
from repro.models import zoo as jzoo
from repro.serve.kvpool import attention as jpaged
from repro_torch import configs, interop
from repro_torch.models import attention as tatt
from repro_torch.models import nn as tnn
from repro_torch.models import transformer, zoo
from repro_torch.serve.kvpool import pages_from_cache

TOL = 2e-4
LOGIT_TOL = 0.125


@pytest.fixture
def ref(monkeypatch):
    """The reference's model package with the jax 0.9 aliases, for one test."""
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
    yield jzoo
    jax.clear_caches()


@pytest.fixture(scope="module")
def models():
    """(reference model, reference params, port model, port params) at the smoke config."""
    jcfg, cfg = jconfigs.get("yi-6b", smoke=True), configs.get("yi-6b", smoke=True)
    jm = jzoo.build(jcfg)
    jp = jm.init(jax.random.key(0))
    tp = interop.params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, zoo.build(cfg), tp


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, dtype=np.float32)


def _rng_f32(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "glm4-9b", "internlm2-20b", "mistral-large-123b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_dense_configs_match_reference(arch, smoke):
    j, t = jconfigs.get(arch, smoke=smoke), configs.get(arch, smoke=smoke)
    for field in ("arch_id", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab", "head_dim", "rope_theta", "norm_eps"):
        assert getattr(t, field) == getattr(j, field), field
    assert t.hd == j.hd


def test_other_families_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        configs.get("rwkv6-3b")
    with pytest.raises(KeyError):
        configs.get("no-such-arch")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        zoo.build(configs.get("yi-6b").reduced(family="ssm"))


def test_params_carry_over_bit_for_bit(models):
    jm, jp, m, tp = models
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == 12          # embed, final_norm, unembed + 9 layer stacks
    for path, leaf in jleaves:
        node = tp
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.bfloat16 and tuple(node.shape) == leaf.shape
        assert np.array_equal(np.asarray(leaf).view(np.uint16),
                              node.view(torch.int16).numpy().view(np.uint16))
    assert m.param_count() == sum(x.size for x in jax.tree.leaves(jp))


def test_init_tree_follows_the_reference_rules(models):
    """Shapes, dtypes and the std rule (normal: fan_in**-0.5, embed: 0.02,
    norms: ones) of a fresh port init, from a torch.Generator."""
    jm, jp, m, _ = models
    tp = m.init(torch.Generator().manual_seed(0), device="cpu")
    again = m.init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(tp["layers"]["wq"], again["layers"]["wq"])
    cfg = m.cfg
    assert torch.all(tp["layers"]["attn_norm"] == 1) and torch.all(tp["final_norm"] == 1)
    for name, std in (("wq", cfg.d_model ** -0.5), ("w_down", cfg.d_ff ** -0.5)):
        w = tp["layers"][name].float()
        assert w.shape == jp["layers"][name].shape and tp["layers"][name].dtype == torch.bfloat16
        assert abs(float(w.std()) / std - 1) < 0.05
    assert abs(float(tp["embed"].float().std()) / 0.02 - 1) < 0.05


# ---------------------------------------------------------------------------
# layer math
# ---------------------------------------------------------------------------

def test_rms_norm_dense_silu_bit_exact_in_bf16():
    x, w, s = _rng_f32(0, 4, 24, 128), _rng_f32(1, 128, 256) * 128 ** -0.5, _rng_f32(2, 128)
    jx, jw, js = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, s))
    tx, tw, ts = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, s))
    np.testing.assert_array_equal(f32(tnn.rms_norm(tx, ts)), f32(jnn.rms_norm(jx, js)))
    h, th = jnn.dense(jx, jw), tnn.dense(tx, tw)
    np.testing.assert_array_equal(f32(th), f32(h))
    np.testing.assert_array_equal(f32(tnn.silu(th)), f32(jax.nn.silu(h)))
    np.testing.assert_allclose(f32(tnn.rms_norm(torch.from_numpy(x), torch.from_numpy(s))),
                               f32(jnn.rms_norm(jnp.asarray(x), jnp.asarray(s))), atol=TOL)


def test_rope():
    x = _rng_f32(3, 2, 24, 4, 32)
    pos = np.tile(np.arange(7, 31, dtype=np.int32), (2, 1))
    want = jatt.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e6)
    got = tatt.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e6)
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL)
    np.testing.assert_allclose(tatt.rope_freqs(32, 5e6).numpy(),
                               np.asarray(jatt.rope_freqs(32, 5e6)), rtol=1e-6)


@pytest.mark.parametrize("chunks", [(8, 8), (512, 512), (6, 12)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention(chunks, causal):
    q, k, v = _rng_f32(4, 2, 24, 4, 32), _rng_f32(5, 2, 24, 2, 32), _rng_f32(6, 2, 24, 2, 32)
    qc, kc = chunks
    want = jatt.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal, q_chunk=qc,
                                kv_chunk=kc)
    got = tatt.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal, q_chunk=qc,
                               kv_chunk=kc)
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL)
    np.testing.assert_allclose(
        f32(tatt.attention_reference(*map(torch.from_numpy, (q, k, v)), causal=causal)),
        f32(jatt.attention_reference(*map(jnp.asarray, (q, k, v)), causal=causal)), atol=TOL)


def test_prefix_and_decode_attention():
    q, ks, vs = _rng_f32(7, 2, 8, 4, 32), _rng_f32(8, 2, 8, 2, 32), _rng_f32(9, 2, 8, 2, 32)
    kp, vp = _rng_f32(10, 2, 32, 2, 32), _rng_f32(11, 2, 32, 2, 32)
    plen = np.asarray([0, 19], np.int32)
    want = jatt.prefix_attention(*map(jnp.asarray, (q, kp, vp, plen, ks, vs)))
    got = tatt.prefix_attention(*map(torch.from_numpy, (q, kp, vp, plen, ks, vs)))
    np.testing.assert_allclose(f32(got), f32(want), atol=TOL)
    qd = _rng_f32(12, 2, 4, 32)
    length = np.asarray([3, 32], np.int32)
    np.testing.assert_allclose(
        f32(tatt.decode_attention(*map(torch.from_numpy, (qd, kp, vp, length)))),
        f32(jatt.decode_attention(*map(jnp.asarray, (qd, kp, vp, length)))), atol=TOL)


# ---------------------------------------------------------------------------
# the model, teacher-forced
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


def test_forward_prefill(ref, models):
    (jl, jc), (tl, tc) = _prefill_both(models)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL)
    assert tc["k"].shape == jc["k"].shape and tc["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tc["length"].numpy(), np.asarray(jc["length"]))
    # the first layer's K/V see only the embedding: bit-identical
    np.testing.assert_array_equal(f32(tc["k"][0]), f32(jc["k"][0]))
    np.testing.assert_array_equal(f32(tc["v"][0]), f32(jc["v"][0]))
    np.testing.assert_allclose(f32(tc["k"]), f32(jc["k"]), atol=LOGIT_TOL)


def test_forward_prefill_without_lengths(ref, models):
    jm, jp, m, tp = models
    toks, _ = _prompt(1, S=16)
    jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL)
    assert tc["length"].tolist() == [16, 16]
    assert tc["k"].shape[2] == transformer.cache_len(16)


def test_forward_decode(ref, models):
    jm, jp, m, tp = models
    (_, jc), (_, tc) = _prefill_both(models)
    # teacher-forced: both decode from the port's cache and the same tokens
    cache_np = {k: f32(v) if k != "length" else v.numpy() for k, v in tc.items()}
    jcache = {"k": jnp.asarray(cache_np["k"], jnp.bfloat16),
              "v": jnp.asarray(cache_np["v"], jnp.bfloat16),
              "length": jnp.asarray(cache_np["length"])}
    tcache = dict(tc)
    for tok in ([5, 7], [300, 2], [11, 511]):
        tok = np.asarray(tok, np.int32)
        jl, jcache = jm.decode(jp, jcache, jnp.asarray(tok))
        tl, tcache = m.decode(tp, tcache, torch.from_numpy(tok))
        np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL)
        np.testing.assert_array_equal(tcache["length"].numpy(), np.asarray(jcache["length"]))
    assert tc["length"].tolist() == cache_np["length"].tolist()   # input cache untouched


@pytest.mark.parametrize("use_kernels", [False, True])
def test_forward_decode_paged(ref, models, use_kernels):
    jm, jp, m, tp = models
    (_, _), (_, tc) = _prefill_both(models)
    ps = 8
    L = tc["k"].shape[0]
    kp, vp = zip(*(pages_from_cache(tc["k"][i], tc["v"][i], ps) for i in range(L)))
    pages = {"k": torch.stack(kp), "v": torch.stack(vp), "length": tc["length"]}
    jpages = {"k": jnp.asarray(f32(pages["k"]), jnp.bfloat16),
              "v": jnp.asarray(f32(pages["v"]), jnp.bfloat16),
              "length": jnp.asarray(pages["length"].numpy())}
    tok = np.asarray([5, 7], np.int32)
    jl, (jk, jv) = jm.decode_paged(jp, jpages, jnp.asarray(tok), use_kernels=False)
    tl, (tk, tv) = m.decode_paged(tp, pages, torch.from_numpy(tok), use_kernels=use_kernels)
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL)
    assert tuple(tk.shape) == jk.shape
    np.testing.assert_array_equal(f32(tk[0]), f32(jk[0]))
    # the paged step equals the contiguous step on the same cache
    cl, ccache = m.decode(tp, tc, torch.from_numpy(tok))
    np.testing.assert_allclose(f32(tl), f32(cl), atol=LOGIT_TOL)
    lanes = torch.arange(2)
    torch.testing.assert_close(tk, ccache["k"][:, lanes, tc["length"].long()], atol=0.05,
                               rtol=0)


def test_forward_prefill_suffix(ref, models):
    jm, jp, m, tp = models
    toks, _ = _prompt(2, B=1, S=24)
    split = 16
    _, pre = m.prefill(tp, {"tokens": torch.from_numpy(toks[:, :split])})
    pre["length"] = torch.tensor([split], dtype=torch.int32)
    suf = np.zeros((1, 16), np.int32)
    suf[0, :8] = toks[0, split:]
    batch = {"tokens": suf, "lengths": np.asarray([8], np.int32)}
    jl, jc = jm.prefill_suffix(
        jp, {"k": jnp.asarray(f32(pre["k"]), jnp.bfloat16),
             "v": jnp.asarray(f32(pre["v"]), jnp.bfloat16),
             "length": jnp.asarray(pre["length"].numpy())},
        {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tcache = m.prefill_suffix(tp, pre, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(f32(tl), f32(jl), atol=LOGIT_TOL)
    assert tcache["length"].tolist() == [24] == np.asarray(jc["length"]).tolist()
    assert tcache["k"].shape == jc["k"].shape
    # suffix prefill == full prefill at the true last position
    full, _ = m.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(f32(tl), f32(full), atol=LOGIT_TOL)


def test_paged_view_matches_reference_pages_from_cache():
    k, v = _rng_f32(13, 2, 32, 2, 8), _rng_f32(14, 2, 32, 2, 8)
    for a, b in zip(pages_from_cache(torch.from_numpy(k), torch.from_numpy(v), 8),
                    jpaged.pages_from_cache(jnp.asarray(k), jnp.asarray(v), 8)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        pages_from_cache(torch.from_numpy(k), torch.from_numpy(v), 5)
