"""The port's recurrent families against the reference, on the CPU: RWKV-6
(rwkv6-3b), the Mamba2 blocks and the Zamba2 hybrid (zamba2-2.7b).

The reference runs in this process with the two jax 0.9 aliases (the
function-scoped ``ref`` fixture, or a ``MonkeyPatch.context()`` where a
fixture outlives one test). Its SMOKE parameters (``model.init(
jax.random.key(0))``) have their zero- and one-initialised leaves (token-shift
mixes, decay base and LoRA, bonus, conv bias, ``A_log``, ``D``) replaced by
seeded random values, so that every path of the recurrences carries data,
and are carried over with ``interop.params_from_reference``. Inputs are numpy
arrays from a seed.

Tolerances:

* ``_wkv_chunked`` and ``_ssd_chunked`` on the same float32 inputs, output
  and final state: ``SCAN_REL`` 1e-4 of the reference's max |value|, at S of
  1, c - 1, c, c + 1 and 2c + 5 (padding), from a zero and a random state.
  The reference's ``_ssd_chunked`` returns the padded rows when S is past one
  chunk and not a multiple of it; the port returns S rows, compared there;
* ``_conv``, output and new state: bit for bit, and the state keeps the
  activations' type;
* the reference's model runs op by op (``jax.disable_jit``) wherever the
  port is held to it: its compiled layer loop keeps some bfloat16 chains in
  float32, which with the random leaves moves zamba2's logits past
  ``LOGIT_TOL`` and its greedy tokens at near ties (they agree 1.0 with the
  op-by-op run); rwkv6's logits equal the op-by-op reference's bit for bit;
* logits of prefill and decode: ``LOGIT_TOL`` 0.125 absolute, as the dense
  family (measured 0 for rwkv6, 0.031 for zamba2); the float recurrent
  state leaves ``STATE_REL`` 5e-2 of the reference's max |value|; every
  cache leaf equal in name, shape and type after ``make_cache``, prefill
  and a decode step (zamba2's ``conv`` is float32 from ``make_cache`` and
  bfloat16 after either step);
* the port's own chunked == stepwise identities at 2e-3 (the reference's
  ``tests/test_attention_ssm.py`` tolerance), and prefill S + decode against
  prefill S + 1 at ``LOGIT_TOL``;
* ``forward_train``: loss ``LOSS_RTOL`` 1e-3 relative, each gradient leaf
  ``GRAD_TOL`` 0.05 of its max |g| (measured 0.013 and 0.021 against the
  op-by-op reference; zamba2's exceed it against the compiled one).
  zamba2's gradients are compared with ``A_log`` at its initial 0: with the
  random ``A_log`` the reference's gradients are NaN (a masked ``exp``
  overflows before its ``where``) and the port's stay finite, which a test
  of its own pins;
* whole-cache ``Engine.generate(park_between=True)``: the kernel route (the
  plain versions on the CPU) equals the plain route bit for bit, tokens,
  caches and containers; each parked leaf's container equals the
  reference's ``compress_cache`` of the same leaf field for field; tokens
  agree with the reference's ``generate`` in >= ``TOKEN_AGREEMENT`` 0.9 of
  places (bfloat16 near ties);
* the port's ``Trainer``, 2 steps through the compressed reduce on a
  one-rank pod mesh, against the reference's ``Trainer`` on
  ``make_local_mesh()`` (its exact reduce; the reference's pod mesh does not
  build on jax 0.9: ``P.UNCONSTRAINED`` with explicit axis types): losses
  ``LOSS_RTOL`` (measured 5.5e-5 and 4.2e-4).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import mamba2 as jmamba2
from repro.models import rwkv6 as jrwkv6
from repro.models import zoo as jzoo
from repro_torch import configs, interop, obs, pytree
from repro_torch.configs.base import SHAPES
from repro_torch.models import mamba2, rwkv6, zoo
from repro_torch.serve import Engine, KVCompressionConfig
from repro_torch.serve.engine import compress_cache
from repro_torch.serve.kvpool import PoolConfig

ARCHS = ["rwkv6-3b", "zamba2-2.7b"]
SCAN_REL = 1e-4
STATE_REL = 5e-2
STEP_TOL = 2e-3
LOGIT_TOL = 0.125
LOSS_RTOL = 1e-3
GRAD_TOL = 0.05
TOKEN_AGREEMENT = 0.9
# the leaves the reference initialises to zeros or ones, and the scale of the
# random values put there (D about 1)
PERTURB = {"mix_r": 1.0, "mix_k": 1.0, "mix_v": 1.0, "mix_g": 1.0, "mix_w": 1.0,
           "mix_fk": 1.0, "mix_fr": 1.0, "w_base": 0.5, "w_lora_b": 0.05, "bonus_u": 0.5,
           "conv_b": 0.1, "A_log": 0.5, "D": 0.5, "b_up": 0.02, "b_down": 0.02}
PARAM_COUNTS = {"rwkv6-3b": 3_073_315_840, "zamba2-2.7b": 2_540_635_040,
                "whisper-tiny": 61_620_864}


def _aliases(mp):
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    mp.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
    mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)


@pytest.fixture
def ref(monkeypatch):
    """The reference's model zoo with the jax 0.9 aliases, for one test. The
    compiled primitives stay cached for the module's later tests (run op by
    op, the reference compiles each primitive on first use)."""
    _aliases(monkeypatch)
    yield jzoo


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@contextlib.contextmanager
def reference_step_globals():
    """The reference's ``build_train_step`` installs a process-wide activation
    sharder on its mesh (``repro/train/step.py:43-50``) and a gradient tap,
    and leaves them installed: put back what was there before, so that a
    later test in this process traces the reference without them."""
    from repro.models import nn as jnn
    saved = jnn._ACT_SHARDER, jnn._GRAD_TAP
    try:
        yield
    finally:
        jnn.set_act_sharder(saved[0])
        jnn.set_grad_tap(saved[1])


def perturbed(jp, seed: int = 1, skip=()):
    """The reference's parameters with the ``PERTURB`` leaves made random."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = path[-1].key
        if name not in PERTURB or name in skip:
            return a
        base = 1.0 if name == "D" else 0.0
        noise = rng.standard_normal(a.shape).astype(np.float32) * PERTURB[name]
        return jnp.asarray(base + noise, a.dtype)
    return jax.tree_util.tree_map_with_path(leaf, jp)


def carried(arch: str, skip=()):
    """(reference model, its perturbed params, port model, the same params)."""
    jm = jzoo.build(jconfigs.get(arch, smoke=True))
    jp = perturbed(jm.init(jax.random.key(0)), skip=skip)
    tp = interop.params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, zoo.build(configs.get(arch, smoke=True)), tp


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return carried(request.param)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else \
            a.view(torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a.view(np.int32)


def rel_err(got, want) -> float:
    w = f32(want)
    return float(np.abs(f32(got) - w).max() / max(np.abs(w).max(), 1e-30))


def op_by_op(fn):
    """``fn`` run under ``jax.disable_jit()``: the reference op by op."""
    def call(*args):
        with jax.disable_jit():
            return fn(*args)
    return call


def leaf_types(cache: dict) -> dict:
    """name -> (shape, type name), for either package's cache."""
    return {name: (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
            for name, leaf in cache.items()}


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_every_arch_resolves_and_builds(ref):
    """``configs.get`` and ``zoo.build`` raise for no id of the registry, full
    and SMOKE; the recurrent and audio models count the reference's
    parameters at full size; the resource pass walks the reference's
    attention geometries."""
    from repro.analysis import space as jspace
    from repro_torch.analysis import space
    for arch in configs.ARCH_IDS:
        for smoke in (False, True):
            model = zoo.build(configs.get(arch, smoke=smoke))
            assert model.param_count() == jzoo.build(jconfigs.get(arch, smoke=smoke)).param_count()
    for arch, n in PARAM_COUNTS.items():
        assert zoo.build(configs.get(arch)).param_count() == n
    want = [(label, b, kvh, g, d) for label, b, _, kvh, g, d in jspace._arch_points()]
    assert space._arch_points() == want
    assert ("zamba2-2.7b", 8, 32, 1, 80) in want and ("whisper-tiny", 8, 6, 1, 64) in want
    assert not any(label.startswith("rwkv6") for label, *_ in want)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_param_tree_match_reference(arch):
    jm, m = jzoo.build(jconfigs.get(arch, smoke=True)), zoo.build(configs.get(arch, smoke=True))
    for shape in SHAPES.values():
        specs, shards = m.input_specs(shape)
        jspecs, jshards = jm.input_specs(shape)
        assert {k: tuple(v.shape) for k, v in specs.items()} == \
            {k: tuple(v.shape) for k, v in jspecs.items()}
        assert shards == jshards
    abstract = jm.abstract_params()
    want = [(jax.tree_util.keystr(p), a.shape, str(a.dtype))
            for p, a in jax.tree_util.tree_flatten_with_path(abstract)[0]]
    got = [(k, tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for k, t in pytree.leaves_with_keys(m.abstract_params())]
    assert got == want
    assert m.param_specs() == jm.param_specs()


# ---------------------------------------------------------------------------
# the scans and the convolution
# ---------------------------------------------------------------------------

def _wkv_inputs(S, state, seed=0):
    rng = np.random.default_rng(seed)
    B, nh, hd = 2, 3, 8
    r, k, v = (rng.standard_normal((B, S, nh, hd)).astype(np.float32) for _ in range(3))
    la = -np.exp(rng.standard_normal((B, S, nh, hd)).astype(np.float32) - 1.0)
    u = rng.standard_normal((nh, hd)).astype(np.float32)
    s0 = (rng.standard_normal((B, nh, hd, hd)).astype(np.float32) if state == "random"
          else np.zeros((B, nh, hd, hd), np.float32))
    return r, k, v, la, u, s0


@pytest.mark.parametrize("state", ["zero", "random"])
@pytest.mark.parametrize("S", [1, 15, 16, 17, 37])
def test_wkv_chunked_matches_reference(ref, S, state):
    args = _wkv_inputs(S, state)
    jo, js = jrwkv6._wkv_chunked(*(jnp.asarray(a) for a in args))
    to, ts = rwkv6._wkv_chunked(*(torch.from_numpy(a) for a in args))
    assert tuple(to.shape) == jo.shape and to.dtype == torch.float32
    assert rel_err(to, jo) <= SCAN_REL and rel_err(ts, js) <= SCAN_REL


def _ssd_inputs(S, state, seed=0):
    rng = np.random.default_rng(seed)
    B, nh, hd, ds = 2, 3, 4, 8
    xh = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    bmat, cmat = (rng.standard_normal((B, S, ds)).astype(np.float32) for _ in range(2))
    dt = rng.standard_normal((B, S, nh)).astype(np.float32)
    A_log = (rng.standard_normal((nh,)) * 0.5).astype(np.float32)
    D = rng.standard_normal((nh,)).astype(np.float32)
    h0 = (rng.standard_normal((B, nh, hd, ds)).astype(np.float32) if state == "random"
          else np.zeros((B, nh, hd, ds), np.float32))
    return xh, bmat, cmat, dt, A_log, D, h0


@pytest.mark.parametrize("state", ["zero", "random"])
@pytest.mark.parametrize("S", [1, 127, 128, 129, 261])
def test_ssd_chunked_matches_reference(ref, S, state):
    args = _ssd_inputs(S, state)
    jy, jh = jmamba2._ssd_chunked(*(jnp.asarray(a) for a in args))
    ty, th = mamba2._ssd_chunked(*(torch.from_numpy(a) for a in args))
    assert tuple(ty.shape) == (2, S, 3, 4) and ty.dtype == torch.float32
    assert rel_err(ty, jy[:, :S]) <= SCAN_REL and rel_err(th, jh) <= SCAN_REL


@pytest.mark.parametrize("S,state", [(7, None), (1, "float32"), (5, "bfloat16"),
                                     (9, "float32")])
def test_conv_bit_for_bit(ref, S, state):
    rng = np.random.default_rng(S)
    B, W, C = 2, 4, 40
    xbc = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((W, C)).astype(np.float32)
    b = (rng.standard_normal((C,)) * 0.1).astype(np.float32)
    jx, tx = jnp.asarray(xbc, jnp.bfloat16), torch.from_numpy(xbc).to(torch.bfloat16)
    js = ts = None
    if state is not None:
        st = rng.standard_normal((B, W - 1, C)).astype(np.float32)
        js = jnp.asarray(st, state)
        ts = torch.from_numpy(st).to(getattr(torch, state))
    jo, jst = jmamba2._conv(jx, jnp.asarray(w), jnp.asarray(b), js)
    to, tst = mamba2._conv(tx, torch.from_numpy(w), torch.from_numpy(b), ts)
    assert to.dtype == tst.dtype == torch.bfloat16 and jst.dtype == jnp.bfloat16
    assert tuple(tst.shape) == jst.shape == (B, W - 1, C)
    np.testing.assert_array_equal(bits(to), bits(jo))
    np.testing.assert_array_equal(bits(tst), bits(jst))


# the port's own identities, as the reference's tests/test_attention_ssm.py

def _wkv_stepwise(r, k, v, la, u):
    B, S, nh, hd = r.shape
    s = torch.zeros((B, nh, hd, hd))
    os_ = []
    for t in range(S):
        kv = torch.einsum("bhd,bhe->bhde", k[:, t], v[:, t])
        os_.append(torch.einsum("bhd,bhde->bhe", r[:, t], s + u[None, :, :, None] * kv))
        s = torch.exp(la[:, t])[..., None] * s + kv
    return torch.stack(os_, dim=1), s


def test_rwkv6_chunked_equals_stepwise():
    r, k, v, la, u, s0 = (torch.from_numpy(a) for a in _wkv_inputs(64, "zero", seed=3))
    o_chunk, s_chunk = rwkv6._wkv_chunked(r, k, v, la, u, s0)
    o_step, s_step = _wkv_stepwise(r, k, v, la, u)
    torch.testing.assert_close(o_chunk, o_step, rtol=STEP_TOL, atol=STEP_TOL)
    torch.testing.assert_close(s_chunk, s_step, rtol=STEP_TOL, atol=STEP_TOL)


def test_rwkv6_prefill_then_decode_matches_full():
    r, k, v, la, u, s0 = (torch.from_numpy(a) for a in _wkv_inputs(33, "zero", seed=4))
    S = 32
    o_full, _ = rwkv6._wkv_chunked(r, k, v, la, u, s0)
    o_pre, s_mid = rwkv6._wkv_chunked(r[:, :S], k[:, :S], v[:, :S], la[:, :S], u, s0)
    o_one, _ = rwkv6._wkv_chunked(r[:, S:], k[:, S:], v[:, S:], la[:, S:], u, s_mid)
    torch.testing.assert_close(o_pre, o_full[:, :S], rtol=STEP_TOL, atol=STEP_TOL)
    torch.testing.assert_close(o_one[:, 0], o_full[:, S], rtol=STEP_TOL, atol=STEP_TOL)


def _ssd_stepwise(xh, bmat, cmat, dt, A_log, D):
    B, S, nh, hd = xh.shape
    h = torch.zeros((B, nh, hd, bmat.shape[-1]))
    ys = []
    for t in range(S):
        dtf = mamba2.softplus(dt[:, t])
        a = torch.exp(-torch.exp(A_log)[None] * dtf)
        upd = torch.einsum("bhe,bd->bhed", xh[:, t] * dtf[..., None], bmat[:, t])
        h = a[:, :, None, None] * h + upd
        y = torch.einsum("bd,bhed->bhe", cmat[:, t], h)
        ys.append(y + xh[:, t] * D[None, :, None])
    return torch.stack(ys, dim=1), h


def test_mamba2_chunked_equals_stepwise():
    xh, bmat, cmat, dt, A_log, D, h0 = (torch.from_numpy(a)
                                        for a in _ssd_inputs(256, "zero", seed=5))
    y_chunk, h_chunk = mamba2._ssd_chunked(xh, bmat, cmat, dt, A_log, D, h0)
    y_step, h_step = _ssd_stepwise(xh, bmat, cmat, dt, A_log, D)
    torch.testing.assert_close(y_chunk, y_step, rtol=STEP_TOL, atol=STEP_TOL)
    torch.testing.assert_close(h_chunk, h_step, rtol=STEP_TOL, atol=STEP_TOL)


# ---------------------------------------------------------------------------
# the models (SMOKE, perturbed params carried over)
# ---------------------------------------------------------------------------

def test_prefill_and_decode_match_reference(ref, models, record_property):
    jm, jp, m, tp = models
    toks = np.random.default_rng(0).integers(0, 512, (2, 24), dtype=np.int32)
    assert leaf_types(m.make_cache(2, 24, device="cpu")) == \
        leaf_types(jm.make_cache(2, 24))
    with jax.disable_jit():
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = m.prefill(tp, {"tokens": torch.from_numpy(toks)})
    assert leaf_types(tc) == leaf_types(jc)
    worst = {"prefill": float(np.abs(f32(tl) - f32(jl)).max())}
    tok = np.asarray([5, 7], np.int32)
    with jax.disable_jit():
        jl1, jc1 = jm.decode(jp, jc, jnp.asarray(tok))
    tl1, tc1 = m.decode(tp, tc, torch.from_numpy(tok))
    assert leaf_types(tc1) == leaf_types(jc1)
    worst["decode"] = float(np.abs(f32(tl1) - f32(jl1)).max())
    record_property("logit_err", worst)
    assert max(worst.values()) <= LOGIT_TOL, worst
    for cache, jcache in ((tc, jc), (tc1, jc1)):
        for name, leaf in cache.items():
            if leaf.dtype == torch.float32:
                assert rel_err(leaf, jcache[name]) <= STATE_REL, name
        np.testing.assert_array_equal(cache["length"].numpy(), np.asarray(jcache["length"]))
    if m.cfg.family == "hybrid":
        assert m.make_cache(2, 24, device="cpu")["conv"].dtype == torch.float32
        assert tc["conv"].dtype == tc1["conv"].dtype == torch.bfloat16


def test_prefill_then_decode_equals_longer_prefill(models):
    """The port's recurrence: prefill S then one decode step gives prefill
    S + 1's last logits and states."""
    _, _, m, tp = models
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (2, 21), dtype=np.int32))
    full_l, full_c = m.prefill(tp, {"tokens": toks})
    _, pre = m.prefill(tp, {"tokens": toks[:, :20]})
    step_l, step_c = m.decode(tp, pre, toks[:, 20])
    assert float((step_l.float() - full_l.float()).abs().max()) <= LOGIT_TOL
    for name, leaf in full_c.items():
        if leaf.dtype == torch.float32:
            assert rel_err(step_c[name], leaf) <= STATE_REL, name
    if "k" in full_c:                     # zamba2: the invocations' K/V past the prompt
        assert torch.equal(step_c["k"][:, :, :20], full_c["k"][:, :, :20])


def _grads(jm, jp, m, tp, arr, op_by_op=True):
    jb = {"tokens": jnp.asarray(arr[:, :-1]), "labels": jnp.asarray(arr[:, 1:])}
    with jax.disable_jit(op_by_op):
        (jl, _), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(jp, jb)
    flat = [p.detach().requires_grad_(True) for p in pytree.leaves(tp)]
    loss, aux = m.train_loss(pytree.unflatten(tp, flat),
                             {"tokens": torch.from_numpy(arr[:, :-1].copy()),
                              "labels": torch.from_numpy(arr[:, 1:].copy())})
    grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    assert torch.equal(loss, aux["xent"])
    return float(jl), jax.tree.leaves(jg), float(loss.detach()), grads


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_grads(ref, arch, record_property):
    jm, jp, m, tp = carried(arch, skip=("A_log",))
    arr = np.random.default_rng(0).integers(0, 512, (2, 41)).astype(np.int32)
    jl, jg, loss, grads = _grads(jm, jp, m, tp, arr)
    assert abs(loss - jl) <= LOSS_RTOL * abs(jl)
    worst = max(rel_err(g, w) for g, w in zip(grads, jg))
    record_property("grad_err", worst)
    assert worst <= GRAD_TOL


def test_gradients_stay_finite_where_the_reference_overflows(ref):
    """zamba2 with the random ``A_log``: the chunk's log-decay spans past 88,
    so the reference's ``exp`` of a masked exponent is inf before its
    ``where`` and its backward gives NaN; the port masks the exponent first.
    The losses agree."""
    jm, jp, m, tp = carried("zamba2-2.7b")
    arr = np.random.default_rng(0).integers(0, 512, (2, 41)).astype(np.int32)
    jl, jg, loss, grads = _grads(jm, jp, m, tp, arr, op_by_op=False)
    assert abs(loss - jl) <= LOSS_RTOL * abs(jl)
    assert any(not np.isfinite(f32(w)).all() for w in jg)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# ---------------------------------------------------------------------------
# serving and training through the entry points
# ---------------------------------------------------------------------------

def test_no_paged_pool_for_recurrent_caches(models):
    _, _, m, tp = models
    eng = Engine(m, tp, device="cpu", pool=PoolConfig(num_pages=4, page_size=8,
                                                      seq_capacity=32, eb=1e-4))
    assert not eng.paged_decode_enabled and eng.prefill_suffix is None
    with pytest.raises(NotImplementedError, match="plain k/v/length caches"):
        eng.make_pool()


def _park_cfg(use_kernels=True):
    return KVCompressionConfig(enabled=True, eb=1e-4, use_kernels=use_kernels,
                               min_leaf_size=256)


def hold_parking(m, tp, jm, jp, batch, jbatch, n_tokens, record_property):
    """``Engine.generate(park_between=True)`` on both routes and the reference's:
    routes bit for bit, the containers of the final cache equal the
    reference's field for field, tokens agree. Returns the parked names."""
    from repro.serve import engine as jengine
    out = {}
    for use_kernels in (True, False):
        kcfg = _park_cfg(use_kernels)
        eng = Engine(m, tp, kv_compress=kcfg, device="cpu")
        toks_out, cache = eng.generate(batch, n_tokens, park_between=True)
        out[use_kernels] = (toks_out, cache, compress_cache(cache, kcfg))
    (toks, cache, parked), (toks_p, cache_p, parked_p) = out[True], out[False]
    assert torch.equal(toks, toks_p)
    fz_names = [n for n, (codec, *_) in parked.items() if codec == "fz"]
    for name in cache:
        assert cache[name].dtype == cache_p[name].dtype and torch.equal(cache[name], cache_p[name])
    for name in fz_names:
        a, b = interop.to_numpy(parked[name][1]), interop.to_numpy(parked_p[name][1])
        for f in a:
            np.testing.assert_array_equal(a[f], b[f], f)
    # the same cache parked by the reference: the same containers
    jcache = {name: jnp.asarray(leaf.numpy()) if leaf.dtype != torch.bfloat16
              else jnp.asarray(f32(leaf), jnp.bfloat16) for name, leaf in cache.items()}
    jkcfg = jengine.KVCompressionConfig(enabled=True, eb=1e-4, min_leaf_size=256)
    jparked = jengine.compress_cache(jcache, jkcfg)
    assert [n for n, v in jparked.items() if v[0] == "fz"] == fz_names
    for name in fz_names:
        assert parked[name][1].dtype_name == str(jparked[name][1].dtype_name)
        for f, leaf in interop.to_numpy(parked[name][1]).items():
            np.testing.assert_array_equal(leaf, np.asarray(getattr(jparked[name][1], f)),
                                          f"{name}.{f}")
    jeng = jengine.Engine(jm, jp, kv_compress=jkcfg)
    jeng._prefill, jeng._decode = op_by_op(jm.prefill), op_by_op(jm.decode)
    jtoks, _ = jeng.generate(jbatch, n_tokens, park_between=True)
    agree = float((toks.numpy() == np.asarray(jtoks)).mean())
    record_property("token_agreement", agree)
    assert agree >= TOKEN_AGREEMENT, agree
    return fz_names


def test_generate_with_parking_matches_the_reference(ref, models, record_property):
    jm, jp, m, tp = models
    toks = np.random.default_rng(3).integers(0, 512, (2, 24), dtype=np.int32)
    names = hold_parking(m, tp, jm, jp, {"tokens": toks}, {"tokens": jnp.asarray(toks)}, 6,
                         record_property)
    float_state = {"ssm": ["wkv", "sh_a", "sh_f"], "hybrid": ["k", "v", "ssm", "conv"]}
    assert names == float_state[m.cfg.family]


@pytest.fixture(scope="module")
def ref_trainers():
    """The reference's ``Trainer`` at each SMOKE, 2 steps on
    ``make_local_mesh()``, run once; with the port's carried params."""
    out = {}
    with pytest.MonkeyPatch.context() as mp, reference_step_globals():
        _aliases(mp)
        from repro.configs.base import ShapeConfig as JShape
        from repro.data.tokens import TokenStream as JStream
        from repro.launch import mesh as jmesh
        from repro.train import TrainConfig as JTrainConfig
        from repro.train.trainer import Trainer as JTrainer
        for arch in ARCHS:
            jm = jzoo.build(jconfigs.get(arch, smoke=True))
            jt = JTrainer(jm, JShape("tiny", 32, 4, "train"), jmesh.make_local_mesh(),
                          JTrainConfig(), stream=JStream(512, 32, 4, seed=0))
            jt.opt = jax.tree.map(jnp.array, jt.opt)   # a float32 leaf is its own master
            tp = interop.params_from_reference(jax.tree.map(np.asarray, jt.params),
                                               device="cpu")
            out[arch] = (jt.run(2), tp)
        jax.clear_caches()
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_through_the_compressed_reduce(ref_trainers, arch):
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.dist import compressed_allreduce as car
    from repro_torch.launch import mesh as lmesh
    from repro_torch.train import TrainConfig, Trainer
    want, tp = ref_trainers[arch]
    owns = lmesh.start_local_group("cpu")
    obs.reset()
    obs.clear_events()
    try:
        mesh = lmesh.make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
        cfg = configs.get(arch, smoke=True)
        t = Trainer(zoo.build(cfg), ShapeConfig("tiny", 32, 4, "train"), mesh,
                    TrainConfig(grad_compress=car.GradCompressionConfig(enabled=True)),
                    stream=TokenStream(cfg.vocab, 32, 4, seed=0), init_params=tp, device="cpu")
        assert t.info["mode"] == "barrier" and t.err
        got = t.run(2)
    finally:
        obs.reset()
        obs.clear_events()
        if owns:
            dist.destroy_process_group()
    assert [a["step"] for a in got] == [b["step"] for b in want] == [0, 1]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_kv_compress_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve as launch_serve
    obs.reset()
    out = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--kv-compress",
                             "--prompt-len", "24", "--tokens", "4"])
    text = capsys.readouterr().out
    assert f"{arch}-smoke: generated (2, 4) tokens on cpu" in text and "KV parked" in text
    assert out["parked_bytes"] > 0
    with pytest.raises(NotImplementedError, match="plain k/v/length caches"):
        launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--paged"])
    obs.reset()
    obs.clear_events()


def test_full_width_cut_counts():
    """The parameter counts of phase 17's training cuts of ``chip_smoke.py``
    (rwkv6-3b at 2 layers, zamba2-2.7b at 6: one superblock) equal the
    reference's."""
    for arch, layers in (("rwkv6-3b", 2), ("zamba2-2.7b", 6)):
        cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
        jcfg = dataclasses.replace(jconfigs.get(arch), n_layers=layers)
        assert zoo.build(cfg).param_count() == jzoo.build(jcfg).param_count()
