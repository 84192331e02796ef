"""The port's training path against the reference, on the CPU, at the Yi-6B smoke config.

``configs.get("yi-6b", smoke=True)`` (2 layers, d_model 128, vocab 512) and
``ShapeConfig("tiny", 32, 4, "train")``. The reference runs in this process
with the two jax 0.9 aliases (a module-scoped ``MonkeyPatch.context()``); its
parameters come from ``model.init(jax.random.key(0))`` and are carried over
with ``interop.params_from_reference``. Inputs are numpy arrays from a seed.

Tolerances (each measured on this box, then pinned with room):

* ``TokenStream`` batches, ``warmup_cosine``'s float32, the reduce inside the
  compressed step and the pod-mean loss: bit for bit (a float32 ``cos`` may
  differ by an ulp in general; at these steps it does not);
* AdamW and ``global_norm`` on carried trees: 1e-6 relative. With the clip
  inactive, ``m`` and ``v`` are bit for bit and the master within one float32
  ulp in a few elements (a float32 ``pow`` may round either way); with the
  clip active the global norm sums in another order, so all three move by an
  ulp;
* ``layer_norm`` / ``gelu_mlp`` / ``sharded_xent`` (values and gradients) and
  float32 ``forward_train`` gradients: ``TOL`` 2e-4 (measured about 2e-6);
* bfloat16 ``forward_train``: loss ``LOSS_TOL`` 5e-4 absolute (measured
  4.8e-5), each leaf's gradient ``GRAD_TOL`` 0.05 of its max |g| (measured
  0.027: the reference rounds bfloat16 partial sums in other places);
* the reference ``Trainer`` against the port's over 4 steps: loss
  ``STEP_LOSS_RTOL`` 1e-3 relative (measured 1.9e-4), grad_norm
  ``STEP_NORM_RTOL`` 5e-3 (measured 8.4e-4), lr 1e-6;
* microbatches 2 against 1: loss ``STEP_LOSS_RTOL``; the port against itself
  with its two microbatches swapped: bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro_torch import configs, interop, obs, pytree
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import mesh as lmesh
from repro_torch.models import nn as tnn
from repro_torch.models import zoo
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm, warmup_cosine
from repro_torch.train import TrainConfig, Trainer, build_train_step
from repro_torch.train import step as step_mod
from repro_torch.train.trainer import StragglerWatchdog

TOL = 2e-4
LOSS_TOL = 5e-4
GRAD_TOL = 0.05
STEP_LOSS_RTOL = 1e-3
STEP_NORM_RTOL = 5e-3
SHAPE = ShapeConfig("tiny", 32, 4, "train")
SEED = 0


@pytest.fixture(scope="module")
def jref():
    """The reference's modules with the jax 0.9 aliases, for this module's tests."""
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        from repro import configs as jconfigs
        from repro.configs import base as jbase
        from repro.data import tokens as jtokens
        from repro.dist import compressed_allreduce as jcar
        from repro.launch import mesh as jmesh
        from repro.models import nn as jnn
        from repro.models import zoo as jzoo
        from repro import optim as joptim
        from repro import train as jtrain
        from repro.train import trainer as jtrainer
        mods = dict(configs=jconfigs, base=jbase, tokens=jtokens, car=jcar, mesh=jmesh,
                    nn=jnn, zoo=jzoo, optim=joptim, train=jtrain, trainer=jtrainer)
        yield type("Ref", (), mods)
        jax.clear_caches()


@pytest.fixture(scope="module")
def smoke(jref):
    """(reference model, its params, port model, the same params in the port)."""
    jm = jref.zoo.build(jref.configs.get("yi-6b", smoke=True))
    jp = jm.init(jax.random.key(0))
    tp = interop.params_from_reference(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, zoo.build(configs.get("yi-6b", smoke=True)), tp


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group for the test (destroyed after it)."""
    owns = lmesh.start_local_group("cpu")
    yield
    if owns:
        dist.destroy_process_group()


@pytest.fixture
def clean_obs():
    obs.reset()
    obs.clear_events()
    yield
    obs.reset()
    obs.clear_events()


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32) if x.dtype == torch.float32 else x.numpy()
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_tree_bits(port_tree, ref_tree):
    got = pytree.leaves_with_keys(port_tree)
    want = [(jax.tree_util.keystr(p), v)
            for p, v in jax.tree_util.tree_flatten_with_path(ref_tree)[0]]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape, k
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)


def _batch(arr: np.ndarray) -> dict:
    return {"tokens": torch.from_numpy(arr[:, :-1].copy()),
            "labels": torch.from_numpy(arr[:, 1:].copy())}


# ---------------------------------------------------------------------------
# configs, the token stream, the schedule, AdamW
# ---------------------------------------------------------------------------

def test_shapes_and_remat_match_reference(jref):
    assert SHAPES == {k: ShapeConfig(*dataclasses.astuple(v)) for k, v in jref.base.SHAPES.items()}
    assert SHAPES["train_4k"].tokens == jref.base.SHAPES["train_4k"].tokens == 4096 * 256
    assert configs.get("yi-6b").remat is jref.configs.get("yi-6b").remat is True


@pytest.mark.parametrize("seed,step,shard,num_shards",
                         [(0, 0, 0, 1), (7, 3, 1, 2), (123, 11, 3, 4), (0, 1000, 0, 8)])
def test_token_stream_is_the_reference_byte_for_byte(jref, seed, step, shard, num_shards):
    kw = dict(vocab_size=512, seq_len=48, global_batch=8, seed=seed)
    got = TokenStream(**kw).shard_batch(step, shard, num_shards)
    want = jref.tokens.TokenStream(**kw).shard_batch(step, shard, num_shards)
    assert got.dtype == want.dtype == np.int32 and got.tobytes() == want.tobytes()
    full = TokenStream(**kw).global_batch_at(step)
    per = 8 // num_shards
    assert np.array_equal(full[shard * per:(shard + 1) * per], got)
    with pytest.raises(ValueError):
        TokenStream(**kw).shard_batch(step, 0, 3)


@pytest.mark.parametrize("step", [0, 9, 10, 55, 100, 150])
def test_warmup_cosine_matches_reference(jref, step):
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    want = np.float32(jref.optim.warmup_cosine(jnp.int32(step), **kw))
    got = warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _opt_tree(rng):
    return {"w": rng.standard_normal((64, 32)).astype(np.float32),
            "b": rng.standard_normal((300,)).astype(np.float32),
            "layers": {"e_bf16": rng.standard_normal((40, 16)).astype(np.float32)}}


def _to_jax(t):
    return {k: _to_jax(v) if isinstance(v, dict) else
            (jnp.asarray(v).astype(jnp.bfloat16) if k.endswith("bf16") else jnp.asarray(v))
            for k, v in t.items()}


def _to_torch(t):
    """The reference's tree carried over bit for bit (``interop``)."""
    return interop.params_from_reference(jax.tree.map(np.asarray, _to_jax(t)), device="cpu")


@pytest.mark.parametrize("clip_norm", [1.0, 1e9], ids=["clip-active", "clip-inactive"])
def test_adamw_matches_reference(jref, clip_norm):
    """Three updates on a seeded tree (float32 and bfloat16 leaves). With the
    clip inactive m and v are bit for bit; the rest within 1e-6 relative."""
    rng = np.random.default_rng(0)
    tree = _opt_tree(rng)
    jp, tp = _to_jax(tree), _to_torch(tree)
    jo, to = jref.optim.adamw_init(jp), adamw_init(tp)
    assert to["count"].dtype == torch.int32 and to["count"].shape == ()
    jcfg, cfg = jref.optim.AdamWConfig(clip_norm=clip_norm), AdamWConfig(clip_norm=clip_norm)
    for i in range(3):
        g = jax.tree.map(lambda v: (rng.standard_normal(v.shape) * (3 if i == 1 else 0.05))
                         .astype(np.float32), tree)
        np.testing.assert_allclose(global_norm(_to_torch(g)).numpy(),
                                   np.float32(jref.optim.global_norm(_to_jax(g))), rtol=1e-6)
        jp, jo = jref.optim.adamw_update(_to_jax(g), jo, jnp.float32(1e-2), jcfg, jp)
        tp, to = adamw_update(_to_torch(g), to, torch.tensor(1e-2, dtype=torch.float32), cfg, tp)
        assert int(to["count"]) == int(jo["count"]) == i + 1
        for part in ("m", "v", "master"):
            if clip_norm > 1 and part != "master":
                _assert_tree_bits(to[part], jo[part])
            for (k, a), b in zip(pytree.leaves_with_keys(to[part]), jax.tree.leaves(jo[part])):
                b = np.asarray(b)
                assert a.dtype == torch.float32, k
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6 * np.abs(b).max(),
                                           err_msg=f"{part}{k}")
        for (k, a), b in zip(pytree.leaves_with_keys(tp), jax.tree.leaves(jp)):
            assert a.dtype == (torch.bfloat16 if k.endswith("bf16']") else torch.float32), k
            tol = 1e-6 if a.dtype == torch.float32 else 2 ** -7
            np.testing.assert_allclose(f32(a), f32(b), rtol=tol, atol=tol * np.abs(f32(b)).max(),
                                       err_msg=k)


# ---------------------------------------------------------------------------
# layer math and the training loss
# ---------------------------------------------------------------------------

def _grad_pair(jfn, tfn, args):
    """Value and gradient of ``sum(fn(*args) * w)`` in both packages (float32)."""
    w = np.random.default_rng(5).standard_normal(np.asarray(jfn(*map(jnp.asarray, args))).shape) \
        .astype(np.float32)
    jv, jg = jax.value_and_grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    tv = torch.sum(tfn(*ts) * torch.from_numpy(w))
    tg = torch.autograd.grad(tv, ts)
    return ((float(jv), [np.asarray(g) for g in jg]),
            (float(tv.detach()), [g.numpy() for g in tg]))


def _assert_pair(pair, tol=TOL):
    (jv, jg), (tv, tg) = pair
    np.testing.assert_allclose(tv, jv, rtol=tol)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())


def test_layer_norm_matches_reference(jref):
    rng = np.random.default_rng(1)
    args = [rng.standard_normal((3, 5, 64)).astype(np.float32) * 2 + 0.5,
            rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)]
    _assert_pair(_grad_pair(jref.nn.layer_norm, tnn.layer_norm, args))


def test_gelu_mlp_matches_reference(jref):
    rng = np.random.default_rng(2)
    args = [rng.standard_normal((4, 6, 32)).astype(np.float32),
            rng.standard_normal((32, 48)).astype(np.float32) * 0.2,
            rng.standard_normal(48).astype(np.float32) * 0.1,
            rng.standard_normal((48, 32)).astype(np.float32) * 0.2,
            rng.standard_normal(32).astype(np.float32) * 0.1]
    _assert_pair(_grad_pair(jref.nn.gelu_mlp, tnn.gelu_mlp, args))
    # bfloat16: each of gelu's ops rounded to x's type, as the reference rounds them
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in args]
    want = np.asarray(jref.nn.gelu_mlp(*jb).astype(jnp.float32))
    got = tnn.gelu_mlp(*(torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                         for a in jb))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    xw = (np.random.default_rng(4).standard_normal(100_000) * 3).astype(np.float32)
    xb = jnp.asarray(xw).astype(jnp.bfloat16)
    np.testing.assert_array_equal(
        tnn.gelu(torch.from_numpy(xw).to(torch.bfloat16)).float().numpy(),
        np.asarray(jax.nn.gelu(xb).astype(jnp.float32)))


def test_sharded_xent_matches_reference(jref):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 7, 300)) * 4).astype(np.float32)
    labels = rng.integers(0, 300, (2, 7)).astype(np.int32)
    jv, jg = jax.value_and_grad(jref.nn.sharded_xent)(jnp.asarray(logits), jnp.asarray(labels))
    t = torch.from_numpy(logits).requires_grad_(True)
    tv = tnn.sharded_xent(t, torch.from_numpy(labels))
    (tg,) = torch.autograd.grad(tv, t)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=TOL, atol=TOL * np.abs(jg).max())


def test_grad_tap_is_the_identity_unless_installed():
    x = torch.randn(3, 4)
    assert tnn.grad_tap(x, "embed") is x
    seen = []
    tnn.set_grad_tap(lambda t, name: seen.append(name) or t)
    try:
        tnn.grad_tap({"w": x}, "layers")
    finally:
        tnn.set_grad_tap(None)
    assert seen == ["layers"] and tnn.grad_tap(x) is x


def _loss_and_grads_both(jm, jp, m, tp, arr):
    jb = {"tokens": jnp.asarray(arr[:, :-1]), "labels": jnp.asarray(arr[:, 1:])}
    (jl, jaux), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(jp, jb)
    flat = [p.detach().requires_grad_(True) for p in pytree.leaves(tp)]
    loss, aux = m.train_loss(pytree.unflatten(tp, flat), _batch(arr))
    grads = torch.autograd.grad(loss, flat)
    assert torch.equal(loss, aux["xent"])
    return (float(jl), jg), (float(loss.detach()), pytree.unflatten(tp, list(grads)))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_train_loss_and_grads_match_reference(smoke, remat, dtype):
    jm, jp, m, tp = smoke
    m = zoo.build(dataclasses.replace(m.cfg, remat=remat))
    if dtype == "float32":
        jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        tp = pytree.tree_map(lambda t: t.to(torch.float32), tp)
    arr = np.random.default_rng(0).integers(0, 512, (4, 33)).astype(np.int32)
    (jl, jg), (tl, tg) = _loss_and_grads_both(jm, jp, m, tp, arr)
    loss_tol, grad_tol = (2e-5 * abs(jl), 2e-5) if dtype == "float32" else (LOSS_TOL, GRAD_TOL)
    assert abs(tl - jl) <= loss_tol
    for (k, g), w in zip(pytree.leaves_with_keys(tg), jax.tree.leaves(jg)):
        assert g.dtype == getattr(torch, dtype), k
        a, b = f32(g), f32(w)
        assert np.abs(a - b).max() <= grad_tol * np.abs(b).max(), k


def test_remat_changes_no_bit():
    cfg = configs.get("yi-6b", smoke=True)
    tp = zoo.build(cfg).init(torch.Generator().manual_seed(1), device="cpu")
    arr = np.random.default_rng(4).integers(0, 512, (2, 17)).astype(np.int32)
    out = []
    for remat in (True, False):
        loss, grads = step_mod._value_and_grad(zoo.build(dataclasses.replace(cfg, remat=remat)),
                                               tp, _batch(arr))
        out.append((loss, grads))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(pytree.leaves(out[0][1]), pytree.leaves(out[1][1])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the step and the trainer
# ---------------------------------------------------------------------------

def _port_trainer(tp, tcfg=TrainConfig(), mesh=None, **kw):
    mesh = mesh if mesh is not None else lmesh.make_local_mesh(device="cpu")
    cfg = configs.get("yi-6b", smoke=True)
    return Trainer(zoo.build(cfg), SHAPE, mesh, tcfg,
                   stream=TokenStream(cfg.vocab, SHAPE.seq_len, SHAPE.global_batch, seed=SEED),
                   init_params=tp, device="cpu", **kw)


@pytest.fixture(scope="module")
def ref_history(jref, smoke):
    """The reference's ``Trainer`` at the smoke config on ``make_local_mesh()``,
    4 steps from ``model.init(key(0))``, stream seed 0: run once."""
    jm = smoke[0]
    jt = jref.trainer.Trainer(jm, jref.base.ShapeConfig("tiny", 32, 4, "train"),
                              jref.mesh.make_local_mesh(), jref.train.TrainConfig(),
                              stream=jref.tokens.TokenStream(512, 32, 4, seed=SEED))
    return jt.run(4)


def test_trainer_matches_reference(ref_history, smoke, one_rank_group, clean_obs):
    t = _port_trainer(smoke[3])
    assert t.info["mode"] == "exact" and t.err == {}
    th = t.run(4)
    assert len(th) == len(ref_history) == 4
    for a, b in zip(th, ref_history):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=STEP_LOSS_RTOL)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=STEP_NORM_RTOL)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
    snap = obs.snapshot()
    assert snap["counters"]["train_steps"] == 4 and snap["gauges"]["train_tokens_per_s"] > 0
    assert [e["name"] for e in obs.events() if e["name"] == "train.step"] == ["train.step"] * 4


def _bits_t(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else (
        t.view(torch.int32) if t.dtype == torch.float32 else t)


def test_microbatches_match_reference(jref, smoke):
    """``microbatches=2``: the reference's ``build_train_step`` against the port's,
    two steps; the accumulated gradients are float32 (one microbatch: bf16)."""
    jm, jp, m, tp = smoke
    jmesh = jref.mesh.make_local_mesh()
    jstep, jinfo = jref.train.build_train_step(
        jm, jref.base.ShapeConfig("tiny", 32, 4, "train"), jmesh,
        jref.train.TrainConfig(microbatches=2, warmup_steps=1))
    stand_in = type("Mesh", (), {"axis_names": ("data", "model"),
                                 "shape": {"data": 1, "model": 1}})()
    step, info = build_train_step(m, SHAPE, stand_in, TrainConfig(microbatches=2, warmup_steps=1),
                                  device="cpu")
    assert info["mode"] == "exact" and info["make_err_state"](m.abstract_params()) == {}
    assert info["err_shardings"] is None and jinfo["err_shardings"] is None
    assert set(info) >= set(jinfo)
    stream = TokenStream(512, 32, 4, seed=SEED)
    jp = jax.tree.map(jnp.array, jp)          # a copy: the reference's step donates it
    jo = jref.optim.adamw_init(jp)
    params, opt, err = tp, adamw_init(tp), {}
    for i in range(2):
        arr = stream.global_batch_at(i)
        jb = {"tokens": jnp.asarray(arr[:, :-1]), "labels": jnp.asarray(arr[:, 1:])}
        jp, jo, _, jmet = jstep(jp, jo, {}, jnp.int32(i), jb)
        params, opt, err, met = step(params, opt, err, i, _batch(arr))
        np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=STEP_LOSS_RTOL)
        np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                                   rtol=STEP_NORM_RTOL)
        np.testing.assert_allclose(float(met["lr"]), float(jmet["lr"]), rtol=1e-6)
    arr = stream.global_batch_at(0)
    for n, dt in ((1, torch.bfloat16), (2, torch.float32)):
        _, g = step_mod._loss_and_grads(m, tp, _batch(arr), n)
        assert {x.dtype for x in pytree.leaves(g)} == {dt}


def test_two_microbatches_equal_one_and_commute(smoke):
    """Two microbatches give one microbatch's loss within ``STEP_LOSS_RTOL``, and
    swapping the two microbatches changes no bit: the float32 sum starts from
    zeros, so (0 + a) + b is b + a."""
    m, tp = smoke[2], smoke[3]
    arr = TokenStream(512, 32, 4, seed=SEED).global_batch_at(2)
    swapped = np.concatenate([arr[2:], arr[:2]])
    l1, _ = step_mod._loss_and_grads(m, tp, _batch(arr), 1)
    l2, g2 = step_mod._loss_and_grads(m, tp, _batch(arr), 2)
    l2s, g2s = step_mod._loss_and_grads(m, tp, _batch(swapped), 2)
    np.testing.assert_allclose(float(l2), float(l1), rtol=STEP_LOSS_RTOL)
    assert torch.equal(_bits_t(l2), _bits_t(l2s))
    for (k, a), b in zip(pytree.leaves_with_keys(g2), pytree.leaves(g2s)):
        assert torch.equal(_bits_t(a), _bits_t(b)), k


def test_straggler_watchdog_flags_injected_delay():
    """The reference's ``tests/test_ckpt.py`` case on the port."""
    wd = StragglerWatchdog(factor=3.0, warmup=1)
    wd.observe(0, 10.0)   # warm-up (first step)
    wd.observe(1, 0.1)
    wd.observe(2, 0.11)
    ev = wd.observe(3, 1.0)
    assert ev is not None and ev.step == 3
    assert wd.observe(4, 0.1) is None


def test_straggler_watchdog_events_equal_reference(jref):
    times = [5.0, 4.0, 0.1, 0.11, 1.0, 0.1, 0.09, 0.5, 0.1, 2.0, 0.1]
    for kw in (dict(), dict(factor=3.0, warmup=1), dict(factor=2.0, alpha=0.5, warmup=0)):
        ours, theirs = StragglerWatchdog(**kw), jref.trainer.StragglerWatchdog(**kw)
        got = [ours.observe(i, s) for i, s in enumerate(times)]
        want = [theirs.observe(i, s) for i, s in enumerate(times)]
        assert [dataclasses.asdict(e) if e else None for e in got] == \
               [dataclasses.asdict(e) if e else None for e in want]
        assert ours.ewma == theirs.ewma and len(ours.events) == len(theirs.events)


def test_trainer_injected_delay_is_flagged(smoke, one_rank_group, monkeypatch):
    """A delay injected into one step of a running trainer is flagged, and only
    that step. The trainer's clock is a stand-in (each reading 10 ms later,
    ``sleep`` advancing it), so the steps' times do not depend on the host."""
    from repro_torch.train import trainer as trainer_mod

    class Clock:
        now = 0.0

        def perf_counter(self):
            self.now += 0.01
            return self.now

        def sleep(self, seconds):
            self.now += seconds
    monkeypatch.setattr(trainer_mod, "time", Clock())
    t = _port_trainer(smoke[3])
    hist = t.run(6, delay_injector=lambda s: 1.0 if s == 4 else 0.0)
    assert [m["straggler"] for m in hist] == [False] * 4 + [True, False]
    assert [e.step for e in t.watchdog.events] == [4]
