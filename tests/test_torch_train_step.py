"""The port's compressed training step against the reference and against
itself, on the CPU, at the Yi-6B smoke config (``ShapeConfig("tiny", 32, 4,
"train")``, ``min_leaf_size`` 1024, buckets of 64 KiB).

* On a one-rank gloo pod mesh (``make_mesh((1, 1, 1), ("pod", "data",
  "model"))``) and with two pods in one process (a stand-in mesh), at one and
  two microbatches: the overlap form (buckets issued from the backward's
  gradient boundaries) equals the barrier form bit for bit (parameters,
  optimizer and error state).
* Given the reference's per-pod gradients, the step's reduce equals the
  reference's inline ``reduce_stacked(mesh=None)`` bit for bit (reduced tree
  and error state) and the loss is the pod mean exactly; AdamW within 1e-6
  relative and the bfloat16 parameters within one bfloat16 ulp (2**-7).

The reference runs in this process with the two jax 0.9 aliases (a
module-scoped ``MonkeyPatch.context()``); its parameters are carried over with
``interop.params_from_reference``.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro_torch import configs, interop, obs, pytree
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import TokenStream
from repro_torch.dist import compressed_allreduce as car
from repro_torch.launch import mesh as lmesh
from repro_torch.models import zoo
from repro_torch.optim import adamw_init
from repro_torch.train import TrainConfig, Trainer, build_train_step
from repro_torch.train import step as step_mod

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
        from repro import optim as joptim
        from repro.dist import compressed_allreduce as jcar
        from repro.models import zoo as jzoo
        yield type("Ref", (), dict(configs=jconfigs, car=jcar, zoo=jzoo, optim=joptim))
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


def _bits_t(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else (
        t.view(torch.int32) if t.dtype == torch.float32 else t)


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


def _port_trainer(tp, tcfg, mesh):
    cfg = configs.get("yi-6b", smoke=True)
    return Trainer(zoo.build(cfg), SHAPE, mesh, tcfg,
                   stream=TokenStream(cfg.vocab, SHAPE.seq_len, SHAPE.global_batch, seed=SEED),
                   init_params=tp, device="cpu")


GC = dict(enabled=True, min_leaf_size=1024)


def _in_backward() -> int:
    return int(obs.snapshot()["counters"].get(step_mod.bkt.IN_BACKWARD, 0))


def test_barrier_equals_overlap_on_a_one_rank_gloo_pod_mesh(smoke, one_rank_group, clean_obs):
    """2 steps of each form from the same start: params, optimizer and error
    state bit for bit (the reference's test_dist 2d at one rank). The overlap
    form issues every bucket from the backward's gradient boundaries."""
    tp = smoke[3]
    mesh = lmesh.make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
    out = {}
    for name, gc in (("barrier", car.GradCompressionConfig(**GC)),
                     ("overlap", car.GradCompressionConfig(**GC, overlap=True,
                                                           bucket_bytes=1 << 16))):
        t = _port_trainer(tp, TrainConfig(grad_compress=gc, total_steps=10), mesh=mesh)
        assert t.info["mode"] == name and t.info["pod"] == 0 and t.info["n_pods"] == 1
        t.run(2)
        out[name] = t._state()
        assert _in_backward() == (2 * t.info["plan"].n_buckets if name == "overlap" else 0)
    assert t.info["plan"].n_buckets > 1
    for (k, a), b in zip(pytree.leaves_with_keys(out["barrier"]), pytree.leaves(out["overlap"])):
        assert torch.equal(_bits_t(a), _bits_t(b)), k
    assert tuple(out["barrier"]["err"]["embed"].shape) == (1, 512, 128)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_overlap_equals_barrier_with_pods_in_one_process(smoke, clean_obs, n_micro):
    """Two pods in this process (a stand-in pod mesh), with one and two
    microbatches: 2 steps of the overlap form equal the barrier form's bit for
    bit. The buckets are issued in the backward of the last pod's last pass."""
    m, tp = smoke[2], smoke[3]
    stand_in = type("Mesh", (), {"axis_names": ("pod", "data", "model"),
                                 "shape": {"pod": 2, "data": 1, "model": 1}})()
    stream = TokenStream(512, 32, 4, seed=SEED)
    out = {}
    for overlap in (False, True):
        gc = car.GradCompressionConfig(**GC, overlap=overlap, bucket_bytes=1 << 16)
        step, info = build_train_step(m, SHAPE, stand_in, TrainConfig(
            grad_compress=gc, total_steps=10, microbatches=n_micro), device="cpu")
        params, opt = tp, adamw_init(tp)
        err = info["make_err_state"](m.abstract_params())
        for i in range(2):
            params, opt, err, met = step(params, opt, err, i, _batch(stream.global_batch_at(i)))
        out[overlap] = dict(params=params, opt=opt, err=err, loss=met["loss"])
    assert _in_backward() == 2 * info["plan"].n_buckets > 2
    for (k, a), b in zip(pytree.leaves_with_keys(out[False]), pytree.leaves(out[True])):
        assert torch.equal(_bits_t(a), _bits_t(b)), k


@pytest.mark.parametrize("overlap", [False, True], ids=["barrier", "overlap"])
def test_compressed_step_matches_reference_inline_reduce(jref, smoke, monkeypatch, overlap):
    """Two pods in this process (a stand-in pod mesh). Given the reference's
    per-pod gradients, the port's step reduces them bit for bit as the
    reference's inline ``reduce_stacked(mesh=None)`` does (reduced tree and
    error state), then AdamW within 1e-6; the loss is the pod mean, exactly."""
    jm, jp, m, tp = smoke
    n_pods, steps = 2, 2
    gc = car.GradCompressionConfig(**GC, overlap=overlap, bucket_bytes=1 << 16)
    jgc = jref.car.GradCompressionConfig(**GC)
    stand_in = type("Mesh", (), {"axis_names": ("pod", "data", "model"),
                                 "shape": {"pod": n_pods, "data": 1, "model": 1}})()
    tcfg = TrainConfig(grad_compress=gc, total_steps=10, warmup_steps=1)
    step, info = build_train_step(m, SHAPE, stand_in, tcfg, device="cpu")
    assert info["mode"] == ("overlap" if overlap else "barrier") and info["pod"] is None
    stream = TokenStream(512, 32, 4, seed=SEED)
    jerr = jref.car.init_error_state(
        jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), jp), n_pods, jgc)
    err = info["make_err_state"](m.abstract_params())
    jo, params, opt = jref.optim.adamw_init(jp), tp, adamw_init(tp)
    per_pod, reduced = [], []

    def fake_loss_and_grads(model, p, batch, n_micro, reducer=None):
        loss, g = per_pod.pop(0)
        g = pytree.unflatten(p, [interop.params_from_reference(np.asarray(x), device="cpu")
                                 for x in jax.tree.leaves(g)])
        if reducer is not None:          # the overlap form: the reducer takes them
            reducer.settle(g)
            g = None
        return torch.tensor(loss), g
    real_reduce = car.reduce_stacked if not overlap else step_mod.bkt.BucketReducer.finish

    def spy(*a, **kw):
        out = real_reduce(*a, **kw)
        reduced.append(out[0])
        return out
    monkeypatch.setattr(step_mod, "_loss_and_grads", fake_loss_and_grads)
    monkeypatch.setattr(step_mod.bkt.BucketReducer if overlap else step_mod.car,
                        "finish" if overlap else "reduce_stacked", spy)
    for i in range(steps):
        arr = stream.global_batch_at(i)
        rows = arr.shape[0] // n_pods
        jgrads, jlosses = [], []
        for p in range(n_pods):
            sl = arr[p * rows:(p + 1) * rows]
            (jl, _), jg = jax.value_and_grad(jm.train_loss, has_aux=True)(
                jp, {"tokens": jnp.asarray(sl[:, :-1]), "labels": jnp.asarray(sl[:, 1:])})
            jgrads.append(jg)
            jlosses.append(np.float32(jl))
            per_pod.append((np.float32(jl), jg))
        jstack = jax.tree.map(lambda *g: jnp.stack(g), *jgrads)
        jred, jerr = jref.car.reduce_stacked(jstack, jerr, jgc)
        lr = jref.optim.warmup_cosine(jnp.int32(i), peak_lr=tcfg.peak_lr,
                                      warmup_steps=tcfg.warmup_steps, total_steps=tcfg.total_steps)
        jp, jo = jref.optim.adamw_update(jred, jo, lr, jref.optim.AdamWConfig(), jp)
        params, opt, err, met = step(params, opt, err, i, _batch(arr))
        _assert_tree_bits(reduced.pop(), jred)
        _assert_tree_bits(err, jerr)
        assert float(met["loss"]) == float(jnp.mean(jnp.asarray(jlosses)))
        for part in ("m", "v", "master"):
            for (k, a), b in zip(pytree.leaves_with_keys(opt[part]), jax.tree.leaves(jo[part])):
                b = np.asarray(b)
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6 * np.abs(b).max(),
                                           err_msg=f"{part}{k}")
        for (k, a), b in zip(pytree.leaves_with_keys(params), jax.tree.leaves(jp)):
            np.testing.assert_allclose(f32(a), f32(b), rtol=2 ** -7, err_msg=k)
