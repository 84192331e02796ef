"""The port's compressed training step across ranks, as gloo processes on the CPU.

Two ranks, one pod each, joined by a ``file://`` store under the test's
temporary directory (no TCP port). Every process runs with one thread (the
CPU's GEMMs sum in an order that depends on the thread count). Two cases run
in the same processes:

* **glm4-9b smoke on a (2, 1, 1) pod x data x model mesh**
  (``launch.mesh.make_mesh``; ``tests/test_dist.py``'s overlap-step case):
  ``build_train_step`` with ``min_leaf_size`` 1024, 2 steps on one seeded
  batch from the reference's ``model.init(key(0))`` (carried over with
  ``interop``), in the barrier form and in the overlap form (buckets of 64
  KiB). The two forms are bit-identical on every rank (parameters, optimizer
  and error state). Both are held to an oracle that this test builds in its
  own process from the reference's parts: ``jax.vmap`` of
  ``train.step._loss_and_grads`` over the two pods' rows,
  ``compressed_allreduce.reduce_stacked(..., mesh=None)``, ``warmup_cosine``
  and ``adamw_update``. XLA and torch round the bfloat16 gradients in other
  places, so the comparison has tolerances (measured, then pinned with
  room): the losses 1e-3 relative (measured 8.7e-5); each rank's residual
  within 2.5 ``eb`` of the oracle's, where ``eb`` is 1e-4 of the range of the
  reduce's input (a code at a rounding edge moves by one quantum, 2 ``eb``;
  measured 1.995 ``eb``); the moments ``m`` within 0.05 and ``v`` within 0.1
  of each leaf's largest magnitude (measured 0.028 and 0.046, on the norm
  scales); the float32 masters within 2e-4 and the bfloat16 parameters
  within 2**-7 of each leaf's largest magnitude (measured 7.2e-5 and 9.1e-5:
  an update of ``lr`` 3e-6 whose sign follows a tiny gradient).
* **yi-6b smoke through the Trainer**, the barrier form for 2 steps with a
  checkpoint, then a new ``Trainer`` that restores it (the error state
  gathered to the stacked ``(2, ...)`` layout on rank 0, each rank's slice
  taken back) and runs a third step; the overlap form for 3 steps. A third
  process composes the same 3 steps alone from the port's pieces (no group):
  each pod's loss and gradients on its rows, the inline
  ``reduce_stacked(mesh=None)``, ``warmup_cosine``, ``adamw_update``, the pod
  mean. Every rank equals the composition bit for bit.

Run one process by hand: ``python tests/test_torch_train_multiproc.py CASE RANK WORLD DIR``.
"""
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
TIMEOUT = 120                # seconds for all processes of the test
STEPS = 3
PODS = 2
GLM_STEPS = 2
GLM_MIN_LEAF = 1024
# each leaf's largest difference from the oracle, over its largest magnitude
ORACLE_TOLS = (("['opt']['m']", 0.05), ("['opt']['v']", 0.1), ("['opt']['master']", 2e-4),
               ("['params']", 2 ** -7))


def _setup():
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.dist.compressed_allreduce import GradCompressionConfig
    from repro_torch.models import zoo
    from repro_torch.train import TrainConfig
    cfg = configs.get("yi-6b", smoke=True)
    model = zoo.build(cfg)
    shape = ShapeConfig("tiny", 32, 4, "train")
    stream = TokenStream(cfg.vocab, shape.seq_len, shape.global_batch, seed=7)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    gc = GradCompressionConfig(enabled=True, min_leaf_size=1024)
    tcfgs = {"barrier": TrainConfig(grad_compress=gc, total_steps=10, warmup_steps=1),
             "overlap": TrainConfig(grad_compress=GradCompressionConfig(
                 enabled=True, min_leaf_size=1024, overlap=True, bucket_bytes=1 << 16),
                 total_steps=10, warmup_steps=1)}
    return model, shape, stream, params, tcfgs


def _glm_tcfgs(gcc):
    from repro_torch.train import TrainConfig
    return {"barrier": TrainConfig(grad_compress=gcc(enabled=True, min_leaf_size=GLM_MIN_LEAF),
                                   total_steps=10),
            "overlap": TrainConfig(grad_compress=gcc(enabled=True, min_leaf_size=GLM_MIN_LEAF,
                                                     overlap=True, bucket_bytes=1 << 16),
                                   total_steps=10)}


def _rank_glm(rank, directory):
    """The glm4-9b smoke step on a (2, 1, 1) mesh, both forms, from the inputs
    the test wrote (the reference's parameters and the batch)."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.compressed_allreduce import GradCompressionConfig
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import zoo
    from repro_torch.optim import adamw_init
    from repro_torch.train import build_train_step
    inputs = torch.load(os.path.join(directory, "glm_inputs.pt"), weights_only=False)
    model = zoo.build(configs.get("glm4-9b", smoke=True))
    mesh = lmesh.make_mesh((PODS, 1, 1), ("pod", "data", "model"), device="cpu")
    res = {}
    for form, tcfg in _glm_tcfgs(GradCompressionConfig).items():
        step, info = build_train_step(model, ShapeConfig("t", 32, 4, "train"), mesh, tcfg,
                                      device="cpu")
        assert info["mode"] == form and info["pod"] == rank
        params, opt = inputs["params"], adamw_init(inputs["params"])
        err = info["make_err_state"](model.abstract_params())
        losses = []
        for i in range(GLM_STEPS):
            params, opt, err, metrics = step(params, opt, err, i, inputs["batch"])
            losses.append(float(metrics["loss"]))
        res[form] = dict(losses=losses, state={"params": params, "opt": opt, "err": err})
    torch.save(res, os.path.join(directory, f"glm_rank{rank}.pt"))


def _rank_train(rank, world, directory):
    from repro_torch.launch import mesh as lmesh
    from repro_torch.train import Trainer
    model, shape, stream, params, tcfgs = _setup()
    mesh = lmesh.make_local_mesh(pods=PODS, device="cpu")
    res = {}
    ck = os.path.join(directory, "ckpt")
    kw = dict(stream=stream, init_params=params, device="cpu")
    t1 = Trainer(model, shape, mesh, tcfgs["barrier"], ckpt_dir=ck, ckpt_every=100, **kw)
    h = t1.run(2)
    t2 = Trainer(model, shape, mesh, tcfgs["barrier"], ckpt_dir=ck, ckpt_every=100, **kw)
    assert t2.step == 2 and t2.info["pod"] == rank and t2.info["mode"] == "barrier"
    h = h + t2.run(1)
    res["barrier"] = dict(losses=[m["loss"] for m in h], state=t2._state(),
                          stacked=t2._stacked_err())
    t3 = Trainer(model, shape, mesh, tcfgs["overlap"], **kw)
    assert t3.info["mode"] == "overlap"
    h = t3.run(STEPS)
    res["overlap"] = dict(losses=[m["loss"] for m in h], state=t3._state(),
                          stacked=t3._stacked_err())
    torch.save(res, os.path.join(directory, f"rank{rank}.pt"))


def _compose(directory):
    """The 3 steps in one process from the port's pieces, without a group."""
    from repro_torch import pytree
    from repro_torch.dist import compressed_allreduce as car
    from repro_torch.optim import adamw_init, adamw_update, warmup_cosine
    model, shape, stream, params, tcfgs = _setup()
    tcfg = tcfgs["barrier"]
    opt = adamw_init(params)
    err = car.init_error_state(model.abstract_params(), PODS, tcfg.grad_compress, device="cpu")
    per = shape.global_batch // PODS
    losses = []
    for i in range(STEPS):
        arr = torch.from_numpy(stream.global_batch_at(i))
        pod_losses, pod_grads = [], []
        for p in range(PODS):
            rows = arr[p * per:(p + 1) * per]
            flat = [x.detach().requires_grad_(True) for x in pytree.leaves(params)]
            loss, _ = model.train_loss(pytree.unflatten(params, flat),
                                       {"tokens": rows[:, :-1], "labels": rows[:, 1:]})
            pod_grads.append(pytree.unflatten(params, list(torch.autograd.grad(loss, flat))))
            pod_losses.append(loss.detach())
        stacked = pytree.tree_map(lambda *g: torch.stack(g), *pod_grads)
        grads, err = car.reduce_stacked(stacked, err, tcfg.grad_compress)
        lr = warmup_cosine(torch.tensor(i, dtype=torch.int32), peak_lr=tcfg.peak_lr,
                           warmup_steps=tcfg.warmup_steps, total_steps=tcfg.total_steps)
        params, opt = adamw_update(grads, opt, lr, tcfg.adamw, params)
        losses.append(float(car.pod_mean(pod_losses)))
    torch.save(dict(losses=losses, state={"params": params, "opt": opt, "err": err}),
               os.path.join(directory, "compose.pt"))


def _main(case, rank, world, directory):
    rank, world = int(rank), int(world)
    if case == "compose":
        _compose(directory)
        return
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{directory}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        _rank_glm(rank, directory)
        _rank_train(rank, world, directory)
    finally:
        dist.destroy_process_group()


def _spawn(directory):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC)] + [p for p in
                                                      env.get("PYTHONPATH", "").split(os.pathsep)
                                                      if p])
    env["OMP_NUM_THREADS"] = "1"
    cmds = [("train", r, PODS) for r in range(PODS)] + [("compose", 0, 1)]
    procs = [subprocess.Popen([sys.executable, str(HERE), case, str(r), str(w), str(directory)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for case, r, w in cmds]
    deadline = time.monotonic() + TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for (case, r, _), p, (_, err) in zip(cmds, procs, outs):
        assert p.returncode == 0, f"{case} process {r} failed:\n{err[-4000:]}"


@pytest.fixture(scope="module")
def jref():
    """The reference's modules with the jax 0.9 aliases, for this module's tests.
    The oracle composes the reference's step on no mesh, so the reference's
    process-wide activation sharder and gradient tap are cleared for the
    module: a reference ``build_train_step`` run earlier in this process
    leaves its mesh's sharder installed (``repro/train/step.py:43-50``)."""
    import jax
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    from repro.models import nn as jnn
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        mp.setattr(jnn, "_ACT_SHARDER", None)
        mp.setattr(jnn, "_GRAD_TAP", None)
        from repro import configs, optim
        from repro.dist import compressed_allreduce as car
        from repro.models import zoo
        from repro.train import step
        yield type("Ref", (), dict(configs=configs, optim=optim, car=car, zoo=zoo, step=step))
        jax.clear_caches()


@pytest.fixture(scope="module")
def runs(jref, tmp_path_factory):
    """Write the glm4-9b inputs (the reference's parameters, a seeded batch),
    run the rank and composing processes once, and return the directory."""
    import jax
    from repro_torch import interop
    directory = tmp_path_factory.mktemp("train_multiproc")
    jm = jref.zoo.build(jref.configs.get("glm4-9b", smoke=True))
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, jm.cfg.vocab, (4, 32)).astype(np.int32),
             "labels": rng.integers(0, jm.cfg.vocab, (4, 32)).astype(np.int32)}
    torch.save({"params": interop.params_from_reference(jp, device="cpu"),
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}},
               directory / "glm_inputs.pt")
    _spawn(directory)
    return directory, jm, jp, batch


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view(np.int32) if t.dtype == torch.float32 else t.numpy()


def _assert_same(got, want, what):
    from repro_torch import pytree
    g, w = pytree.leaves_with_keys(got), pytree.leaves_with_keys(want)
    assert [k for k, _ in g] == [k for k, _ in w], what
    for (k, a), (_, b) in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape), (what, k)
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{what} {k}")


def _oracle(jref, jm, jp, batch):
    """The reference's step from its parts: vmap of ``_loss_and_grads`` over
    the pods' rows, the inline reduce, the schedule and AdamW."""
    import jax
    import jax.numpy as jnp
    tcfg = _glm_tcfgs(jref.car.GradCompressionConfig)["barrier"]
    gc = tcfg.grad_compress
    jerr = jref.car.init_error_state(
        jax.tree.map(lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), jp), PODS, gc)
    jo = jref.optim.adamw_init(jp)
    pods_batch = {k: jnp.asarray(v).reshape((PODS, -1) + v.shape[1:]) for k, v in batch.items()}
    losses = []
    for i in range(GLM_STEPS):
        pod_losses, g_stack = jax.vmap(
            lambda p, b: jref.step._loss_and_grads(jm, p, b, 1), in_axes=(None, 0))(jp, pods_batch)
        # the reduce's input: each pod's gradient plus its replayed residual
        x = jax.tree.map(lambda g, e: np.asarray(g.astype(jnp.float32) + e) if e.size else e,
                         g_stack, jerr)
        red, jerr = jref.car.reduce_stacked(g_stack, jerr, gc, mesh=None)
        lr = jref.optim.warmup_cosine(jnp.int32(i), peak_lr=tcfg.peak_lr,
                                      warmup_steps=tcfg.warmup_steps,
                                      total_steps=tcfg.total_steps)
        jp, jo = jref.optim.adamw_update(red, jo, lr, tcfg.adamw, jp)
        losses.append(float(jnp.mean(pod_losses)))
    return losses, jax.tree.map(np.asarray, {"params": jp, "opt": jo, "err": jerr}), x


def test_two_rank_glm4_barrier_equals_overlap_and_the_reference_oracle(jref, runs):
    import jax
    import jax.numpy as jnp
    from repro_torch import pytree
    directory, jm, jp, batch = runs
    want_losses, want, x = _oracle(jref, jm, jp, batch)
    want_leaves = {jax.tree_util.keystr(p): v
                   for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    x_leaves = {"['err']" + jax.tree_util.keystr(p): v
                for p, v in jax.tree_util.tree_flatten_with_path(x)[0]}
    for rank in range(PODS):
        res = torch.load(directory / f"glm_rank{rank}.pt", weights_only=False)
        _assert_same(res["overlap"]["state"], res["barrier"]["state"], f"rank {rank} overlap")
        assert res["overlap"]["losses"] == res["barrier"]["losses"]
        np.testing.assert_allclose(res["barrier"]["losses"], want_losses, rtol=1e-3)
        for k, got in pytree.leaves_with_keys(res["barrier"]["state"]):
            w = want_leaves[k]
            if k.startswith("['err']"):
                if got.numel() == 0:
                    assert w.size == 0, k
                    continue
                w = w[rank:rank + 1]                    # this rank's residual
                eb = 1e-4 * float(np.ptp(x_leaves[k][rank]))
                assert np.abs(got.numpy() - w).max() <= 2.5 * eb, k
            elif k.startswith("['opt']['count']"):
                assert int(got) == int(w) == GLM_STEPS
            else:
                tol = next(t for prefix, t in ORACLE_TOLS if k.startswith(prefix))
                w32 = np.asarray(jnp.asarray(w).astype(jnp.float32))
                diff = np.abs(got.to(torch.float32).numpy() - w32).max()
                assert diff <= tol * np.abs(w32).max(), k


def test_two_rank_compressed_trainer_equals_its_single_process_composition(runs):
    from repro_torch import pytree
    directory = runs[0]
    want = torch.load(directory / "compose.pt", weights_only=False)
    assert len(want["losses"]) == STEPS and all(np.isfinite(want["losses"]))
    for rank in range(PODS):
        res = torch.load(directory / f"rank{rank}.pt", weights_only=False)
        for form in ("barrier", "overlap"):
            got = res[form]
            assert got["losses"] == want["losses"], (rank, form)
            _assert_same(got["state"]["params"], want["state"]["params"], f"{form} params")
            _assert_same(got["state"]["opt"], want["state"]["opt"], f"{form} opt")
            _assert_same(got["stacked"], want["state"]["err"], f"{form} stacked err")
            own = pytree.tree_map(lambda e: e[rank:rank + 1] if e.numel() else e,
                                  want["state"]["err"])
            _assert_same(got["state"]["err"], own, f"{form} rank {rank} err")
    assert (directory / "ckpt" / "LATEST").read_text() == "step_00000003"


if __name__ == "__main__":
    _main(*sys.argv[1:])
