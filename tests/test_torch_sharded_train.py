"""In-pod FSDP x tensor parallelism on DTensors, as four gloo processes on the CPU.

Four ranks joined by a ``file://`` store under the test's temporary directory
(no TCP port), one thread each. Every rank runs, for glm4-9b SMOKE (dense)
and dbrx-132b SMOKE (experts on ``tp``), from the reference's
``init(key(0))`` weights carried over with ``interop`` and one seeded batch of
8 x 32 tokens, two steps of ``build_train_step`` on each mesh, at step
indices 1 and 2 of a one-step warmup, so both steps move the weights by the
peak rate (step 0 would run at rate 0):

* ``(data, model)`` = ``(4, 1)`` and ``(2, 2)``: the exact step;
* ``(pod, data, model)`` = ``(2, 2, 1)``: the compressed barrier and overlap
  forms (``min_leaf_size`` 1024), each pod's leaf gathered whole in the pod
  before K4's plain version compresses it.

Each rank asserts that every parameter's local block has the shape
``resolve_spec`` implies, and saves the gathered state: parameters, AdamW's
masters and moments, the error state and each step's loss and gradient
norm. Held against:

* the port's one-process step: the exact step on a stand-in mesh for the
  exact forms; the inline pod form (every pod in one process, ``reduce_stacked
  (mesh=None)``) for the compressed ones. Barrier and overlap are bit-identical
  on every rank;
* the reference's ``build_train_step`` on the same mesh over 4 fake XLA
  devices, in a subprocess that wraps ``jax.make_mesh`` with Auto axes (the
  jax 0.9 drift; nothing in ``src/repro`` changes). The reference's overlap
  form does not run on jax 0.9 (its ``optimization_barrier`` reads
  ``batching.primitive_batchers`` as a dict), so the port's overlap form is
  held to the reference's barrier form, which it equals in the port.

XLA and torch round bfloat16 products in other places and DTensor sums the
partial products in another order, so the comparisons have tolerances,
measured and pinned with room as in ``test_torch_train_multiproc.py`` (``TOL``;
the worst measured over ranks and cases, glm4-9b / dbrx-132b): the losses
1e-3 relative (2.4e-4 / 7.1e-4); the gradient norms (5.4e-4 / 5.7e-3); the
2-norm of the difference of AdamW's moments ``m`` and ``v``, relative to the
moments' own (m 0.019 / 0.17, v 0.026 / 0.22); that of the float32 masters'
difference, relative to how far the two updates moved them (0.13 / 0.42:
Adam moves an element whose gradient is near 0 by a whole update of either
sign); each pod's error-state leaf's largest and root-mean-square residual,
relative (0.0096 / 0.074). The parameters equal their masters rounded. A
zeroed gradient puts the moments and the update a whole of their size away;
a pod's or half of the batch's rows alone fail them too (PERF.md records
such planted faults). A sharded ``Trainer`` (yi-6b SMOKE on
the ``(2, 2)`` mesh) saves a checkpoint of gathered leaves, a new one
restores it laid out again, and the restored state equals the saved one bit
for bit.

Run one process by hand: ``python tests/test_torch_sharded_train.py RANK WORLD DIR``.
"""
import datetime
import json
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
TIMEOUT = 300                # seconds for all processes of the test
WORLD = 4
STEPS = 2
ARCHS = ("glm4-9b", "dbrx-132b")
MIN_LEAF = 1024
BATCH, SEQ = 8, 32
# name -> (mesh shape, axis names, compressed form or None)
CASES = {"d4": ((4, 1), ("data", "model"), None),
         "d2m2": ((2, 2), ("data", "model"), None),
         "pod_barrier": ((2, 2, 1), ("pod", "data", "model"), "barrier"),
         "pod_overlap": ((2, 2, 1), ("pod", "data", "model"), "overlap")}
FIRST_STEP = 1              # step 0 of a one-step warmup runs at rate 0
PEAK_LR = 3e-4
LOSS_RTOL = 1e-3
# measured (see the module docstring), pinned with room: "norm" relative to the
# gradient norms; "moment" the 2-norm of the moments' difference relative to
# the moments'; "update" that of the masters' difference relative to what the
# two steps moved them; "err" relative to each error-state leaf's largest and
# root-mean-square residual. The MoE's router flips experts at near ties,
# which moves its gradients more than the dense model's rounding does.
TOL = {"glm4-9b": {"norm": 2e-3, "moment": 2 ** -4, "update": 0.25, "err": 0.05},
       "dbrx-132b": {"norm": 2e-2, "moment": 0.5, "update": 0.75, "err": 0.2}}


def _tcfg(form, gcc, tc):
    if form is None:
        return tc(total_steps=10, warmup_steps=1, peak_lr=PEAK_LR)
    return tc(total_steps=10, warmup_steps=1, peak_lr=PEAK_LR, grad_compress=gcc(
        enabled=True, min_leaf_size=MIN_LEAF, overlap=form == "overlap",
        bucket_bytes=1 << 16))


def _run_case(arch, case, inputs, mesh=None):
    """Two steps of one case; ``mesh`` None runs the one-process form."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.compressed_allreduce import GradCompressionConfig
    from repro_torch.models import zoo
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, build_train_step
    model = zoo.build(configs.get(arch, smoke=True))
    shape, names, form = CASES[case]
    if mesh is None:
        sizes = {n: (s if n == "pod" else 1) for n, s in zip(names, shape)}
        mesh = type("StandIn", (), {"axis_names": names, "shape": sizes})()
    step, info = build_train_step(model, ShapeConfig("t", SEQ, BATCH, "train"), mesh,
                                  _tcfg(form, GradCompressionConfig, TrainConfig),
                                  device="cpu")
    params = inputs["params"][arch]
    if info["sharded"]:
        params = shd.distribute_tree(params, model.param_specs(), mesh)
        for p, sh in zip(_leaves(params), _leaves(info["params"])):
            from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
            want, _ = compute_local_shape_and_global_offset(tuple(p.shape), sh.mesh,
                                                            list(sh.placements))
            assert tuple(p.to_local().shape) == tuple(want), (arch, case, sh.spec)
    opt = adamw_init(params)
    err = info["make_err_state"](model.abstract_params())
    losses, norms = [], []
    for i in range(FIRST_STEP, FIRST_STEP + STEPS):
        params, opt, err, m = step(params, opt, err, i, inputs["batch"])
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms, "params": shd.gather_tree(params),
            "opt": shd.gather_tree(opt), "err": err, "mode": info["mode"], "pod": info["pod"]}


def _leaves(tree):
    from repro_torch import pytree
    return pytree.leaves(tree)


def _rank_trainer(rank, directory):
    """A sharded Trainer saves, a new one restores: the restored state's full
    leaves equal the saved ones."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import zoo
    from repro_torch.train import TrainConfig, Trainer
    model = zoo.build(configs.get("yi-6b", smoke=True))
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    stream = TokenStream(model.cfg.vocab, SEQ, BATCH, seed=3)
    mesh = lmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
    ck = os.path.join(directory, "ckpt")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    t1 = Trainer(model, shape, mesh, TrainConfig(total_steps=10), stream=stream,
                 ckpt_dir=ck, ckpt_every=100, init_params=params, device="cpu")
    assert t1.info["sharded"] and shd.is_dtensor(_leaves(t1.params)[0])
    t1.run(2)
    saved = t1._full_state()
    t2 = Trainer(model, shape, mesh, TrainConfig(total_steps=10), stream=stream,
                 ckpt_dir=ck, ckpt_every=100, init_params=params, device="cpu")
    assert t2.step == 2 and shd.is_dtensor(_leaves(t2.params)[0])
    torch.save({"saved": saved, "restored": t2._full_state()},
               os.path.join(directory, f"trainer_rank{rank}.pt"))


def _main(rank, world, directory):
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch import mesh as lmesh
    dist.init_process_group("gloo", init_method=f"file://{directory}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        inputs = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
        res = {}
        for arch in ARCHS:
            for case, (shape, names, _) in CASES.items():
                mesh = lmesh.make_mesh(shape, names, device="cpu")
                res[(arch, case)] = _run_case(arch, case, inputs, mesh)
        torch.save(res, os.path.join(directory, f"rank{rank}.pt"))
        _rank_trainer(rank, directory)
    finally:
        dist.destroy_process_group()


# the reference's step on the same meshes, in its own process
REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax._src.core as jcore
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import AxisType
jax.core.trace_state_clean = jcore.trace_state_clean
pltpu.TPUCompilerParams = pltpu.CompilerParams
_make = jax.make_mesh
jax.make_mesh = lambda shape, names, **kw: _make(shape, names,
                                                 axis_types=(AxisType.Auto,) * len(names))
import jax.numpy as jnp
from repro import configs
from repro.configs.base import ShapeConfig
from repro.dist.compat import make_mesh
from repro.dist.compressed_allreduce import GradCompressionConfig
from repro.models import zoo
from repro.optim import adamw_init
from repro.train.step import TrainConfig, build_train_step
directory, cases = sys.argv[1], json.loads(sys.argv[2])
batch = dict(np.load(directory + "/batch.npz"))
out = {}
for arch in cases["archs"]:
    model = zoo.build(configs.get(arch, smoke=True))
    for case, (shape, names, form) in cases["cases"].items():
        if form == "overlap":
            continue
        mesh = make_mesh(tuple(shape), tuple(names))
        tcfg = TrainConfig(total_steps=10, warmup_steps=1, peak_lr=cases["lr"]) \
            if form is None else TrainConfig(
            total_steps=10, warmup_steps=1, peak_lr=cases["lr"],
            grad_compress=GradCompressionConfig(
                enabled=True, min_leaf_size=cases["min_leaf"], overlap=form == "overlap",
                bucket_bytes=1 << 16))
        step, info = build_train_step(model, ShapeConfig("t", cases["seq"], cases["batch"],
                                                         "train"), mesh, tcfg)
        params = jax.device_put(model.init(jax.random.key(0)), info["params"])
        # the master of a float32 leaf (dbrx's router) is the leaf itself, which
        # the step would donate twice: give the step a copy
        opt = adamw_init(params)
        opt["master"] = jax.tree.map(jnp.copy, opt["master"])
        opt = jax.device_put(opt, info["opt"])
        err = info["make_err_state"](jax.tree.map(
            lambda p: jax.ShapeDtypeStruct(p.shape, p.dtype), params))
        losses, norms = [], []
        for i in range(cases["first"], cases["first"] + cases["steps"]):
            params, opt, err, m = step(params, opt, err, jnp.int32(i), batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        flat = {what + jax.tree_util.keystr(p): np.asarray(v.astype(jnp.float32))
                for what, tree in (("m", opt["m"]), ("v", opt["v"]), ("master", opt["master"]))
                for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
        np.savez(f"{directory}/ref_{arch}_{case}.npz", **flat)
        out[f"{arch}/{case}"] = {"losses": losses, "grad_norms": norms}
json.dump(out, open(directory + "/ref_losses.json", "w"))
"""


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC)] + [p for p in
                                                      env.get("PYTHONPATH", "").split(os.pathsep)
                                                      if p])
    env["OMP_NUM_THREADS"] = "1"
    env.pop("XLA_FLAGS", None)
    env.update(extra or {})
    return env


def _spawn(directory):
    cases = {"archs": ARCHS, "cases": {k: [list(v[0]), list(v[1]), v[2]]
                                       for k, v in CASES.items()},
             "min_leaf": MIN_LEAF, "seq": SEQ, "batch": BATCH, "steps": STEPS,
             "first": FIRST_STEP, "lr": PEAK_LR}
    cmds = [[sys.executable, str(HERE), str(r), str(WORLD), str(directory)]
            for r in range(WORLD)]
    envs = [_env()] * WORLD
    cmds.append([sys.executable, "-c", REFERENCE, str(directory), json.dumps(cases)])
    envs.append(_env({"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                      "JAX_PLATFORMS": "cpu"}))
    procs = [subprocess.Popen(c, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c, e in zip(cmds, envs)]
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
    for i, (p, (_, err)) in enumerate(zip(procs, outs)):
        what = f"rank {i}" if i < WORLD else "the reference"
        assert p.returncode == 0, f"{what} failed:\n{err[-4000:]}"


def _collect(directory: Path):
    """The reference's weights and a seeded batch written to ``directory``, the
    four ranks and the reference's process run once, the one-process forms run
    here -> (one-process results, each rank's results, the initial parameters)."""
    import jax
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    from repro_torch import interop
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        from repro import configs as rconfigs
        from repro.models import zoo as rzoo
        params = {}
        for arch in ARCHS:
            jm = rzoo.build(rconfigs.get(arch, smoke=True))
            params[arch] = interop.params_from_reference(
                jax.tree.map(np.asarray, jm.init(jax.random.key(0))), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32),
             "labels": rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32)}
    np.savez(directory / "batch.npz", **batch)
    inputs = {"params": params, "batch": {k: torch.from_numpy(v) for k, v in batch.items()}}
    torch.save(inputs, directory / "inputs.pt")
    _spawn(directory)
    torch.set_num_threads(1)
    try:
        one = {(arch, case): _run_case(arch, case, inputs)
               for arch in ARCHS for case in CASES}
    finally:
        torch.set_num_threads(os.cpu_count() or 1)
    ranks = [torch.load(directory / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return one, ranks, params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    directory = tmp_path_factory.mktemp("sharded_train")
    return (directory, *_collect(directory))


def _keyed(tree) -> dict:
    from repro_torch import pytree
    return {k: torch.as_tensor(v).to(torch.float32) for k, v in pytree.leaves_with_keys(tree)}


def _rel(got: dict, want: dict, base: dict | None = None) -> tuple[float, str]:
    """The largest ``|got - want| / |want - base|`` (2-norms) over the leaves,
    and its leaf: with ``base`` the initial masters, how far one run's update
    is from the other's, in units of that update."""
    assert set(got) == set(want)
    worst = (0.0, "")
    for k, b in want.items():
        a = got[k]
        assert a.shape == b.shape, k
        if not b.numel():
            continue
        ref = b - base[k] if base is not None else b
        worst = max(worst, (float((a - b).norm()) / max(float(ref.norm()), 1e-30), k))
    return worst


def _state(res) -> dict:
    return {part: _keyed(res["opt"][part]) for part in ("m", "v", "master")}


def _hold(got: dict, want: dict, init: dict, arch: str, what: str) -> None:
    """AdamW's moments and masters of one run held against another's."""
    tol = TOL[arch]
    for part in ("m", "v"):
        err, key = _rel(got[part], want[part])
        assert err <= tol["moment"], (what, part, key, err)
    err, key = _rel(got["master"], want["master"], init)
    assert err <= tol["update"], (what, "master", key, err)


def _err_sizes(err: dict) -> dict:
    """Each error-state leaf's largest and root-mean-square residual."""
    return {k: (float(e.abs().max()), float(e.square().mean().sqrt()))
            for k, e in err.items() if e.numel()}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_the_one_process_step(runs, arch, case):
    _, one, ranks, params = runs
    want = one[(arch, case)]
    init = _keyed(params[arch])
    for r, res in enumerate(ranks):
        got = res[(arch, case)]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                                   rtol=TOL[arch]["norm"])
        _hold(_state(got), _state(want), init, arch, f"rank {r} {arch} {case}")
        for p, m in zip(_leaves(got["params"]), _leaves(got["opt"]["master"])):
            assert torch.equal(p, m.to(p.dtype))     # the parameters are their masters
        assert got["mode"] == want["mode"]
        if CASES[case][2] is not None:
            # the residuals are each pod's whole leaves, bounded by the whole
            # leaf's range: as large as the inline form's row of that pod
            pod = got["pod"]
            inline = _err_sizes({k: v[pod:pod + 1] for k, v in _keyed(want["err"]).items()})
            sharded = _err_sizes(_keyed(got["err"]))
            assert set(sharded) == set(inline) and inline
            for k, (mx, rms) in inline.items():
                assert abs(sharded[k][0] / mx - 1) <= TOL[arch]["err"], (r, arch, case, k)
                assert abs(sharded[k][1] / rms - 1) <= TOL[arch]["err"], (r, arch, case, k)
    for res in ranks[1:]:              # every rank ends with the same full state
        for a, b in zip(_leaves((res[(arch, case)]["params"], res[(arch, case)]["opt"])),
                        _leaves((ranks[0][(arch, case)]["params"],
                                 ranks[0][(arch, case)]["opt"]))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_barrier_equals_overlap_on_every_rank(runs, arch):
    for res in runs[2]:
        b, o = res[(arch, "pod_barrier")], res[(arch, "pod_overlap")]
        assert b["losses"] == o["losses"] and b["grad_norms"] == o["grad_norms"]
        for x, y in zip(_leaves((b["params"], b["opt"], b["err"])),
                        _leaves((o["params"], o["opt"], o["err"]))):
            assert torch.equal(x, y)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_the_reference_on_the_same_mesh(runs, arch, case):
    directory, _, ranks, params = runs
    ref_case = "pod_barrier" if case == "pod_overlap" else case
    ref_runs = json.loads((directory / "ref_losses.json").read_text())[f"{arch}/{ref_case}"]
    got = ranks[0][(arch, case)]
    np.testing.assert_allclose(got["losses"], ref_runs["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norms"], ref_runs["grad_norms"],
                               rtol=TOL[arch]["norm"])
    ref = np.load(directory / f"ref_{arch}_{ref_case}.npz")
    want = {part: {k[len(part):]: torch.from_numpy(ref[k]) for k in ref.files
                   if k.startswith(part + "[")} for part in ("m", "v", "master")}
    _hold(_state(got), want, _keyed(params[arch]), arch, f"{arch} {case} against the reference")


def test_sharded_trainer_checkpoint_round_trip(runs):
    directory = runs[0]
    for r in range(WORLD):
        res = torch.load(directory / f"trainer_rank{r}.pt", weights_only=False)
        for a, b in zip(_leaves(res["saved"]), _leaves(res["restored"])):
            assert a.shape == b.shape and torch.equal(a, b)


if __name__ == "__main__":
    _main(*sys.argv[1:])
