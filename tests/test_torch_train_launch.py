"""The port's meshes and training launcher against the reference, on the CPU.

* ``launch.mesh``: the local mesh of one rank is ``(data, model)``, as the
  reference's ``make_local_mesh()`` is; the elastic ``make_mesh((1, 1, 1),
  ("pod", "data", "model"))`` has a pod axis; the production meshes need 256
  and 512 ranks; the step refuses in-pod data and model axes.
* ``make_local_mesh(pods=1)`` has no pod axis, so a compressed ``TrainConfig``
  on it runs the exact reduce, in the port as in the reference; the launcher
  prints ``reduce=barrier`` for ``--compressed-grads`` all the same, as the
  reference's launcher does.
* ``python -m repro_torch.launch.train`` (its ``main``) prints the reference
  launcher's lines at the Yi-6B smoke config and resumes from its checkpoint
  directory, with ``--ckpt-codec fz`` too.

The reference runs in this process with the two jax 0.9 aliases (a
module-scoped ``MonkeyPatch.context()``).
"""
import dataclasses
import re
import sys

import pytest
import torch.distributed as dist

import jax

from repro_torch import configs, obs
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import compressed_allreduce as car
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import train as launch_train
from repro_torch.models import zoo
from repro_torch.train import TrainConfig, build_train_step
from repro_torch.train import step as step_mod

SHAPE = ShapeConfig("tiny", 32, 4, "train")


@pytest.fixture(scope="module")
def jref():
    """The reference's modules with the jax 0.9 aliases, for this module's tests."""
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
        mp.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
        from repro import configs as jconfigs
        from repro import train as jtrain
        from repro.configs import base as jbase
        from repro.dist import compressed_allreduce as jcar
        from repro.launch import mesh as jmesh
        from repro.models import zoo as jzoo
        yield type("Ref", (), dict(configs=jconfigs, base=jbase, car=jcar, mesh=jmesh,
                                   zoo=jzoo, train=jtrain))
        jax.clear_caches()


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


def test_meshes(one_rank_group):
    mesh = lmesh.make_local_mesh(device="cpu")
    assert lmesh.mesh_shape(mesh) == {"data": 1, "model": 1}
    assert lmesh.mesh_shape(lmesh.make_mesh((1, 1, 1), ("pod", "data", "model"),
                                            device="cpu")) == {"pod": 1, "data": 1, "model": 1}
    for bad in (lambda: lmesh.make_local_mesh(model_parallel=2, device="cpu"),
                lambda: lmesh.make_local_mesh(pods=2, device="cpu")):
        with pytest.raises(ValueError):
            bad()
    for multi_pod in (False, True):          # 256 and 512 ranks: not one
        with pytest.raises(RuntimeError):
            lmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
    m = zoo.build(configs.get("yi-6b", smoke=True))
    # in-pod axes above 1 run on DTensors, which need a DeviceMesh, not a stand-in
    # (tests/test_torch_sharded_train.py runs them on gloo ranks)
    for shape in ({"data": 2, "model": 1}, {"pod": 2, "data": 1, "model": 2}):
        stand_in = type("Mesh", (), {"axis_names": tuple(shape), "shape": shape})()
        with pytest.raises(ValueError, match="need a DeviceMesh"):
            build_train_step(m, SHAPE, stand_in, TrainConfig(), device="cpu")


def test_local_mesh_of_one_pod_has_no_pod_axis_as_in_the_reference(jref, one_rank_group):
    """``make_local_mesh(pods=1)`` builds ``(data, model)``, as the reference's
    does, so a compressed ``TrainConfig`` on it runs the exact reduce: the step
    reads no error state and the reduce is never called. The reference's
    ``build_train_step`` makes the same choice on its local mesh."""
    gc = car.GradCompressionConfig(enabled=True, min_leaf_size=1024)
    mesh, jmesh = lmesh.make_local_mesh(pods=1, device="cpu"), jref.mesh.make_local_mesh(pods=1)
    assert "pod" not in lmesh.mesh_shape(mesh) and "pod" not in jmesh.axis_names
    m = zoo.build(configs.get("yi-6b", smoke=True))
    for overlap in (False, True):
        tcfg = TrainConfig(grad_compress=dataclasses.replace(gc, overlap=overlap))
        _, info = build_train_step(m, SHAPE, mesh, tcfg, device="cpu")
        assert info["mode"] == "exact" and info["make_err_state"](m.abstract_params()) == {}
        jm = jref.zoo.build(jref.configs.get("yi-6b", smoke=True))
        _, jinfo = jref.train.build_train_step(
            jm, jref.base.ShapeConfig("tiny", 32, 4, "train"), jmesh,
            jref.train.TrainConfig(grad_compress=jref.car.GradCompressionConfig(
                enabled=True, min_leaf_size=1024, overlap=overlap)))
        assert jinfo["make_err_state"](jm.abstract_params()) == {}


def _ref_launcher(jref, argv, capsys):
    from repro.launch import train as jlaunch
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["train"] + argv)
        jlaunch.main()
    return capsys.readouterr().out.splitlines()


STEP_LINE = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) \((\d+\.\d\d)s\)$")


def test_launcher_on_the_cpu_resumes_and_prints_the_reference_lines(jref, tmp_path, capsys,
                                                                    clean_obs):
    args = ["--arch", "yi-6b", "--smoke", "--seq", "32", "--batch", "4"]
    want = _ref_launcher(jref, args + ["--steps", "4", "--ckpt-dir", str(tmp_path / "ref")],
                         capsys)
    launch_train.main(args + ["--steps", "4", "--ckpt-dir", str(tmp_path / "port"),
                              "--device", "cpu"])
    first = capsys.readouterr().out.splitlines()
    assert not dist.is_initialized()
    assert first[0] == want[0] == ("yi-6b-smoke: 0.4M params, mesh={'data': 1, 'model': 1}, "
                                   "reduce=exact, resume_step=0")
    got_steps = [STEP_LINE.match(line) for line in first[1:]]
    want_steps = [STEP_LINE.match(line) for line in want[1:]]
    assert all(got_steps) and all(want_steps)    # the weights are each package's own random
    assert [g[1] for g in got_steps] == [w[1] for w in want_steps] == ["0", "1", "2", "3"]
    hist = launch_train.main(args + ["--steps", "6", "--ckpt-dir", str(tmp_path / "port"),
                                     "--device", "cpu", "--overlap-reduce",
                                     "--metrics-out", str(tmp_path / "m.json")])
    second = capsys.readouterr().out.splitlines()
    assert second[0] == ("yi-6b-smoke: 0.4M params, mesh={'data': 1, 'model': 1}, "
                         "reduce=bucketed-overlap, resume_step=4")
    assert [m["step"] for m in hist] == [4, 5]
    assert [STEP_LINE.match(line)[1] for line in second[1:3]] == ["4", "5"]
    assert "metrics snapshot" in second[-1]


def test_launcher_compressed_grads_on_one_rank_runs_the_exact_reduce(jref, tmp_path, capsys,
                                                                    monkeypatch, clean_obs):
    """``--compressed-grads`` on one rank: ``make_local_mesh(pods=1)`` has no pod
    axis, so the step runs the exact reduce (the compressed reduces are never
    called), while the printed line says ``reduce=barrier``, as the
    reference's launcher prints it. ``--ckpt-codec fz`` saves and resumes."""
    args = ["--arch", "yi-6b", "--smoke", "--seq", "32", "--batch", "4", "--compressed-grads"]
    want = _ref_launcher(jref, args + ["--steps", "2"], capsys)

    def never(*a, **kw):
        raise AssertionError("a compressed reduce ran on a mesh without a pod axis")
    monkeypatch.setattr(car, "reduce_stacked", never)
    monkeypatch.setattr(step_mod.bkt, "BucketReducer", never)
    root = str(tmp_path / "fz")
    for steps in (2, 3):
        launch_train.main(args + ["--steps", str(steps), "--ckpt-dir", root,
                                  "--ckpt-codec", "fz", "--device", "cpu"])
    first, second = capsys.readouterr().out.split("yi-6b-smoke")[1:]
    head = ": 0.4M params, mesh={'data': 1, 'model': 1}, reduce=barrier, resume_step="
    assert want[0] == "yi-6b-smoke" + head + "0"
    assert first.splitlines()[0] == head + "0" and second.splitlines()[0] == head + "2"
    assert [STEP_LINE.match(line)[1] for line in second.splitlines()[1:]] == ["2"]
    assert car.gathered_bytes() == {}
