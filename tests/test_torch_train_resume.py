"""The port's trainer checkpoints against the reference's, on the CPU, at the
Yi-6B smoke config (``ShapeConfig("tiny", 32, 4, "train")``).

* ``tests/test_ckpt.py::test_trainer_resume_bitwise`` on the port: 4 steps, a
  restart from the checkpoint, 2 more steps equal steps 5 and 6 of a 6-step
  run, losses bit for bit (raw codec). Also on a one-rank pod mesh
  (``launch.mesh.make_mesh((1, 1, 1), ("pod", "data", "model"))``), where the
  step compresses and the error-feedback state is part of the checkpoint.
* ``codec="fz"``: the state tree of a compressed trainer after 4 steps
  (parameters, AdamW state, error state) is saved with the reference's
  ``ckpt.save(..., codec="fz")`` and with the port's. Every file is byte for
  byte the reference's, and each package's restore gives the same tree bit
  for bit, so each restored leaf's error is the reference's error. A leaf
  whose restored error passes its bound (strict mode overflows its outlier
  channel on noise-like leaves, such as the error-feedback residuals) is past
  it in the reference too; every other FZ leaf holds ``eb`` = 1e-5 of its
  range (with the reference's own ``test_fz_codec_error_bounded`` slack of
  1% plus ``2e-7`` of the range).

The reference needs two jax 0.9 aliases, set for each test by the ``ref``
fixture's ``monkeypatch``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs, pytree
from repro_torch.ckpt import checkpoint
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import TokenStream
from repro_torch.dist.compressed_allreduce import GradCompressionConfig
from repro_torch.launch import mesh as lmesh
from repro_torch.models import zoo
from repro_torch.train import TrainConfig, Trainer

SHAPE = ShapeConfig("tiny", 32, 4, "train")
GC = GradCompressionConfig(enabled=True, min_leaf_size=1024)


@pytest.fixture
def ref(monkeypatch):
    """The reference's ckpt module with the jax 0.9 aliases, for one test."""
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
    from repro.ckpt import checkpoint as jckpt
    yield jckpt
    jax.clear_caches()


@pytest.fixture
def one_rank_group():
    owns = lmesh.start_local_group("cpu")
    yield
    if owns:
        dist.destroy_process_group()


def _trainer(mesh_kind, tcfg, **kw):
    cfg = configs.get("yi-6b", smoke=True)
    mesh = (lmesh.make_local_mesh(device="cpu") if mesh_kind == "local" else
            lmesh.make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu"))
    stream = TokenStream(vocab_size=cfg.vocab, seq_len=32, global_batch=4, seed=7)
    return Trainer(zoo.build(cfg), SHAPE, mesh, tcfg, stream=stream, device="cpu", **kw)


@pytest.mark.parametrize("mesh_kind,tcfg", [("local", TrainConfig()),
                                            ("pod", TrainConfig(grad_compress=GC))],
                         ids=["exact", "compressed-pod-mesh"])
def test_trainer_resume_bitwise(tmp_path, one_rank_group, mesh_kind, tcfg):
    """Restart from checkpoint reproduces the exact loss sequence."""
    t1 = _trainer(mesh_kind, tcfg, ckpt_dir=str(tmp_path), ckpt_every=100)
    assert t1.info["mode"] == ("exact" if mesh_kind == "local" else "barrier")
    t1.run(4)
    t2 = _trainer(mesh_kind, tcfg, ckpt_dir=str(tmp_path), ckpt_every=100)
    assert t2.step == 4
    h2 = t2.run(2)
    t3 = _trainer(mesh_kind, tcfg, ckpt_dir=None)
    h3 = t3.run(6)
    want = [m["loss"] for m in h3][4:]
    got = [m["loss"] for m in h2]
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A port leaf as the reference holds it (bfloat16 through its bit pattern)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def test_fz_state_files_and_restored_errors_equal_reference(ref, tmp_path, one_rank_group):
    t = _trainer("pod", TrainConfig(grad_compress=GC))
    t.run(4)
    state = t._state()
    jstate = pytree.tree_map(_numpy, state)
    meta = {"data_seed": 7}
    ref.save(str(tmp_path / "ref"), 4, jstate, meta=meta, codec="fz")
    checkpoint.save(str(tmp_path / "port"), 4, state, meta=meta, codec="fz", device="cpu")
    step = "step_00000004"
    names = sorted(os.listdir(tmp_path / "ref" / step))
    assert names == sorted(os.listdir(tmp_path / "port" / step))
    for name in names:
        assert (tmp_path / "port" / step / name).read_bytes() == \
               (tmp_path / "ref" / step / name).read_bytes(), name

    got, gmeta = checkpoint.restore(str(tmp_path / "port"), state, device="cpu")
    want, wmeta = ref.restore(str(tmp_path / "ref"), jstate)
    assert gmeta == wmeta
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    n_fz, past = 0, []
    for (k, g), (jpath, w), orig in zip(pytree.leaves_with_keys(got), want_leaves,
                                        pytree.leaves(state)):
        assert k == jax.tree_util.keystr(jpath)
        np.testing.assert_array_equal(_bits(_numpy(g)), _bits(w), err_msg=k)
        if orig.dtype != torch.float32 or orig.numel() < checkpoint._MIN_FZ_SIZE:
            np.testing.assert_array_equal(_bits(_numpy(g)), _bits(_numpy(orig)), err_msg=k)
            continue
        n_fz += 1
        x = orig.numpy()
        rng_ = float(x.max() - x.min())
        err = np.abs(np.asarray(w) - x).max()            # the reference's restored error
        assert np.abs(g.numpy() - x).max() == err, k
        if err > 1e-5 * rng_ * 1.01 + rng_ * 2e-7:
            past.append(k)
    assert n_fz >= 10
    # the port writes no bound of its own: a leaf past its bound is past it in
    # the reference's round trip of the same tree (the error-feedback residuals)
    assert all(k.startswith("['err']") for k in past), past
