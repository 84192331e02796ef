"""The port's checkpoints (``repro_torch.ckpt``) against the reference, on the CPU.

* The reference's five checkpoint cases that need no trainer
  (``tests/test_ckpt.py``) on the port: bitwise save/restore, the LATEST
  pointer and keep-last-k, corruption caught by the crc32, the FZ codec's
  error bound and ratio, and a stale tmp directory never shadowing a step.
* **Byte equality**: the port's ``save`` of the reference's ``_tree()``
  (float32, bfloat16, an int32 scalar) with ``codec="raw"`` and ``"fz"``, and
  of a tree whose float leaves are large enough for FZ, writes the same leaf
  files, manifest and LATEST pointer as the reference's ``ckpt.save``.
* Cross-restore both ways: each package restores the other's checkpoint to
  identical values; ``compression_report`` is equal.

On jax 0.9 the reference needs two aliases; the ``ref`` fixture sets them for
one test.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import ckpt
from repro_torch.ckpt import checkpoint
from repro_torch import pytree


@pytest.fixture
def ref(monkeypatch):
    """The reference's ckpt package with the jax 0.9 aliases, for one test."""
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
    from repro.ckpt import checkpoint as jckpt
    yield jckpt
    jax.clear_caches()


def _numpy_tree(seed=0):
    """The reference's ``_tree()`` (tests/test_ckpt.py) as numpy: float64 normals
    become float32 first, as ``jnp.asarray`` makes them."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((128, 64)).astype(np.float32),
            "b": rng.standard_normal((64,)).astype(np.float32),
            "emb_bf16": rng.standard_normal((1000, 128)).astype(np.float32),
            "count": np.int32(17)}


def _big_tree():
    """Float leaves past ``_MIN_FZ_SIZE``: FZ-coded under ``codec="fz"``."""
    rng = np.random.default_rng(3)
    return {"big": np.cumsum(rng.standard_normal((512, 256)).astype(np.float32), axis=0),
            "noise": rng.standard_normal((300, 400)).astype(np.float32),
            "small": np.ones((8,), np.float32),
            "emb_bf16": rng.standard_normal((300, 256)).astype(np.float32)}


def _port(tree):
    return {k: torch.from_numpy(np.asarray(v)).to(torch.bfloat16) if k.endswith("bf16")
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v).astype(jnp.bfloat16) if k.endswith("bf16") else jnp.asarray(v)
            for k, v in tree.items()}


def _tree(seed=0):
    return _port(_numpy_tree(seed))


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _files(step_dir):
    return {f: open(os.path.join(step_dir, f), "rb").read() for f in sorted(os.listdir(step_dir))}


# -- the reference's cases, on the port ------------------------------------------

def test_save_restore_bitwise(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 5, t, meta={"foo": 1}, device="cpu")
    restored, meta = ckpt.restore(str(tmp_path), t, device="cpu")
    assert meta["step"] == 5 and meta["foo"] == 1
    for a, b in zip(pytree.leaves(t), pytree.leaves(restored)):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


def test_latest_pointer_and_gc(tmp_path):
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, t, keep_last=2, device="cpu")
    assert ckpt.latest_step(str(tmp_path)) == 5
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005"]
    assert ckpt.latest_step(str(tmp_path / "nowhere")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "nowhere"), t, device="cpu")


def test_corruption_detected(tmp_path):
    t = _tree()
    d = ckpt.save(str(tmp_path), 1, t, device="cpu")
    victim = os.path.join(d, "leaf_000000.bin")
    raw = bytearray(open(victim, "rb").read())
    raw[10] ^= 0xFF
    open(victim, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        ckpt.restore(str(tmp_path), t, device="cpu")


def test_fz_codec_error_bounded(tmp_path):
    rng = np.random.default_rng(3)
    big = np.cumsum(rng.standard_normal((512, 256)).astype(np.float32), axis=0)
    t = {"big": torch.from_numpy(big), "small": torch.ones(8)}
    ckpt.save(str(tmp_path), 1, t, codec="fz", device="cpu")
    restored, _ = ckpt.restore(str(tmp_path), t, device="cpu")
    rng_ = big.max() - big.min()
    err = np.abs(restored["big"].numpy() - big).max()
    # 1.01x + ulp slack: f32 divide/rint/multiply rounding at q ~ 5e4
    assert err <= 1e-5 * rng_ * 1.01 + rng_ * 2e-7, err
    np.testing.assert_array_equal(restored["small"].numpy(), np.ones(8, np.float32))
    rep = checkpoint.compression_report(str(tmp_path), 1)
    assert rep["ratio"] > 1.5, rep


def test_atomicity_partial_write_ignored(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t, device="cpu")
    os.makedirs(os.path.join(str(tmp_path), ".tmp_step_00000002"))
    assert ckpt.latest_step(str(tmp_path)) == 1
    restored, meta = ckpt.restore(str(tmp_path), t, device="cpu")
    assert meta["step"] == 1


# -- byte equality and cross-restore against the reference ------------------------

TREES = {"tree": _numpy_tree, "big": _big_tree}


@pytest.mark.parametrize("codec", ["raw", "fz"])
@pytest.mark.parametrize("which", list(TREES))
def test_files_byte_identical_to_reference(ref, tmp_path, which, codec):
    t = TREES[which]()
    d_ref = ref.save(str(tmp_path / "ref"), 3, _jax(t), meta={"seed": 0}, codec=codec)
    d_port = ckpt.save(str(tmp_path / "port"), 3, _port(t), meta={"seed": 0}, codec=codec,
                       device="cpu")
    want, got = _files(d_ref), _files(d_port)
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    assert open(tmp_path / "port" / "LATEST").read() == open(tmp_path / "ref" / "LATEST").read()
    rep = checkpoint.compression_report(str(tmp_path / "port"), 3)
    assert rep == ref.compression_report(str(tmp_path / "ref"), 3)
    if which == "big" and codec == "fz":
        import json
        codecs = [l["codec"] for l in json.loads(got["manifest.json"])["leaves"]]
        assert codecs == ["fz", "raw", "fz", "raw"]     # big, emb_bf16 (raw), noise, small


@pytest.mark.parametrize("codec", ["raw", "fz"])
@pytest.mark.parametrize("which", list(TREES))
def test_cross_restore_both_ways(ref, tmp_path, which, codec):
    t = TREES[which]()
    ref.save(str(tmp_path / "ref"), 2, _jax(t), meta={"k": "v"}, codec=codec)
    ckpt.save(str(tmp_path / "port"), 2, _port(t), meta={"k": "v"}, codec=codec, device="cpu")
    port_of_ref, meta_a = ckpt.restore(str(tmp_path / "ref"), _port(t), device="cpu")
    ref_of_port, meta_b = ref.restore(str(tmp_path / "port"), _jax(t))
    port_own, _ = ckpt.restore(str(tmp_path / "port"), _port(t), device="cpu")
    ref_own, _ = ref.restore(str(tmp_path / "ref"), _jax(t))
    assert meta_a == meta_b == {"k": "v", "step": 2}
    for key in sorted(t):
        for got, want in ((port_of_ref[key], ref_own[key]), (ref_of_port[key], ref_own[key]),
                          (port_own[key], ref_own[key])):
            assert tuple(np.shape(got)) == tuple(np.shape(want)), key
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=key)
        assert port_of_ref[key].dtype == _port(t)[key].dtype
