"""The port stands alone and runs on the card unless asked for the CPU.

* No module of ``repro_torch`` and not ``chip_smoke.py`` imports ``jax`` or the
  reference package ``repro`` (an AST walk, and an import in a subprocess
  where both are blocked).
* The entry points raise without a card unless given ``device="cpu"``: the
  compressor's, K7's, the model init, the pool, the engine, the wire and
  checkpoints, the meshes, the train step, the trainer and both launchers.
* ``kernel_mode="staged"`` runs on the CPU on request, through the plain
  versions of K1-K3.
* A kernel wrapper takes its plain version only for a CPU tensor and never
  falls back for any other device; nothing is built on import.
* ``chip_smoke.py`` fails, and prints no result, without a card or outside
  the repository.
"""
import ast
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch import ckpt, configs, interop, kernels
from repro_torch.dist import compat
from repro_torch.dist import compressed_allreduce as car
from repro_torch.dist import flash_decode as fdp
from repro_torch.core import shuffle
from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_decode as fd
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.train import TrainConfig, Trainer, build_train_step
from repro_torch.models import nn as tnn
from repro_torch.models import zoo
from repro_torch.serve import Engine, KVCompressionConfig, PagePool, PoolConfig

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _env_without_pythonpath():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_port_imports_with_jax_and_reference_blocked():
    modules = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
               .removesuffix(".__init__") for p in FILES[:-1]]
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
            + f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
            + f"sys.path.insert(0, {str(ROOT)!r})\n"
            + "".join(f"import {m}\n" for m in modules)
            + "import chip_smoke\n"
            + "from repro_torch.kernels import build\n"
            + "assert not build._loaded, 'a kernel library was loaded on import'\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=_env_without_pythonpath())
    assert out.returncode == 0, out.stderr


def _container():
    x = np.linspace(-1, 1, 5000, dtype=np.float32)
    return x, rt.compress(x, rt.FZConfig(), device="cpu")


def _attn_inputs():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 8, generator=g)
    k = torch.randn(2, 16, 2, 8, generator=g)
    return q, k, k.clone(), torch.tensor([3, 16], dtype=torch.int32)


SMOKE = configs.get("yi-6b", smoke=True)
RECURRENT_AUDIO = ("rwkv6-3b", "zamba2-2.7b", "whisper-tiny")
SHAPE = ShapeConfig("tiny", 8, 2, "train")
_STAND_IN = type("Mesh", (), {"axis_names": ("data", "model"),
                              "shape": {"data": 1, "model": 1}})()
NEVER_WRITTEN = os.path.join(tempfile.gettempdir(), "repro_torch_hygiene_never_written")


ENTRY_POINTS = {
    "compress": lambda x, c: rt.compress(x, rt.FZConfig()),
    "compress_with_eb": lambda x, c: rt.compress_with_eb(x, 1e-3, rt.FZConfig()),
    "decompress": lambda x, c: rt.decompress(c, rt.FZConfig()),
    "roundtrip": lambda x, c: rt.roundtrip(x, rt.FZConfig()),
    "from_reference": lambda x, c: interop.from_reference(interop.to_numpy(c), c.shape,
                                                          c.dtype_name),
    "resolve_device": lambda x, c: rt.resolve_device(),
    "compress_batch_with_eb": lambda x, c: rt.compress_batch_with_eb(
        np.stack([x, x]), 1e-3, rt.FZConfig()),
    "decompress_batch": lambda x, c: rt.decompress_batch(
        rt.compress_batch_with_eb(np.stack([x, x]), 1e-3, rt.FZConfig(), device="cpu"),
        rt.FZConfig()),
    "tree_compress": lambda x, c: rt.tree_compress({"x": torch.from_numpy(x)}, rt.FZConfig()),
    "tree_decompress": lambda x, c: rt.tree_decompress({"c": c}, rt.FZConfig()),
    "from_bytes": lambda x, c: rt.from_bytes(rt.to_bytes(c, rt.FZConfig())),
    "decompress_bytes": lambda x, c: rt.decompress_bytes(rt.to_bytes(c, rt.FZConfig())),
    "decode_partials": lambda x, c: fd.decode_partials(*_attn_inputs()),
    "decode_partials_pages": lambda x, c: fd.decode_partials_pages(
        *(t.reshape(2, 2, 8, 2, 8) if t.ndim == 4 else t for t in _attn_inputs())),
    "flash_decode": lambda x, c: fd.flash_decode(*_attn_inputs()),
    "params_from_reference": lambda x, c: interop.params_from_reference({"w": x}),
    "init_tree": lambda x, c: tnn.init_tree({"w": tnn.Param((4, 4))}),
    "model.init": lambda x, c: zoo.build(SMOKE).init(),
    "PagePool": lambda x, c: PagePool(PoolConfig(), n_layers=2, n_kv_heads=2, head_dim=8),
    "Engine": lambda x, c: Engine(zoo.build(SMOKE), {}, pool=PoolConfig()),
    "launch.serve": lambda x, c: launch_serve.main(["--arch", "yi-6b", "--smoke", "--paged"]),
    **{f"model.init[{arch}]": (lambda x, c, arch=arch: zoo.build(
        configs.get(arch, smoke=True)).init()) for arch in RECURRENT_AUDIO},
    **{f"Engine[{arch}]": (lambda x, c, arch=arch: Engine(
        zoo.build(configs.get(arch, smoke=True)), {},
        kv_compress=KVCompressionConfig(enabled=True))) for arch in RECURRENT_AUDIO},
    **{f"launch.serve[{arch}]": (lambda x, c, arch=arch: launch_serve.main(
        ["--arch", arch, "--smoke", "--kv-compress"])) for arch in RECURRENT_AUDIO},
    "make_mesh": lambda x, c: compat.make_mesh((1,), ("pod",)),
    "init_error_state": lambda x, c: car.init_error_state(
        {"w": torch.from_numpy(x)}, 2, car.GradCompressionConfig(enabled=True)),
    "shard_partials": lambda x, c: fdp.shard_partials(*_attn_inputs(), shard_offset=0),
    "flash_decode_shard": lambda x, c: fdp.flash_decode_shard(
        *_attn_inputs(), mesh=None, axis="model", shard_offset=0),
    "ckpt.save": lambda x, c: ckpt.save(NEVER_WRITTEN, 1, {"x": torch.from_numpy(x)}),
    "ckpt.restore": lambda x, c: ckpt.restore(NEVER_WRITTEN, {"x": torch.from_numpy(x)}),
    "launch.mesh.make_mesh": lambda x, c: launch_mesh.make_mesh((1, 1, 1),
                                                                ("pod", "data", "model")),
    "make_local_mesh": lambda x, c: launch_mesh.make_local_mesh(),
    "make_production_mesh": lambda x, c: launch_mesh.make_production_mesh(),
    "start_local_group": lambda x, c: launch_mesh.start_local_group(),
    "build_train_step": lambda x, c: build_train_step(
        zoo.build(SMOKE), SHAPE, _STAND_IN, TrainConfig()),
    "Trainer": lambda x, c: Trainer(zoo.build(SMOKE), SHAPE, _STAND_IN, TrainConfig(),
                                    stream=TokenStream(512, 8, 2)),
    "launch.train": lambda x, c: launch_train.main(["--arch", "yi-6b", "--smoke",
                                                    "--steps", "1"]),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_need_a_card_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    x, c = _container()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](x, c)


def test_cpu_on_request():
    assert rt.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        rt.resolve_device("meta")
    x, c = _container()
    rec = rt.decompress(c, rt.FZConfig(), device="cpu")
    assert rec.shape == x.shape and rec.device.type == "cpu"


def test_defaults_take_the_kernel_route():
    cfg = rt.FZConfig()
    assert cfg.use_kernels is True and cfg.kernel_mode == "auto"
    assert rt.ARCH == "sm_90a"


@pytest.mark.parametrize("exact_outliers", [True, False])
@pytest.mark.parametrize("op", ["compress", "decompress"])
def test_staged_route_runs_on_the_cpu_on_request(monkeypatch, op, exact_outliers):
    """``kernel_mode="staged"`` goes through the staged wrappers (their plain
    versions on the CPU: K1 in paper mode, K2 to compress, K3 to decompress)
    and through none of the fused ones, and equals the plain route."""
    x, _ = _container()
    calls = []
    for name in ("lorenzo_quant_ref", "bitshuffle_flag_ref", "bitunshuffle_ref",
                 "fused_compress_ref", "fused_shuffle_encode_ref", "fused_decompress_ref"):
        def spy(*args, _name=name, _fn=getattr(ref, name), **kw):
            calls.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(ref, name, spy)
    cfg = rt.FZConfig(kernel_mode="staged", exact_outliers=exact_outliers)
    plain = rt.FZConfig(use_kernels=False, exact_outliers=exact_outliers)
    c = rt.compress(x, cfg, device="cpu")
    c0 = rt.compress(x, plain, device="cpu")
    if op == "compress":
        want = ["bitshuffle_flag_ref"] if exact_outliers else ["lorenzo_quant_ref",
                                                               "bitshuffle_flag_ref"]
        assert calls == want
        for f in c.FIELDS:
            assert torch.equal(getattr(c, f), getattr(c0, f)), f
    else:
        calls.clear()
        y = rt.decompress(c, cfg, device="cpu")
        assert calls == ["bitunshuffle_ref"]
        assert torch.equal(y, rt.decompress(c0, plain, device="cpu"))


def test_unknown_kernel_mode_is_rejected():
    with pytest.raises(ValueError):
        rt.FZConfig(kernel_mode="megakernel")


def test_wrappers_run_plain_versions_on_cpu_and_count_nothing():
    kernels.reset_launch_counts()
    x = torch.linspace(0, 1, 9000).reshape(90, 100)
    eb = torch.tensor(1e-3)
    bf, pl, nnz = kernels.fused_compress(x, eb, capacity=1000)
    kernels.fused_compress_strict(x, eb, capacity=1000, outlier_capacity=35)
    kernels.fused_shuffle_encode(torch.zeros(4096, dtype=torch.uint16), capacity=10)
    kernels.fused_decompress(bf, pl, eb, shape=(90, 100))
    codes = kernels.lorenzo_quant(x, eb)
    shuffled, _ = kernels.bitshuffle_flag(
        shuffle.pad_to_tiles(codes.reshape(-1)).reshape(-1, 4096))
    kernels.bitunshuffle_tiles(shuffled)
    q, k, v, length = _attn_inputs()
    fd.decode_partials(q, k, v, length, device="cpu")
    kernels.flash_decode_partials(fd.prep_q(q, 2), k, v, length, tile=4)
    assert kernels.launch_counts() == {name: 0 for name in kernels.WRAPPERS}
    assert not build._loaded


@pytest.mark.parametrize("wrapper", ["fused_compress", "fused_compress_strict",
                                     "fused_shuffle_encode",
                                     "fused_decompress", "lorenzo_quant", "bitshuffle_flag",
                                     "bitunshuffle_tiles", "flash_decode_pages",
                                     "flash_decode_contiguous"])
def test_wrappers_never_fall_back_on_other_devices(wrapper):
    meta = torch.device("meta")
    eb = torch.tensor(1e-3, device=meta)
    calls = {
        "fused_compress": lambda: kernels.fused_compress(
            torch.empty(100, device=meta), eb, capacity=4),
        "fused_compress_strict": lambda: kernels.fused_compress_strict(
            torch.empty(100, device=meta), eb, capacity=4, outlier_capacity=1),
        "fused_shuffle_encode": lambda: kernels.fused_shuffle_encode(
            torch.empty(4096, dtype=torch.uint16, device=meta), capacity=4),
        "fused_decompress": lambda: kernels.fused_decompress(
            torch.empty(16, dtype=torch.uint32, device=meta),
            torch.empty(4, 8, dtype=torch.uint16, device=meta), eb, shape=(100,)),
        "lorenzo_quant": lambda: kernels.lorenzo_quant(torch.empty(100, device=meta), eb),
        "bitshuffle_flag": lambda: kernels.bitshuffle_flag(
            torch.empty(2, 4096, dtype=torch.uint16, device=meta)),
        "bitunshuffle_tiles": lambda: kernels.bitunshuffle_tiles(
            torch.empty(2, 4096, dtype=torch.uint16, device=meta)),
        "flash_decode_pages": lambda: kernels.flash_decode_partials(
            torch.empty(2, 2, 4, 8, device=meta), torch.empty(2, 3, 4, 2, 8, device=meta),
            torch.empty(2, 3, 4, 2, 8, device=meta), torch.empty(2, dtype=torch.int32,
                                                                 device=meta)),
        "flash_decode_contiguous": lambda: kernels.flash_decode_partials(
            torch.empty(2, 2, 4, 8, device=meta), torch.empty(2, 12, 2, 8, device=meta),
            torch.empty(2, 12, 2, 8, device=meta), torch.empty(2, dtype=torch.int32,
                                                               device=meta), tile=4),
    }
    with pytest.raises(ValueError, match="unsupported device"):
        calls[wrapper]()


def test_build_targets_sm90a_without_fast_math(monkeypatch, tmp_path):
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert build.library_path("fz_compress.cu").parent == rt.BUILD_DIR
    assert len({build.library_path(s) for s in build.SOURCES}) == len(build.SOURCES) == 4
    assert set(build.SIGNATURES) == set(build.SOURCES)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def _run_smoke(cwd: Path, fake_card: bool):
    prelude = "import torch; torch.cuda.is_available = lambda: True; " if fake_card else ""
    code = prelude + "import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')"
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=120, env=_env_without_pythonpath())


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run_smoke(ROOT, fake_card=False)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    """Alone in a directory, even where a card is reported, the script cannot
    find the port and exits non-zero before printing any result."""
    (tmp_path / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    out = _run_smoke(tmp_path, fake_card=True)
    assert out.returncode != 0
    assert "repro_torch" in out.stderr
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
