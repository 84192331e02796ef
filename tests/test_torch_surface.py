"""The port's package surface against the reference's: every name a reference
package ``__init__`` exports exists at the port's package level, and the
re-exported stage functions equal the reference's bit for bit.

The reference's names are read from its ``__init__`` files by AST, so JAX is
not imported for the surface check.
"""
import ast
import importlib
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core as tcore
import repro_torch.tune as ttune

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"

# Out of scope, each with its reason:
OUT_OF_SCOPE = {
    # the dry-run tooling (ROADMAP queue 1, item 8): the (arch, shape, mesh) cells
    # and the prefill / decode steps only the dry-run calls
    ("repro.configs", "cells_for"),
    ("repro.train", "build_prefill_step"),
    ("repro.train", "build_decode_step"),
    # Pallas-only: the BlockSpec and scratch declarations of a TPU launch; a
    # CUDA launch's KernelSpec states grid, threads and shared bytes instead
    ("repro.analysis", "BlockDecl"),
    ("repro.analysis", "ScratchDecl"),
}
# shared, not ported: the test harness's hypothesis shim and the docs runner
SHARED = {"repro.testing"}


def _packages():
    return sorted(".".join(p.parent.relative_to(REF.parent).parts)
                  for p in REF.rglob("__init__.py"))


def exported(init: Path) -> set[str]:
    """Public names a package ``__init__`` binds: its relative imports, defs,
    classes and assignments."""
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level >= 1:
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("package", [p for p in _packages() if p not in SHARED])
def test_every_reference_name_exists_in_the_port(package):
    init = REF.parent.joinpath(*package.split("."), "__init__.py")
    port = importlib.import_module(package.replace("repro", "repro_torch", 1))
    names = exported(init)
    assert names, package
    missing = sorted(n for n in names if (package, n) not in OUT_OF_SCOPE
                     and not hasattr(port, n))
    assert not missing, f"{port.__name__} lacks {missing}"


def test_out_of_scope_names_are_the_references():
    """Each listed exception is a name the reference exports (no stale entry)."""
    for package, name in OUT_OF_SCOPE:
        assert name in exported(REF.parent.joinpath(*package.split("."), "__init__.py"))


def test_the_testing_package_is_shared_not_ported():
    assert (REF / "testing" / "minihypothesis.py").exists()
    assert importlib.util.find_spec("repro_torch.testing") is None


def test_kernels_package_exports_the_reference_submodules():
    import repro_torch.kernels as k
    for sub in ("flash_decode", "fused_decode", "ops", "ref"):
        assert getattr(k, sub).__name__ == f"repro_torch.kernels.{sub}"
    # the wrappers keep their names where the reference's are submodules
    for fn in ("bitshuffle_flag", "fused_compress", "lorenzo_quant"):
        assert callable(getattr(k, fn)) and hasattr(getattr(k, fn), "launches")


def test_models_package_builds():
    from repro_torch import configs, models
    m = models.build(configs.get("yi-6b", smoke=True))
    assert isinstance(m, models.Model) and m.param_count() > 0
    for sub in ("attention", "mamba2", "moe", "nn", "rwkv6", "transformer", "whisper",
                "zamba2", "zoo"):
        assert getattr(models, sub).__name__ == f"repro_torch.models.{sub}"


def test_configs_data_launch_surface():
    from repro_torch import configs, data, launch
    assert configs.SHAPES["train_4k"] == configs.ShapeConfig("train_4k", 4096, 256, "train")
    assert data.FIELD_KINDS == ("smooth", "turbulent", "particle", "wavefront")
    assert data.make_field("smooth", (4, 5), seed=0).shape == (4, 5)
    assert data.TokenStream(64, 8, 2, seed=0).seq_len == 8
    assert {launch.make_mesh, launch.make_local_mesh, launch.make_production_mesh}


@pytest.mark.parametrize("b", [None, "cuda", "cpu"])
def test_fz_fallback_mode_is_fused_first(b):
    """The port's static order is fused, staged, reference on both backends
    (the reference's is staged-first off the TPU), so the first kernel choice
    is fused."""
    assert ttune.fz_fallback_mode(b) == "fused"
    assert ttune.fz_fallback_mode(b) in ttune.dispatch.FZ_FALLBACK


def test_fz_fallback_mode_refuses_an_unknown_backend():
    with pytest.raises(ValueError):
        ttune.fz_fallback_mode("tpu")


def test_tune_lazy_names_resolve():
    assert ttune.attn_cache_elems(832, 4, 128) == ttune.impls.attn_cache_elems(832, 4, 128)
    assert callable(ttune.fz_impl_config)


# ---------------------------------------------------------------------------
# the re-exported stages, bit for bit
# ---------------------------------------------------------------------------

def _field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3.0


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("shape", [(5000,), (37, 130), (9, 33, 70)])
@pytest.mark.parametrize("code_mode", ["sign_mag", "zigzag"])
def test_reexported_dual_quantize_is_the_references(shape, code_mode):
    from repro import core as jcore
    x = _field(shape, 3)
    eb = np.float32(1e-3)
    cap = max(1, x.size // 256)
    got = tcore.dual_quantize(torch.from_numpy(x), torch.tensor(eb), code_mode=code_mode,
                              outlier_capacity=cap)
    want = jcore.dual_quantize(jnp.asarray(x), jnp.float32(eb), code_mode=code_mode,
                               outlier_capacity=cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g).astype(np.int64), np.asarray(w).astype(np.int64))
    rec = tcore.dual_dequantize(got[0], torch.tensor(eb), shape, code_mode=code_mode,
                                outlier_idx=got[1], outlier_val=got[2])
    jrec = jcore.dual_dequantize(want[0], jnp.float32(eb), shape, code_mode=code_mode,
                                 outlier_idx=want[1], outlier_val=want[2])
    np.testing.assert_array_equal(_np(rec).view(np.uint32), np.asarray(jrec).view(np.uint32))


@pytest.mark.parametrize("tiles", [1, 3])
def test_reexported_bitshuffle_is_the_references(tiles):
    from repro import core as jcore
    assert tcore.TILE == jcore.TILE and tcore.BLOCK_WORDS == jcore.BLOCK_WORDS
    assert tcore.BLOCK_BYTES == jcore.BLOCK_BYTES
    codes = np.random.default_rng(tiles).integers(0, 1 << 16, tiles * tcore.TILE)
    got = tcore.bitshuffle(torch.from_numpy(codes.astype(np.int32)))
    want = jcore.bitshuffle(jnp.asarray(codes.astype(np.uint16)))
    np.testing.assert_array_equal(_np(got).astype(np.int64), np.asarray(want).astype(np.int64))
    back = tcore.bitunshuffle(got)
    np.testing.assert_array_equal(_np(back).astype(np.int64), codes)
    jback = jcore.bitunshuffle(want)
    np.testing.assert_array_equal(np.asarray(jback).astype(np.int64), codes)


def test_reexported_lorenzo_and_transpose_are_the_references():
    from repro import core as jcore
    q = np.random.default_rng(7).integers(-1000, 1000, (9, 33, 70)).astype(np.int32)
    d = tcore.lorenzo_delta(torch.from_numpy(q))
    np.testing.assert_array_equal(_np(d), np.asarray(jcore.lorenzo_delta(jnp.asarray(q))))
    np.testing.assert_array_equal(_np(tcore.lorenzo_inverse(d)), q)
    g = np.random.default_rng(8).integers(0, 1 << 16, (64, 16))
    np.testing.assert_array_equal(
        _np(tcore.transpose16(torch.from_numpy(g.astype(np.int32)))).astype(np.int64),
        np.asarray(jcore.transpose16(jnp.asarray(g.astype(np.uint16)))).astype(np.int64))
