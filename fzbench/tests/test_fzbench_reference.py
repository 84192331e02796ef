"""The frozen reference equals the port's plain route at small sizes, and it
imports nothing of the program, of the JAX package or of JAX."""
from __future__ import annotations

import ast

import pytest
import torch

from fzbench.reference import check, fz_ref
from repro_torch.core import fz

from .conftest import ROOT

SHAPES = [(4099,), (33, 130), (9, 17, 29)]
MODES = [  # (eb, eb_mode, code_mode, exact_outliers)
    (1e-3, "rel", "sign_mag", False),
    (1e-3, "rel", "sign_mag", True),
    (1e-4, "rel", "zigzag", True),
    (2e-6, "abs", "sign_mag", True),     # deltas past the code's range: outliers
    (2e-6, "abs", "sign_mag", False),    # ... saturated in paper mode
]


def _field(shape, dtype=torch.float32):
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g).cumsum(-1) * 0.05
    return x.to(dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("mode", MODES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_reference_equals_the_ports_plain_route(shape, mode, dtype):
    eb, eb_mode, code_mode, exact = mode
    x = _field(shape, dtype)
    cfg = fz.FZConfig(eb=eb, eb_mode=eb_mode, code_mode=code_mode, exact_outliers=exact,
                      use_kernels=False)
    prog = fz.compress(x, cfg, device="cpu")
    ref = fz_ref.compress(x, eb=eb, eb_mode=eb_mode, code_mode=code_mode,
                          exact_outliers=exact, outlier_frac=cfg.outlier_frac)
    assert check.container_mismatch(prog, ref) == 0
    assert ref.nnz == int(prog.nnz_blocks) and ref.n_outliers == int(prog.n_outliers)
    y_ref = fz_ref.decompress(ref.bitflags, ref.payload, ref.eb_abs, ref.shape,
                              code_mode=code_mode, outlier_idx=ref.outlier_idx,
                              outlier_val=ref.outlier_val)
    y = fz.decompress(prog, cfg, device="cpu")
    assert check.recon_mismatch(y, y_ref) == 0
    assert check.recon_mismatch(check.decode_program(prog, code_mode), y_ref) == 0
    if eb_mode == "abs" and not exact:
        return                    # saturated deltas: the bound is not the mode's guarantee
    assert check.bound_violations(x.to(torch.float32), y, y_ref, float(ref.eb_abs)) == 0


def test_the_outlier_cases_have_outliers():
    x = _field((9, 17, 29))
    ref = fz_ref.compress(x, eb=2e-6, eb_mode="abs", exact_outliers=True)
    assert ref.n_outliers > 0


def test_the_reference_imports_torch_alone():
    for path in sorted((ROOT / "fzbench" / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    continue
                names = [node.module]
            else:
                continue
            assert {n.partition(".")[0] for n in names} <= {"torch", "dataclasses",
                                                           "__future__"}, (path, names)


def test_stored_bytes_counts_the_used_parts():
    # 4097 elements: 2 tiles, 1024 blocks -> 128 flag bytes
    assert fz_ref.stored_bytes(4097, 10, 3) == 32 + 128 + 160 + 24
    x = _field((9, 17, 29))
    for exact in (False, True):
        cfg = fz.FZConfig(eb=2e-6, eb_mode="abs", exact_outliers=exact, use_kernels=False)
        prog = fz.compress(x, cfg, device="cpu")
        assert prog.used_bytes() == fz_ref.stored_bytes(x.numel(), int(prog.nnz_blocks),
                                                        int(prog.n_outliers))
