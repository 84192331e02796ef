"""The comparison that decides ``correct``: the program's answers against the
plain reference (:mod:`fz_ref`), which works out everything again from the
generated fields.

Three numbers, each an exact count with the limit 0:

* ``container_mismatch``: over every compared container, 1 for a resolved
  bound ``eb_abs`` whose float32 differs, plus the flag words that differ, the
  gap in ``nnz_blocks``, the used payload rows (16-byte blocks) that differ,
  the gap in ``n_outliers``, the used outlier slots (index or value) that
  differ, and 1 for a stored size (``used_bytes()``, which the ``ratio``
  metric reads) other than the reference's. It covers quantization, Lorenzo,
  the outlier channel, the bitshuffle, the flags, the compaction and the size.
* ``recon_mismatch``: reconstructed elements whose float32 bits differ from the
  reference's reconstruction (decompress cells).
* ``bound_violations``: elements whose error against the original field
  exceeds the stated bound, ``|x - y| > eb (1 + 2^-20) + max|x| 2^-22`` (float32
  rounding of the dequantizing product), where the reference's own
  reconstruction keeps it. In compress cells the reference decodes the
  program's container; one equal to the reference's decodes to the
  reference's reconstruction and is not decoded again.
"""
from __future__ import annotations

import torch

from . import fz_ref

LIMITS = {"container_mismatch": 0, "recon_mismatch": 0, "bound_violations": 0}
_CHUNK = 1 << 26          # elements a block of the elementwise checks


def _count_ne(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements of two integer tensors that differ; a shape gap counts whole."""
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a != b).sum())


def container_mismatch(prog, ref: fz_ref.Container) -> int:
    """The program's container (``bitflags``, ``payload``, ``nnz_blocks``,
    ``outlier_idx``/``outlier_val``, ``n_outliers``, ``eb_abs``, ``shape``,
    ``used_bytes()``) against the reference's."""
    if tuple(prog.shape) != ref.shape:
        return ref.bitflags.numel() + ref.nnz + 2
    bad = int(float(prog.eb_abs) != float(ref.eb_abs))
    n = 1
    for s in ref.shape:
        n *= s
    bad += int(prog.used_bytes() != fz_ref.stored_bytes(n, ref.nnz, ref.n_outliers))
    bad += _count_ne(prog.bitflags.to(torch.int64), ref.bitflags.to(torch.int64))
    nnz = int(prog.nnz_blocks)
    bad += abs(nnz - ref.nnz)
    rows = min(nnz, ref.nnz, prog.payload.shape[0])
    got = prog.payload[:rows].to(torch.int32)
    want = ref.payload[:rows].to(torch.int32)
    bad += int((got != want).any(dim=-1).sum()) + (min(nnz, ref.nnz) - rows)
    n_out = int(prog.n_outliers)
    bad += abs(n_out - ref.n_outliers)
    k = min(n_out, ref.n_outliers, prog.outlier_idx.numel())
    bad += _count_ne(prog.outlier_idx[:k].to(torch.int32), ref.outlier_idx[:k])
    bad += _count_ne(prog.outlier_val[:k].to(torch.int32), ref.outlier_val[:k])
    return bad


def decode_program(prog, code_mode: str) -> torch.Tensor:
    """The reference's decoder run on the program's container, as it says."""
    nnz = min(int(prog.nnz_blocks), prog.payload.shape[0])
    n_out = min(int(prog.n_outliers), prog.outlier_idx.numel())
    return fz_ref.decompress(prog.bitflags, prog.payload[:nnz], prog.eb_abs.to(torch.float32),
                             tuple(prog.shape), code_mode=code_mode,
                             outlier_idx=prog.outlier_idx[:n_out],
                             outlier_val=prog.outlier_val[:n_out])


def recon_mismatch(y: torch.Tensor, y_ref: torch.Tensor) -> int:
    if y.shape != y_ref.shape or y.dtype != torch.float32:
        return y_ref.numel()
    a, b = y.reshape(-1).view(torch.int32), y_ref.reshape(-1).view(torch.int32)
    return sum(int((a[i:i + _CHUNK] != b[i:i + _CHUNK]).sum())
               for i in range(0, a.numel(), _CHUNK))


def bound_violations(x: torch.Tensor, y: torch.Tensor, y_ref: torch.Tensor,
                     eb_abs: float) -> int:
    if y.shape != x.shape:
        return x.numel()
    allow = eb_abs * (1.0 + 2.0**-20) + float(x.abs().max()) * 2.0**-22
    xs, ys, rs = x.reshape(-1), y.reshape(-1).to(torch.float32), y_ref.reshape(-1)
    bad = 0
    for i in range(0, xs.numel(), _CHUNK):
        xd = xs[i:i + _CHUNK].to(torch.float64)
        err = (xd - ys[i:i + _CHUNK].to(torch.float64)).abs()
        ref_err = (xd - rs[i:i + _CHUNK].to(torch.float64)).abs()
        bad += int(((err > allow) & (ref_err <= allow)).sum())
    return bad


def judge(direction: str, fields, answers, setup_containers, fz: dict,
          log=None) -> dict[str, int]:
    """Totals of the compared numbers over every field.

    ``answers[i]``: the window's answers for field ``i`` (containers for
    ``compress``, reconstructions for ``decompress``); ``setup_containers[i]``:
    the containers that the program's set-up made (decompress cells). With
    ``log``, prints the reference's used blocks and outliers by field.
    """
    counts = []
    totals = dict.fromkeys(("container_mismatch", "recon_mismatch", "bound_violations"), 0)
    if direction == "compress":
        del totals["recon_mismatch"]
    kw = {k: fz[k] for k in ("eb", "eb_mode", "code_mode", "exact_outliers", "outlier_frac")}
    for i, x in enumerate(fields):
        ref = fz_ref.compress(x, **kw)
        y_ref = fz_ref.decompress(ref.bitflags, ref.payload, ref.eb_abs, ref.shape,
                                  code_mode=fz["code_mode"], outlier_idx=ref.outlier_idx,
                                  outlier_val=ref.outlier_val)
        eb = float(ref.eb_abs)
        counts.append((ref.nnz, ref.n_outliers))
        if direction == "compress":
            for c in answers[i]:
                bad = container_mismatch(c, ref)
                totals["container_mismatch"] += bad
                if bad:
                    totals["bound_violations"] += bound_violations(
                        x, decode_program(c, fz["code_mode"]), y_ref, eb)
        else:
            totals["container_mismatch"] += container_mismatch(setup_containers[i], ref)
            for y in answers[i]:
                totals["recon_mismatch"] += recon_mismatch(y, y_ref)
                totals["bound_violations"] += bound_violations(x, y, y_ref, eb)
        del ref, y_ref
    if log is not None:
        print(f"reference by field: used blocks {[c[0] for c in counts]}, "
              f"outliers {[c[1] for c in counts]}", file=log)
    return totals
