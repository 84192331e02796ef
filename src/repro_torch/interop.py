"""State across the two packages, as numpy arrays.

* Containers: a container made by the reference (its fields as numpy arrays)
  becomes a port :class:`~repro_torch.core.fz.FZCompressed` with
  :func:`from_reference`, and :func:`to_numpy` gives the reverse, field for
  field with the reference's types.
* Model weights: :func:`params_from_reference` turns the reference's
  parameter tree (nested dicts of numpy arrays) into the port's parameters.

Neither side imports the other.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.fz import FZCompressed
from .device import resolve_device

NUMPY_DTYPES = {"bitflags": np.uint32, "payload": np.uint16, "nnz_blocks": np.int32,
                "outlier_idx": np.int32, "outlier_val": np.int32, "n_outliers": np.int32,
                "eb_abs": np.float32}


def from_reference(fields: dict[str, np.ndarray], shape, dtype_name: str, *,
                   device="cuda") -> FZCompressed:
    """Reference container fields (numpy) -> port container on ``device``."""
    dev = resolve_device(device)
    missing = set(NUMPY_DTYPES) - set(fields)
    if missing:
        raise KeyError(f"container fields missing: {sorted(missing)}")
    tensors = {name: torch.from_numpy(np.array(fields[name], dtype=dt, copy=True)).to(dev)
               for name, dt in NUMPY_DTYPES.items()}
    return FZCompressed(**tensors, shape=tuple(int(s) for s in shape),
                        dtype_name=str(dtype_name))


def to_numpy(c: FZCompressed) -> dict[str, np.ndarray]:
    """Port container -> its fields as numpy arrays of the reference's types."""
    return {name: getattr(c, name).cpu().numpy().astype(dt, copy=False)
            for name, dt in NUMPY_DTYPES.items()}


def _tensor(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, bit-exact. bfloat16 leaves (``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses) travel as their 16-bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_reference(tree, *, device="cuda"):
    """Reference parameter tree (nested dicts of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) -> the same tree of tensors on
    ``device``, each leaf bit for bit in its own type."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {key: params_from_reference(val, device=dev) for key, val in tree.items()}
    return _tensor(np.asarray(tree)).to(dev)
