"""Containers across the two packages, as numpy arrays.

The compressor has no model weights; the state carried across is the
container. A container made by the reference (its fields as numpy arrays)
becomes a port :class:`~repro_torch.core.fz.FZCompressed` with
:func:`from_reference`, and :func:`to_numpy` gives the reverse, field for
field with the reference's types. Neither side imports the other.
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
