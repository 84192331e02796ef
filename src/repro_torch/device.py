"""Device resolution for the port: the CUDA card by default, the CPU only on request.

Every public entry point of :mod:`repro_torch` takes a ``device`` argument and
resolves it here. Without a card and without ``device="cpu"`` the call raises;
it never carries on silently on the CPU.
"""
from __future__ import annotations

from pathlib import Path

import torch

ARCH = "sm_90a"                      # Hopper target of every hand-written kernel
BUILD_DIR = Path(__file__).resolve().parent / "_build"   # listed in .gitignore


def resolve_device(device: str | torch.device | None = "cuda", *,
                   allow_meta: bool = False) -> torch.device:
    """``None``/``"cuda"`` -> the current CUDA device; ``"cpu"`` -> the CPU;
    with ``allow_meta``, ``"meta"`` -> shapes and types only (the dry-run's
    tensors: no storage, no computation).

    Raises ``RuntimeError`` when a CUDA device is asked for and none exists.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA card by default and no card is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return dev
    if dev.type == "cpu" or (allow_meta and dev.type == "meta"):
        return dev
    raise ValueError(f"unsupported device {dev!r}: use 'cuda' or 'cpu'")
