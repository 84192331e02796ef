"""SDRBench proxy fields made on the device from the run's seed.

Each proxy kind is a file of its own, ``fzbench/proxies/<kind>.py``, with
``make(shape, generator, device) -> float32 tensor``, found by the name a
configuration gives under ``proxy``. The kinds are torch copies of the port's
``data/fields.py``, so that a 512^3 spectrum or 281M lognormals take a
fraction of a second on the card instead of tens of host seconds in numpy.
The bytes differ from numpy's (another generator); the statistics that set
the compression ratio are the same.

Field ``index`` of a configuration is drawn from its own generator, seeded
from (the run's seed, the configuration's name, the index): the same seed
gives the same bytes on one device and torch build, and another seed gives
other fields of the same shapes and statistics.
"""
from __future__ import annotations

import hashlib
import importlib.util
from pathlib import Path

import torch

PROXIES = Path(__file__).resolve().parent / "proxies"
DTYPES = ("float32",)    # the reference's check and its control are set for float32


def field_seed(seed: int, key: str, index: int) -> int:
    """A 63-bit generator seed from (run seed, configuration name, field index)."""
    digest = hashlib.sha256(f"fzbench:{int(seed)}:{key}:{int(index)}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def proxy(kind: str, proxies: Path = PROXIES):
    """The ``make`` function of ``<proxies>/<kind>.py``."""
    path = Path(proxies) / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"unknown proxy kind {kind!r}: no {path}")
    spec = importlib.util.spec_from_file_location(f"fzbench_proxy_{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make


def make_field(kind: str, shape, dtype: str, seed: int, key: str, index: int, device,
               proxies: Path = PROXIES) -> torch.Tensor:
    """Field ``index`` of configuration ``key`` in the run of ``seed``: proxy
    ``kind`` at ``shape``, contiguous, on ``device``."""
    if dtype not in DTYPES:
        raise ValueError(f"configuration {key}: dtype {dtype!r} is not one the check "
                         f"compares ({DTYPES}); another needs its own control precision")
    gen = torch.Generator(device=device)
    gen.manual_seed(field_seed(seed, key, index))
    return proxy(kind, proxies)(tuple(shape), gen, device)
