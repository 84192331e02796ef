"""Checkpoint/restart: atomic, checksummed, FZ-compressible, keep-last-k. The
port of ``repro/ckpt/checkpoint.py``; the files it writes are the reference's,
byte for byte, and each package restores the other's.

Layout (one directory per step):
    <root>/step_000123/
        manifest.json     # leaf paths, shapes, dtypes, checksums, codec, meta
        leaf_000000.bin   # raw little-endian bytes or a serialized FZ container
    <root>/LATEST         # atomically-renamed pointer file

Contract:
  * atomic publish: a crash mid-save never corrupts LATEST (tmp dir + rename);
  * integrity: every leaf carries a crc32; restore verifies before use;
  * keep-last-k garbage collection;
  * codec "fz": float leaves of at least ``_MIN_FZ_SIZE`` elements go through
    the error-bounded compressor with exact outliers on (the paper's
    GPU-to-disk use case, §2.4), as float32 (the container header says
    float32, as the reference casts), serialized with ``to_bytes(entropy="auto",
    tier="ckpt")``. The compressor runs on the card (strict mode: strict K4,
    one launch); only the container's bytes move to the host.
    Restore decodes with ``decompress_bytes`` (K6 on the card), which also
    reads the headerless pre-v1 stream. The whole checkpoint's ratio feeds
    the ``ckpt`` tier of ``obs.note_ratio``.

Leaves are numbered in JAX's flatten order (sorted dict keys) and keyed by
JAX's path strings (``repro_torch.pytree``). bfloat16 leaves stay raw even under
``codec="fz"``: the reference tests numpy's dtype kind, which is ``"V"`` for
bfloat16, not ``"f"``; their bytes are written through an int16 view.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any

import numpy as np
import torch

from .. import obs, pytree
from ..core.fz import FZConfig, compress, decompress_bytes, to_bytes
from ..device import resolve_device

_FZ_CKPT = FZConfig(eb=1e-5, eb_mode="rel", exact_outliers=True, outlier_frac=1 / 64)
_MIN_FZ_SIZE = 65_536


def _tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))


def _dtype_name(t: torch.Tensor) -> str:
    """numpy's name of the dtype, as the manifest records it (``"bfloat16"`` too)."""
    return str(t.dtype).removeprefix("torch.")


def _kind(t: torch.Tensor) -> str:
    """numpy's dtype kind: ``"f"`` for float16/32/64, ``"V"`` for bfloat16 (its
    ml_dtypes kind), else integer/bool kinds (never ``"f"``)."""
    if t.dtype == torch.bfloat16:
        return "V"
    return "f" if t.is_floating_point() else "i"


def _host_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _serialize_fz(t: torch.Tensor, dev: torch.device) -> bytes:
    """One float leaf -> a serialized v1 FZ container. Flattened: the container
    records shape (n,); the manifest keeps the real shape and dtype."""
    x = t.detach().to(dev).reshape(-1).to(torch.float32)
    c = compress(x, _FZ_CKPT, device=dev)
    return to_bytes(c, _FZ_CKPT, entropy="auto", tier="ckpt")


def _deserialize_fz(raw: bytes, shape, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    rec = decompress_bytes(raw, tier="ckpt", device=dev)
    return rec.to(dtype).reshape(shape)


def _from_raw(raw: bytes, shape, name: str, dev: torch.device) -> torch.Tensor:
    if name == "bfloat16":
        t = torch.from_numpy(np.frombuffer(raw, "<i2").copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(raw, np.dtype(name)).copy())
    return t.reshape(shape).to(dev)


def save(root: str, step: int, tree: Any, *, meta: dict | None = None,
         codec: str = "raw", keep_last: int = 3, device="cuda") -> str:
    """Atomic checkpoint write. codec: "raw" | "fz". ``device``: where FZ leaves
    are compressed (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    name = f"step_{step:08d}"
    tmp = os.path.join(root, f".tmp_{name}")
    final = os.path.join(root, name)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "meta": meta or {}, "codec": codec, "leaves": []}
    for i, (path, leaf) in enumerate(pytree.leaves_with_keys(tree)):
        t = _tensor(leaf)
        fname = f"leaf_{i:06d}.bin"
        use_fz = codec == "fz" and _kind(t) == "f" and t.numel() >= _MIN_FZ_SIZE
        raw = _serialize_fz(t, dev) if use_fz else _host_bytes(t)
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(raw)
        manifest["leaves"].append({
            "path": path, "file": fname, "shape": list(t.shape),
            "dtype": _dtype_name(t), "codec": "fz" if use_fz else "raw",
            "crc32": zlib.crc32(raw), "bytes": len(raw),
            "raw_bytes": t.numel() * t.element_size(),
        })
    if codec == "fz":
        # one whole-checkpoint ratio sample a save (per-leaf ratios legitimately
        # differ by more than the drift factor)
        obs.note_ratio("ckpt",
                       sum(l["raw_bytes"] for l in manifest["leaves"])
                       / max(sum(l["bytes"] for l in manifest["leaves"]), 1))
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    latest_tmp = os.path.join(root, ".LATEST_tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
    os.replace(latest_tmp, os.path.join(root, "LATEST"))
    _gc(root, keep_last)
    return final


def _gc(root: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(root) if d.startswith("step_"))
    for d in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def latest_step(root: str) -> int | None:
    try:
        with open(os.path.join(root, "LATEST")) as f:
            return int(f.read().strip().split("_")[1])
    except (FileNotFoundError, IndexError, ValueError):
        return None


def restore(root: str, tree_like: Any, *, step: int | None = None,
            shardings: Any | None = None, device="cuda") -> tuple[Any, dict]:
    """Restore into the structure of ``tree_like`` (a template: only its
    structure is read), onto ``device``.

    ``shardings``: optional matching tree of ``dist.sharding.NamedSharding`` --
    each leaf is laid out as a DTensor on its mesh (elastic restore onto any
    mesh; every rank reads the files).
    """
    dev = resolve_device(device)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_meta = manifest["leaves"]
    flat = pytree.leaves(tree_like)
    assert len(flat) == len(leaves_meta), (len(flat), len(leaves_meta))
    sh_flat = pytree.leaves(shardings) if shardings is not None else [None] * len(flat)
    out = []
    for meta_l, sh in zip(leaves_meta, sh_flat):
        with open(os.path.join(d, meta_l["file"]), "rb") as f:
            raw = f.read()
        if zlib.crc32(raw) != meta_l["crc32"]:
            raise IOError(f"checksum mismatch in {meta_l['file']} (corrupt checkpoint)")
        if meta_l["codec"] == "fz":
            arr = _deserialize_fz(raw, meta_l["shape"], getattr(torch, meta_l["dtype"]), dev)
        else:
            arr = _from_raw(raw, meta_l["shape"], meta_l["dtype"], dev)
        if sh is not None:
            from torch.distributed.tensor import distribute_tensor
            arr = distribute_tensor(arr, sh.mesh, sh.placements)
        out.append(arr)
    return pytree.unflatten(tree_like, out), manifest["meta"] | {"step": manifest["step"]}


def compression_report(root: str, step: int) -> dict:
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    raw = sum(l["raw_bytes"] for l in manifest["leaves"])
    stored = sum(l["bytes"] for l in manifest["leaves"])
    return {"raw_bytes": raw, "stored_bytes": stored, "ratio": raw / max(stored, 1)}
