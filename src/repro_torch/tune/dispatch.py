"""Near-zero-overhead tuned dispatch: cached winner, else backend fallback. The
port of ``repro/tune/dispatch.py``.

This is the hot-path half of ``repro_torch.tune``: the fz entry points resolve
``kernel_mode="auto"`` here on every call, and the engine its decode
attention once, so the lookup must cost a dict probe, not a file read. The
persistent cache is loaded once per process (and re-read only when the
tuner writes a new winner via :func:`invalidate_memo`), and resolutions are
memoized per backend and ``(op, bucket, dtype)``.

The backend is the call's device: ``cuda`` (the CUDA kernels on the card) or
``cpu`` (the wrappers' plain versions), never a process-wide default.

Fallback ordering when no tuning-cache entry exists for a workload --
deliberate difference: ``FZ_FALLBACK`` is fused, staged, reference on both
backends. The reference orders its ``gpu`` and ``interpret`` backends staged
first (``repro/tune/dispatch.py:42-46``) because the Pallas interpreter runs
the fused kernels' sequential grid in Python. On the H100, fused paper
compress takes 0.267 ms at (100, 500, 500) f32 and staged 1.226-1.293 ms
(PERF.md section 5); on the CPU the port runs the plain versions, where that
reason does not hold; and fused-first keeps the routes "auto" took before the
tuner was ported.

Untuned ``decode_attention`` takes the kernel route. On the card the plain
routes (``reference``, ``jnp``) are the tuner's parity oracle and never its
winner (:mod:`.tuner`), so a cache entry that names one there is refused
rather than followed: a call on the card never gives way to the plain
version.

Counters: ``tune_cache{result=hit|miss, site=dispatch}`` and
``tune_selected{op=..., impl=..., site=dispatch}``, one each a resolved call,
queued on ``obs``'s deferred path (``obs.registry._queued``) as the fz
entry points queue their own. Nothing is counted while a CUDA graph is
captured (or ``torch.compile`` traces): a capture is not a dispatch, as the
reference gates its counters on ``jax.core.trace_state_clean()``.
"""
from __future__ import annotations

import functools

import torch

from ..obs import registry as _reg
from ..obs import spans
from . import registry
from .cache import TuneCache, cache_key, shape_bucket

# static ordering when no cache entry exists (most-preferred first)
FZ_FALLBACK = ("fused", "staged", "reference")
PLAIN_IMPLS = ("reference", "jnp")   # the plain routes: on the card, oracles only
_FZ_OPS = {"compress": "fz.compress", "decompress": "fz.decompress"}

_cache: TuneCache | None = None
# (backend, op, bucket, dtype) -> (impl, (tune_cache labels, tune_selected labels))
_memo: dict[tuple[str, str, int, str], tuple[str, tuple[dict, dict]]] = {}


def _device(device) -> torch.device:
    return device if isinstance(device, torch.device) else torch.device(device)


def backend(device="cuda") -> str:
    """Registry backend label of the call's device: ``"cuda"`` or ``"cpu"``."""
    return "cuda" if _device(device).type == "cuda" else "cpu"


@functools.cache
def _card_name(index: int | None) -> str:
    return torch.cuda.get_device_name(index).replace(" ", "_").replace("|", "_")


def arch(device="cuda") -> str:
    """Device kind the measurements were taken on (part of the cache key): the
    card's name with spaces as ``_``, or ``"cpu"``."""
    dev = _device(device)
    return _card_name(dev.index) if dev.type == "cuda" else "cpu"


def active_cache() -> TuneCache:
    """The process-wide cache, loaded lazily from the default path."""
    global _cache
    if _cache is None:
        _cache = TuneCache().load()
    return _cache


def configure(path=None) -> TuneCache:
    """Point the process at a specific cache file (tests, CLI --cache)."""
    global _cache
    _cache = TuneCache(path).load()
    _memo.clear()
    return _cache


def reset() -> None:
    """Drop the loaded cache and memo (next lookup reloads from disk)."""
    global _cache
    _cache = None
    _memo.clear()


def invalidate_memo() -> None:
    """Called by the tuner after writing a winner so dispatch sees it."""
    _memo.clear()


def _apply_count(cache_labels: dict, selected_labels: dict) -> None:
    _reg.add_now("tune_cache", cache_labels)
    _reg.add_now("tune_selected", selected_labels)


def _resolve(op: str, n: int, dtype: str, device, fallback) -> str:
    """The memoized winner; ``fallback(op)`` names the impl on a miss."""
    dev = _device(device)
    b = "cuda" if dev.type == "cuda" else "cpu"
    memo_key = (b, op, shape_bucket(n), dtype)
    cached = _memo.get(memo_key)
    if cached is None:
        key = cache_key(b, op, n, dtype, arch(dev))
        entry = active_cache().get(key)
        impl, result = (entry["impl"], "hit") if entry is not None else (fallback(op), "miss")
        if b == "cuda" and impl in PLAIN_IMPLS:
            raise ValueError(f"tuning cache {active_cache().path}: {key} names the plain "
                             f"route {impl!r}, which a call on the card never takes")
        cached = _memo[memo_key] = (impl, ({"result": result, "site": "dispatch"},
                                           {"op": op, "impl": impl, "site": "dispatch"}))
    if _reg._enabled and not spans.trace_time():
        _reg._queued.append((_apply_count, cached[1]))
        if len(_reg._queued) >= _reg.QUEUE_LIMIT:
            _reg.apply_deferred()
    return cached[0]


def _fz_fallback(op: str) -> str:
    cands = {c.impl for c in registry.candidates(op)}
    return next((impl for impl in FZ_FALLBACK if impl in cands), "reference")


def _kernel_fallback(op: str) -> str:
    return "kernel"


def fz_fallback_mode(b: str | None = None) -> str:
    """First *kernel* choice of the static ordering on backend ``b`` (``"cuda"``
    or ``"cpu"``; default ``backend()``): ``"fused"``, since the port's order is
    fused-first on both backends (the reference's is staged-first off the TPU)."""
    if b not in (None, "cuda", "cpu"):
        raise ValueError(f"unknown backend {b!r}: use 'cuda' or 'cpu'")
    return next(impl for impl in FZ_FALLBACK if impl not in PLAIN_IMPLS)


def resolve_fz(direction: str, n: int, dtype: str, device="cuda") -> str:
    """Winning impl for ``fz.compress``/``fz.decompress`` at this workload on
    ``device``: ``"reference" | "staged" | "fused"``. ``direction`` is
    "compress" or "decompress"."""
    return _resolve(_FZ_OPS[direction], n, dtype, device, _fz_fallback)


def decode_attention_impl(n: int, dtype, device="cuda") -> str:
    """Winning impl for decode attention at a per-sequence cache of ``n``
    elements: ``"kernel" | "jnp"`` (``jnp`` names the plain route, as the
    reference names its jnp oracle; on the card it is never the answer).
    Untuned, "kernel"."""
    return _resolve("decode_attention", n, str(dtype).removeprefix("torch."), device,
                    _kernel_fallback)
