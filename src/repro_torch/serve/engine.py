"""Serving engine: batched prefill + greedy decode with FZ-compressed KV.

The port of ``repro/serve/engine.py``. Two cache regimes:

  * **whole-cache parking** (``park``/``resume``): one cache is FZ-compressed
    between decode steps (K4 in, K6 out on the card). It is the parity
    oracle of the pool: at a shared absolute bound a page-granular
    roundtrip reconstructs bit-identically to it.
  * **paged pool** (``serve``): KV lives as pages in the pool's slab, cold
    pages are compressed in place, preemption is compress-park, and
    ``ContinuousBatcher`` drives admit/step/preempt/resume. With
    ``PoolConfig.use_kernels`` (the default) decode keeps the page layout
    and runs K7 (``decode_step_paged`` over ``PagePool.gather_pages``);
    without it, decode runs the model's own step on the gathered contiguous
    cache.

PyTorch runs eagerly, so there is nothing to trace or cache per shape. Where
the reference asks its tuner (``repro.tune``) whether paged decode should run
the kernel, the port takes ``PoolConfig.use_kernels`` as it stands: the tuner
is not ported (ROADMAP, queue 1 item 6).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import fz
from ..device import resolve_device
from ..models import zoo
from . import kvpool


@dataclasses.dataclass(frozen=True)
class KVCompressionConfig:
    enabled: bool = False
    eb: float = 1e-3               # error bound on K/V values
    eb_mode: str = "rel"           # "rel" (per-leaf range) | "abs"
    min_leaf_size: int = 65_536
    use_kernels: bool = True       # the port's default: FZ on K4/K6
    kernel_mode: str = "auto"      # "auto" (= "fused") | "fused" | "staged"

    def fz_config(self) -> fz.FZConfig:
        return fz.FZConfig(eb=self.eb, eb_mode=self.eb_mode, exact_outliers=False,
                           use_kernels=self.use_kernels, kernel_mode=self.kernel_mode)


def compress_cache(cache: dict, kcfg: KVCompressionConfig) -> dict:
    """Compress the float KV leaves; bookkeeping stays raw. Leaves keep their own
    dtype on the way in, so a bfloat16 cache's containers report bfloat16
    ``raw_bytes``."""
    fzc = kcfg.fz_config()
    out = {}
    for name, leaf in cache.items():
        if leaf.is_floating_point() and leaf.numel() >= kcfg.min_leaf_size:
            flat = leaf.reshape(-1)
            out[name] = ("fz", fz.compress(flat, fzc, device=leaf.device), tuple(leaf.shape),
                         leaf.dtype)
        else:
            out[name] = ("raw", leaf, None, None)
    return out


def decompress_cache(comp: dict, kcfg: KVCompressionConfig) -> dict:
    fzc = kcfg.fz_config()
    out = {}
    for name, (codec, payload, shape, dtype) in comp.items():
        if codec == "fz":
            out[name] = fz.decompress(payload, fzc, device=payload.eb_abs.device) \
                .reshape(shape).to(dtype)
        else:
            out[name] = payload
    return out


def cache_bytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values())


def compressed_cache_bytes(comp: dict) -> int:
    total = 0
    for codec, payload, _, _ in comp.values():
        if codec == "fz":
            total += int(payload.used_bytes())
        else:
            total += payload.numel() * payload.element_size()
    return total


class Engine:
    """Batched serving session on ``device``: whole-cache oracle path + paged pool
    path. ``params`` must already lie on that device."""

    def __init__(self, model: zoo.Model, params: dict, *,
                 kv_compress: KVCompressionConfig | None = None,
                 pool: kvpool.PoolConfig | None = None, device="cuda"):
        self.model = model
        self.params = params
        self.device = resolve_device(device)
        self.kcfg = kv_compress or KVCompressionConfig()
        self.pool_cfg = pool

    @property
    def paged_decode_enabled(self) -> bool:
        """True when ``serve`` decodes page-natively through K7
        (``PoolConfig.use_kernels`` routes both FZ and decode attention)."""
        return self.pool_cfg is not None and self.pool_cfg.use_kernels

    def prefill(self, batch: dict):
        return self.model.prefill(self.params, batch)

    def prefill_suffix(self, prefix: dict, batch: dict):
        """Suffix prefill against cached prefix K/V (prefix-sharing admission)."""
        return self.model.prefill_suffix(self.params, prefix, batch)

    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """One decode step on an explicit cache (the pool's gathered view)."""
        return self.model.decode(self.params, cache, tokens)

    def decode_step_paged(self, pages: dict, tokens: torch.Tensor):
        """One decode step on the page view (``PagePool.gather_pages``); returns
        ``(logits, (k_new, v_new))`` with the step's K/V (L, B, KVH, hd) for the
        pool append."""
        use_kernels = self.pool_cfg is None or self.pool_cfg.use_kernels
        return self.model.decode_paged(self.params, pages, tokens, use_kernels=use_kernels)

    # -- whole-cache parking (parity oracle for the pool) ----------------------

    def park(self, cache: dict) -> dict:
        """Compress a cache for in-memory parking (request preempted)."""
        if not self.kcfg.enabled:
            raise ValueError("park needs KVCompressionConfig(enabled=True)")
        return compress_cache(cache, self.kcfg)

    def resume(self, parked: dict) -> dict:
        return decompress_cache(parked, self.kcfg)

    def generate(self, batch: dict, n_tokens: int, *, park_between: bool = False):
        """Greedy generation; with ``park_between`` the cache is parked and
        resumed between steps, exercising the compressed path end to end."""
        batch = {name: torch.as_tensor(t).to(self.device) for name, t in batch.items()}
        logits, cache = self.prefill(batch)
        tokens = [torch.argmax(logits, -1).to(torch.int32)]
        for _ in range(n_tokens - 1):
            if park_between and self.kcfg.enabled:
                cache = self.resume(self.park(cache))
            logits, cache = self.decode_step(cache, tokens[-1])
            tokens.append(torch.argmax(logits, -1).to(torch.int32))
        return torch.stack(tokens, dim=1), cache

    # -- paged pool path -------------------------------------------------------

    def make_pool(self) -> kvpool.PagePool:
        """The paged KV pool for this model's cache geometry, on the engine's device."""
        if self.pool_cfg is None:
            raise ValueError("Engine was built without a PoolConfig")
        cfg = self.model.cfg
        return kvpool.PagePool(self.pool_cfg, n_layers=cfg.n_layers,
                               n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                               device=self.device)

    def serve(self, requests: list[kvpool.Request], *, max_batch: int = 2,
              pool: kvpool.PagePool | None = None):
        """Run a request trace through the pool with continuous batching.

        Returns ``(outputs, stats, pool)``; outputs maps req_id to the
        generated token array.
        """
        pool = pool or self.make_pool()
        batcher = kvpool.ContinuousBatcher(self, pool, max_batch=max_batch)
        outputs, stats = batcher.run(requests)
        return outputs, stats, pool
