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
    (``decode_step_paged`` over ``PagePool.gather_pages``); without it,
    decode runs the model's own step on the gathered contiguous cache.

PyTorch runs eagerly, so there is nothing to trace or cache per shape. As the
reference does (``repro/serve/engine.py:122-132``), the engine asks the tuner
once, at construction, whether paged decode runs K7 or the plain partials:
``tune.decode_attention_impl`` at the pool's per-sequence cache size
(``attn_cache_elems(seq_capacity, n_kv_heads, head_dim)``) and type, on the
engine's device -- the cached winner, else the kernel. The choice is
``Engine.decode_attention`` (``"kernel"``, or on the CPU ``"jnp"``, the plain
route; on the card the tuner never picks the plain route).
``Engine.attention_workload`` is the tuning point of that choice with the
engine's own geometry, so a pre-tune measures the paged route it serves.

A model without page-native paths (M-RoPE: ``model.decode_paged is None``)
serves through the whole cache only: ``make_pool`` raises
``NotImplementedError`` for it, as the reference's does, and the engine's
``prefill_suffix`` is ``None``.

Telemetry, as the reference's: ``engine.prefill``, ``engine.decode_step``,
``engine.decode_step_paged``, ``engine.park``, ``engine.resume`` and
``engine.serve`` spans, and the ``engine_serve_tokens`` /
``engine_serve_tokens_per_s`` gauges of the last ``serve``.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .. import obs
from ..core import fz
from ..device import resolve_device
from ..models import zoo
from ..tune import dispatch as tune_dispatch
from ..tune.impls import attention_geometry, attn_cache_elems
from . import kvpool


@dataclasses.dataclass(frozen=True)
class KVCompressionConfig:
    enabled: bool = False
    eb: float = 1e-3               # error bound on K/V values
    eb_mode: str = "rel"           # "rel" (per-leaf range) | "abs"
    min_leaf_size: int = 65_536
    use_kernels: bool = True       # the port's default: FZ on K4/K6
    kernel_mode: str = "auto"      # "auto" (tuned, repro_torch.tune) | "fused" | "staged"

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
        if model.prefill_suffix is None:
            # the scheduler probes callable(engine.prefill_suffix); without it,
            # prefix sharing degrades to full prefill
            self.prefill_suffix = None
        # paged decode attention, resolved once: the tuned winner, else K7
        self.decode_attention = None
        if pool is not None and pool.use_kernels:
            _, n_attn, dtype, _ = self.attention_workload()
            self.decode_attention = tune_dispatch.decode_attention_impl(
                n_attn, dtype, self.device)

    def attention_workload(self, batch: int = 2) -> tuple[str, int, str, dict]:
        """``(op, n, dtype, geometry)``: the tuner's workload of this engine's
        paged decode attention at ``batch`` lanes (``tune.ensure_tuned``)."""
        cfg, pool = self.model.cfg, self.pool_cfg
        geometry = attention_geometry(kvh=cfg.n_kv_heads, g=cfg.n_heads // cfg.n_kv_heads,
                                      d=cfg.hd, page_size=pool.page_size, batch=batch)
        return ("decode_attention", attn_cache_elems(pool.seq_capacity, cfg.n_kv_heads, cfg.hd),
                pool.dtype, geometry)

    @property
    def paged_decode_enabled(self) -> bool:
        """True when ``serve`` decodes page-natively through K7
        (``PoolConfig.use_kernels`` routes both FZ and decode attention)."""
        return (self.pool_cfg is not None and self.pool_cfg.use_kernels
                and self.model.decode_paged is not None)

    def prefill(self, batch: dict):
        with obs.span("engine.prefill"):
            return self.model.prefill(self.params, batch)

    def prefill_suffix(self, prefix: dict, batch: dict):
        """Suffix prefill against cached prefix K/V (prefix-sharing admission)."""
        return self.model.prefill_suffix(self.params, prefix, batch)

    def decode_step(self, cache: dict, tokens: torch.Tensor):
        """One decode step on an explicit cache (the pool's gathered view)."""
        with obs.span("engine.decode_step"):
            return self.model.decode(self.params, cache, tokens)

    def decode_step_paged(self, pages: dict, tokens: torch.Tensor):
        """One decode step on the page view (``PagePool.gather_pages``); returns
        ``(logits, (k_new, v_new))`` with the step's K/V (L, B, KVH, hd) for the
        pool append."""
        if self.model.decode_paged is None:
            raise ValueError("model/pool combination has no paged decode")
        use_kernels = self.pool_cfg is None or self.decode_attention == "kernel"
        with obs.span("engine.decode_step_paged"):
            return self.model.decode_paged(self.params, pages, tokens,
                                           use_kernels=use_kernels)

    # -- whole-cache parking (parity oracle for the pool) ----------------------

    def park(self, cache: dict) -> dict:
        """Compress a cache for in-memory parking (request preempted)."""
        if not self.kcfg.enabled:
            raise ValueError("park needs KVCompressionConfig(enabled=True)")
        with obs.span("engine.park"):
            return compress_cache(cache, self.kcfg)

    def resume(self, parked: dict) -> dict:
        with obs.span("engine.resume"):
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
            logits, cache = self.model.decode(self.params, cache, tokens[-1])
            tokens.append(torch.argmax(logits, -1).to(torch.int32))
        return torch.stack(tokens, dim=1), cache

    # -- paged pool path -------------------------------------------------------

    def make_pool(self) -> kvpool.PagePool:
        """The paged KV pool for this model's cache geometry, on the engine's device."""
        if self.pool_cfg is None:
            raise ValueError("Engine was built without a PoolConfig")
        cfg = self.model.cfg
        if cfg.mrope_sections is not None:
            raise NotImplementedError(
                f"paged KV pool supports plain k/v/length caches with 1-D positions; "
                f"{cfg.arch_id} rotates by M-RoPE position ids")
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
        t0 = time.perf_counter()
        with obs.span("engine.serve", requests=len(requests)):
            outputs, stats = batcher.run(requests)
        dt = time.perf_counter() - t0
        n_tokens = sum(len(v) for v in outputs.values())
        obs.gauge("engine_serve_tokens").set(n_tokens)
        if dt > 0:
            obs.gauge("engine_serve_tokens_per_s").set(n_tokens / dt)
        return outputs, stats, pool
