"""Model API over the ported families: the port of ``repro/models/zoo.py``.

    model = zoo.build(cfg)
    params = model.init(generator, device="cuda")
    loss, aux = model.train_loss(params, batch)
    logits, cache = model.prefill(params, batch)
    logits, cache = model.decode(params, cache, token, positions=None)
    logits, (k_new, v_new) = model.decode_paged(params, pages, token, use_kernels=True)
    logits, cache = model.prefill_suffix(params, prefix, batch)
    specs = model.input_specs(shape)       # meta tensors + logical shardings
    cache, logical = model.cache_specs(shape)   # meta tensors + logical shardings

``build`` dispatches on the family, as the reference's does: dense, moe and
vlm to ``transformer``, hybrid to ``zamba2``, ssm to ``rwkv6`` and audio to
``whisper``. The page-native paths (``decode_paged``, ``prefill_suffix``) exist
where the reference's gate allows them: dense and moe, and vlm without M-RoPE.
Elsewhere they are ``None`` (``WholeCacheModel``): an M-RoPE model's, because
the pool's paged decode rotates by the 1-D cache length where M-RoPE takes
(B, 3, S) position ids, and the recurrent and audio families', whose caches
are not plain k/v/length caches. ``input_specs`` adds the stubbed audio
frontend's ``audio_embeds`` (B, n_audio_ctx, d) bfloat16 for the audio family.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import pytree
from ..configs.base import ArchConfig, ShapeConfig
from . import nn, rwkv6, transformer, whisper, zamba2

DP = "dp"    # batch/activation axis -> ("pod", "data")
TP = "tp"

FAMILY_MODULES = {"dense": transformer, "moe": transformer, "vlm": transformer,
                  "hybrid": zamba2, "ssm": rwkv6, "audio": whisper}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    @property
    def family_module(self):
        """The module of the config's family (``transformer``, ``zamba2``,
        ``rwkv6`` or ``whisper``)."""
        return FAMILY_MODULES[self.cfg.family]

    def defs(self) -> dict:
        return self.family_module.model_defs(self.cfg)

    def init(self, generator: torch.Generator | None = None, *, device="cuda") -> dict:
        """Random parameters from ``generator`` (default: seed 0 on ``device``)."""
        return nn.init_tree(self.defs(), generator, device=device)

    def param_specs(self) -> dict:
        """Logical axes of every parameter (``dist.sharding`` resolves them)."""
        return nn.spec_tree(self.defs())

    def abstract_params(self) -> dict:
        """The parameter tree as ``meta`` tensors: shapes and types, no storage."""
        return pytree.tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
                               self.defs())

    def param_count(self) -> int:
        return nn.param_count(self.defs())

    def active_param_count(self) -> int:
        """MoE: parameters touched per token (for MODEL_FLOPS = 6 N_active D)."""
        cfg = self.cfg
        total = self.param_count()
        if not cfg.n_experts:
            return total
        layers = self.defs()["layers"]
        expert = nn.param_count({name: layers[name]
                                 for name in ("we_gate", "we_up", "we_down")})
        return total - expert + expert * cfg.top_k // cfg.n_experts

    def train_loss(self, params, batch):
        return self.family_module.forward_train(params, self.cfg, batch)

    def input_specs(self, shape: ShapeConfig) -> tuple[dict, dict]:
        """(structs, logical shardings) of the step's inputs: ``meta`` tensors
        of the shape's sizes (int32; the audio frontend's embeddings bfloat16),
        and each input's logical axes."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        mrope = cfg.mrope_sections is not None

        def struct(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")
        if shape.kind in ("train", "prefill"):
            specs, shards = {"tokens": struct(B, S)}, {"tokens": (DP, None)}
            if shape.kind == "train":
                specs["labels"], shards["labels"] = struct(B, S), (DP, None)
            if mrope:
                specs["positions"], shards["positions"] = struct(B, 3, S), (DP, None, None)
            if cfg.family == "audio":
                specs["audio_embeds"] = struct(B, cfg.n_audio_ctx, cfg.d_model,
                                               dtype=torch.bfloat16)
                shards["audio_embeds"] = (DP, None, None)
            return specs, shards
        specs, shards = {"token": struct(B)}, {"token": (DP,)}
        if mrope:
            specs["positions"], shards["positions"] = struct(B, 3, 1), (DP, None, None)
        return specs, shards

    def prefill(self, params, batch):
        return self.family_module.forward_prefill(params, self.cfg, batch)

    def decode(self, params, cache, token, positions=None):
        return self.family_module.forward_decode(params, self.cfg, cache, token, positions)

    def decode_paged(self, params, pages, token, use_kernels: bool = True):
        return transformer.forward_decode_paged(params, self.cfg, pages, token,
                                                use_kernels=use_kernels)

    def prefill_suffix(self, params, prefix, batch):
        return transformer.forward_prefill_suffix(params, self.cfg, prefix, batch)

    def make_cache(self, B: int, S: int, *, device) -> dict:
        return self.family_module.init_cache(self.cfg, B, S, device=device)

    def cache_specs(self, shape: ShapeConfig) -> tuple[dict, dict]:
        """The decode cache of ``shape`` as ``meta`` tensors (no storage), and
        each leaf's logical axes."""
        cache = self.make_cache(shape.global_batch, shape.seq_len, device="meta")
        return cache, cache_shardings(self.cfg, cache)


def cache_shardings(cfg: ArchConfig, cache: dict) -> dict:
    """Logical axes of a cache's leaves, the reference's rule: KV caches are
    sequence-sharded on ``tp`` (the flash-decoding layout) and batch-sharded on
    ``dp``; recurrent states shard heads (``ssm``, ``wkv``) or channels
    (``conv``) on ``tp``; token-shift states and lengths on ``dp`` alone."""
    out = {}
    for name, leaf in cache.items():
        if name in ("k", "v"):           # (L, B, Smax, KVH, hd)
            out[name] = (None, DP, TP, None, None)
        elif name in ("xk", "xv"):       # whisper cross KV (L, B, ctx, H, hd)
            out[name] = (None, DP, None, TP, None)
        elif name in ("ssm", "wkv"):     # (L, B, nh, hd, ds) / (L, B, nh, hdk, hdv)
            out[name] = (None, DP, TP, None, None)
        elif name == "conv":             # (L, B, W-1, C)
            out[name] = (None, DP, None, TP)
        elif name in ("sh_a", "sh_f"):   # (L, B, d)
            out[name] = (None, DP, None)
        elif name == "length":
            out[name] = (DP,)
        else:
            out[name] = (None,) * leaf.ndim
    return out


@dataclasses.dataclass(frozen=True)
class WholeCacheModel(Model):
    """A model without the page-native paths (M-RoPE, recurrent, audio): it
    serves through the whole cache only."""
    decode_paged = None
    prefill_suffix = None


def build(cfg: ArchConfig) -> Model:
    if cfg.family not in FAMILY_MODULES:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family in ("dense", "moe") or (cfg.family == "vlm" and cfg.mrope_sections is None):
        return Model(cfg)
    return WholeCacheModel(cfg)
