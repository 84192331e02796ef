"""Model API over the ported families: the port of ``repro/models/zoo.py``.

    model = zoo.build(cfg)
    params = model.init(generator, device="cuda")
    loss, aux = model.train_loss(params, batch)
    logits, cache = model.prefill(params, batch)
    logits, cache = model.decode(params, cache, token, positions=None)
    logits, (k_new, v_new) = model.decode_paged(params, pages, token, use_kernels=True)
    logits, cache = model.prefill_suffix(params, prefix, batch)
    specs = model.input_specs(shape)       # meta tensors + logical shardings

``build`` takes the reference's ``transformer`` families: dense, moe and vlm.
The page-native paths (``decode_paged``, ``prefill_suffix``) exist where the
reference's gate allows them: dense and moe, and vlm without M-RoPE. An M-RoPE
model's are ``None``: the pool's paged decode rotates by the 1-D cache length,
where M-RoPE takes (B, 3, S) position ids. ``build`` raises
``NotImplementedError`` for the recurrent and audio families (ROADMAP, queue 1
item 5).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import pytree
from ..configs.base import ArchConfig, ShapeConfig
from . import nn, transformer

DP = "dp"    # batch/activation axis -> ("pod", "data")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def defs(self) -> dict:
        return transformer.model_defs(self.cfg)

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
        return transformer.forward_train(params, self.cfg, batch)

    def input_specs(self, shape: ShapeConfig) -> tuple[dict, dict]:
        """(structs, logical shardings) of the step's inputs: ``meta`` int32
        tensors of the shape's sizes, and each input's logical axes."""
        B, S = shape.global_batch, shape.seq_len
        mrope = self.cfg.mrope_sections is not None

        def struct(*dims):
            return torch.empty(dims, dtype=torch.int32, device="meta")
        if shape.kind in ("train", "prefill"):
            specs, shards = {"tokens": struct(B, S)}, {"tokens": (DP, None)}
            if shape.kind == "train":
                specs["labels"], shards["labels"] = struct(B, S), (DP, None)
            if mrope:
                specs["positions"], shards["positions"] = struct(B, 3, S), (DP, None, None)
            return specs, shards
        specs, shards = {"token": struct(B)}, {"token": (DP,)}
        if mrope:
            specs["positions"], shards["positions"] = struct(B, 3, 1), (DP, None, None)
        return specs, shards

    def prefill(self, params, batch):
        return transformer.forward_prefill(params, self.cfg, batch)

    def decode(self, params, cache, token, positions=None):
        return transformer.forward_decode(params, self.cfg, cache, token, positions)

    def decode_paged(self, params, pages, token, use_kernels: bool = True):
        return transformer.forward_decode_paged(params, self.cfg, pages, token,
                                                use_kernels=use_kernels)

    def prefill_suffix(self, params, prefix, batch):
        return transformer.forward_prefill_suffix(params, self.cfg, prefix, batch)

    def make_cache(self, B: int, S: int, *, device) -> dict:
        return transformer.init_cache(self.cfg, B, S, device=device)


@dataclasses.dataclass(frozen=True)
class WholeCacheModel(Model):
    """A model without the page-native paths (M-RoPE): it serves through the
    whole cache only."""
    decode_paged = None
    prefill_suffix = None


def build(cfg: ArchConfig) -> Model:
    if cfg.family not in transformer.FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.arch_id}) is not ported "
                                  "yet (ROADMAP, queue 1 item 5)")
    if cfg.family in ("dense", "moe") or cfg.mrope_sections is None:
        return Model(cfg)
    return WholeCacheModel(cfg)
