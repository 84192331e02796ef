"""Model API over the ported families: the port of ``repro/models/zoo.py``.

    model = zoo.build(cfg)
    params = model.init(generator, device="cuda")
    loss, aux = model.train_loss(params, batch)
    logits, cache = model.prefill(params, batch)
    logits, cache = model.decode(params, cache, token)
    logits, (k_new, v_new) = model.decode_paged(params, pages, token, use_kernels=True)
    logits, cache = model.prefill_suffix(params, prefix, batch)
    specs = model.input_specs(shape)       # meta tensors + logical shardings

Only the dense family is ported; ``build`` raises ``NotImplementedError`` for
the others (ROADMAP, queue 1 item 14).
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

    def train_loss(self, params, batch):
        return transformer.forward_train(params, self.cfg, batch)

    def input_specs(self, shape: ShapeConfig) -> tuple[dict, dict]:
        """(structs, logical shardings) of the step's inputs: ``meta`` int32
        tensors of the shape's sizes, and each input's logical axes."""
        B, S = shape.global_batch, shape.seq_len

        def struct(*dims):
            return torch.empty(dims, dtype=torch.int32, device="meta")
        if shape.kind in ("train", "prefill"):
            specs, shards = {"tokens": struct(B, S)}, {"tokens": (DP, None)}
            if shape.kind == "train":
                specs["labels"], shards["labels"] = struct(B, S), (DP, None)
            return specs, shards
        return {"token": struct(B)}, {"token": (DP,)}

    def prefill(self, params, batch):
        return transformer.forward_prefill(params, self.cfg, batch)

    def decode(self, params, cache, token):
        return transformer.forward_decode(params, self.cfg, cache, token)

    def decode_paged(self, params, pages, token, use_kernels: bool = True):
        return transformer.forward_decode_paged(params, self.cfg, pages, token,
                                                use_kernels=use_kernels)

    def prefill_suffix(self, params, prefix, batch):
        return transformer.forward_prefill_suffix(params, self.cfg, prefix, batch)

    def make_cache(self, B: int, S: int, *, device) -> dict:
        return transformer.init_cache(self.cfg, B, S, device=device)


def build(cfg: ArchConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.arch_id}) is not ported "
                                  "yet (ROADMAP, queue 1 item 14)")
    return Model(cfg)
