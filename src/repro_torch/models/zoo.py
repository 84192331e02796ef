"""Model API over the ported families: the port of ``repro/models/zoo.py``.

    model = zoo.build(cfg)
    params = model.init(generator, device="cuda")
    logits, cache = model.prefill(params, batch)
    logits, cache = model.decode(params, cache, token)
    logits, (k_new, v_new) = model.decode_paged(params, pages, token, use_kernels=True)
    logits, cache = model.prefill_suffix(params, prefix, batch)

Only the dense family is ported; ``build`` raises ``NotImplementedError`` for
the others (ROADMAP, queue 1 item 14).
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ArchConfig
from . import nn, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def defs(self) -> dict:
        return transformer.model_defs(self.cfg)

    def init(self, generator: torch.Generator | None = None, *, device="cuda") -> dict:
        """Random parameters from ``generator`` (default: seed 0 on ``device``)."""
        return nn.init_tree(self.defs(), generator, device=device)

    def param_count(self) -> int:
        return nn.param_count(self.defs())

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
