"""Mixture-of-Experts FFN (dbrx 16e/top-4, llama4-scout 16e/top-1): the port of
``repro/models/moe.py``.

GSPMD-style grouped dispatch and combine with capacity limiting, op for op as
the reference computes it outside any Pallas kernel: tokens are split into
groups of ``g`` (the largest divisor of the token count up to
``GROUP_TOKENS``), each group dispatches into ``C = max(1, int(g * k * cf /
E))`` slots per expert, and a (token, choice) past its expert's capacity is
dropped (Switch style). The products are ``torch.einsum`` contractions in
``h``'s type with float32 accumulation, as XLA's dots; dispatch and combine
are built in float32 and cast to ``h``'s type before their einsums. No
``(G, g, k, E, C)`` tensor is built: dispatch and combine contract the top-k
axis away in one batched product each.

Top-k is ``jax.lax.top_k``'s: the ``k`` largest scores, a tie broken towards
the lower expert index (a stable descending sort, since ``torch.topk``
promises no order among equal values).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import nn

DP = "fsdp"
TP = "tp"

GROUP_TOKENS = 2048


def moe_defs(cfg: ArchConfig) -> dict:
    L, d, f, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": nn.Param((L, d, E), (None, DP, None), dtype=torch.float32),
        "we_gate": nn.Param((L, E, d, f), (None, TP, DP, None)),
        "we_up": nn.Param((L, E, d, f), (None, TP, DP, None)),
        "we_down": nn.Param((L, E, f, d), (None, TP, None, DP)),
    }


def _group_size(T: int) -> int:
    g = min(GROUP_TOKENS, T)
    while T % g:
        g -= 1
    return g


def top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: values in descending order, a tie
    broken towards the lower index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: ``exp(x - max)`` over its sum."""
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True).detach())
    return e / torch.sum(e, dim=-1, keepdim=True)


def route(lp: dict, x: torch.Tensor, cfg: ArchConfig, C: int) -> dict:
    """The router of one ``(G, g, d)`` batch of groups, in float32: ``scores``
    (G, g, E), the top-k ``vals`` (renormalised) and ``idx`` (G, g, k), each
    choice's one-hot expert ``m`` (G, g, k, E), its slot ``pos`` in that
    expert's queue (G, g, k), whether it fits the capacity (``keep``), its
    one-hot slot ``oh_pos`` (G, g, k, C; zero where dropped), and the
    ``dispatch`` mask and ``combine`` weights (G, g, E, C)."""
    E, k = cfg.n_experts, cfg.top_k
    G, g, _ = x.shape
    scores = softmax(nn.dense(x, lp["router"]).to(torch.float32))         # (G, g, E)
    vals, idx = top_k(scores, k)                                           # (G, g, k)
    vals = vals / torch.clamp(torch.sum(vals, -1, keepdim=True), min=1e-9)
    m = F.one_hot(idx, E).to(torch.float32)                                # (G, g, k, E)
    # position of each (token, choice) within its expert's capacity
    flat = m.reshape(G, g * k, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, g, k, E)
    pos = torch.sum(pos * m, dim=-1)                                       # (G, g, k)
    keep = (pos < C).to(torch.float32)
    slots = torch.arange(C, dtype=torch.float32, device=x.device)
    oh_pos = (pos[..., None] == slots).to(torch.float32) * keep[..., None]  # (G, g, k, C)
    # one batched product each over the top-k axis; each (e, c) takes at most
    # one choice, so both are exact
    dispatch = torch.einsum("gtke,gtkc->gtec", m, oh_pos)
    combine = torch.einsum("gtke,gtkc->gtec", vals[..., None] * m, oh_pos)
    return {"scores": scores, "vals": vals, "idx": idx, "m": m, "pos": pos, "keep": keep,
            "oh_pos": oh_pos, "dispatch": dispatch, "combine": combine}


def experts(lp: dict, x: torch.Tensor, dispatch: torch.Tensor,
            combine: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on their dispatched slots, combined back: x (G, g, d)
    -> (G, g, d) in x's type. On DTensors each rank runs its groups through its
    experts (``nn.per_shard``), and the combine is a partial sum over the
    experts' ranks."""
    if nn.is_dtensor(x):
        w = {"we_gate": lp["we_gate"], "we_up": lp["we_up"], "we_down": lp["we_down"]}
        gr, er = {0: "groups"}, {0: "experts"}
        ge = {0: "groups", 2: "experts"}
        # the weights come before the masks: the experts split as the weights
        # do (on ``tp``), not as the masks, which are whole on every rank
        return nn.per_shard(
            lambda xl, wg, wu, wd, dl, cl: experts(
                {"we_gate": wg, "we_up": wu, "we_down": wd}, xl, dl, cl),
            [x, w["we_gate"], w["we_up"], w["we_down"], dispatch, combine],
            [gr, er, er, er, ge, ge], [{0: "groups", "sum": "experts"}])
    dt = x.dtype
    xin = torch.einsum("gtec,gtd->egcd", dispatch.to(dt), x)                    # (E,G,C,d)
    h1 = torch.einsum("egcd,edf->egcf", xin, lp["we_gate"].to(dt))
    h2 = torch.einsum("egcd,edf->egcf", xin, lp["we_up"].to(dt))
    act = nn.silu(h1) * h2
    out_e = torch.einsum("egcf,efd->egcd", act, lp["we_down"].to(dt))
    return torch.einsum("gtec,egcd->gtd", combine.to(dt), out_e)


def moe_apply(lp: dict, h: torch.Tensor, cfg: ArchConfig):
    """h: (B, S, d) -> (out (B, S, d), aux load-balance loss)."""
    B, S, d = h.shape
    E = cfg.n_experts
    T = B * S
    g = _group_size(T)
    G = T // g
    C = max(1, int(g * cfg.top_k * cfg.capacity_factor / E))

    x = h.reshape(G, g, d)
    r = route(lp, x, cfg, C)
    y = experts(lp, x, r["dispatch"], r["combine"])

    # Switch-style load-balance loss
    frac_tokens = nn.mean(r["m"].sum(2), dim=1)             # (G, E)
    frac_probs = nn.mean(r["scores"], dim=1)                # (G, E)
    aux = E * nn.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
    return y.reshape(B, S, d), aux
