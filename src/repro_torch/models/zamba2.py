"""Zamba2: a Mamba2 backbone plus one weight-shared attention block, the port of
``repro/models/zamba2.py``.

The backbone is ``n_layers`` Mamba2 blocks in K = ``n_layers //
shared_attn_every`` superblocks. Before each superblock the shared transformer
block (attention + SwiGLU MLP, one set of weights for every invocation) runs
on concat(hidden, the token embedding), projected back to d_model by the
invocation's own ``fuse_proj``. Each invocation keeps its own K/V cache.

Cache: ``k``, ``v`` (K, B, S + 128, KVH, hd) bfloat16; ``ssm`` (L, B, nh, hd,
ds) float32; ``conv`` (L, B, W - 1, C), float32 from ``init_cache`` and
bfloat16 after a prefill or a decode step (``mamba2._conv`` keeps the last
inputs in the activations' type), as in the reference.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import mamba2, nn
from .attention import apply_rope, decode_attention, flash_attention
from .transformer import cache_len

DP = "fsdp"
TP = "tp"


def n_invocations(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_every


def model_defs(cfg: ArchConfig) -> dict:
    d, hd = cfg.d_model, cfg.hd
    K = n_invocations(cfg)
    shared = {
        "attn_norm": nn.Param((d,), (None,), init="ones"),
        "wq": nn.Param((d, cfg.n_heads * hd), (DP, TP)),
        "wk": nn.Param((d, cfg.n_kv_heads * hd), (DP, TP)),
        "wv": nn.Param((d, cfg.n_kv_heads * hd), (DP, TP)),
        "wo": nn.Param((cfg.n_heads * hd, d), (TP, DP)),
        "mlp_norm": nn.Param((d,), (None,), init="ones"),
        "w_gate": nn.Param((d, cfg.d_ff), (DP, TP)),
        "w_up": nn.Param((d, cfg.d_ff), (DP, TP)),
        "w_down": nn.Param((cfg.d_ff, d), (TP, DP)),
    }
    return {
        "embed": nn.Param((cfg.vocab, cfg.d_model), (None, TP), init="embed"),
        "shared": shared,
        "fuse_proj": nn.Param((K, 2 * d, d), (None, DP, TP)),
        "mamba": mamba2.mamba_defs(cfg, cfg.n_layers),
        "final_norm": nn.Param((d,), (None,), init="ones"),
        "unembed": nn.Param((d, cfg.vocab), (DP, TP)),
    }


def _shared_block_train(sp: dict, h: torch.Tensor, cfg: ArchConfig, pos: torch.Tensor):
    B, S, _ = h.shape
    hd = cfg.hd
    a = nn.rms_norm(h, sp["attn_norm"], cfg.norm_eps)
    q = apply_rope(nn.dense(a, sp["wq"]).reshape(B, S, cfg.n_heads, hd), pos, cfg.rope_theta)
    k = apply_rope(nn.dense(a, sp["wk"]).reshape(B, S, cfg.n_kv_heads, hd), pos, cfg.rope_theta)
    v = nn.dense(a, sp["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    o = flash_attention(q, k, v, causal=True)
    h = h + nn.dense(o.reshape(B, S, -1), sp["wo"])
    m = nn.rms_norm(h, sp["mlp_norm"], cfg.norm_eps)
    return h + nn.swiglu(m, sp["w_gate"], sp["w_up"], sp["w_down"]), (k, v)


def _stack_mamba(params_mamba: dict, K: int) -> list[list[dict]]:
    """The ``[L, ...]`` Mamba stack as K superblocks of L / K per-layer dicts."""
    layers = nn.unstack(params_mamba)
    per = len(layers) // K
    return [layers[j * per:(j + 1) * per] for j in range(K)]


def _superblock(sp, fuse, mp, x, e0, cfg, pos):
    """The shared block, then this superblock's Mamba blocks. Returns (x, k, v,
    its layers' ssm states, their conv states)."""
    h = nn.dense(torch.cat([x, e0], dim=-1), fuse)
    h, (k, v) = _shared_block_train(sp, h, cfg, pos)
    x = x + h
    ssms, convs = [], []
    for lp in mp:
        x, (ssm, conv) = mamba2.mamba_block(lp, x, cfg)
        x = nn.shard_act(x, ("dp", None, None))
        ssms.append(ssm)
        convs.append(conv)
    return x, k, v, ssms, convs


def _start(params: dict, tokens: torch.Tensor):
    B, S = tokens.shape
    x = nn.shard_act(nn.embed_lookup(tokens, params["embed"]), ("dp", None, None))
    pos = torch.arange(S, dtype=torch.int32, device=tokens.device).expand(B, S)
    return x, pos


def forward_train(params: dict, cfg: ArchConfig, batch: dict):
    """batch: ``tokens`` and ``labels`` (B, S). Returns (loss, {"xent": loss});
    with ``cfg.remat`` each superblock is recomputed in the backward pass."""
    x, pos = _start(params, batch["tokens"])
    e0 = x
    K = n_invocations(cfg)
    for fuse, mp in zip(torch.unbind(params["fuse_proj"], 0), _stack_mamba(params["mamba"], K)):
        args = (params["shared"], fuse, mp, nn.shard_act(x, ("dp", None, None)), e0, cfg, pos)
        x = (checkpoint(_superblock, *args, use_reentrant=False) if cfg.remat
             else _superblock(*args))[0]
    x = nn.rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = nn.sharded_xent(nn.dense(x, params["unembed"]), batch["labels"])
    return loss, {"xent": loss}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, B: int, S: int, dtype=torch.bfloat16, *,
               device: torch.device) -> dict:
    K = n_invocations(cfg)
    d_inner, nh, hd_s, ds = mamba2.dims(cfg)
    kv = (K, B, cache_len(S), cfg.n_kv_heads, cfg.hd)
    f32 = dict(dtype=torch.float32, device=device)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "ssm": torch.zeros((cfg.n_layers, B, nh, hd_s, ds), **f32),
            "conv": torch.zeros((cfg.n_layers, B, cfg.conv_width - 1, d_inner + 2 * ds), **f32),
            "length": torch.zeros((B,), dtype=torch.int32, device=device)}


def forward_prefill(params: dict, cfg: ArchConfig, batch: dict):
    """Returns (last-position logits, the populated cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x, pos = _start(params, tokens)
    e0 = x
    K = n_invocations(cfg)
    ks, vs, ssms, convs = [], [], [], []
    for fuse, mp in zip(torch.unbind(params["fuse_proj"], 0), _stack_mamba(params["mamba"], K)):
        x, k, v, ssm, conv = _superblock(params["shared"], fuse, mp, x, e0, cfg, pos)
        ks.append(nn.cache_slots(k, cache_len(S) - S))
        vs.append(nn.cache_slots(v, cache_len(S) - S))
        ssms += ssm
        convs += conv
    x = nn.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs), "ssm": torch.stack(ssms),
             "conv": torch.stack(convs),
             "length": torch.full((B,), S, dtype=torch.int32, device=tokens.device)}
    return nn.dense(x, params["unembed"]), cache


def forward_decode(params: dict, cfg: ArchConfig, cache: dict, token: torch.Tensor,
                   positions=None):
    """One token (B,) against the cache. Writes this step's K/V at index
    ``length`` of a copy of each invocation's cache. Returns (logits, new cache)."""
    B = token.shape[0]
    K = n_invocations(cfg)
    per = cfg.shared_attn_every
    x = nn.embed_lookup(token, params["embed"])
    e0 = x
    length = cache["length"]
    pos = length[:, None]
    sp = params["shared"]
    hd = cfg.hd
    ks, vs, ssms, convs = [], [], [], []
    superblocks = _stack_mamba(params["mamba"], K)
    for j, (fuse, mp) in enumerate(zip(torch.unbind(params["fuse_proj"], 0), superblocks)):
        kc, vc = cache["k"][j], cache["v"][j]
        h = nn.dense(torch.cat([x, e0], dim=-1), fuse)
        a = nn.rms_norm(h[:, None], sp["attn_norm"], cfg.norm_eps)
        q = apply_rope(nn.dense(a, sp["wq"]).reshape(B, 1, cfg.n_heads, hd), pos, cfg.rope_theta)
        k = apply_rope(nn.dense(a, sp["wk"]).reshape(B, 1, cfg.n_kv_heads, hd), pos,
                       cfg.rope_theta)
        v = nn.dense(a, sp["wv"]).reshape(B, 1, cfg.n_kv_heads, hd)
        onehot = (torch.arange(kc.shape[1], device=x.device)[None, :]
                  == length[:, None])[:, :, None, None]
        kc = torch.where(onehot, k.to(kc.dtype), kc)
        vc = torch.where(onehot, v.to(vc.dtype), vc)
        o = decode_attention(q[:, 0], kc, vc, length + 1)
        h = h + nn.dense(o.reshape(B, -1), sp["wo"])
        m = nn.rms_norm(h[:, None], sp["mlp_norm"], cfg.norm_eps)
        h = h + nn.swiglu(m, sp["w_gate"], sp["w_up"], sp["w_down"])[:, 0]
        x = x + h
        for i, lp in enumerate(mp):
            layer = j * per + i
            x, (ssm, conv) = mamba2.mamba_decode_step(lp, x, cfg, cache["ssm"][layer],
                                                      cache["conv"][layer])
            ssms.append(ssm)
            convs.append(conv)
        ks.append(kc)
        vs.append(vc)
    x = nn.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return nn.dense(x, params["unembed"]), {
        "k": torch.stack(ks), "v": torch.stack(vs), "ssm": torch.stack(ssms),
        "conv": torch.stack(convs), "length": length + 1}
