"""The GQA decoder: the port of ``repro/models/transformer.py`` (dense, MoE and
M-RoPE variants).

Pre-RMSNorm, SwiGLU, full RoPE, grouped-query attention; the MoE family (dbrx,
llama4-scout) swaps the FFN for ``moe.moe_apply`` (plus a shared SwiGLU
expert where the config has one), and the VLM backbone (qwen2-vl) rotates q
and k by M-RoPE over ``batch["positions"]`` (B, 3, S). Layer parameters are
stacked ``[L, ...]`` and every forward pass is a Python loop over the stack.
``forward_train`` gives the training loss; the serving entry points mirror the
reference one for one:

* ``forward_prefill`` -- prompt -> last-position logits + the K/V cache
  (``batch["lengths"]`` marks true lengths of right-padded prompts);
* ``forward_prefill_suffix`` -- a prompt suffix against a cached prefix;
* ``forward_decode`` -- one token against a contiguous cache (M-RoPE positions
  default to the cache length on all three axes);
* ``forward_decode_paged`` -- one token against the pool's page view, through
  ``serve/kvpool/attention.paged_decode_attention`` (K7 when ``use_kernels``).
  It takes no positions: ``zoo.build`` offers it only where the reference does
  (not for M-RoPE).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import moe as moe_mod
from . import nn
from .attention import (apply_mrope, apply_rope, decode_attention, flash_attention,
                        prefix_attention)

CACHE_MARGIN = 128  # decode slots past the prefill length
DP = "fsdp"
TP = "tp"
FAMILIES = ("dense", "moe", "vlm")


def layer_defs(cfg: ArchConfig) -> dict:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"{cfg.family} layers are not ported yet "
                                  "(ROADMAP, queue 1 item 5)")
    L, d, hd = cfg.n_layers, cfg.d_model, cfg.hd
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
    defs = {
        "attn_norm": nn.Param((L, d), (None, None), init="ones"),
        "wq": nn.Param((L, d, qd), (None, DP, TP)),
        "wk": nn.Param((L, d, kvd), (None, DP, TP)),
        "wv": nn.Param((L, d, kvd), (None, DP, TP)),
        "wo": nn.Param((L, qd, d), (None, TP, DP)),
        "mlp_norm": nn.Param((L, d), (None, None), init="ones"),
    }
    if cfg.n_experts:
        defs.update(moe_mod.moe_defs(cfg))
    if not cfg.n_experts or cfg.shared_expert:
        ffn = "ws" if cfg.n_experts else "w"        # the shared expert, or the dense FFN
        defs.update({
            f"{ffn}_gate": nn.Param((L, d, cfg.d_ff), (None, DP, TP)),
            f"{ffn}_up": nn.Param((L, d, cfg.d_ff), (None, DP, TP)),
            f"{ffn}_down": nn.Param((L, cfg.d_ff, d), (None, TP, DP)),
        })
    return defs


def model_defs(cfg: ArchConfig) -> dict:
    return {
        "embed": nn.Param((cfg.vocab, cfg.d_model), (None, TP), init="embed"),
        "layers": layer_defs(cfg),
        "final_norm": nn.Param((cfg.d_model,), (None,), init="ones"),
        "unembed": nn.Param((cfg.d_model, cfg.vocab), (DP, TP)),
    }


def _layer(params: dict, i: int) -> dict:
    return {name: w[i] for name, w in params["layers"].items()}


def _ffn(lp: dict, h: torch.Tensor, cfg: ArchConfig):
    """Returns (out, aux_loss)."""
    if cfg.n_experts:
        out, aux = moe_mod.moe_apply(lp, h, cfg)
        if cfg.shared_expert:
            out = out + nn.swiglu(h, lp["ws_gate"], lp["ws_up"], lp["ws_down"])
        return out, aux
    return (nn.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _qkv(lp: dict, h: torch.Tensor, cfg: ArchConfig, pos: torch.Tensor):
    B, S, _ = h.shape
    hd = cfg.hd
    q = nn.shard_act(nn.dense(h, lp["wq"]).reshape(B, S, cfg.n_heads, hd),
                     ("dp", None, "tp", None))
    k = nn.shard_act(nn.dense(h, lp["wk"]).reshape(B, S, cfg.n_kv_heads, hd),
                     ("dp", None, "tp", None))
    v = nn.shard_act(nn.dense(h, lp["wv"]).reshape(B, S, cfg.n_kv_heads, hd),
                     ("dp", None, "tp", None))
    if cfg.mrope_sections is not None:
        return (apply_mrope(q, pos, cfg.mrope_sections, cfg.rope_theta),
                apply_mrope(k, pos, cfg.mrope_sections, cfg.rope_theta), v)
    return apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta), v


def _logits_at(params: dict, cfg: ArchConfig, x: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """Final norm + unembed at position ``lengths - 1`` of each row."""
    x_last = x[torch.arange(x.shape[0], device=x.device), lengths.to(torch.int64) - 1]
    return nn.dense(nn.rms_norm(x_last, params["final_norm"], cfg.norm_eps),
                    params["unembed"])


def _block_train(lp: dict, x: torch.Tensor, cfg: ArchConfig,
                 pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    x = nn.shard_act(x, ("dp", None, None))
    h = nn.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q, k, v = _qkv(lp, h, cfg, pos)
    o = flash_attention(q, k, v, causal=True)
    x = x + nn.dense(o.reshape(B, S, -1), lp["wo"])
    h = nn.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    f, aux = _ffn(lp, h, cfg)
    return x + f, aux


def _positions(cfg: ArchConfig, batch: dict, S: int, B: int) -> torch.Tensor:
    """M-RoPE: ``batch["positions"]`` (B, 3, S), which the caller supplies (the
    reference's ``input_specs`` rule: the vision frontend is stubbed). Else
    positions 0..S-1 for every row."""
    if cfg.mrope_sections is not None:
        if batch.get("positions") is None:
            raise ValueError(f"{cfg.arch_id} takes M-RoPE position ids: "
                             "batch['positions'] of shape (B, 3, S)")
        return batch["positions"]
    return torch.arange(S, dtype=torch.int32, device=batch["tokens"].device).expand(B, S)


def forward_train(params: dict, cfg: ArchConfig, batch: dict):
    """batch: ``tokens`` and ``labels`` (B, S). Returns (loss, {"xent": loss}).

    Parameter groups pass through ``nn.grad_tap`` at their use sites (embed,
    the layer stack, final_norm, unembed), the reference's gradient
    boundaries. The stack is split into layers with one ``torch.unbind`` a
    leaf, whose backward stacks the layers' gradients once. With
    ``cfg.remat`` each layer is recomputed in the backward pass
    (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint`` over
    the reference's scan body). The loss adds ``0.01`` times the sum of the
    layers' auxiliary losses (MoE load balance; 0 in the dense family) to
    the cross entropy; ``aux["xent"]`` is the cross entropy alone. M-RoPE
    configs read ``batch["positions"]``.
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = nn.shard_act(nn.embed_lookup(tokens, nn.grad_tap(params["embed"], "embed")),
                     ("dp", None, None))
    pos = _positions(cfg, batch, S, B)
    stack = nn.grad_tap(params["layers"], "layers")
    names = sorted(stack)
    auxs = []
    for slices in zip(*(torch.unbind(stack[n], 0) for n in names)):
        lp = dict(zip(names, slices))
        if cfg.remat:
            x, aux = checkpoint(_block_train, lp, x, cfg, pos, use_reentrant=False)
        else:
            x, aux = _block_train(lp, x, cfg, pos)
        x = nn.shard_act(x, ("dp", None, None))
        auxs.append(aux)
    x = nn.rms_norm(x, nn.grad_tap(params["final_norm"], "final_norm"), cfg.norm_eps)
    logits = nn.shard_act(nn.dense(x, nn.grad_tap(params["unembed"], "unembed")),
                          ("dp", None, "tp"))
    loss = nn.sharded_xent(logits, batch["labels"])
    return loss + 0.01 * torch.sum(torch.stack(auxs)), {"xent": loss}


def cache_len(S: int) -> int:
    return S + CACHE_MARGIN


def init_cache(cfg: ArchConfig, B: int, S: int, dtype=torch.bfloat16, *,
               device: torch.device) -> dict:
    kv = (cfg.n_layers, B, cache_len(S), cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "length": torch.zeros((B,), dtype=torch.int32, device=device)}


def forward_prefill(params: dict, cfg: ArchConfig, batch: dict):
    """Returns (last-position logits, populated cache).

    Optional ``batch["lengths"]`` (B,) marks true prompt lengths of
    right-padded ``tokens``: logits are taken at ``lengths - 1`` and the cache
    length is ``lengths``. Padded positions still write K/V; causal masking
    keeps true positions exact and decode masks the tail by length.
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    x = nn.embed_lookup(tokens, params["embed"])
    pos = _positions(cfg, batch, S, B)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = nn.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(lp, h, cfg, pos)
        o = flash_attention(q, k, v, causal=True)
        x = x + nn.dense(o.reshape(B, S, -1), lp["wo"])
        h = nn.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(lp, h, cfg)[0]
        pad = (0, 0, 0, 0, 0, CACHE_MARGIN)
        ks.append(torch.nn.functional.pad(k, pad).to(torch.bfloat16))
        vs.append(torch.nn.functional.pad(v, pad).to(torch.bfloat16))
    if "lengths" in batch:
        lengths = batch["lengths"].to(torch.int32)
    else:
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    logits = _logits_at(params, cfg, x, lengths)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs), "length": lengths}


def forward_prefill_suffix(params: dict, cfg: ArchConfig, prefix: dict, batch: dict):
    """Prefill a prompt suffix against cached prefix K/V (prefix-sharing admission).

    prefix: ``{"k": (L, B, Sk, KVH, hd), "v": ..., "length": (B,)}``, valid
    below ``length``; batch: ``tokens`` (B, Ssuf) right-padded, ``lengths``
    (B,) true suffix lengths. Suffix queries are RoPE'd at ``prefix_len + i``.
    Returns (last-true-position logits, ``{"k", "v"}`` of the suffix's own K/V
    (L, B, Ssuf, KVH, hd) and ``length`` = prefix + suffix).
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    x = nn.embed_lookup(tokens, params["embed"])
    prefix_len = prefix["length"].to(torch.int32)
    pos = prefix_len[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = nn.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(lp, h, cfg, pos)
        o = prefix_attention(q, prefix["k"][i], prefix["v"][i], prefix_len, k, v)
        x = x + nn.dense(o.reshape(B, S, -1), lp["wo"])
        h = nn.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(lp, h, cfg)[0]
        ks.append(k.to(torch.bfloat16))
        vs.append(v.to(torch.bfloat16))
    lengths = batch["lengths"].to(torch.int32)
    logits = _logits_at(params, cfg, x, lengths)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "length": prefix_len + lengths}


def forward_decode(params: dict, cfg: ArchConfig, cache: dict, token: torch.Tensor,
                   positions: torch.Tensor | None = None):
    """One decode step. token: (B,) int. Returns (logits, new cache).

    Writes this step's K/V at index ``length`` of a copy of the cache, then
    attends over the valid prefix; the input cache is left as it was. M-RoPE
    configs rotate by ``positions`` (B, 3, 1), by default the cache length on
    all three axes.
    """
    B = token.shape[0]
    x = nn.embed_lookup(token, params["embed"])          # (B, d)
    length = cache["length"]
    if cfg.mrope_sections is not None:
        pos = positions if positions is not None else \
            length[:, None, None].expand(B, 3, 1)
    else:
        pos = length[:, None]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        kc, vc = cache["k"][i], cache["v"][i]
        h = nn.rms_norm(x[:, None], lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(lp, h, cfg, pos)
        onehot = (torch.arange(kc.shape[1], device=x.device)[None, :]
                  == length[:, None])[:, :, None, None]
        kc = torch.where(onehot, k.to(kc.dtype), kc)
        vc = torch.where(onehot, v.to(vc.dtype), vc)
        o = decode_attention(q[:, 0], kc, vc, length + 1)
        x = x + nn.dense(o.reshape(B, -1), lp["wo"])
        h = nn.rms_norm(x[:, None], lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(lp, h, cfg)[0][:, 0]
        ks.append(kc)
        vs.append(vc)
    x = nn.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = nn.dense(x, params["unembed"])
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs), "length": length + 1}


def forward_decode_paged(params: dict, cfg: ArchConfig, pages: dict, token: torch.Tensor,
                         *, use_kernels: bool = True):
    """One decode step over the pool's page view.

    pages: ``{"k": (L, B, P, ps, KVH, hd), "v": ..., "length": (B,)}`` as
    ``PagePool.gather_pages`` emits it. Attention runs per page through the
    flash-decoding partials (K7 when ``use_kernels``); this step's K/V is
    folded into the softmax (it sits at position ``length``, past every page)
    and returned for the pool append. Returns ``(logits, (k_new, v_new))``,
    each (L, B, KVH, hd).
    """
    from ..serve.kvpool import attention as paged_attn   # serve imports the models

    B = token.shape[0]
    x = nn.embed_lookup(token, params["embed"])
    length = pages["length"]
    pos = length[:, None]            # M-RoPE configs have no paged decode (zoo.build)
    k_new, v_new = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = nn.rms_norm(x[:, None], lp["attn_norm"], cfg.norm_eps)
        q, k, v = _qkv(lp, h, cfg, pos)
        o = paged_attn.paged_decode_attention(
            q[:, 0], pages["k"][i], pages["v"][i], length, k_new=k[:, 0], v_new=v[:, 0],
            use_kernels=use_kernels)
        x = x + nn.dense(o.reshape(B, -1), lp["wo"])
        h = nn.rms_norm(x[:, None], lp["mlp_norm"], cfg.norm_eps)
        x = x + _ffn(lp, h, cfg)[0][:, 0]
        k_new.append(k[:, 0])
        v_new.append(v[:, 0])
    x = nn.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = nn.dense(x, params["unembed"])
    return logits, (torch.stack(k_new), torch.stack(v_new))
