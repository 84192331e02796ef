"""RWKV-6 "Finch": the port of ``repro/models/rwkv6.py``.

Attention-free, with a data-dependent per-channel decay. The time-mix WKV state
is per head S in R^{hd x hd}:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t,      w_t = exp(-exp(lora(x_t)))
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

``_wkv_chunked`` evaluates it in chunks of ``CHUNK`` = 16 in float32, as the
reference does: within a chunk the pairwise decay factors exp(La[t-1] - La[s])
(s <= t-1, La the cumulative log-decay) form an explicit (c, c, hd) tensor a
head; exponents there are ordered differences of a decreasing sequence, so
<= 0. The intra-chunk terms of every chunk are formed at once; the state is
carried from chunk to chunk in order, as the reference's ``lax.scan`` carries
it. The masked exponents are set to -inf before ``exp`` (the reference takes
``where`` after ``exp``): the values are the same, and the backward pass
stays finite where a masked exponent would overflow.

Decode runs the chunked path with S = 1. Layer parameters are stacked
``[L, ...]`` and each forward pass is a loop over the stack. The recurrent
cache is ``wkv`` (L, B, nh, hd, hd) and the token-shift carries ``sh_a`` and
``sh_f`` (L, B, d), all float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import nn

DP = "fsdp"
TP = "tp"

CHUNK = 16
LORA_R = 64


def dims(cfg: ArchConfig) -> tuple[int, int]:
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd


def rwkv_defs(cfg: ArchConfig) -> dict:
    L, d = cfg.n_layers, cfg.d_model
    nh, hd = dims(cfg)
    f32 = torch.float32

    def mix():
        return nn.Param((L, d), (None, None), init="zeros", dtype=f32)
    return {
        "ln_att": nn.Param((L, d), (None, None), init="ones"),
        "mix_r": mix(), "mix_k": mix(), "mix_v": mix(), "mix_g": mix(), "mix_w": mix(),
        "wr": nn.Param((L, d, d), (None, DP, TP)),
        "wk": nn.Param((L, d, d), (None, DP, TP)),
        "wv": nn.Param((L, d, d), (None, DP, TP)),
        "wg": nn.Param((L, d, d), (None, DP, TP)),
        "w_base": nn.Param((L, d), (None, TP), init="zeros", dtype=f32),
        "w_lora_a": nn.Param((L, d, LORA_R), (None, DP, None)),
        "w_lora_b": nn.Param((L, LORA_R, d), (None, None, TP), init="zeros"),
        "bonus_u": nn.Param((L, nh, hd), (None, TP, None), init="zeros", dtype=f32),
        "ln_out": nn.Param((L, d), (None, TP), init="ones"),
        "wo": nn.Param((L, d, d), (None, TP, DP)),
        "ln_ffn": nn.Param((L, d), (None, None), init="ones"),
        "mix_fk": mix(), "mix_fr": mix(),
        "fk": nn.Param((L, d, cfg.d_ff), (None, DP, TP)),
        "fv": nn.Param((L, cfg.d_ff, d), (None, TP, DP)),
        "fr": nn.Param((L, d, d), (None, DP, TP)),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """Token shift: x_{t-1} with carry-in ``prev`` (B, d), else zeros."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, xp: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    m = torch.sigmoid(mu)[None, None, :]
    return (x.to(torch.float32) * m + xp.to(torch.float32) * (1 - m)).to(x.dtype)


def _wkv_chunked(r, k, v, la, u, s0):
    """r/k/v: (B, S, nh, hd); la: (B, S, nh, hd) log-decay (<= 0); u: (nh, hd);
    s0: (B, nh, hd, hd). Returns (o (B, S, nh, hd) float32, final state). On
    DTensors it runs per shard of batch and heads (``nn.per_shard``)."""
    if nn.is_dtensor(r):
        bh, st = {0: "batch", 2: "heads"}, {0: "batch", 1: "heads"}
        return nn.per_shard(_wkv_chunked, [r, k, v, la, u, s0],
                            [bh, bh, bh, bh, {0: "heads"}, st], [bh, st])
    B, S, nh, hd = r.shape
    c = min(CHUNK, S)
    pad = (-S) % c
    if pad:
        # state-neutral padding: k = 0 adds nothing, log-decay 0 keeps the
        # state; the padded outputs are sliced off below
        r, k, v, la = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, la))
    n = (S + pad) // c
    rs, ks, vs = (t.to(torch.float32).reshape(B, n, c, nh, hd) for t in (r, k, v))
    las = la.to(torch.float32).reshape(B, n, c, nh, hd)
    La = torch.cumsum(las, dim=2)                            # inclusive
    La_ex = La - las                                         # exclusive (= La[t-1])
    # intra-chunk strict lower triangle, pairwise per channel: (B, n, t, s, nh, hd)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)
    diff = La_ex[:, :, :, None] - La[:, :, None, :]
    P = torch.exp(diff.masked_fill(~tri[:, :, None, None], float("-inf")))
    score = torch.einsum("bnthd,bnshd,bntshd->bntsh", rs, ks, P)
    intra = torch.einsum("bntsh,bnshe->bnthe", score, vs)
    diag = torch.einsum("bnthd,hd,bnthd->bnth", rs, u.to(torch.float32), ks)
    # the state at each chunk's start, carried in order
    decay_to_end = torch.exp(La[:, :, -1:] - La)             # (B, n, c, nh, hd)
    ds = torch.einsum("bnshd,bnshe->bnhde", ks * decay_to_end, vs)
    chunk_decay = torch.exp(La[:, :, -1])[..., None]         # (B, n, nh, hd, 1)
    s = s0.to(torch.float32)
    starts = []
    for i in range(n):
        starts.append(s)
        s = chunk_decay[:, i] * s + ds[:, i]
    inter = torch.einsum("bnthd,bnhde->bnthe", rs * torch.exp(La_ex), torch.stack(starts, 1))
    o = inter + intra + diag[..., None] * vs
    o = o.reshape(B, n * c, nh, hd)
    return (o[:, :S] if pad else o), s


def _decay_log(lp: dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent log-decay (<= 0): -exp(base + lora(x)), float32."""
    lora = nn.dense(torch.tanh(nn.dense(xw, lp["w_lora_a"])), lp["w_lora_b"])
    return -torch.exp(torch.clamp(lp["w_base"][None, None] + lora.to(torch.float32), -8.0, 4.0))


def time_mix(lp: dict, x: torch.Tensor, cfg: ArchConfig, wkv_state=None, shift_state=None):
    """x: (B, S, d) -> (out, (wkv_state, last_token))."""
    B, S, d = x.shape
    nh, hd = dims(cfg)
    h = nn.layer_norm(x, lp["ln_att"], torch.zeros_like(lp["ln_att"]), cfg.norm_eps)
    hp = _shift(h, shift_state)
    r = nn.dense(_mix(h, hp, lp["mix_r"]), lp["wr"]).reshape(B, S, nh, hd)
    k = nn.dense(_mix(h, hp, lp["mix_k"]), lp["wk"]).reshape(B, S, nh, hd)
    v = nn.dense(_mix(h, hp, lp["mix_v"]), lp["wv"]).reshape(B, S, nh, hd)
    g = nn.dense(_mix(h, hp, lp["mix_g"]), lp["wg"])
    la = _decay_log(lp, _mix(h, hp, lp["mix_w"])).reshape(B, S, nh, hd)
    s0 = (torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=x.device)
          if wkv_state is None else wkv_state)
    o, s = _wkv_chunked(r, k, v, la, lp["bonus_u"], s0)
    o = o.reshape(B, S, d).to(x.dtype)
    o = nn.rms_norm(o, lp["ln_out"], cfg.norm_eps) * nn.silu(g)
    return x + nn.dense(o, lp["wo"]), (s, h[:, -1])


def channel_mix(lp: dict, x: torch.Tensor, cfg: ArchConfig, shift_state=None):
    h = nn.layer_norm(x, lp["ln_ffn"], torch.zeros_like(lp["ln_ffn"]), cfg.norm_eps)
    hp = _shift(h, shift_state)
    kx = _mix(h, hp, lp["mix_fk"])
    rx = _mix(h, hp, lp["mix_fr"])
    kk = torch.square(torch.relu(nn.dense(kx, lp["fk"])))
    out = nn.sigmoid(nn.dense(rx, lp["fr"])) * nn.dense(kk, lp["fv"])
    return x + out, h[:, -1]


def rwkv_block(lp: dict, x: torch.Tensor, cfg: ArchConfig, states=None):
    """states: (wkv, att_shift, ffn_shift) or None."""
    wkv, sh_a, sh_f = states if states is not None else (None, None, None)
    x, (wkv, sh_a) = time_mix(lp, x, cfg, wkv, sh_a)
    x, sh_f = channel_mix(lp, x, cfg, sh_f)
    return x, (wkv, sh_a, sh_f)


def rwkv_decode_step(lp: dict, x: torch.Tensor, cfg: ArchConfig, states):
    """One token: x (B, d); the exact recurrence through the chunked path at S = 1."""
    wkv, sh_a, sh_f = states
    y, (wkv, sh_a) = time_mix(lp, x[:, None], cfg, wkv, sh_a)
    y, sh_f = channel_mix(lp, y, cfg, sh_f)
    return y[:, 0], (wkv, sh_a, sh_f)


# ---------------------------------------------------------------------------
# The whole model (embed + blocks + head)
# ---------------------------------------------------------------------------

def model_defs(cfg: ArchConfig) -> dict:
    return {
        "embed": nn.Param((cfg.vocab, cfg.d_model), (None, TP), init="embed"),
        "ln0": nn.Param((cfg.d_model,), (None,), init="ones"),
        "blocks": rwkv_defs(cfg),
        "final_norm": nn.Param((cfg.d_model,), (None,), init="ones"),
        "unembed": nn.Param((cfg.d_model, cfg.vocab), (DP, TP)),
    }


def _embed(params: dict, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    return nn.rms_norm(nn.embed_lookup(tokens, params["embed"]), params["ln0"], cfg.norm_eps)


def _train_block(lp: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return nn.shard_act(rwkv_block(lp, x, cfg)[0], ("dp", None, None))


def forward_train(params: dict, cfg: ArchConfig, batch: dict):
    """batch: ``tokens`` and ``labels`` (B, S). Returns (loss, {"xent": loss});
    with ``cfg.remat`` each block is recomputed in the backward pass."""
    x = nn.shard_act(_embed(params, cfg, batch["tokens"]), ("dp", None, None))
    for lp in nn.unstack(params["blocks"]):
        x = (checkpoint(_train_block, lp, x, cfg, use_reentrant=False) if cfg.remat
             else _train_block(lp, x, cfg))
    x = nn.rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = nn.sharded_xent(nn.dense(x, params["unembed"]), batch["labels"])
    return loss, {"xent": loss}


def init_cache(cfg: ArchConfig, B: int, S: int, dtype=torch.bfloat16, *,
               device: torch.device) -> dict:
    nh, hd = dims(cfg)
    L, d = cfg.n_layers, cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"wkv": torch.zeros((L, B, nh, hd, hd), **f32),
            "sh_a": torch.zeros((L, B, d), **f32),
            "sh_f": torch.zeros((L, B, d), **f32),
            "length": torch.zeros((B,), dtype=torch.int32, device=device)}


def _cache(states: list, length: torch.Tensor) -> dict:
    """Per-layer (wkv, sh_a, sh_f) -> the cache, the carries in float32."""
    wkv, sa, sf = zip(*states)
    return {"wkv": torch.stack(wkv), "sh_a": torch.stack(sa).to(torch.float32),
            "sh_f": torch.stack(sf).to(torch.float32), "length": length}


def forward_prefill(params: dict, cfg: ArchConfig, batch: dict):
    """Returns (last-position logits, the recurrent cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _embed(params, cfg, tokens)
    states = []
    for lp in nn.unstack(params["blocks"]):
        x, st = rwkv_block(lp, x, cfg)
        states.append(st)
    x = nn.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    length = torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    return nn.dense(x, params["unembed"]), _cache(states, length)


def forward_decode(params: dict, cfg: ArchConfig, cache: dict, token: torch.Tensor,
                   positions=None):
    """One token (B,) against the recurrent cache. Returns (logits, new cache)."""
    x = _embed(params, cfg, token)
    states = []
    for i, lp in enumerate(nn.unstack(params["blocks"])):
        x, st = rwkv_decode_step(lp, x, cfg, (cache["wkv"][i], cache["sh_a"][i],
                                              cache["sh_f"][i]))
        states.append(st)
    x = nn.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return nn.dense(x, params["unembed"]), _cache(states, cache["length"] + 1)
