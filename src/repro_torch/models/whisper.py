"""The Whisper-tiny encoder-decoder backbone: the port of ``repro/models/whisper.py``.

The conv/mel frontend is stubbed, as in the reference: ``batch["audio_embeds"]``
(B, n_audio_ctx, d) goes straight into the encoder. Pre-RMSNorm, GELU MLP,
projections without bias, sinusoidal encoder positions and learned decoder
positions (``MAX_DEC_POS`` of them), multi-head attention (K/V heads =
``n_heads``, not ``n_kv_heads``), the unembedding tied to the token embedding.

Decode runs the decoder against its self-attention K/V cache (``k``, ``v``:
(L, B, S + 128, H, hd)) and the cross-attention K/V computed once at prefill
(``xk``, ``xv``: (L, B, n_audio_ctx, H, hd)), all bfloat16.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import nn
from .attention import decode_attention, flash_attention
from .transformer import cache_len

DP = "fsdp"
TP = "tp"

MAX_DEC_POS = 65_536  # the learned decoder position table


def _attn_defs(L: int, d: int, heads: int, hd: int) -> dict:
    return {
        "norm": nn.Param((L, d), (None, None), init="ones"),
        "wq": nn.Param((L, d, heads * hd), (None, DP, TP)),
        "wk": nn.Param((L, d, heads * hd), (None, DP, TP)),
        "wv": nn.Param((L, d, heads * hd), (None, DP, TP)),
        "wo": nn.Param((L, heads * hd, d), (None, TP, DP)),
    }


def _mlp_defs(L: int, d: int, f: int) -> dict:
    return {
        "norm": nn.Param((L, d), (None, None), init="ones"),
        "w_up": nn.Param((L, d, f), (None, DP, TP)),
        "b_up": nn.Param((L, f), (None, TP), init="zeros"),
        "w_down": nn.Param((L, f, d), (None, TP, DP)),
        "b_down": nn.Param((L, d), (None, DP), init="zeros"),
    }


def model_defs(cfg: ArchConfig) -> dict:
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    Le, Ld = cfg.n_enc_layers, cfg.n_layers
    return {
        "enc": {"self": _attn_defs(Le, d, H, hd), "mlp": _mlp_defs(Le, d, cfg.d_ff),
                "final_norm": nn.Param((d,), (None,), init="ones")},
        "dec": {"embed": nn.Param((cfg.vocab, d), (None, TP), init="embed"),
                "pos": nn.Param((MAX_DEC_POS, d), (None, TP), init="embed"),
                "self": _attn_defs(Ld, d, H, hd),
                "cross": _attn_defs(Ld, d, H, hd),
                "mlp": _mlp_defs(Ld, d, cfg.d_ff),
                "final_norm": nn.Param((d,), (None,), init="ones")},
    }


def _sin_pos(n: int, d: int, device=None) -> torch.Tensor:
    """Sinusoidal positions (n, d) in float32: sines, then cosines."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _attn(lp: dict, x: torch.Tensor, cfg: ArchConfig, causal: bool,
          kv_src: torch.Tensor | None = None):
    """Attention of x over itself (``kv_src`` None) or over ``kv_src`` (cross
    attention, which normalises ``kv_src`` with the same ``norm`` weights).
    Returns (x + out, (k, v))."""
    B, S, _ = x.shape
    hd, H = cfg.hd, cfg.n_heads
    h = nn.rms_norm(x, lp["norm"], cfg.norm_eps)
    hk = h if kv_src is None else nn.rms_norm(kv_src, lp["norm"], cfg.norm_eps)
    Sk = hk.shape[1]
    q = nn.dense(h, lp["wq"]).reshape(B, S, H, hd)
    k = nn.dense(hk, lp["wk"]).reshape(B, Sk, H, hd)
    v = nn.dense(hk, lp["wv"]).reshape(B, Sk, H, hd)
    o = flash_attention(q, k, v, causal=causal)
    return x + nn.dense(o.reshape(B, S, -1), lp["wo"]), (k, v)


def _mlp(lp: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = nn.rms_norm(x, lp["norm"], cfg.norm_eps)
    return x + nn.gelu_mlp(h, lp["w_up"], lp["b_up"], lp["w_down"], lp["b_down"])


def _layers(*stacks: dict) -> list[tuple[dict, ...]]:
    return list(zip(*(nn.unstack(s) for s in stacks)))


def _enc_block(sa: dict, ml: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x, _ = _attn(sa, x, cfg, causal=False)
    return nn.shard_act(_mlp(ml, x, cfg), ("dp", None, None))


def encode(params: dict, cfg: ArchConfig, audio_embeds: torch.Tensor) -> torch.Tensor:
    """audio_embeds: (B, n_audio_ctx, d) from the stubbed conv frontend."""
    enc = params["enc"]
    x = audio_embeds + _sin_pos(audio_embeds.shape[1], cfg.d_model,
                                audio_embeds.device).to(audio_embeds.dtype)
    for sa, ml in _layers(enc["self"], enc["mlp"]):
        x = (checkpoint(_enc_block, sa, ml, x, cfg, use_reentrant=False) if cfg.remat
             else _enc_block(sa, ml, x, cfg))
    return nn.rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _dec_block(sa, ca, ml, x, enc_out, cfg):
    x = nn.shard_act(x, ("dp", None, None))
    x, (ks, vs) = _attn(sa, x, cfg, causal=True)
    x, (kc, vc) = _attn(ca, x, cfg, causal=False, kv_src=enc_out)
    return _mlp(ml, x, cfg), (ks, vs, kc, vc)


def _decoder(params: dict, cfg: ArchConfig, tokens: torch.Tensor, enc_out: torch.Tensor,
             collect_cache: bool = False, Smax: int | None = None):
    """The decoder over ``tokens`` (B, S). Returns (x after the final norm, the
    cache's k, v, xk, xv stacked over layers when ``collect_cache``)."""
    dec = params["dec"]
    S = tokens.shape[1]
    x = nn.embed_lookup(tokens, dec["embed"]) + dec["pos"][:S].to(torch.bfloat16)
    caches = []
    for sa, ca, ml in _layers(dec["self"], dec["cross"], dec["mlp"]):
        args = (sa, ca, ml, x, enc_out, cfg)
        x, (ks, vs, kc, vc) = (checkpoint(_dec_block, *args, use_reentrant=False)
                               if cfg.remat and not collect_cache else _dec_block(*args))
        if collect_cache:
            caches.append((nn.cache_slots(ks, Smax - S), nn.cache_slots(vs, Smax - S),
                           kc.to(torch.bfloat16), vc.to(torch.bfloat16)))
    x = nn.rms_norm(x, dec["final_norm"], cfg.norm_eps)
    return x, ([torch.stack(c) for c in zip(*caches)] if collect_cache else None)


def forward_train(params: dict, cfg: ArchConfig, batch: dict):
    """batch: ``tokens``, ``labels`` (B, S) and ``audio_embeds`` (B,
    n_audio_ctx, d). Returns (loss, {"xent": loss})."""
    enc_out = encode(params, cfg, batch["audio_embeds"])
    x, _ = _decoder(params, cfg, batch["tokens"], enc_out)
    logits = nn.dense(x, params["dec"]["embed"].T)             # tied embeddings
    loss = nn.sharded_xent(logits, batch["labels"])
    return loss, {"xent": loss}


def init_cache(cfg: ArchConfig, B: int, S: int, dtype=torch.bfloat16, *,
               device: torch.device) -> dict:
    L, H, hd = cfg.n_layers, cfg.n_heads, cfg.hd
    kv = dict(dtype=dtype, device=device)
    return {"k": torch.zeros((L, B, cache_len(S), H, hd), **kv),
            "v": torch.zeros((L, B, cache_len(S), H, hd), **kv),
            "xk": torch.zeros((L, B, cfg.n_audio_ctx, H, hd), **kv),
            "xv": torch.zeros((L, B, cfg.n_audio_ctx, H, hd), **kv),
            "length": torch.zeros((B,), dtype=torch.int32, device=device)}


def forward_prefill(params: dict, cfg: ArchConfig, batch: dict):
    """Returns (last-position logits, the populated cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    enc_out = encode(params, cfg, batch["audio_embeds"])
    x, (ks, vs, xks, xvs) = _decoder(params, cfg, tokens, enc_out, collect_cache=True,
                                     Smax=cache_len(S))
    logits = nn.dense(x[:, -1], params["dec"]["embed"].T)
    return logits, {"k": ks, "v": vs, "xk": xks, "xv": xvs,
                    "length": torch.full((B,), S, dtype=torch.int32, device=tokens.device)}


def forward_decode(params: dict, cfg: ArchConfig, cache: dict, token: torch.Tensor,
                   positions=None):
    """One token (B,) at decoder position ``length``. Returns (logits, new cache)."""
    dec = params["dec"]
    B = token.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    length = cache["length"]
    x = nn.embed_lookup(token, dec["embed"]) + \
        dec["pos"][length.to(torch.int64)].to(torch.bfloat16)
    ks, vs = [], []
    layers = _layers(dec["self"], dec["cross"], dec["mlp"])
    for i, (sa, ca, ml) in enumerate(layers):
        kc, vc, xk, xv = (cache[n][i] for n in ("k", "v", "xk", "xv"))
        h = nn.rms_norm(x[:, None], sa["norm"], cfg.norm_eps)
        q = nn.dense(h, sa["wq"]).reshape(B, 1, H, hd)
        k = nn.dense(h, sa["wk"]).reshape(B, 1, H, hd)
        v = nn.dense(h, sa["wv"]).reshape(B, 1, H, hd)
        onehot = (torch.arange(kc.shape[1], device=x.device)[None, :]
                  == length[:, None])[:, :, None, None]
        kc = torch.where(onehot, k.to(kc.dtype), kc)
        vc = torch.where(onehot, v.to(vc.dtype), vc)
        o = decode_attention(q[:, 0], kc, vc, length + 1)
        x = x + nn.dense(o.reshape(B, -1), sa["wo"])
        # cross attention over the fixed encoder context
        h = nn.rms_norm(x[:, None], ca["norm"], cfg.norm_eps)
        q = nn.dense(h, ca["wq"]).reshape(B, H, hd)
        full = torch.full((B,), xk.shape[1], dtype=torch.int32, device=x.device)
        o = decode_attention(q, xk, xv, full)
        x = x + nn.dense(o.reshape(B, -1), ca["wo"])
        h = nn.rms_norm(x[:, None], ml["norm"], cfg.norm_eps)
        x = x + nn.gelu_mlp(h, ml["w_up"], ml["b_up"], ml["w_down"], ml["b_down"])[:, 0]
        ks.append(kc)
        vs.append(vc)
    x = nn.rms_norm(x, dec["final_norm"], cfg.norm_eps)
    return nn.dense(x, dec["embed"].T), {"k": torch.stack(ks), "v": torch.stack(vs),
                                         "xk": cache["xk"], "xv": cache["xv"],
                                         "length": length + 1}
