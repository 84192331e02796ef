"""Attention: RoPE, chunked flash attention, the prefix and decode paths.

The port of ``repro/models/attention.py`` for the dense decoder. Everything is
plain PyTorch in float32, as the reference computes it outside any Pallas
kernel: ``flash_attention`` is the chunked online softmax (q and kv chunks,
causal masking with ``where``), ``attention_reference`` the naive oracle,
``prefix_attention`` the suffix prefill against a cached prefix, and
``decode_attention`` one token against a contiguous cache. The decode kernel
(K7) sits behind ``serve/kvpool/attention.py``. M-RoPE waits for the VLM
family.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _pick_chunk(s: int, target: int) -> int:
    """Largest divisor of s that is <= target."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (B, S, H, D), pos: (B, S) int."""
    d2 = x.shape[-1] // 2
    ang = pos[:, :, None].to(torch.float32) * rope_freqs(x.shape[-1], theta, x.device)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :d2].to(torch.float32), x[..., d2:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_chunk: int = 512,
                    kv_chunk: int = 512) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, KVH, D), H % KVH == 0 (GQA).

    Online softmax over kv chunks inside a loop over q chunks, float32
    statistics and accumulator; output (B, Sq, H, D) in q's type.
    """
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    G = H // KVH
    scale = D ** -0.5
    q_chunk = _pick_chunk(Sq, q_chunk)
    kv_chunk = _pick_chunk(Sk, kv_chunk)
    qs = q.reshape(B, Sq, KVH, G, D).to(torch.float32)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    pos_q = torch.arange(Sq, device=q.device)
    pos_k = torch.arange(Sk, device=q.device)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qb, qp = qs[:, q0:q0 + q_chunk], pos_q[q0:q0 + q_chunk]
        m = torch.full((B, q_chunk, KVH, G), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, q_chunk, KVH, G), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, q_chunk, KVH, G, D), dtype=torch.float32, device=q.device)
        for k0 in range(0, Sk, kv_chunk):
            kb, vb = kf[:, k0:k0 + kv_chunk], vf[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qb, kb) * scale
            if causal:
                kp = pos_k[k0:k0 + kv_chunk]
                s = torch.where((qp[:, None] >= kp[None, :])[None, :, None, None, :],
                                s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vb)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    return torch.cat(outs, dim=1).reshape(B, Sq, H, D).to(q.dtype)


def attention_reference(q, k, v, *, causal=True):
    """Naive O(S^2) oracle for tests."""
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    qf = q.reshape(B, Sq, KVH, H // KVH, D).to(torch.float32) * D ** -0.5
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, k.to(torch.float32))
    if causal:
        mask = torch.arange(Sq, device=q.device)[:, None] >= torch.arange(Sk, device=q.device)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, v.to(torch.float32))
    return o.reshape(B, Sq, H, D).to(q.dtype)


def prefix_attention(q: torch.Tensor, k_pre: torch.Tensor, v_pre: torch.Tensor,
                     prefix_len: torch.Tensor, k_suf: torch.Tensor,
                     v_suf: torch.Tensor) -> torch.Tensor:
    """Suffix-prefill attention against a cached prefix (prefix sharing).

    q: (B, Sq, H, D), RoPE'd at ``prefix_len + i``; k_pre/v_pre: (B, Sk, KVH,
    D), valid below ``prefix_len`` (B,); k_suf/v_suf: (B, Sq, KVH, D). One
    softmax over [masked prefix | causal suffix], naive and float32.
    """
    B, Sq, H, D = q.shape
    KVH = k_suf.shape[2]
    dev = q.device
    qf = q.reshape(B, Sq, KVH, H // KVH, D).to(torch.float32) * D ** -0.5
    s_pre = torch.einsum("bqhgd,bkhd->bqhgk", qf, k_pre.to(torch.float32))
    pre_valid = torch.arange(k_pre.shape[1], device=dev)[None, :] < prefix_len[:, None]
    s_pre = torch.where(pre_valid[:, None, None, None, :], s_pre, NEG_INF)
    s_suf = torch.einsum("bqhgd,bkhd->bqhgk", qf, k_suf.to(torch.float32))
    causal = torch.arange(Sq, device=dev)[:, None] >= torch.arange(Sq, device=dev)[None, :]
    s_suf = torch.where(causal[None, :, None, None, :], s_suf, NEG_INF)
    p = torch.softmax(torch.cat([s_pre, s_suf], dim=-1), dim=-1)
    vcat = torch.cat([v_pre, v_suf], dim=1).to(torch.float32)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, vcat)
    return o.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); caches: (B, Smax, KVH, D); length: (B,) valid prefix.

    Stable softmax over the valid prefix only. Returns (B, H, D).
    """
    B, H, D = q.shape
    KVH = k_cache.shape[2]
    qf = q.reshape(B, KVH, H // KVH, D).to(torch.float32) * D ** -0.5
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.to(torch.float32))
    valid = torch.arange(k_cache.shape[1], device=q.device)[None, :] < length[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.to(torch.float32))
    o = o / p.sum(-1, keepdim=True)
    return o.reshape(B, H, D).to(q.dtype)
