"""Paged decode attention: flash-decoding partials per page, combined on one card.

The port of ``repro/serve/kvpool/attention.py``. Pages past a sequence's
valid length contribute exactly zero: when any page is non-empty an empty
page's weight ``exp(NEG_INF - m)`` underflows to 0, and when every page is
empty (a length-0 lane) the output is 0 because num and den are both 0. That
is what lets the pool gather fixed-width page lists with zero padding.

Two paths, selected by ``use_kernels`` (as ``PoolConfig.use_kernels``):

* plain -- ``dist.flash_decode.decode_partials`` over every page (the pages
  as a batch), then a max/sum combine over the page axis; the oracle;
* K7 (``kernels/flash_decode.decode_partials_pages``) -- reads the pool's
  (B, P, ps, KVH, hd) page view in place, one CTA per (row, KV head), the
  combine over pages fused in the kernel's online softmax.

``k_new``/``v_new`` (each (B, KVH, D)) fold one just-computed decode token
into the softmax without it touching the pages; ``_combine`` stays plain
torch on both paths, as in the reference.
"""
from __future__ import annotations

import torch

from ...dist import flash_decode
from ...kernels import flash_decode as fdk


def _combine(m_a, num_a, den_a, m_b, num_b, den_b):
    """Merge two online-softmax partial triples (same shapes, elementwise)."""
    m = torch.maximum(m_a, m_b)
    ca, cb = torch.exp(m_a - m), torch.exp(m_b - m)
    return m, num_a * ca[..., None] + num_b * cb[..., None], den_a * ca + den_b * cb


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                           length: torch.Tensor, *, k_new: torch.Tensor | None = None,
                           v_new: torch.Tensor | None = None,
                           use_kernels: bool = True) -> torch.Tensor:
    """q: (B, H, D); k_pages/v_pages: (B, P, ps, KVH, D); length: (B,) valid
    prefix over the concatenated pages. Optional ``k_new``/``v_new`` (B, KVH,
    D) are this step's token at position ``length`` (always valid). Returns
    (B, H, D) in q's type."""
    B, P, ps, KVH, D = k_pages.shape
    G = q.shape[1] // KVH
    if use_kernels:
        m, num, den = fdk.decode_partials_pages(q, k_pages, v_pages, length, device=q.device)
    else:
        # every page a row of one batch: (P * B) slices at offsets page * ps
        def rows(t):
            return t.transpose(0, 1).reshape(P * B, ps, KVH, D)
        offsets = (torch.arange(P, device=q.device) * ps).repeat_interleave(B)
        ms, nums, dens = flash_decode.decode_partials(
            q.repeat(P, 1, 1), rows(k_pages), rows(v_pages), length.repeat(P),
            shard_offset=offsets)
        ms = ms.reshape(P, B, KVH, G)
        m = ms.amax(0)
        corr = torch.exp(ms - m)           # 0 for empty pages (if any page is non-empty)
        num = (nums.reshape(P, B, KVH, G, D) * corr[..., None]).sum(0)
        den = (dens.reshape(P, B, KVH, G) * corr).sum(0)
    if k_new is not None:
        qf = q.reshape(B, KVH, G, D).to(torch.float32) * D ** -0.5
        m_t = torch.einsum("bhgd,bhd->bhg", qf, k_new.to(torch.float32))
        num_t = v_new.to(torch.float32)[:, :, None, :].expand(B, KVH, G, D)
        m, num, den = _combine(m, num, den, m_t, num_t, torch.ones_like(m_t))
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(B, KVH * G, D).to(q.dtype)


def pages_from_cache(k_cache: torch.Tensor, v_cache: torch.Tensor, page_size: int):
    """Reshape contiguous caches (B, S, KVH, D) into (B, P, ps, KVH, D)."""
    B, S, KVH, D = k_cache.shape
    if S % page_size:
        raise ValueError(f"cache length {S} not a multiple of page_size")
    P = S // page_size
    return (k_cache.reshape(B, P, page_size, KVH, D),
            v_cache.reshape(B, P, page_size, KVH, D))
