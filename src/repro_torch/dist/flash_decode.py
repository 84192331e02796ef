"""Flash-decoding partials over one contiguous KV slice: the port of
``repro/dist/flash_decode.py:decode_partials``, K7's plain oracle.

Each slice of the sequence axis gives the online-softmax partials -- running
max, exp-sum denominator, weighted-value numerator -- renormalizable against
any global max. The paged decode attention (``serve/kvpool/attention.py``)
combines them over the page axis on one card. The sequence-sharded
``flash_decode_shard`` (pmax/psum over a mesh axis) waits for the
``torch.distributed`` slice.
"""
from __future__ import annotations

import torch

# Finite -inf stand-in: an entirely masked slice yields 0/0-free partials,
# NEG_INF - NEG_INF == 0.
NEG_INF = -1e30


def decode_partials(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    length: torch.Tensor, *, shard_offset=0):
    """Partials over one contiguous slice of the KV sequence.

    q: (B, H, D); k_cache/v_cache: (B, S_slice, KVH, D); length: (B,) global
    valid prefix; ``shard_offset``: global position of the slice's first slot
    (an int, or a (B,) tensor: one offset per row). Returns ``(m_local, num,
    den)``: (B, KVH, G), (B, KVH, G, D), (B, KVH, G). An entirely masked slice
    yields m_local == NEG_INF and zero num/den.
    """
    B, H, D = q.shape
    S_slice, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    dev = q.device
    qf = q.reshape(B, KVH, G, D).to(torch.float32) * D ** -0.5
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k_cache.to(torch.float32))
    offset = torch.as_tensor(shard_offset, device=dev).reshape(-1, 1)
    pos = offset + torch.arange(S_slice, device=dev)[None, :]
    valid = (pos < length.reshape(B, 1))[:, None, None, :]     # (B, 1, 1, S_slice)
    s = torch.where(valid, s, NEG_INF)
    m_local = s.amax(-1)
    p = torch.where(valid, torch.exp(s - m_local[..., None]), 0.0)  # empty-slice safety
    num = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.to(torch.float32))
    den = p.sum(-1)
    return m_local, num, den
