"""Sequence-sharded decode attention: the port of ``repro/dist/flash_decode.py``.

Each slice of the sequence axis gives the online-softmax partials -- running
max, exp-sum denominator, weighted-value numerator -- renormalizable against
any global max (:func:`decode_partials`, K7's plain oracle). The paged decode
attention (``serve/kvpool/attention.py``) combines them over the page axis on
one card; :func:`flash_decode_shard` combines them over a mesh dimension,
with ``all_reduce(MAX)`` / ``all_reduce(SUM)`` where the reference has
``pmax`` / ``psum``. The combine itself is :func:`renormalize`, a sum and
``kernels.flash_decode.combine_partials``; :func:`combine_shards` applies it
to a list of every shard's partials in one process, without a collective.

Difference from the reference: ``flash_decode_shard`` takes the mesh and the
dimension's name (the reference names an axis of the enclosing
``shard_map``), and ``use_kernels`` defaults to True, as everywhere in the port.
"""
from __future__ import annotations

import torch

from ..device import resolve_device

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


def shard_partials(q, k_cache, v_cache, length, *, shard_offset, use_kernels: bool = True,
                   device="cuda"):
    """One shard's partials: K7 or its plain version, as ``tune.decode_attention_impl``
    resolves the request for this shard's cache (untuned: K7)."""
    dev = resolve_device(device)
    q, k_cache, v_cache, length = (torch.as_tensor(t).to(dev)
                                   for t in (q, k_cache, v_cache, length))
    if use_kernels:
        from .. import tune
        s_shard, kvh = k_cache.shape[1], k_cache.shape[2]
        n_attn = tune.attn_cache_elems(s_shard, kvh, k_cache.shape[3])
        use_kernels = tune.decode_attention_impl(n_attn, k_cache.dtype, dev) == "kernel"
    if use_kernels:
        from ..kernels import flash_decode as fdk
        return fdk.decode_partials(q, k_cache, v_cache, length, shard_offset=shard_offset,
                                   device=dev)
    return decode_partials(q, k_cache, v_cache, length, shard_offset=shard_offset)


def renormalize(m_local, num, den, m_global):
    """A shard's (num, den) against the global max. An empty shard's weight
    underflows to 0 when any shard is non-empty; when every shard is empty it
    is exp(0) == 1 and the output is still 0, because num and den are 0."""
    corr = torch.exp(m_local - m_global)
    return num * corr[..., None], den * corr


def combine_shards(partials, dtype=torch.float32) -> torch.Tensor:
    """Every shard's ``(m_local, num, den)``, in shard order, combined in one
    process: what :func:`flash_decode_shard` computes with collectives."""
    m_global = partials[0][0]
    for m, _, _ in partials[1:]:
        m_global = torch.maximum(m_global, m)
    from ..kernels.flash_decode import combine_partials
    num = den = None
    for m, nu, de in partials:
        nu, de = renormalize(m, nu, de, m_global)
        num, den = (nu, de) if num is None else (num + nu, den + de)
    return combine_partials(m_global, num, den, dtype)


def flash_decode_shard(q, k_cache, v_cache, length, *, mesh, axis: str, shard_offset,
                       use_kernels: bool = True, device="cuda") -> torch.Tensor:
    """One rank's shard of sequence-sharded decode attention.

    q: (B, H, D), the same on every rank; k_cache/v_cache: (B, S_shard, KVH, D),
    this rank's slice of the sequence axis; length: (B,) global valid prefix;
    ``shard_offset``: global position of the slice's first slot (e.g. the
    rank along ``axis`` times ``S_shard``). Returns (B, H, D), the same on
    every rank of ``mesh``'s ``axis`` dimension.
    """
    import torch.distributed as dist
    from ..kernels.flash_decode import combine_partials
    q = torch.as_tensor(q)
    m_local, num, den = shard_partials(q, k_cache, v_cache, length, shard_offset=shard_offset,
                                       use_kernels=use_kernels, device=device)
    group = mesh.get_group(axis)
    m_global = m_local.clone()
    dist.all_reduce(m_global, op=dist.ReduceOp.MAX, group=group)
    num, den = renormalize(m_local, num, den, m_global)
    dist.all_reduce(num, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(den, op=dist.ReduceOp.SUM, group=group)
    return combine_partials(m_global, num, den, q.dtype)
