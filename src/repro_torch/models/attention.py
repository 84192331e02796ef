"""Attention: RoPE / M-RoPE, chunked flash attention, the prefix and decode paths.

The port of ``repro/models/attention.py`` for the transformer family. Everything is
plain PyTorch in float32, as the reference computes it outside any Pallas
kernel: ``flash_attention`` is the chunked online softmax (q and kv chunks,
causal masking with ``where``), ``attention_reference`` the naive oracle,
``prefix_attention`` the suffix prefill against a cached prefix, and
``decode_attention`` one token against a contiguous cache. The decode kernel
(K7) sits behind ``serve/kvpool/attention.py``. ``apply_mrope`` is Qwen2-VL's
multimodal RoPE.

The dry-run's two knobs, as in the reference:

* ``set_causal_skip(True)``: q chunk ``i`` visits only kv chunks ``<= i``
  (when the q and kv chunkings are the same), skipping the strictly-upper
  pairs, whose scores are all masked. The outputs are unchanged: a masked
  pair multiplies the accumulator by ``exp(0) = 1`` and adds zeros.
* ``nn.set_bf16_matmul_output(True)`` with bfloat16 inputs: q, k, v and the
  probabilities enter the two products in bfloat16, and each product is a
  bfloat16 GEMM (float32 accumulation, one rounding), where the reference
  keeps the products' float32 outputs; the statistics and the accumulator
  stay float32.

On DTensor inputs ``flash_attention`` runs per shard of batch and heads
(``nn.per_shard``); where the kv heads do not split as the q heads do, each
rank takes the kv heads its q heads read.
"""
from __future__ import annotations

import torch

from . import nn

NEG_INF = -1e30

_CAUSAL_SKIP = False


def set_causal_skip(on: bool) -> None:
    global _CAUSAL_SKIP
    _CAUSAL_SKIP = on


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


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, sections: tuple[int, int, int],
                theta: float = 1e4) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (B, S, H, D), pos3: (B, 3, S) (t/h/w position
    ids); the D/2 frequency slots are split into ``sections`` (t, h, w), each slot
    rotating by its section's position id."""
    d2 = x.shape[-1] // 2
    if sum(sections) != d2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to head_dim/2 = {d2}")
    sec_of = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                          device=pos3.device)                    # (d2,)
    pos = torch.index_select(pos3, 1, sec_of)                  # (B, d2, S)
    ang = pos.transpose(1, 2).to(torch.float32) * rope_freqs(x.shape[-1], theta, x.device)
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
    if nn.is_dtensor(q):
        return _sharded_heads(lambda ql, kl, vl: flash_attention(
            ql, kl, vl, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk), q, k, v)
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    G = H // KVH
    scale = D ** -0.5
    q_chunk = _pick_chunk(Sq, q_chunk)
    kv_chunk = _pick_chunk(Sk, kv_chunk)
    bf16 = nn.bf16_matmul_output() and q.dtype == torch.bfloat16
    cdt = torch.bfloat16 if bf16 else torch.float32
    qs = q.reshape(B, Sq, KVH, G, D).to(cdt)
    kf, vf = k.to(cdt), v.to(cdt)
    skip = causal and _CAUSAL_SKIP and Sq == Sk and q_chunk == kv_chunk
    pos_q = torch.arange(Sq, device=q.device)
    pos_k = torch.arange(Sk, device=q.device)

    def row(q0):
        qb, qp = qs[:, q0:q0 + q_chunk], pos_q[q0:q0 + q_chunk]
        m = torch.full((B, q_chunk, KVH, G), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, q_chunk, KVH, G), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, q_chunk, KVH, G, D), dtype=torch.float32, device=q.device)
        return qb, qp, m, l, acc

    def pair(qb, qp, k0, m, l, acc):
        kb, vb = kf[:, k0:k0 + kv_chunk], vf[:, k0:k0 + kv_chunk]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qb, kb).to(torch.float32) * scale
        if causal:
            kp = pos_k[k0:k0 + kv_chunk]
            s = torch.where((qp[:, None] >= kp[None, :])[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p.to(cdt),
                                                   vb).to(torch.float32)
        return m_new, l, acc

    nq, nk = Sq // q_chunk, Sk // kv_chunk
    if _counting_only(q):
        # counting only (the dry-run): every row and every chunk pair has the
        # same shapes, so one of each is run and counted for all of them; the
        # rows' outputs are held as the loop holds them before the ``cat``
        outs = [torch.empty((B, Sq - q_chunk, KVH, G, D), dtype=torch.float32,
                            device=q.device)]
        with nn.repeated(nq):
            qb, qp, m, l, acc = row(0)
            with nn.repeated((nq + 1) / 2 if skip else nk):
                m, l, acc = pair(qb, qp, 0, m, l, acc)
            outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    else:
        outs = []
        for q0 in range(0, Sq, q_chunk):
            qb, qp, m, l, acc = row(q0)
            for k0 in range(0, q0 + 1 if skip else Sk, kv_chunk):
                m, l, acc = pair(qb, qp, k0, m, l, acc)
            outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    return torch.cat(outs, dim=1).reshape(B, Sq, H, D).to(q.dtype)


def _counting_only(x) -> bool:
    """A forward on ``meta`` tensors without autograd: the dry-run's counting,
    where no value is computed and nothing is kept for a backward."""
    return x.is_meta and not torch.is_grad_enabled()


def _sharded_heads(fn, q, k, v):
    """``fn(q, k, v)`` (B, S, H, D) per shard of batch and heads."""
    H, KVH = q.shape[2], k.shape[2]
    G = H // KVH
    mesh = q.device_mesh
    hdims = [m for m, p in enumerate(q.placements) if p.is_shard(2)]
    n = 1
    for m in hdims:
        n *= mesh.size(m)
    qr = {0: "batch", 2: "heads"}
    if n == 1 or KVH % n == 0 or H % n:
        return nn.per_shard(fn, [q, k, v], [qr, qr, qr], [qr])
    Hl = H // n
    if Hl % G and G % Hl:
        br = {0: "batch"}
        return nn.per_shard(fn, [q, k, v], [br, br, br], [br])
    coord = mesh.get_coordinate()
    r = 0
    for m in hdims:
        r = r * mesh.size(m) + coord[m]
    lo = r * Hl // G
    hi = (r + 1) * Hl // G if Hl % G == 0 else lo + 1
    kvr = {0: "batch"}
    return nn.per_shard(lambda ql, kl, vl: fn(ql, kl[:, :, lo:hi], vl[:, :, lo:hi]),
                        [q, k, v], [qr, kvr, kvr], [qr])


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

    Stable softmax over the valid prefix only. Returns (B, H, D). On a
    sequence-sharded DTensor cache it is flash-decoding: each rank's partials
    over its slice, combined by a max and a sum over the sequence's ranks.
    """
    if nn.is_dtensor(k_cache):
        return _sharded_decode(q, k_cache, v_cache, length)
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


def _sharded_decode(q, k_cache, v_cache, length):
    """``decode_attention`` on DTensors: batch split as the cache's, the
    sequence split as the cache's, heads whole; partials a slice
    (``dist.flash_decode.decode_partials``), the global max by an all-reduce
    (``Partial("max")``), the renormalized numerators and denominators by a sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ..dist import flash_decode as fd
    from ..dist import sharding as shd
    from ..kernels.flash_decode import combine_partials
    mesh = k_cache.device_mesh
    bdims = [m for m, p in enumerate(k_cache.placements) if p.is_shard(0)]
    sdims = [m for m, p in enumerate(k_cache.placements) if p.is_shard(1)]

    def pl(dims_of: dict, default=Replicate()):
        out = [default] * mesh.ndim
        for d, ms in dims_of.items():
            for m in ms:
                out[m] = Shard(d) if isinstance(d, int) else d
        return out

    def local(x, dims_of):
        if shd.is_dtensor(x):
            return x.redistribute(mesh, pl(dims_of)).to_local()
        return shd.local_slice(x, mesh, pl(dims_of))
    ql = local(q, {0: bdims})
    kl, vl = local(k_cache, {0: bdims, 1: sdims}), local(v_cache, {0: bdims, 1: sdims})
    ll = local(length, {0: bdims})
    coord, r = mesh.get_coordinate(), 0
    for m in sdims:
        r = r * mesh.size(m) + coord[m]
    m_loc, num, den = fd.decode_partials(ql, kl, vl, ll, shard_offset=r * kl.shape[1])

    def reduce(x, op):
        placed = pl({0: bdims})
        for m in sdims:
            placed[m] = Partial(op)
        return DTensor.from_local(x, mesh, placed, run_check=False).redistribute(
            mesh, pl({0: bdims})).to_local()
    m_glob = reduce(m_loc, "max")
    num, den = fd.renormalize(m_loc, num, den, m_glob)
    out = combine_partials(m_glob, reduce(num, "sum"), reduce(den, "sum"), q.dtype)
    return DTensor.from_local(out, mesh, pl({0: bdims}), run_check=False)
