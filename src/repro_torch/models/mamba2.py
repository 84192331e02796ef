"""Mamba2 (SSD) blocks, zamba2's backbone: the port of ``repro/models/mamba2.py``.

The chunked state-space-dual algorithm in float32: a scalar decay a head, so
the intra-chunk part is a (c, c) decay-masked, attention-like product, and the
state is carried from chunk to chunk in order (the reference's ``lax.scan``).
The intra-chunk terms of every chunk are formed at once. Every decay exponent
used is <= 0 (cumulative log-decays and their ordered differences); the
masked ones are set to -inf before ``exp`` (the reference takes ``where``
after it), which keeps the values and keeps the backward pass finite where a
masked exponent would overflow.

``_conv`` is the causal depthwise convolution by shifted adds, in float32
products and sums in the reference's order; its state is the last W - 1
inputs, in the activations' type.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import nn

DP = "fsdp"
TP = "tp"

CHUNK = 128


def dims(cfg: ArchConfig) -> tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    nh = d_inner // cfg.ssm_head_dim
    return d_inner, nh, cfg.ssm_head_dim, cfg.ssm_state


def mamba_defs(cfg: ArchConfig, n_layers: int) -> dict:
    d = cfg.d_model
    d_inner, nh, hd, ds = dims(cfg)
    conv_ch = d_inner + 2 * ds
    L = n_layers
    f32 = torch.float32
    return {
        "norm": nn.Param((L, d), (None, None), init="ones"),
        "in_proj": nn.Param((L, d, 2 * d_inner + 2 * ds + nh), (None, DP, TP)),
        "conv_w": nn.Param((L, cfg.conv_width, conv_ch), (None, None, TP), dtype=f32),
        "conv_b": nn.Param((L, conv_ch), (None, TP), init="zeros", dtype=f32),
        "A_log": nn.Param((L, nh), (None, TP), init="zeros", dtype=f32),
        "dt_bias": nn.Param((L, nh), (None, TP), init="zeros", dtype=f32),
        "D": nn.Param((L, nh), (None, TP), init="ones", dtype=f32),
        "ssm_norm": nn.Param((L, d_inner), (None, TP), init="ones"),
        "out_proj": nn.Param((L, d_inner, d), (None, TP, DP)),
    }


def _split(lp: dict, x: torch.Tensor, cfg: ArchConfig):
    d_inner, nh, hd, ds = dims(cfg)
    zxbcdt = nn.dense(x, lp["in_proj"])
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * ds, nh], dim=-1)


def _conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state: torch.Tensor | None):
    """Causal depthwise conv of width W by shifted adds. xbc: (B, S, C); state:
    (B, W-1, C) trailing context (decode), or None (zero history). Returns
    (out, new_state): the new state is the last W - 1 inputs in xbc's type."""
    W = w.shape[0]
    B, S, C = xbc.shape
    hist = (torch.zeros((B, W - 1, C), dtype=xbc.dtype, device=xbc.device)
            if state is None else state.to(xbc.dtype))
    ext = torch.cat([hist, xbc], dim=1)                      # (B, S+W-1, C)
    out = torch.zeros((B, S, C), dtype=torch.float32, device=xbc.device)
    for i in range(W):
        out = out + ext[:, i:i + S].to(torch.float32) * w[i]
    y = out + b
    # float32 silu as x * sigmoid(x): the reference's float32 jax.nn.silu, to the
    # bit once rounded to the activations' type
    return (y * torch.sigmoid(y)).to(xbc.dtype), ext[:, S:]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as max(x, 0) + log1p(e^-|x|)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _ssd_chunked(xh, bmat, cmat, dt, A_log, D, h0):
    """The chunked SSD scan.

    xh: (B, S, nh, hd); bmat/cmat: (B, S, ds); dt: (B, S, nh) raw; h0: (B, nh,
    hd, ds). Returns (y (B, S, nh, hd) float32, h_final). On DTensors it runs
    per shard of batch and heads (``nn.per_shard``).
    """
    if nn.is_dtensor(xh):
        bh, b = {0: "batch", 2: "heads"}, {0: "batch"}
        return nn.per_shard(_ssd_chunked, [xh, bmat, cmat, dt, A_log, D, h0],
                            [bh, b, b, bh, {0: "heads"}, {0: "heads"}, {0: "batch", 1: "heads"}],
                            [bh, {0: "batch", 1: "heads"}])
    B, S, nh, hd = xh.shape
    ds = bmat.shape[-1]
    c = min(CHUNK, S)
    pad = (-S) % c
    if pad:
        # state-neutral padding: dt -> -30 makes softplus(dt) ~ 0 (no decay, no
        # input); the padded outputs are sliced off below
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad), value=-30.0)
    n = (S + pad) // c
    dt = softplus(dt.to(torch.float32))                      # (B, S, nh)
    la = -torch.exp(A_log)[None, None, :] * dt               # log decay, <= 0
    xf = (xh.to(torch.float32) * dt[..., None]).reshape(B, n, c, nh, hd)
    bf = bmat.to(torch.float32).reshape(B, n, c, ds)
    cf = cmat.to(torch.float32).reshape(B, n, c, ds)
    La = torch.cumsum(la.reshape(B, n, c, nh), dim=2)        # (B, n, c, nh) inclusive
    # intra-chunk: decay-masked attention, (B, n, t, s, nh)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=xh.device))
    diff = La[:, :, :, None, :] - La[:, :, None, :, :]
    M = torch.exp(diff.masked_fill(~tri[:, :, None], float("-inf")))
    score = torch.einsum("bntd,bnsd->bnts", cf, bf)          # (B, n, c, c)
    y = torch.einsum("bntsh,bnshe->bnthe", score[..., None] * M, xf)
    # the state at each chunk's start, carried in order
    decay_to_end = torch.exp(La[:, :, -1:, :] - La)          # (B, n, c, nh)
    dh = torch.einsum("bnsh,bnshe,bnsd->bnhed", decay_to_end, xf, bf)
    chunk_decay = torch.exp(La[:, :, -1])[..., None, None]   # (B, n, nh, 1, 1)
    h = h0.to(torch.float32)
    starts = []
    for i in range(n):
        starts.append(h)
        h = chunk_decay[:, i] * h + dh[:, i]
    y = y + torch.einsum("bntd,bnth,bnhed->bnthe", cf, torch.exp(La), torch.stack(starts, 1))
    y = y.reshape(B, n * c, nh, hd)[:, :S]
    return y + xh[:, :S].to(torch.float32) * D[None, None, :, None], h


def mamba_block(lp: dict, x: torch.Tensor, cfg: ArchConfig, ssm_state=None, conv_state=None):
    """One Mamba2 block. x: (B, S, d). Returns (out, (ssm_state, conv_state))."""
    B, S, d = x.shape
    d_inner, nh, hd, ds = dims(cfg)
    h = nn.rms_norm(x, lp["norm"], cfg.norm_eps)
    z, xbc, dt = _split(lp, h, cfg)
    xbc, conv_state = _conv(xbc, lp["conv_w"], lp["conv_b"], conv_state)
    xs, bmat, cmat = torch.split(xbc, [d_inner, ds, ds], dim=-1)
    xh = xs.reshape(B, S, nh, hd)
    h0 = (torch.zeros((B, nh, hd, ds), dtype=torch.float32, device=x.device)
          if ssm_state is None else ssm_state)
    y, h_final = _ssd_chunked(xh, bmat, cmat, dt, lp["A_log"], lp["D"], h0)
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = nn.rms_norm(y, lp["ssm_norm"], cfg.norm_eps) * nn.silu(z)
    return x + nn.dense(y, lp["out_proj"]), (h_final, conv_state)


def mamba_decode_step(lp: dict, x: torch.Tensor, cfg: ArchConfig, ssm_state, conv_state):
    """The single-token recurrence. x: (B, d); the states as in ``mamba_block``."""
    B, d = x.shape
    d_inner, nh, hd, ds = dims(cfg)
    h = nn.rms_norm(x[:, None], lp["norm"], cfg.norm_eps)
    z, xbc, dt = _split(lp, h, cfg)
    xbc, conv_state = _conv(xbc, lp["conv_w"], lp["conv_b"], conv_state)
    xs, bmat, cmat = torch.split(xbc[:, 0], [d_inner, ds, ds], dim=-1)
    xh = xs.reshape(B, nh, hd).to(torch.float32)
    dtf = softplus(dt[:, 0].to(torch.float32))                    # (B, nh)
    a = torch.exp(-torch.exp(lp["A_log"])[None] * dtf)            # (B, nh)
    upd = torch.einsum("bhe,bd->bhed", xh * dtf[..., None], bmat.to(torch.float32))
    ssm_state = a[:, :, None, None] * ssm_state + upd
    y = torch.einsum("bd,bhed->bhe", cmat.to(torch.float32), ssm_state)
    y = y + xh * lp["D"][None, :, None]
    y = y.reshape(B, d_inner).to(x.dtype)
    y = nn.rms_norm(y, lp["ssm_norm"], cfg.norm_eps) * nn.silu(z[:, 0])
    return x + nn.dense(y, lp["out_proj"]), (ssm_state, conv_state)
