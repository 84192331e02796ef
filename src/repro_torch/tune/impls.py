"""Built-in tunable ops and their candidate implementations. The port of
``repro/tune/impls.py``, with the reference's op and impl names, so a cache
entry and a ``tune_selected`` counter mean the same in both packages.

Three ops cover every tuned dispatch site:

  * ``fz.compress``   -- reference / staged / fused compressor routes (paper
    mode: K1 + K2 staged, K4 fused). Parity gate: the *error-bound
    invariant* -- the candidate's container, decoded through the reference
    inverse pipeline, must reconstruct every element within ``eb_abs`` (plus
    the documented f32 rounding allowance). A candidate that is fast but
    breaks the bound can never be selected.
  * ``fz.decompress`` -- the same three routes on the inverse pipeline (K3
    staged, K6 fused). Parity gate: *bit-identity* against the reference
    decode.
  * ``decode_attention`` -- ``jnp`` (the plain
    ``models/attention.py:decode_attention``, named as the reference names its
    jnp oracle) vs ``kernel`` (K7 through ``kernels.flash_decode``). Parity
    gate: max-abs tolerance (2e-4 in f32, the pinned kernel-vs-plain bound;
    4e-2 for bf16/f16 outputs, which round to ~3 decimal digits).

Contexts are deterministic (seeded by the workload size) so a tuning run is
reproducible. The FZ context is built from ``np.random.default_rng(1234 + n)``
exactly as the reference's, so its data equals the reference's bit for bit.
By default it is that 1-D stream compressed in paper mode, as the
reference's; a caller whose traffic differs passes its ``shape`` (the same
draws, reshaped) and ``mode`` (``"paper"`` or ``"strict"``), and every
candidate then runs that route -- K1 walks and K6 runs its column passes on
a 3-D field, strict compress runs plain ``dual_quantize`` + K5.

Deliberate difference: the attention context is drawn from
``np.random.default_rng(7)`` where the reference draws from
``jax.random.key(7)`` (the two generators give different numbers). Its
default geometry follows the reference's ``_attn_geometry`` on a contiguous
cache; a caller passes its own (``attention_geometry``: the engine's KV
heads, group, head size, page size and lanes), and the candidates then run
the paged route the engine runs, ``serve.kvpool.attention.
paged_decode_attention`` on K7 (``kernel``) or its plain partials (``jnp``).
Candidates with kernel launches declare ``kernel_specs`` -- the
:mod:`repro_torch.analysis` specs the tuner statically budget-checks before
ever measuring.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import fz
from ..device import resolve_device
from ..kernels import flash_decode as fdk
from ..kernels import module
from ..models import attention
from . import registry

# f32 rounding allowance used by the property suite (tests/test_fz_properties)
F32_EPS_ALLOWANCE = 2.0 ** -22
EB = 1e-3
ATTN_TOL_F32 = 2e-4     # pinned kernel-vs-plain bound (tests/test_torch_flash_decode.py)
ATTN_TOL_LOWP = 4e-2    # bf16/f16 outputs round to ~8 mantissa bits

_FZ_IMPLS = ("reference", "staged", "fused")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def fz_impl_config(impl: str, eb: float = EB, exact_outliers: bool = False) -> fz.FZConfig:
    """Concrete (non-auto) FZConfig for one execution path; paper mode unless
    ``exact_outliers``."""
    return fz.FZConfig(eb=eb, exact_outliers=exact_outliers,
                       use_kernels=impl != "reference",
                       kernel_mode=impl if impl != "reference" else "staged")


def _fz_context(*, n: int, dtype: str, device="cuda", shape=None, mode: str = "paper") -> dict:
    dev = resolve_device(device)
    if mode not in ("paper", "strict"):
        raise ValueError(f"mode must be 'paper' or 'strict', got {mode!r}")
    shape = tuple(int(s) for s in shape) if shape is not None else (int(n),)
    rng = np.random.default_rng(1234 + int(n))
    x = np.cumsum(rng.standard_normal(n).astype(np.float32) * 0.01)
    data = torch.from_numpy(x.reshape(shape)).to(dev).to(_DTYPES[dtype])
    strict = mode == "strict"
    ref_cfg = fz_impl_config("reference", exact_outliers=strict)
    container = fz._compress_unmetered(data, ref_cfg)
    return {"n": n, "dtype": dtype, "device": dev, "data": data, "shape": shape,
            "strict": strict, "ref_cfg": ref_cfg, "container": container}


def _n_tiles(n: int) -> int:
    return -(-int(n) // 4096)


def _fz_specs(impl: str, direction: str):
    """kernel_specs hook for one (impl, direction); None for the reference."""
    if impl == "reference":
        return None

    def specs(ctx: dict) -> list:
        shape, dtype, n_tiles = ctx["shape"], ctx["dtype"], _n_tiles(ctx["n"])
        if direction == "compress":
            bs = module("bitshuffle_flag")
            if ctx["strict"]:            # plain dual_quantize, then K5 or K2
                return [module("fused_compress").fused_shuffle_encode_spec(n_tiles)
                        if impl == "fused" else bs.bitshuffle_flag_spec(n_tiles)]
            if impl == "fused":
                return [module("fused_compress").fused_compress_spec(shape, dtype)]
            return [*module("lorenzo_quant").specs(shape, dtype), bs.bitshuffle_flag_spec(n_tiles)]
        if impl == "fused":
            n_out = int(ctx["container"].outlier_idx.numel()) if ctx["strict"] else 0
            return module("fused_decode").specs(shape, n_out)
        return [module("bitshuffle_flag").bitunshuffle_tiles_spec(n_tiles)]

    return specs


def _compress_runner(impl: str):
    def make_runner(ctx: dict):
        cfg = fz_impl_config(impl, exact_outliers=ctx["strict"])
        data = ctx["data"]
        return lambda: fz._compress_unmetered(data, cfg)
    return make_runner


def _compress_parity(ctx: dict, out, ref_out) -> str | None:
    """Error-bound invariant: decode through the reference inverse pipeline."""
    x = ctx["data"].to(torch.float32)
    rec = fz._decompress(out, ctx["ref_cfg"]).to(torch.float32)
    eb_abs = float(out.eb_abs)
    err = (x - rec).abs()
    limit = eb_abs * (1 + 1e-6) + x.abs() * F32_EPS_ALLOWANCE
    if bool((err > limit).any()):
        return (f"error bound violated: max|x-x̂| {float(err.max()):.3g} "
                f"> eb_abs {eb_abs:.3g}")
    return None


def _decompress_runner(impl: str):
    def make_runner(ctx: dict):
        cfg = fz_impl_config(impl, exact_outliers=ctx["strict"])
        c = ctx["container"]
        return lambda: fz._decompress(c, cfg)
    return make_runner


def _decompress_parity(ctx: dict, out, ref_out) -> str | None:
    del ctx
    if not torch.equal(out, ref_out):
        return "decode not bit-identical to the reference inverse pipeline"
    return None


registry.register_op(registry.OpSpec(
    name="fz.compress", reference="reference", make_context=_fz_context,
    parity=_compress_parity, gate="error-bound"))
registry.register_op(registry.OpSpec(
    name="fz.decompress", reference="reference", make_context=_fz_context,
    parity=_decompress_parity, gate="bit-identity"))

for _impl in _FZ_IMPLS:
    registry.register(registry.Candidate(
        op="fz.compress", impl=_impl, make_runner=_compress_runner(_impl),
        kernel_specs=_fz_specs(_impl, "compress")))
    registry.register(registry.Candidate(
        op="fz.decompress", impl=_impl, make_runner=_decompress_runner(_impl),
        kernel_specs=_fz_specs(_impl, "decompress")))


# ---------------------------------------------------------------------------
# decode_attention: the plain version vs the K7 flash-decode kernel
# ---------------------------------------------------------------------------

ATTN_KVH = 2
ATTN_D = 64
ATTN_B = 2
ATTN_G = 2


def _attn_geometry(n: int) -> tuple[int, int, int, int, int]:
    """(B, S, KVH, G, D) for a cache of ~n elements per sequence.

    Dispatch sites key on ``n = S * KVH * D`` (the per-sequence cache size,
    the axis the kernel tiles over); the remaining dims are held at a
    representative serving geometry unless the caller gives its own.
    """
    s = max(8, int(n) // (ATTN_KVH * ATTN_D))
    return ATTN_B, s, ATTN_KVH, ATTN_G, ATTN_D


def attn_cache_elems(seq_len: int, n_kv_heads: int, head_dim: int) -> int:
    """The ``n`` a decode-attention dispatch site should tune/look up with."""
    return int(seq_len) * int(n_kv_heads) * int(head_dim)


def attention_geometry(*, kvh: int, g: int, d: int, page_size: int, batch: int = ATTN_B) -> dict:
    """The geometry of a paged decode-attention site (the engine's): KV heads,
    query heads a KV head, head size, page size and lanes. With it the context
    holds pages (B, S / page_size, page_size, KVH, D) and this step's K/V, and
    both candidates run ``paged_decode_attention`` as the engine does."""
    return {"kvh": int(kvh), "g": int(g), "d": int(d), "page_size": int(page_size),
            "batch": int(batch)}


def _attn_context(*, n: int, dtype: str, device="cuda", kvh=None, g=None, d=None,
                  page_size=None, batch=None) -> dict:
    dev = resolve_device(device)
    if kvh is None:
        b, s, kvh, g, d = _attn_geometry(n)
    else:
        b, s = batch or ATTN_B, max(page_size, int(n) // (kvh * d) // page_size * page_size)
    rng = np.random.default_rng(7)

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) \
            .to(dev).to(_DTYPES[dtype])
    q, k, v = draw((b, kvh * g, d)), draw((b, s, kvh, d)), draw((b, s, kvh, d))
    length = torch.full((b,), s, dtype=torch.int32, device=dev)
    ctx = {"n": n, "dtype": dtype, "device": dev, "q": q, "k": k, "v": v,
           "length": length, "geometry": (b, s, kvh, g, d), "page_size": page_size}
    if page_size is not None:          # the engine's paged step: pages and this token
        from ..serve.kvpool import attention as paged   # the engine imports this module
        ctx["k_pages"], ctx["v_pages"] = paged.pages_from_cache(k, v, page_size)
        ctx["k_new"], ctx["v_new"] = draw((b, kvh, d)), draw((b, kvh, d))
    return ctx


def _attn_runner(impl: str):
    def make_runner(ctx: dict):
        q, k, v, length = ctx["q"], ctx["k"], ctx["v"], ctx["length"]
        if ctx["page_size"] is not None:
            from ..serve.kvpool import attention as paged
            kp, vp, kn, vn = ctx["k_pages"], ctx["v_pages"], ctx["k_new"], ctx["v_new"]
            use_kernels = impl == "kernel"
            return lambda: paged.paged_decode_attention(q, kp, vp, length, k_new=kn, v_new=vn,
                                                        use_kernels=use_kernels)
        if impl == "jnp":
            return lambda: attention.decode_attention(q, k, v, length)
        return lambda: fdk.flash_decode(q, k, v, length, device=q.device)
    return make_runner


def _attn_parity(ctx: dict, out, ref_out) -> str | None:
    a, b = out.to(torch.float32), ref_out.to(torch.float32)
    tol = ATTN_TOL_F32 if ctx["dtype"] in ("float32", "float64") else ATTN_TOL_LOWP
    diff = float((a - b).abs().max())
    if diff > tol:
        return f"max|Δ| {diff:.3g} exceeds the {tol:g} kernel-parity bound"
    return None


def _attn_specs(ctx: dict) -> list:
    b, s, kvh, g, d = ctx["geometry"]
    tile = ctx["page_size"] or min(fdk.KV_TILE, s)
    return module("flash_decode").specs(b, -(-s // tile), kvh, g, d, ctx["dtype"],
                                        point=f"tune n={ctx['n']}")


registry.register_op(registry.OpSpec(
    name="decode_attention", reference="jnp", make_context=_attn_context,
    parity=_attn_parity, gate="tolerance"))
registry.register(registry.Candidate(
    op="decode_attention", impl="jnp", make_runner=_attn_runner("jnp")))
registry.register(registry.Candidate(
    op="decode_attention", impl="kernel", make_runner=_attn_runner("kernel"),
    kernel_specs=_attn_specs))


def evil_candidate(op: str, impl: str = "evil") -> registry.Candidate:
    """A fast-but-wrong candidate for parity-gate tests: returns the right
    structure with zeroed data (instant, never correct)."""
    spec = registry.op(op)

    def make_runner(ctx: dict):
        ref_impl = next(c for c in registry.candidates(op)
                        if c.impl == spec.reference)
        ref_out = ref_impl.make_runner(ctx)()
        if dataclasses.is_dataclass(ref_out):
            # keep the resolved bound so the error-bound gate sees a
            # plausible container whose *data* is wrong
            zeros = dataclasses.replace(ref_out, **{
                f: torch.zeros_like(getattr(ref_out, f))
                for f in ref_out.FIELDS if f != "eb_abs"})
        else:
            zeros = torch.zeros_like(ref_out)
        return lambda: zeros
    return registry.Candidate(op=op, impl=impl, make_runner=make_runner)
