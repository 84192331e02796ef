"""The shipped config space the resource analyzer evaluates specs over. The port
of ``repro/analysis/space.py``.

Static analysis is only as honest as the geometry points it checks. This
module enumerates the shapes the repo actually ships:

  * **FZ payload shapes**: the reference's (the property-suite and bench 1-D
    leaves, a 4 MiB reduce bucket, a 2-D plane, a 3-D subcube, a KV page slab,
    a bf16 activation leaf), and the ones ``chip_smoke.py`` drives: the
    Hurricane-like (100, 500, 500) f32 timing shape, the Nyx-like 512^3 f32,
    the HACC-like 2^26 f32, and the serving page (2,097,152 bf16: 2 x 32
    layers x 64 x 4 x 128 of Yi-6B). Every K1-K6 launch site is evaluated at
    each. The reference crosses them with its ``capacity_frac`` values; no
    launch of the port changes with the outlier capacity (its grids and
    shared bytes follow the shape alone), so the port does not.
  * **flash-decode geometries**: every config of the registry
    (``repro_torch.configs``: the dense yi-6b, glm4-9b, internlm2-20b and
    mistral-large-123b, the MoE dbrx-132b (G 6) and llama4-scout-17b-a16e
    (G 5), qwen2-vl-72b, zamba2-2.7b (KVH 32, G 1, D 80) and whisper-tiny
    (KVH 6, G 1, D 64); the attention-free rwkv6-3b has none), full and smoke,
    at the contiguous ``KV_TILE`` and at the page sizes 8, 16, 64
    (``chip_smoke.py``'s serving pool) and 128, in bf16 (the pool's type) and
    f32, as the reference's ``_arch_points`` walks its registry.

``build_specs()`` materializes the specs of every launch at every point from
the builders :mod:`repro_torch.kernels` registers.
"""
from __future__ import annotations

from ..kernels import module
from .kernelspec import KernelSpec

# (shape, dtype) FZ inputs
FZ_SHAPES: tuple[tuple[tuple[int, ...], str], ...] = (
    ((4096,), "float32"),                 # one-tile leaf (property suite)
    ((65536,), "float32"),                # small gradient leaf
    ((1 << 20,), "float32"),              # 4 MiB reduce bucket
    ((1024, 1024), "float32"),            # 2D field (paper-scale plane)
    ((96, 96, 96), "float32"),            # 3D field (NYX-class subcube)
    ((2048,), "bfloat16"),                # KV page slab: ps=8 x KVH=2 x hd=128
    ((1 << 20,), "bfloat16"),             # bf16 activation leaf
    ((100, 500, 500), "float32"),         # chip_smoke.py's timing shape (Hurricane-like)
    ((512, 512, 512), "float32"),         # Nyx-like
    ((1 << 26,), "float32"),              # HACC-like, cut to 2^26
    ((2097152,), "bfloat16"),             # the serving page (Yi-6B, pages of 64)
)

# paged-decode page sizes: 8 (benchmarks/examples), 16 (the PoolConfig
# default), 64 (chip_smoke.py's serving pool), 128
PAGE_SIZES = (8, 16, 64, 128)

# decode batch size and contiguous KV length of the reference's space
DECODE_BATCH = 8
CONTIG_KV = 4096

def _arch_points():
    """(label, B, KVH, G, D) attention geometries of the registry's configs, in
    its order."""
    from .. import configs
    pts = []
    for arch_id in configs.ARCH_IDS:
        for smoke in (False, True):
            cfg = configs.get(arch_id, smoke=smoke)
            if cfg.attention_free or cfg.n_kv_heads <= 0:
                continue
            pts.append((cfg.arch_id, DECODE_BATCH, cfg.n_kv_heads,
                        max(1, cfg.n_heads // cfg.n_kv_heads), cfg.hd))
    return pts


def fz_specs(shape, dtype: str) -> list[KernelSpec]:
    """Every K1-K6 launch of both routes at one FZ input: K1 (the launch it
    makes), K2, K3, K4, K5, K6's launches (with outlier slots: all three of
    its launch sites) and strict K4."""
    n = 1
    for s in shape:
        n *= int(s)
    n_tiles = -(-n // 4096)
    point = f"{tuple(shape)} {dtype}"
    fc, bs = module("fused_compress"), module("bitshuffle_flag")
    return [*module("lorenzo_quant").specs(shape, dtype, point),
            bs.bitshuffle_flag_spec(n_tiles, point), bs.bitunshuffle_tiles_spec(n_tiles, point),
            fc.fused_compress_spec(shape, dtype, point),
            fc.fused_shuffle_encode_spec(n_tiles, point),
            *module("fused_decode").specs(shape, max(1, n // 256), point),
            fc.fused_compress_strict_spec(shape, dtype, point)]


def attention_specs() -> list[KernelSpec]:
    """K7's launches at every served geometry, contiguous and paged, bf16 and f32."""
    fd = module("flash_decode")
    specs = []
    for label, b, kvh, g, d in _arch_points():
        for dtype in ("bfloat16", "float32"):
            specs += fd.specs(b, -(-CONTIG_KV // fd.KV_TILE), kvh, g, d, dtype,
                              f"{label} contiguous {dtype}")
            for ps in PAGE_SIZES:
                specs += fd.specs(b, -(-CONTIG_KV // ps), kvh, g, d, dtype,
                                  f"{label} paged ps={ps} {dtype}")
    return specs


def build_specs() -> list[KernelSpec]:
    """One KernelSpec per (launch site, shipped geometry point)."""
    specs: list[KernelSpec] = []
    for shape, dtype in FZ_SHAPES:
        specs += fz_specs(shape, dtype)
    return specs + attention_specs()
