"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA card. Run on a card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The FZ kernels (K1-K6, strict K4) are held bit for bit: they and their plain versions do
the same integer work and the same IEEE float divide and multiply. K7
(flash-decode) is held at 2e-4 against the plain split-then-combine at the
wrapper's split count (what the wrapper runs for CPU tensors): float32 sums in
another order; fully masked rows exactly (-1e30, 0, 0).

The wire and checkpoints on the card: ``reduce_stacked`` (K4, K6) equal to
the plain route, the CPU route and the bucketed form over three steps;
``flash_decode_shard``'s per-shard K7 partials combined within 2e-4 of the
plain attention; a ``codec="fz"`` checkpoint saved on the card (strict K4) equal to
the CPU port's files, restored (K6) within the bound.

The MoE router on the card: ``moe.moe_apply`` on exactly representable
inputs (ties included) routes as on the CPU, index for index and slot for
slot.

Training on the card: two compressed steps at the smoke config, the kernel
route equal to the plain route and to itself, bit for bit; the overlap form
equal to the barrier form; the train launcher saving with strict K4 and
resuming with K6 under ``--ckpt-codec fz``.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch import FZConfig, compress, decompress, kernels
from repro_torch.core import quant, shuffle
from repro_torch.data.fields import make_field
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref
from repro_torch.kernels.fused_compress import shuffle_encode_ctas

pytestmark = pytest.mark.cuda

SHAPES = [(5000,), (37, 130), (9, 33, 70), (3, 4096), (2, 64, 64), (70000,),
          (1,), (4096,), (3, 1, 7), (5000, 1), (1, 4097)]
# every layout of K4's neighbour windows: 2-D and 3-D rows of at least a tile,
# 3-D planes of at least a tile with short rows, rows of 1
K4_EDGE_SHAPES = [(3, 5000), (2, 3, 5000), (3, 2, 2100), (4100, 1)]
# K1's walk along the leading axis (K4_EDGE_SHAPES' (3, 5000) walks 2-D rows
# longer than a tile): a plane of exactly one tile, a plane of 4101 (not a
# multiple of 8 or 16), one plane, rows of fewer than 16 (every code gated),
# 1103 planes (prime: not a multiple of any chunk), and rows too long for two
# windows in shared memory (the tile step)
K1_WALK_SHAPES = [(4, 64, 64), (5, 3, 1367), (1, 70, 70), (2, 300, 15), (1103, 64, 64),
                  (2, 2, 30000)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _field(shape, seed=0):
    kind = "particle" if len(shape) == 1 else "turbulent"
    return torch.from_numpy(make_field(kind, shape, seed=seed))


def _equal(a, b):
    torch.cuda.synchronize()
    return torch.equal(a.cpu().to(torch.int64) if a.dtype in (torch.uint16, torch.uint32)
                       else a.cpu(),
                       b.cpu().to(torch.int64) if b.dtype in (torch.uint16, torch.uint32)
                       else b.cpu())


@pytest.mark.parametrize("shape", SHAPES + K4_EDGE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("code_mode", ["sign_mag", "zigzag"])
@pytest.mark.parametrize("capacity_frac", [1.0, 0.25])
def test_fused_compress_matches_plain(cuda, shape, dtype, code_mode, capacity_frac):
    x = _field(shape).to(dtype).to(cuda)
    eb = torch.tensor(1e-3, dtype=torch.float32, device=cuda) * (x.float().amax() - x.float().amin())
    cap = FZConfig(capacity_frac=capacity_frac).payload_capacity(x.numel())
    got = kernels.fused_compress(x, eb, capacity=cap, code_mode=code_mode)
    want = ref.fused_compress_ref(x, eb, capacity=cap, code_mode=code_mode)
    for g, w in zip(got, want):
        assert _equal(g, w)


@pytest.mark.parametrize("shape", [(5000,), (9, 33, 70), (2, 3, 5000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 3, 5])
def test_fused_compress_of_a_view_off_16_bytes_matches_plain(cuda, shape, dtype, offset):
    """K4 reads 16-byte chunks aligned to the data's address, not to its start;
    K5 reads codes that do not start on 16 bytes with 2-byte loads."""
    n = int(np.prod(shape))
    buf = _field((n + 8,)).to(dtype).to(cuda)
    x = buf[offset:offset + n].view(shape)
    eb = torch.tensor(1e-3, device=cuda) * (x.float().amax() - x.float().amin())
    cap = FZConfig(capacity_frac=0.25).payload_capacity(n)
    got = kernels.fused_compress(x, eb, capacity=cap)
    for g, w in zip(got, ref.fused_compress_ref(x, eb, capacity=cap)):
        assert _equal(g, w)
    codes = shuffle.pad_to_tiles(ref.lorenzo_quant_ref(x, eb).reshape(-1))
    flat = torch.empty(codes.numel() + offset, dtype=torch.uint16, device=cuda)[offset:]
    flat.copy_(codes)
    got = kernels.fused_shuffle_encode(flat, capacity=cap)
    for g, w in zip(got, ref.fused_shuffle_encode_ref(codes, capacity=cap)):
        assert _equal(g, w)


# strict K4's fields: K4's shapes with planted jumps, a 1-D stream past one
# wave of tiles whose jumps sit on both sides of tile borders, and non-finite
# and saturated values (a delta of INT32_MIN among them)
STRICT_CASES = SHAPES + K4_EDGE_SHAPES + ["waves", "nonfinite"]
NONFINITE_RUN = [0.0, -1e30, 0.0, float("nan"), float("inf"), float("-inf"), 1e30, 3.0,
                 -3e9, 3e9, 2.2e9, -2.2e9, 0.0, 1.0, 2.0, 4e4, -4e4, 7e4]


def _strict_field(case, seed=11):
    """-> (float32 field, its range): jumps of 20 ranges every 61st element
    (1-D stream: next to every 7th tile border), alternating in sign."""
    if case == "nonfinite":
        run = torch.tensor(NONFINITE_RUN)
        x = torch.cat([run, torch.zeros(shuffle.TILE - run.numel()), run, torch.zeros(5)])
        return x, 1.0
    if case == "waves":
        n = (shuffle_encode_ctas() + 3) * shuffle.TILE - 1000
        x = torch.randn(n, generator=torch.Generator().manual_seed(seed)).cumsum(0) * 1e-3
        at = [p for t in range(7, n // shuffle.TILE, 7)
              for p in (t * shuffle.TILE - 1, t * shuffle.TILE, t * shuffle.TILE + 4095)]
    else:
        x = _field(case, seed=seed)
        at = list(range(0, x.numel(), 61))
    rng_ = float(x.max() - x.min()) or 1.0
    flat = x.reshape(-1)
    for k, p in enumerate(at):
        flat[p:] += 20.0 * rng_ * (1 if k % 2 else -1)
    return x, rng_


@pytest.mark.parametrize("case", STRICT_CASES, ids=[str(c) for c in STRICT_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("code_mode", ["sign_mag", "zigzag"])
@pytest.mark.parametrize("offset", [0, 3])
def test_fused_compress_strict_matches_plain(cuda, case, dtype, code_mode, offset):
    """Strict K4 against ``dual_quantize`` + K5's plain version, bit for bit in
    all six outputs, with the channel empty (a bound no delta can pass), exactly
    full and overflowing (n_over > K: the first K kept), at the data's own
    allocation and 3 elements off 16 bytes."""
    x32, rng_ = _strict_field(case)
    n = x32.numel()
    buf = torch.empty(n + offset, dtype=dtype, device=cuda)
    x = buf[offset:].view(x32.shape)
    x.copy_(x32.to(dtype))
    cap = FZConfig(capacity_frac=0.5).payload_capacity(n)
    # a jump of 20 ranges is a delta of 1e5 at 1e-4 of the range; at 1e-2 no
    # delta passes 8 x 1000 (the non-finite run overflows at any bound)
    loose = torch.tensor(1e-2 * rng_, device=cuda)
    eb = torch.tensor((0.5 if case == "nonfinite" else 1e-4 * rng_), device=cuda)
    n_over = int(quant.dual_quantize(x, eb, code_mode=code_mode, outlier_capacity=1)[3])
    assert n_over > 0
    for eb_, k in ((loose, 3), (eb, n_over), (eb, max(1, n_over // 2)), (eb, max(1, n_over - 1))):
        got = kernels.fused_compress_strict(x, eb_, capacity=cap, outlier_capacity=k,
                                            code_mode=code_mode)
        want = ref.fused_compress_strict_ref(x, eb_, capacity=cap, outlier_capacity=k,
                                             code_mode=code_mode)
        for name, g, w in zip(("bitflags", "payload", "nnz", "outlier_idx", "outlier_val",
                               "n_over"), got, want):
            assert _equal(g, w), (name, float(eb_), k)
        if eb_ is loose and case != "nonfinite":
            assert int(got[5]) == 0                  # the empty channel
    assert int(got[5]) == n_over


@pytest.mark.parametrize("shape", SHAPES + K4_EDGE_SHAPES)
@pytest.mark.parametrize("capacity_frac", [1.0, 0.25])
def test_fused_shuffle_encode_matches_plain(cuda, shape, capacity_frac):
    rng = np.random.default_rng(1)
    n = int(np.prod(shape))
    codes = torch.from_numpy(rng.geometric(0.3, size=n).astype(np.int32) - 1)
    flat = shuffle.pad_to_tiles(codes).to(torch.uint16).to(cuda)
    cap = FZConfig(capacity_frac=capacity_frac).payload_capacity(n)
    got = kernels.fused_shuffle_encode(flat, capacity=cap)
    want = ref.fused_shuffle_encode_ref(flat, capacity=cap)
    for g, w in zip(got, want):
        assert _equal(g, w)


# K5 at tile counts below, at and past one wave of its CTAs ("wave": how many
# the card runs at once)
K5_TILES = ["1", "2", "5", "wave - 1", "wave", "wave + 1", "3 * wave + 7"]


def _k5_codes(n_tiles, seed):
    """Small codes (most high bit planes zero, so many zero blocks) with a
    zero stretch in every third tile from the second."""
    rng = np.random.default_rng(seed)
    codes = rng.geometric(0.15, size=n_tiles * shuffle.TILE) - 1
    codes.reshape(n_tiles, -1)[1::3, 1000:3000] = 0
    return torch.from_numpy(codes.astype(np.int32)).to(torch.uint16)


@pytest.mark.parametrize("tiles", K5_TILES)
@pytest.mark.parametrize("capacity_frac", [1.0, 0.25])
@pytest.mark.parametrize("offset", [0, 3])
def test_fused_shuffle_encode_waves_match_plain(cuda, tiles, capacity_frac, offset):
    """K5 at tile counts around one wave, capacity 1.0 and 0.25, codes at their
    own allocation and 3 elements off 16 bytes (2-byte loads). The payload is
    allocated right after a same-sized block filled with 0xFFFF is freed, so a
    tail that the kernel left unzeroed would show."""
    n_tiles = eval(tiles, {"wave": shuffle_encode_ctas()})
    codes = _k5_codes(n_tiles, seed=n_tiles).to(cuda)
    flat = torch.empty(codes.numel() + offset, dtype=torch.uint16, device=cuda)[offset:]
    flat.copy_(codes)
    cap = FZConfig(capacity_frac=capacity_frac).payload_capacity(codes.numel())
    torch.full((cap, 8), -1, dtype=torch.int16, device=cuda)
    got = kernels.fused_shuffle_encode(flat, capacity=cap)
    want = ref.fused_shuffle_encode_ref(codes, capacity=cap)
    for g, w in zip(got, want):
        assert _equal(g, w)


@pytest.mark.parametrize("tiles", ["1", "5", "wave + 1"])
@pytest.mark.parametrize("capacity_frac", [1.0, 0.25])
def test_fused_shuffle_encode_writes_its_whole_payload(cuda, tiles, capacity_frac):
    """K5's entry point on a payload filled with 0xFFFF: every block is
    written, the compacted ones and zeros past nnz (none where the capacity
    is short of nnz)."""
    from repro_torch.kernels import build
    n_tiles = eval(tiles, {"wave": shuffle_encode_ctas()})
    codes = _k5_codes(n_tiles, seed=7).to(cuda)
    cap = FZConfig(capacity_frac=capacity_frac).payload_capacity(codes.numel())
    bitflags = torch.empty(n_tiles * 16, dtype=torch.uint32, device=cuda)
    payload = torch.full((cap, 8), -1, dtype=torch.int16, device=cuda).view(torch.uint16)
    nnz = torch.empty((), dtype=torch.int32, device=cuda)
    scratch = torch.zeros(n_tiles + 1, dtype=torch.int64, device=cuda)
    lib = build.library("fz_compress.cu")
    rc = lib.fz_fused_shuffle_encode(codes.data_ptr(), n_tiles, bitflags.data_ptr(),
                                     payload.data_ptr(), cap, nnz.data_ptr(),
                                     scratch.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    want = ref.fused_shuffle_encode_ref(codes, capacity=cap)
    for g, w in zip((bitflags, payload, nnz), want):
        assert _equal(g, w)
    if capacity_frac == 0.25:
        assert int(nnz) > cap          # the short capacity: an empty tail, the true nnz


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("code_mode", ["sign_mag", "zigzag"])
@pytest.mark.parametrize("capacity_frac", [1.0, 0.25])
@pytest.mark.parametrize("outliers", [False, True])
def test_fused_decompress_matches_plain(cuda, shape, code_mode, capacity_frac, outliers):
    x = _field(shape, seed=2)
    cfg = FZConfig(eb=1e-4, code_mode=code_mode, capacity_frac=capacity_frac,
                   exact_outliers=outliers, use_kernels=False)
    c = compress(x, cfg, device=cuda)
    if outliers:   # force residuals: overwrite some deltas with large values
        n = c.n
        c.outlier_idx[: min(3, c.outlier_idx.numel())] = torch.tensor(
            [0, n // 2, n - 1][: min(3, c.outlier_idx.numel())], dtype=torch.int32, device=cuda)
        c.outlier_val[: min(3, c.outlier_val.numel())] = 40000
    oidx = c.outlier_idx if outliers else None
    oval = c.outlier_val if outliers else None
    got = kernels.fused_decompress(c.bitflags, c.payload, c.eb_abs, shape=c.shape,
                                   code_mode=code_mode, outlier_idx=oidx, outlier_val=oval)
    want = ref.fused_decompress_ref(c.bitflags, c.payload, c.eb_abs, shape=c.shape,
                                    code_mode=code_mode, outlier_idx=oidx, outlier_val=oval)
    assert _equal(got, want)


# rows longer than a tile, rows of one element, the serving page (a flattened
# 1-D bfloat16 page of 2 x 32 layers x 64 positions x 4 KV heads x 128)
K6_SHAPES = [(2**16 + 3,), (3, 9000), (4100, 1), (2, 3, 1), (5, 1, 7), (2097152,)]


def _outlier_slots(n, kind, seed):
    """Outlier slots in no order: 'few' (repeats, fill slots at n, some tiles
    under their bin), 'many' (about 300 a tile: every bin overflows) or
    'one_tile' (all in the first tile)."""
    rng = np.random.default_rng(seed)
    if kind == "few":
        idx = np.array([n - 1, n, 0, n // 2, 0, n // 3, n - 1, n, n // 2, 1], np.int64)
    elif kind == "many":
        idx = rng.integers(0, n + 1, size=max(8, n // 14))
    else:
        idx = rng.integers(0, min(n, 4096), size=500)
    val = rng.integers(-2**31, 2**31, size=idx.size)
    val[idx == n] = 0
    return (torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(val.astype(np.int32)))


@pytest.mark.parametrize("shape", K6_SHAPES)
@pytest.mark.parametrize("code_mode", ["sign_mag", "zigzag"])
@pytest.mark.parametrize("capacity_frac", [1.0, 0.25])
@pytest.mark.parametrize("slots", [None, "few", "many", "one_tile"])
def test_fused_decompress_edge_shapes_and_slots_match_plain(cuda, shape, code_mode,
                                                            capacity_frac, slots):
    x = _field(shape, seed=8)
    if len(shape) == 1 and shape[0] == 2097152:
        x = x.to(torch.bfloat16)
    eb = (torch.tensor(1e-4) * (x.float().amax() - x.float().amin())).to(cuda)
    n = x.numel()
    cap = FZConfig(capacity_frac=capacity_frac).payload_capacity(n)
    bf, payload, _ = kernels.fused_compress(x.to(cuda), eb, capacity=cap, code_mode=code_mode)
    oidx, oval = _outlier_slots(n, slots, n) if slots else (None, None)
    args = dict(shape=shape, code_mode=code_mode,
                outlier_idx=None if oidx is None else oidx.to(cuda),
                outlier_val=None if oval is None else oval.to(cuda))
    got = kernels.fused_decompress(bf, payload, eb, **args)
    assert _equal(got, ref.fused_decompress_ref(bf, payload, eb, **args))
    if slots:                        # the plain version on the CPU, slots sorted
        order = torch.argsort(oidx.to(torch.int64), stable=True)
        cpu = ref.fused_decompress_ref(bf.cpu(), payload.cpu(), eb.cpu(), shape=shape,
                                       code_mode=code_mode, outlier_idx=oidx[order],
                                       outlier_val=oval[order])
        assert _equal(got, cpu)


@pytest.mark.parametrize("shape", SHAPES + K4_EDGE_SHAPES + K1_WALK_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("code_mode", ["sign_mag", "zigzag"])
def test_lorenzo_quant_matches_plain(cuda, shape, dtype, code_mode):
    x = _field(shape).to(dtype).to(cuda)
    eb = torch.tensor(1e-4, device=cuda) * (x.float().amax() - x.float().amin())
    got = kernels.lorenzo_quant(x, eb, code_mode=code_mode)
    assert got.dtype == torch.uint16 and got.shape == x.shape
    assert _equal(got, ref.lorenzo_quant_ref(x, eb, code_mode=code_mode))


@pytest.mark.parametrize("shape", [(5000,), (9, 33, 70), (2, 3, 5000), (5, 3, 1367),
                                   (3, 5000), (4, 64, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 3, 5])
def test_lorenzo_quant_of_a_view_off_16_bytes_matches_plain(cuda, shape, dtype, offset):
    """K1 reads 16-byte chunks aligned to the data's address, not to its start."""
    n = int(np.prod(shape))
    buf = _field((n + 8,)).to(dtype).to(cuda)
    x = buf[offset:offset + n].view(shape)
    eb = torch.tensor(1e-3, device=cuda) * (x.float().amax() - x.float().amin())
    got = kernels.lorenzo_quant(x, eb)
    assert _equal(got, ref.lorenzo_quant_ref(x, eb))


@pytest.mark.parametrize("shape", SHAPES + K4_EDGE_SHAPES)
def test_bitshuffle_flag_and_unshuffle_match_plain(cuda, shape):
    rng = np.random.default_rng(2)
    n = int(np.prod(shape))
    codes = torch.from_numpy(rng.geometric(0.3, size=n).astype(np.int32) - 1)
    tiles = shuffle.pad_to_tiles(codes).to(torch.uint16).reshape(-1, shuffle.TILE).to(cuda)
    got = kernels.bitshuffle_flag(tiles)
    want = ref.bitshuffle_flag_ref(tiles)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _equal(g, w)
    back = kernels.bitunshuffle_tiles(got[0])
    assert _equal(back, ref.bitunshuffle_ref(got[0]))
    assert _equal(back, tiles)


@pytest.mark.parametrize("exact_outliers", [True, False])
def test_staged_entry_points_launch_the_staged_kernels(cuda, exact_outliers):
    x = _field((9, 33, 70), seed=3)
    cfg = FZConfig(eb=1e-3, exact_outliers=exact_outliers, kernel_mode="staged")
    kernels.reset_launch_counts()
    c = compress(x, cfg)
    y = decompress(c, cfg)
    counts = kernels.launch_counts()
    assert counts == {"lorenzo_quant": 0 if exact_outliers else 1, "bitshuffle_flag": 1,
                      "bitunshuffle_tiles": 1, "fused_compress": 0, "fused_compress_strict": 0,
                      "fused_shuffle_encode": 0, "fused_decompress": 0, "flash_decode": 0}
    plain = FZConfig(eb=1e-3, exact_outliers=exact_outliers, use_kernels=False)
    c0 = compress(x, plain)
    for f in c.FIELDS:
        assert _equal(getattr(c, f), getattr(c0, f)), f
    assert _equal(y, decompress(c0, plain))


@pytest.mark.parametrize("entropy", [False, True, "auto"])
def test_cold_and_batch_forms_on_the_card(cuda, entropy):
    from repro_torch import (compress_batch_with_eb, compress_with_eb, decompress_batch,
                             decompress_bytes, to_bytes)
    x = _field((9, 33, 70), seed=6)
    cfg = FZConfig(eb=1e-4)
    c = compress(x, cfg)
    kernels.reset_launch_counts()
    y = decompress_bytes(to_bytes(c, cfg, entropy=entropy))
    assert kernels.launch_counts()["fused_decompress"] == 1
    assert y.device.type == "cuda" and _equal(y, decompress(c, cfg))
    rows = _field((4, 5000), seed=7)
    cb = compress_batch_with_eb(rows, 1e-3, cfg)
    yb = decompress_batch(cb, cfg)
    for i in range(rows.shape[0]):
        one = compress_with_eb(rows[i], 1e-3, cfg)
        for f in c.FIELDS:
            assert _equal(getattr(cb, f)[i], getattr(one, f)), (i, f)
        assert _equal(yb[i], decompress(one, cfg))


@pytest.mark.parametrize("exact_outliers", [True, False])
def test_entry_points_launch_the_kernels(cuda, exact_outliers):
    x = _field((9, 33, 70), seed=3)
    cfg = FZConfig(eb=1e-3, exact_outliers=exact_outliers)
    kernels.reset_launch_counts()
    c = compress(x, cfg)
    y = decompress(c, cfg)
    counts = kernels.launch_counts()
    assert counts["fused_compress"] == (0 if exact_outliers else 1)
    assert counts["fused_compress_strict"] == (1 if exact_outliers else 0)
    assert counts["fused_shuffle_encode"] == 0
    assert counts["fused_decompress"] == 1
    plain = FZConfig(eb=1e-3, exact_outliers=exact_outliers, use_kernels=False)
    c0 = compress(x, plain)
    for f in c.FIELDS:
        assert _equal(getattr(c, f), getattr(c0, f)), f
    assert _equal(y, decompress(c0, plain))


@pytest.mark.parametrize("exact_outliers", [True, False])
def test_zero_field_and_smallest_capacity(cuda, exact_outliers):
    """All-zero data (no block flagged, the 1e-30 eb floor) and capacity 1."""
    for x, frac in ((torch.zeros(9, 33, 70), 1.0), (_field((9, 33, 70), seed=5), 1e-9)):
        cfg = FZConfig(eb=1e-3, capacity_frac=frac, exact_outliers=exact_outliers)
        plain = FZConfig(eb=1e-3, capacity_frac=frac, exact_outliers=exact_outliers,
                         use_kernels=False)
        c, c0 = compress(x, cfg), compress(x, plain)
        assert c.payload.shape[0] == c0.payload.shape[0]
        for f in c.FIELDS:
            assert _equal(getattr(c, f), getattr(c0, f)), f
        assert _equal(decompress(c, cfg), decompress(c0, plain))


def test_overflowing_deltas_take_the_outlier_route(cuda):
    """Strict mode on a field with jumps: the residual channel fills and strict
    K4 still matches the plain route."""
    x = _field((9, 33, 70), seed=4)
    x[::2] += 1000.0
    cfg = FZConfig(eb=1e-3, eb_mode="abs")
    c = compress(x, cfg)
    assert int(c.n_outliers) > 0
    y = decompress(c, cfg)
    plain = FZConfig(eb=1e-3, eb_mode="abs", use_kernels=False)
    assert _equal(y, decompress(compress(x, plain), plain))


# K7 cases (as chip_smoke.py): B, H, KVH, D, pages P (or slice length S),
# page size (0: contiguous), dtype, lengths, kv_tile, shard_offset
K7_CASES = [
    (4, 32, 4, 128, 13, 64, torch.bfloat16, [0, 100, 128, 832], None, 0),   # serving geometry
    (4, 32, 4, 128, 13, 64, torch.float32, [700, 31, 64, 1], None, 0),
    (3, 4, 4, 64, 5, 7, torch.float32, [0, 20, 35], None, 0),               # ps 7, G 1
    (3, 4, 1, 64, 5, 7, torch.bfloat16, [3, 40, 36], None, 0),              # G 4
    (2, 8, 2, 64, 50, 0, torch.float32, [60, 17], 16, 7),                   # offset, overlong
    (2, 8, 8, 64, 50, 0, torch.bfloat16, [0, 49], None, 0),
    (2, 8, 2, 256, 300, 0, torch.float32, [300, 250], 128, 0),
    # split over pages: one page a split at the serving geometry (13 splits;
    # 64 and 128 on split borders, 900 past the slice), 2 splits of 2 pages
    # (B x KVH = 128), one split walking 4 pages (B x KVH = 264)
    (4, 32, 4, 128, 13, 64, torch.bfloat16, [64, 5, 128, 900], None, 0),
    (16, 64, 8, 64, 4, 16, torch.bfloat16, [0, 5, 32, 100] * 4, None, 0),
    (33, 16, 8, 64, 4, 16, torch.float32, [0, 5, 16, 100] * 8 + [64], None, 0),
    (2, 16, 8, 128, 1, 64, torch.bfloat16, [0, 40], None, 0),
    # rows of 24 bytes, not a multiple of 16: copied by plain loads, not cp.async
    (2, 8, 2, 12, 5, 7, torch.bfloat16, [0, 30], None, 0),
    (3, 4, 4, 6, 50, 0, torch.float32, [50, 13, 0], 16, 0),
    # group sizes that do not divide K7's 32 lane groups: dbrx-132b (48 heads
    # over 8, G 6) and llama4-scout-17b-a16e (40 over 8, G 5), pages of 64
    (4, 48, 8, 128, 13, 64, torch.bfloat16, [0, 100, 128, 832], None, 0),
    (4, 40, 8, 128, 13, 64, torch.bfloat16, [64, 5, 500, 900], None, 0),
]


@pytest.mark.parametrize("case", K7_CASES, ids=[f"k7-{i}" for i in range(len(K7_CASES))])
def test_flash_decode_matches_plain(cuda, case):
    B, H, KVH, D, P, ps, dtype, lengths, tile, off = case
    g = torch.Generator().manual_seed(7)
    q = torch.randn(B, H, D, generator=g).to(cuda)
    shape = (B, P, ps, KVH, D) if ps else (B, P, KVH, D)
    k, v = (torch.randn(*shape, generator=g).to(dtype).to(cuda) for _ in range(2))
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    kernels.reset_launch_counts()
    if ps:
        got = fd.decode_partials_pages(q, k, v, length)
        want = fd.decode_partials_pages(q.cpu(), k.cpu(), v.cpu(), length.cpu(), device="cpu")
    else:
        got = fd.decode_partials(q, k, v, length, kv_tile=tile, shard_offset=off)
        want = fd.decode_partials(q.cpu(), k.cpu(), v.cpu(), length.cpu(), kv_tile=tile,
                                  shard_offset=off, device="cpu")
    assert kernels.launch_counts()["flash_decode"] == 1
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, atol=2e-4, rtol=0)
    for b, n in enumerate(lengths):
        if n - off <= 0:
            assert torch.all(got[0][b] == -1e30) and torch.all(got[1][b] == 0)
            assert torch.all(got[2][b] == 0)


def test_flash_decode_reads_the_strided_page_view(cuda):
    """The pool's gathered view (B and P strided) is read in place, and a page
    view with a non-contiguous page is refused."""
    slab = torch.randn(4, 13, 2, 3, 64, 4, 128, device=cuda).to(torch.bfloat16)
    kv = slab.permute(2, 3, 0, 1, 4, 5, 6)
    k, v = kv[0][1], kv[1][1]
    q = torch.randn(4, 32, 128, device=cuda)
    length = torch.tensor([700, 650, 832, 0], dtype=torch.int32, device=cuda)
    got = fd.decode_partials_pages(q, k, v, length)
    want = fd.decode_partials_pages(q, k.contiguous(), v.contiguous(), length)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    every_other = k[:, :, ::2]            # positions of a page 2 rows apart
    with pytest.raises(ValueError, match="contiguous"):
        fd.decode_partials_pages(q, every_other, v[:, :, ::2], length // 2)


def test_smoke_serve_on_the_card_launches_k7_per_layer_and_step(cuda):
    from repro_torch.launch import serve as launch_serve
    kernels.reset_launch_counts()
    out = launch_serve.main(["--arch", "yi-6b", "--smoke", "--paged", "--prompt-len", "24",
                             "--tokens", "8"])
    counts = kernels.launch_counts()
    assert out["stats"].completed == 2
    assert counts["flash_decode"] == out["stats"].decode_steps * 2      # 2 layers
    assert counts["fused_compress"] > 0 and counts["fused_decompress"] > 0


# -- obs on the card ------------------------------------------------------------

def _syncs(fn) -> int:
    """Synchronizing CUDA calls ``fn`` makes, as ``set_sync_debug_mode("warn")``
    reports them."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def test_span_around_k4_records_its_event_and_adds_no_sync(cuda):
    from repro_torch import compress_with_eb, obs
    from repro_torch.obs import spans
    obs.reset()
    obs.clear_events()
    try:
        x = _field((9, 33, 70)).to(cuda)
        eb = torch.tensor(1e-3, device=cuda)
        with obs.span("k4.call", data=x):
            kernels.fused_compress(x, eb, capacity=64)
        (ev,) = [e for e in spans.events() if e["name"] == "k4.call"]
        assert ev["cat"] == "span" and ev["args"]["data"] == "Tensor[9, 33, 70] float32 cuda:0"
        cfg = FZConfig(eb_mode="abs", exact_outliers=False)
        call = lambda: compress_with_eb(x, 1e-3, cfg)     # noqa: E731
        call()
        on = _syncs(call)
        with obs.disabled():
            off = _syncs(call)
        assert on == off
        assert obs.counter("fz_dispatches", op="compress", path="fused").value >= 2
        stage = [e for e in spans.events() if e["name"] == "fz.stage.fused_compress"]
        assert stage and all(e["args"] == {"backend": "cuda"} for e in stage)
    finally:
        obs.reset()
        obs.clear_events()


@pytest.mark.parametrize("strict", [False, True], ids=["paper", "strict"])
def test_fz_host_syncs_count_the_cards_syncs(cuda, strict):
    """``fz_host_syncs`` counts what ``set_sync_debug_mode`` reports of a
    compress and its size read (``used_bytes``'s two reads in both modes:
    strict K4 writes the outlier channel on the card, with no ``nonzero``),
    and the spans, counters and GC hook add no sync (on == off)."""
    from repro_torch import obs
    obs.reset()
    obs.clear_events()
    try:
        x = _field((70000,) if strict else (9, 33, 70)).to(cuda)
        cfg = FZConfig(eb=1e-5) if strict else FZConfig(exact_outliers=False)
        call = lambda: compress(x, cfg).used_bytes()     # noqa: E731
        call()
        obs.reset()
        on = _syncs(call)
        counted = sum(v for k, v in obs.snapshot()["counters"].items()
                      if k.startswith("fz_host_syncs{"))
        assert counted == on == 2
        with obs.disabled():
            off = _syncs(call)
        assert on == off
    finally:
        obs.reset()
        obs.clear_events()


def test_span_in_a_cuda_graph_capture_records_only_a_trace_time_event(cuda):
    from repro_torch import obs
    from repro_torch.obs import spans
    obs.reset()
    obs.clear_events()
    try:
        x = torch.arange(4096, dtype=torch.float32, device=cuda)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):            # warm up off the capture
            y = x * 2 + 1
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            with obs.span("graph.body"):
                y = x * 2 + 1
        x.copy_(torch.arange(4096, dtype=torch.float32, device=cuda) * 3)
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, x * 2 + 1)
        evs = [e for e in spans.events() if e["name"] == "graph.body"]
        assert len(evs) == 1 and evs[0]["cat"] == "jit-trace"
        assert obs.counter("span_traces", span="graph.body").value == 1
        assert obs.counter("span_calls", span="graph.body").value == 0
        assert not spans.trace_time()
    finally:
        obs.reset()
        obs.clear_events()


def test_launcher_profile_dir_holds_the_card_kernels(cuda, tmp_path):
    import json
    from repro_torch.launch import serve as launch_serve
    from repro_torch.obs import cli as obs_cli
    launch_serve.main(["--arch", "yi-6b", "--smoke", "--paged", "--prompt-len", "24",
                       "--tokens", "4", "--profile-dir", str(tmp_path)])
    doc = json.loads((tmp_path / obs_cli.PROFILE_FILE).read_text())
    kernel_names = {e["name"] for e in doc["traceEvents"] if e.get("cat") == "kernel"}
    assert any("flash_decode" in n for n in kernel_names), sorted(kernel_names)[:20]
    ranges = {e["name"] for e in doc["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"engine.serve", "sched.step", "engine.decode_step_paged"} <= ranges


# -- the wire (dist) and checkpoints (ckpt) on the card -------------------------

def _wire_grads(n_pods, device):
    g = torch.Generator().manual_seed(5)
    f = lambda *s: torch.randn((n_pods,) + s, generator=g).to(device)  # noqa: E731
    return {"layers": {"wq": f(2, 128, 256), "wk": f(2, 128, 64)}, "embed": f(1000, 130),
            "final_norm": f(4096), "bias": f(8),
            "emb_bf16": f(96, 100).to(torch.bfloat16)}


def _same_tree(a, b):
    from repro_torch import pytree
    la, lb = pytree.leaves_with_keys(a), pytree.leaves_with_keys(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert _equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                      y.view(torch.int16) if y.dtype == torch.bfloat16 else y), k


@pytest.mark.parametrize("n_pods", [2, 3])
def test_reduce_on_the_card_matches_plain_cpu_and_bucketed(cuda, n_pods):
    """Three error-feedback steps of ``reduce_stacked`` (K4, K6) equal the plain
    route on the card and the CPU route, bit for bit; the bucketed form equals
    it; K4 and K6 launched."""
    import dataclasses
    from repro_torch.dist import bucketed_reduce as bkt
    from repro_torch.dist import compressed_allreduce as car
    from repro_torch import pytree
    cfg = car.GradCompressionConfig(enabled=True, min_leaf_size=1024)
    routes = {"kernel": (cfg, cuda), "plain": (dataclasses.replace(cfg, use_kernels=False), cuda),
              "cpu": (cfg, torch.device("cpu")),
              "bucketed": (dataclasses.replace(cfg, overlap=True, bucket_bytes=1 << 16), cuda)}
    ab = pytree.tree_map(lambda t: torch.empty(t.shape[1:], dtype=t.dtype, device="meta"),
                         _wire_grads(n_pods, "cpu"))
    errs = {r: car.init_error_state(ab, n_pods, c, device=d) for r, (c, d) in routes.items()}
    kernels.reset_launch_counts()
    for _ in range(3):
        out = {}
        for r, (c, d) in routes.items():
            fn = bkt.reduce_stacked_bucketed if r == "bucketed" else car.reduce_stacked
            out[r], errs[r] = fn(_wire_grads(n_pods, d), errs[r], c)
        for r in ("plain", "cpu", "bucketed"):
            _same_tree(out["kernel"], out[r])
            _same_tree(errs["kernel"], errs[r])
    counts = kernels.launch_counts()
    assert counts["fused_compress"] > 0 and counts["fused_decompress"] > 0


@pytest.mark.parametrize("lengths", [[600, 417, 208, 1], [832, 700, 5, 0]])
def test_flash_decode_shards_on_the_card(cuda, lengths):
    """K7 partials at each shard's offset (one shard past every length in the
    first set), combined by ``combine_shards``: within 2e-4 of the plain
    attention."""
    from repro_torch.dist import flash_decode as fdp
    from repro_torch.models.attention import decode_attention
    g = torch.Generator().manual_seed(2)
    B, H, KVH, D, S, n = 4, 32, 4, 128, 832, 4
    q, k, v = (torch.randn(s, generator=g).to(cuda).to(torch.bfloat16)
               for s in ((B, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    length = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    s = S // n
    kernels.reset_launch_counts()
    parts = [fdp.shard_partials(q, k[:, i * s:(i + 1) * s], v[:, i * s:(i + 1) * s], length,
                                shard_offset=i * s) for i in range(n)]
    assert kernels.launch_counts()["flash_decode"] == n
    got = fdp.combine_shards(parts)
    want = decode_attention(q.float(), k, v, length)
    valid = length > 0                      # a length-0 row: the reference degenerates to a mean
    torch.testing.assert_close(got[valid], want[valid], rtol=2e-4, atol=2e-4)


def test_checkpoint_on_the_card_matches_the_cpu(cuda, tmp_path):
    """``codec="fz"`` compresses on the card (strict K4) and restores with K6: the files
    equal the CPU port's byte for byte, the bound holds and bf16 comes back exact."""
    from repro_torch import ckpt
    from repro_torch.ckpt import checkpoint
    g = torch.Generator().manual_seed(4)
    tree = {"w": torch.randn(512, 300, generator=g).cumsum(0), "n": torch.randn(70000, generator=g),
            "e": torch.randn(300, 256, generator=g).to(torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int32)}
    kernels.reset_launch_counts()
    d_card = ckpt.save(str(tmp_path / "card"), 1, {k: v.to(cuda) for k, v in tree.items()},
                       codec="fz")
    d_cpu = ckpt.save(str(tmp_path / "cpu"), 1, tree, codec="fz", device="cpu")
    for name in sorted(os.listdir(d_cpu)):
        assert open(os.path.join(d_card, name), "rb").read() == \
            open(os.path.join(d_cpu, name), "rb").read(), name
    back, meta = ckpt.restore(str(tmp_path / "card"), tree)
    counts = kernels.launch_counts()
    assert counts["fused_compress_strict"] > 0 and counts["fused_decompress"] > 0
    assert meta["step"] == 1
    for key in ("w", "n"):
        x = tree[key]
        eb = float(checkpoint._FZ_CKPT.eb * torch.maximum(x.max() - x.min(), x.abs().max()))
        rng_ = float(x.max() - x.min())
        assert float((back[key].cpu() - x).abs().max()) <= eb * 1.01 + rng_ * 2e-7
    assert torch.equal(back["e"].cpu().view(torch.int16), tree["e"].view(torch.int16))
    assert torch.equal(back["step"].cpu(), tree["step"])


def test_train_step_on_the_card_matches_the_plain_route(cuda):
    """Two compressed training steps at the yi-6b smoke config, two pods in one
    process (a stand-in pod mesh): the kernel route (K4, K6 once a leaf past
    ``min_leaf_size`` and pod a step) equals the plain route bit for bit, and
    the same run repeated equals itself (the step is deterministic)."""
    import dataclasses
    from repro_torch import configs, pytree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.dist import compressed_allreduce as car
    from repro_torch.models import zoo
    from repro_torch.train import TrainConfig, Trainer
    cfg = configs.get("yi-6b", smoke=True)
    model = zoo.build(cfg)
    shape = ShapeConfig("tiny", 64, 4, "train")
    mesh = type("Mesh", (), {"axis_names": ("pod", "data", "model"),
                             "shape": {"pod": 2, "data": 1, "model": 1}})()
    params = model.init(torch.Generator(device=cuda).manual_seed(0), device=cuda)
    gc = car.GradCompressionConfig(enabled=True, min_leaf_size=1024)
    n_fz = sum(1 for t in pytree.leaves(model.abstract_params()) if t.numel() >= 1024)
    states = []
    for use_kernels in (True, False, True):
        t = Trainer(model, shape, mesh, TrainConfig(grad_compress=dataclasses.replace(
            gc, use_kernels=use_kernels), total_steps=4, warmup_steps=1),
            stream=TokenStream(cfg.vocab, 64, 4, seed=0), init_params=params, device=cuda)
        kernels.reset_launch_counts()
        hist = t.run(2)
        counts = kernels.launch_counts()
        want = 2 * 2 * n_fz if use_kernels else 0
        assert counts["fused_compress"] == counts["fused_decompress"] == want
        assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in hist)
        states.append(t._state())
    _same_tree(states[0], states[1])
    _same_tree(states[0], states[2])


def test_overlap_step_on_the_card_equals_the_barrier_step(cuda):
    """Two pods in one process, two steps, one and two microbatches: the
    overlap form (each bucket issued from the backward on a side stream)
    equals the barrier form bit for bit, and every bucket is issued from the
    backward."""
    import dataclasses
    from repro_torch import configs, obs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.dist import bucketed_reduce as bkt
    from repro_torch.dist import compressed_allreduce as car
    from repro_torch.models import zoo
    from repro_torch.train import TrainConfig, Trainer
    cfg = configs.get("yi-6b", smoke=True)
    model = zoo.build(cfg)
    shape = ShapeConfig("tiny", 64, 4, "train")
    mesh = type("Mesh", (), {"axis_names": ("pod", "data", "model"),
                             "shape": {"pod": 2, "data": 1, "model": 1}})()
    params = model.init(torch.Generator(device=cuda).manual_seed(0), device=cuda)
    gc = car.GradCompressionConfig(enabled=True, min_leaf_size=1024, bucket_bytes=1 << 16)
    for n_micro in (1, 2):
        states, early = [], 0
        for overlap in (False, True):
            t = Trainer(model, shape, mesh, TrainConfig(
                grad_compress=dataclasses.replace(gc, overlap=overlap), total_steps=4,
                warmup_steps=1, microbatches=n_micro),
                stream=TokenStream(cfg.vocab, 64, 4, seed=0), init_params=params, device=cuda)
            before = obs.counter(bkt.IN_BACKWARD).value
            t.run(2)
            early = obs.counter(bkt.IN_BACKWARD).value - before
            states.append(t._state())
        assert t.info["mode"] == "overlap" and early == 2 * t.info["plan"].n_buckets > 2
        _same_tree(states[0], states[1])


def test_train_launcher_on_the_card_saves_and_resumes_with_the_fz_codec(cuda, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch yi-6b --smoke --ckpt-codec fz``
    on the card: 2 steps, then 3 from the same directory. The save compresses
    the large float32 leaves with strict K4, the restore decodes them with K6, and the
    printed lines are the reference's."""
    from repro_torch.launch import train as launch_train
    root = str(tmp_path / "ck")
    args = ["--arch", "yi-6b", "--smoke", "--seq", "32", "--batch", "4",
            "--ckpt-codec", "fz", "--ckpt-dir", root]
    kernels.reset_launch_counts()
    launch_train.main(args + ["--steps", "2"])
    saved = kernels.launch_counts()
    kernels.reset_launch_counts()
    hist = launch_train.main(args + ["--steps", "3"])
    resumed = kernels.launch_counts()
    out = capsys.readouterr().out.splitlines()
    head = "yi-6b-smoke: 0.4M params, mesh={'data': 1, 'model': 1}, reduce=exact, resume_step="
    assert [line for line in out if line.startswith("yi-6b")] == [head + "0", head + "2"]
    assert [m["step"] for m in hist] == [2] and np.isfinite(hist[0]["loss"])
    assert saved["fused_compress_strict"] > 0 and resumed["fused_decompress"] > 0
    assert saved["fused_compress"] == resumed["fused_compress"] == 0     # no pod axis


def test_moe_routes_on_the_card_as_on_the_cpu(cuda):
    """Exactly representable router and input (small integers times powers of
    two), experts 1 and 3 tied on every token and one all-zero token: the top-k
    indices, slots, drops and dispatch mask on the card equal the CPU's, and
    the outputs agree within 0.0625 (bfloat16 sums in another order)."""
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import moe
    cfg = ArchConfig(arch_id="t", family="moe", n_layers=1, d_model=32, n_heads=2,
                     n_kv_heads=2, d_ff=64, vocab=128, n_experts=4, top_k=2,
                     capacity_factor=0.5)
    rng = np.random.default_rng(1)
    router = rng.integers(-2, 3, (32, 4)).astype(np.float32) * 0.25
    router[:, 3] = router[:, 1]
    h = rng.integers(-3, 4, (2, 16, 32)).astype(np.float32) * 0.5
    h[0, 5] = 0.0
    lp = {"router": torch.from_numpy(router)}
    for name, shape in (("we_gate", (4, 32, 64)), ("we_up", (4, 32, 64)),
                        ("we_down", (4, 64, 32))):
        lp[name] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.2) \
            .to(torch.bfloat16)
    x = torch.from_numpy(h).to(torch.bfloat16)
    C = max(1, int(32 * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    want = moe.route(lp, x.reshape(1, 32, 32), cfg, C)
    got = moe.route({k: v.to(cuda) for k, v in lp.items()}, x.to(cuda).reshape(1, 32, 32),
                    cfg, C)
    for key in ("idx", "pos", "keep", "oh_pos", "dispatch"):
        assert torch.equal(got[key].cpu(), want[key]), key
    assert int((1 - want["keep"]).sum()) > 0 and want["idx"][0, 5].tolist() == [0, 1]
    y, aux = moe.moe_apply({k: v.to(cuda) for k, v in lp.items()}, x.to(cuda), cfg)
    y0, aux0 = moe.moe_apply(lp, x, cfg)
    torch.testing.assert_close(y.float().cpu(), y0.float(), atol=0.0625, rtol=0)
    torch.testing.assert_close(aux.cpu(), aux0, rtol=1e-6, atol=0)
