"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA card. Run on a card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The FZ kernels (K1-K6) are held bit for bit: they and their plain versions do
the same integer work and the same IEEE float divide and multiply. K7
(flash-decode) is held at 2e-4: float32 sums in another order; fully masked
rows exactly (-1e30, 0, 0).
"""
import numpy as np
import pytest
import torch

from repro_torch import FZConfig, compress, decompress, kernels
from repro_torch.core import shuffle
from repro_torch.data.fields import make_field
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref

pytestmark = pytest.mark.cuda

SHAPES = [(5000,), (37, 130), (9, 33, 70), (3, 4096), (2, 64, 64), (70000,),
          (1,), (4096,), (3, 1, 7), (5000, 1), (1, 4097)]


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


@pytest.mark.parametrize("shape", SHAPES)
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


@pytest.mark.parametrize("shape", SHAPES)
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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("code_mode", ["sign_mag", "zigzag"])
def test_lorenzo_quant_matches_plain(cuda, shape, dtype, code_mode):
    x = _field(shape).to(dtype).to(cuda)
    eb = torch.tensor(1e-4, device=cuda) * (x.float().amax() - x.float().amin())
    got = kernels.lorenzo_quant(x, eb, code_mode=code_mode)
    assert got.dtype == torch.uint16 and got.shape == x.shape
    assert _equal(got, ref.lorenzo_quant_ref(x, eb, code_mode=code_mode))


@pytest.mark.parametrize("shape", SHAPES)
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
                      "bitunshuffle_tiles": 1, "fused_compress": 0,
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
    assert counts["fused_shuffle_encode"] == (1 if exact_outliers else 0)
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
    """Strict mode on a field with jumps: the residual channel fills and K5 still
    matches the plain route."""
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
