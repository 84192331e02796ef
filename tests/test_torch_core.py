"""The port's core stages (quant, shuffle, encode, metrics, fields) against the
reference's, bit for bit, on the CPU.

Inputs are made from a seed with numpy and handed to both packages. Integer
results are compared by value (the port carries u16 codes as int32), float
results by their bits. The reference's stage functions need no API aliases.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encode as jenc
from repro.core import metrics as jmetrics
from repro.core import quant as jquant
from repro.core import shuffle as jshuffle
from repro.data import fields as jfields
from repro_torch.core import encode as enc
from repro_torch.core import metrics, quant, shuffle
from repro_torch.data import fields

SHAPES = [(1000,), (5000,), (37, 130), (17, 23), (9, 33, 70), (5, 7, 11)]


def assert_same(ref, port):
    """Equal shape and values; floats equal bit for bit."""
    a = np.asarray(ref)
    b = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


def _ints(seed, shape, lo, hi):
    return np.random.default_rng(seed).integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _codes(seed, n):
    """u16 codes with the zero-heavy skew real code streams have."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 1 << 16, size=n, dtype=np.int64)
    c[rng.random(n) < 0.7] = 0
    return c.astype(np.uint16)


# ---------------------------------------------------------------------------
# core/quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_lorenzo_delta_and_inverse(shape):
    q = _ints(1, shape, -100000, 100000)
    d = quant.lorenzo_delta(torch.from_numpy(q))
    assert_same(jquant.lorenzo_delta(jnp.asarray(q)), d)
    assert_same(jquant.lorenzo_inverse(jnp.asarray(d.numpy())), quant.lorenzo_inverse(d))


def test_lorenzo_wraps_like_int32():
    q = np.array([2**31 - 1, -(2**31), 5, 2**31 - 7], np.int32)
    assert_same(jquant.lorenzo_delta(jnp.asarray(q)), quant.lorenzo_delta(torch.from_numpy(q)))
    assert_same(jquant.lorenzo_inverse(jnp.asarray(q)), quant.lorenzo_inverse(torch.from_numpy(q)))


@pytest.mark.parametrize("code_mode", ["sign_mag", "zigzag"])
@pytest.mark.parametrize("span", [32767, 70000, 2**30])
def test_to_codes_and_from_codes(code_mode, span):
    d = _ints(2, (4000,), -span, span)
    d[:4] = [0, -1, span - 1, -span]
    jc, jo, jr = jquant.to_codes(jnp.asarray(d), code_mode=code_mode)
    c, o, r = quant.to_codes(torch.from_numpy(d), code_mode=code_mode)
    assert_same(jc, c)
    assert_same(jo, o)
    assert_same(jr, r)
    assert_same(jquant.from_codes(jc, code_mode=code_mode),
                quant.from_codes(c, code_mode=code_mode))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("code_mode", ["sign_mag", "zigzag"])
@pytest.mark.parametrize("outlier_capacity", [0, 4, 64])
def test_dual_quantize(shape, code_mode, outlier_capacity):
    x = fields.make_field("particle" if len(shape) == 1 else "turbulent", shape, seed=3)
    x[..., ::7] += 20.0 * (x.max() - x.min())   # jumps: deltas overflow a u16 code
    eb = np.float32(1e-5 * (x.max() - x.min()))
    got = quant.dual_quantize(torch.from_numpy(x), torch.tensor(eb), code_mode=code_mode,
                              outlier_capacity=outlier_capacity)
    want = jquant.dual_quantize(jnp.asarray(x), jnp.float32(eb), code_mode=code_mode,
                                outlier_capacity=outlier_capacity)
    for w, g in zip(want, got):
        assert_same(w, g)
    assert int(got[3]) >= 4         # overflows present; most shapes exceed capacity 4


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("code_mode", ["sign_mag", "zigzag"])
def test_dual_dequantize_with_outliers(shape, code_mode):
    x = fields.make_field("smooth", shape, seed=4)
    x[..., ::5] += 50.0
    eb = np.float32(1e-4)
    jc, ji, jv, _ = jquant.dual_quantize(jnp.asarray(x), jnp.float32(eb), code_mode=code_mode,
                                         outlier_capacity=max(1, x.size // 16))
    want = jquant.dual_dequantize(jc, jnp.float32(eb), shape, code_mode=code_mode,
                                  outlier_idx=ji, outlier_val=jv)
    got = quant.dual_dequantize(torch.from_numpy(np.array(jc, np.int32)),
                                torch.tensor(eb), shape, code_mode=code_mode,
                                outlier_idx=torch.from_numpy(np.array(ji)),
                                outlier_val=torch.from_numpy(np.array(jv)))
    assert_same(want, got)


def test_dual_quantize_rounds_ties_to_even():
    """x / (2 eb) lands exactly on .5: the divide and half-even rounding decide."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5, 1e-3, 7.0], np.float32)
    eb = np.float32(0.5)
    got = quant.dual_quantize(torch.from_numpy(x), torch.tensor(eb))
    want = jquant.dual_quantize(jnp.asarray(x), jnp.float32(eb))
    assert_same(want[0], got[0])


# ---------------------------------------------------------------------------
# core/shuffle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transpose16(seed):
    x = _codes(seed, 64 * 16).reshape(64, 16)
    assert_same(jshuffle.transpose16(jnp.asarray(x)), shuffle.transpose16(torch.from_numpy(x)))


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 12288 + 5])
def test_pad_to_tiles(n):
    c = _codes(n, n)
    assert_same(jshuffle.pad_to_tiles(jnp.asarray(c)), shuffle.pad_to_tiles(torch.from_numpy(c)))


@pytest.mark.parametrize("n_tiles", [1, 2, 5])
def test_bitshuffle_and_unshuffle(n_tiles):
    c = _codes(10 + n_tiles, n_tiles * shuffle.TILE)
    js = jshuffle.bitshuffle(jnp.asarray(c))
    s = shuffle.bitshuffle(torch.from_numpy(c))
    assert_same(js, s)
    assert_same(jshuffle.bitunshuffle(js), shuffle.bitunshuffle(s))
    assert_same(c, shuffle.bitunshuffle(s))


def test_bitshuffle_bit_convention():
    """(element e, bit b) -> (element 15-b, bit 15-e) within a group."""
    c = np.zeros(shuffle.TILE, np.uint16)
    c[3] = 1 << 5                     # group 0, element 3, bit 5
    s = shuffle.bitshuffle(torch.from_numpy(c)).numpy()
    w = 15 - 5                        # word (plane) 10 of group 0
    assert s[w * shuffle.GROUPS_PER_TILE + 0] == 1 << (15 - 3)
    assert np.count_nonzero(s) == 1


def test_shuffle_rejects_partial_tiles():
    with pytest.raises(ValueError):
        shuffle.bitshuffle(torch.zeros(100, dtype=torch.int32))
    with pytest.raises(ValueError):
        shuffle.bitunshuffle(torch.zeros(100, dtype=torch.int32))


# ---------------------------------------------------------------------------
# core/encode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_blocks", [1, 31, 32, 33, 512, 1500])
def test_flag_words_and_bitflag_packing(n_blocks):
    assert enc.flag_words(n_blocks) == jenc.flag_words(n_blocks)
    flags = np.random.default_rng(n_blocks).random(n_blocks) < 0.4
    jp = jenc.pack_bitflags(jnp.asarray(flags))
    p = enc.pack_bitflags(torch.from_numpy(flags))
    assert p.dtype == torch.uint32
    assert_same(jp, p)
    assert_same(jenc.unpack_bitflags(jp, n_blocks), enc.unpack_bitflags(p, n_blocks))


@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
@pytest.mark.parametrize("capacity_frac", [1.0, 0.25])
def test_encode_decode_and_compaction(density, capacity_frac):
    rng = np.random.default_rng(int(density * 100))
    words = rng.integers(1, 1 << 16, size=2 * shuffle.TILE).astype(np.uint16)
    words = (words.reshape(-1, 8) * (rng.random(words.size // 8) < density)[:, None])
    words = words.reshape(-1).astype(np.uint16)
    n_blocks = words.size // 8
    cap = max(1, int(n_blocks * capacity_frac))
    assert_same(jenc.block_flags(jnp.asarray(words)), enc.block_flags(torch.from_numpy(words)))
    jout = jenc.encode(jnp.asarray(words), capacity=cap)
    out = enc.encode(torch.from_numpy(words), capacity=cap)
    assert out[1].dtype == torch.uint16
    for w, g in zip(jout, out):
        assert_same(w, g)
    assert_same(jenc.decode(jout[0], jout[1], n_blocks=n_blocks),
                enc.decode(out[0], out[1], n_blocks=n_blocks))
    flags = torch.from_numpy(words.reshape(-1, 8).any(axis=1))
    for w, g in zip(jenc.compact_blocks(jnp.asarray(flags.numpy()),
                                        jnp.asarray(words.reshape(-1, 8)), capacity=cap),
                    enc.compact_blocks(flags, torch.from_numpy(words.reshape(-1, 8)),
                                       capacity=cap)):
        assert_same(w, g)


@pytest.mark.parametrize("nnz,n_out", [(0, 0), (17, 0), (300, 9)])
def test_used_bytes(nnz, n_out):
    want = jenc.used_bytes(4096, jnp.int32(nnz), jnp.int32(n_out))
    assert enc.used_bytes(4096, nnz, n_out) == int(want)


# ---------------------------------------------------------------------------
# core/metrics, data/fields
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["smooth", "turbulent", "particle", "wavefront"])
@pytest.mark.parametrize("shape", [(3000,), (20, 31), (6, 10, 12)])
def test_make_field_is_the_same_field(kind, shape):
    np.testing.assert_array_equal(fields.make_field(kind, shape, seed=7),
                                  jfields.make_field(kind, shape, seed=7))


@pytest.mark.parametrize("shape", [(3000,), (20, 31)])
def test_metrics_match_reference(shape):
    x = fields.make_field("smooth", shape, seed=8)
    y = x + np.random.default_rng(8).normal(0, 1e-3, shape).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    # max_abs_err is exact; psnr/nrmse are float reductions: float32 rounding
    assert metrics.max_abs_err(tx, ty) == float(jmetrics.max_abs_err(jx, jy))
    assert metrics.psnr(tx, ty) == pytest.approx(float(jmetrics.psnr(jx, jy)), rel=1e-5)
    assert metrics.nrmse(tx, ty) == pytest.approx(float(jmetrics.nrmse(jx, jy)), rel=1e-5)
