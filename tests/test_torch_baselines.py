"""The port's baselines (``core/baselines``) and ratio / fidelity metrics
(``metrics.bitrate``, ``metrics.ssim2d``) against the reference's, on the CPU;
then the reference's four baseline properties (tests/test_system.py) on the
port's own CPU route.

Inputs are made from a seed with numpy, at 1-, 2- and 3-D shapes that are not
multiples of 4 (cuZFP's block) or of a 4096-code tile, and handed to both
packages. ``cusz_like``, ``cuszx_like``, ``cuzfp_like`` and ``bitrate`` are held
exactly: reconstructions bit for bit, byte counts by value. ``ssim2d`` is held
at 1e-5: both make float32 window means, with the sums in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import baselines as jbaselines
from repro.core import metrics as jmetrics
from repro_torch.core import baselines, metrics
from repro_torch.data.fields import make_field

SHAPES = [(1001,), (37, 130), (9, 33, 70), (5, 7, 11)]
SSIM_TOL = 1e-5


@pytest.fixture
def ref(monkeypatch):
    """The reference's ``baselines`` module with the jax 0.9 aliases, for one test."""
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
    yield jbaselines
    jax.clear_caches()


def assert_bits(ref_arr, port):
    a = np.asarray(ref_arr)
    b = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def _field(shape, seed=3):
    kind = "particle" if len(shape) == 1 else "turbulent"
    return make_field(kind, shape, seed=seed)


def _eb_abs(x, rel):
    return float(np.float32(rel) * (x.max() - x.min()))


def _powers_of_two(shape, seed):
    """Values at, one ulp below and one ulp above powers of two from 2**-120
    to 2**120, both signs, with zeros between: most 4^d blocks have one of
    them as their largest magnitude."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    p = np.float32(2.0) ** rng.integers(-120, 121, n).astype(np.float32)
    step = rng.integers(0, 3, n)
    v = np.where(step == 1, np.nextafter(p, np.float32(0)),
                 np.where(step == 2, np.nextafter(p, np.float32(np.inf)), p))
    v = v * np.where(rng.random(n) < 0.5, -1, 1) * (rng.random(n) < 0.8)
    return v.astype(np.float32).reshape(shape)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("eb_rel", [1e-2, 1e-4, 1e-6])
def test_cusz_like_matches_reference(ref, shape, eb_rel):
    """1e-6 leaves codes past the radius: the escape and outlier accounting."""
    x = _field(shape)
    eb = _eb_abs(x, eb_rel)
    want = ref.cusz_like(x, eb)
    got = baselines.cusz_like(torch.from_numpy(x), eb)
    assert_bits(want.reconstruction, got.reconstruction)
    assert got.compressed_bytes == int(want.compressed_bytes)
    assert got.n_outliers == int(want.n_outliers)
    assert got.compression_ratio(x.nbytes) == want.compression_ratio(x.nbytes)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("eb_rel", [1e-2, 1e-3])
@pytest.mark.parametrize("block", [256, 64])
def test_cuszx_like_matches_reference(ref, shape, eb_rel, block):
    x = _field(shape)
    eb = np.float32(_eb_abs(x, eb_rel))
    rec_j, bytes_j = ref.cuszx_like(jnp.asarray(x), jnp.float32(eb), block=block)
    rec, nbytes = baselines.cuszx_like(torch.from_numpy(x), float(eb), block=block)
    assert_bits(rec_j, rec)
    assert nbytes == int(bytes_j)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rate", [1, 4, 8, 16, 30])
@pytest.mark.parametrize("values", ["field", "powers of two"])
def test_cuzfp_like_matches_reference(ref, shape, rate, values):
    x = _field(shape) if values == "field" else _powers_of_two(shape, seed=rate)
    rec_j, bytes_j = ref.cuzfp_like(jnp.asarray(x), rate)
    rec, nbytes = baselines.cuzfp_like(torch.from_numpy(x), rate)
    assert_bits(rec_j, rec)
    assert nbytes == int(bytes_j)


def test_cuzfp_block_exponent_is_the_references_at_powers_of_two(ref):
    """The block exponent is XLA's floor(log2(x)): the Cephes log times
    1 / log 2, which at 8192 gives 12 (the correctly rounded log2 gives 13).
    Held at every power of two of float32's normal range and 64 ulps either
    side of each."""
    p = np.float32(2.0) ** np.arange(-126, 128).astype(np.float32)
    vals = [p]
    up, down = p.copy(), p.copy()
    for _ in range(64):
        up, down = np.nextafter(up, np.float32(np.inf)), np.nextafter(down, np.float32(0))
        vals += [up, down]
    v = np.concatenate(vals)
    v = v[np.isfinite(v) & (v >= np.finfo(np.float32).tiny)]
    want = np.floor(np.asarray(jnp.log2(jnp.asarray(v))))
    got = baselines._floor_log2(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[v == np.float32(8192.0)][0] == 12.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("as_array", [False, True])
def test_bitrate_matches_reference(dtype, as_array):
    raw, comp = 4 * 37 * 130, 1733
    want = jmetrics.bitrate(raw, jnp.int32(comp) if as_array else comp, getattr(jnp, dtype))
    got = metrics.bitrate(raw, torch.tensor(comp, dtype=torch.int32) if as_array else comp,
                          getattr(torch, dtype))
    if as_array:
        assert_bits(want, got)
    else:
        assert type(got) is float and got == want


@pytest.mark.parametrize("shape", [(37, 130), (64, 64), (100, 77)])
@pytest.mark.parametrize("k", [7, 3])
def test_ssim2d_matches_reference(shape, k):
    x = make_field("smooth", (1,) + shape, seed=5)[0]
    noise = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    y = (x + 0.05 * (x.max() - x.min()) * noise).astype(np.float32)
    for rec in (x, y):
        want = float(jmetrics.ssim2d(jnp.asarray(x), jnp.asarray(rec), k=k))
        got = metrics.ssim2d(torch.from_numpy(x), torch.from_numpy(rec), k=k)
        assert abs(got - want) <= SSIM_TOL, (got, want)
    assert metrics.ssim2d(torch.from_numpy(x), torch.from_numpy(x), k=k) == pytest.approx(1.0)


# -- the reference's baseline properties (tests/test_system.py) on the port --

@pytest.fixture(scope="module")
def system_fields():
    return {k: torch.from_numpy(make_field(k, (48, 48, 48), seed=11))
            for k in ("smooth", "turbulent", "particle", "wavefront")}


def test_psnr_identical_to_cusz_like(system_fields):
    """Same lossy stage, so the same reconstruction quality as the cuSZ baseline."""
    f = system_fields["smooth"]
    rec, c = rt.roundtrip(f, rt.FZConfig(eb=1e-3), device="cpu")
    cz = baselines.cusz_like(f, float(c.eb_abs))
    psnr_fz = metrics.psnr(f, rec)
    psnr_cz = metrics.psnr(f, torch.from_numpy(cz.reconstruction))
    assert abs(psnr_fz - psnr_cz) < 0.6, (psnr_fz, psnr_cz)


def test_ratio_close_to_cusz_like(system_fields):
    """Fig. 7: FZ's bitrate is close to cuSZ's (within 2x)."""
    for name, f in system_fields.items():
        c = rt.compress(f, rt.FZConfig(eb=1e-3), device="cpu")
        cz = baselines.cusz_like(f, float(c.eb_abs))
        raw = f.numel() * 4
        assert raw / c.used_bytes() > 0.5 * raw / cz.compressed_bytes, name


def test_beats_cuszx_like_ratio(system_fields):
    """§4.3: a much higher ratio than the constant-block compressor."""
    wins = 0
    for f in system_fields.values():
        c = rt.compress(f, rt.FZConfig(eb=1e-3), device="cpu")
        _, bx = baselines.cuszx_like(f, c.eb_abs)
        wins += c.compression_ratio() > 1.3 * (f.numel() * 4 / bx)
    assert wins >= 3, wins


def test_beats_cuzfp_like_quality_at_matched_rate(system_fields):
    """Fig. 7: at a matched bitrate, FZ's PSNR is well above fixed-rate
    transform coding's."""
    f = system_fields["turbulent"]
    rec, c = rt.roundtrip(f, rt.FZConfig(eb=1e-3), device="cpu")
    bits = metrics.bitrate(f.numel() * 4, c.used_bytes())
    rec_z, _ = baselines.cuzfp_like(f, max(int(bits), 1))
    assert metrics.psnr(f, rec) > metrics.psnr(f, rec_z) + 3.0
