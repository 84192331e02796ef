"""The port's byte container and entropy coder against the reference, on the CPU.

* ``to_bytes`` byte-identical to the reference's ``fz.to_bytes`` on the same
  container, entropy ``False``/``True``/``"auto"``, both code modes, outlier
  channel on and off; ``from_bytes`` / ``decompress_bytes`` of those bytes
  field for field and bit for bit the reference's.
* ``core.entropy``: ``plan`` / ``encode`` / ``decode`` and the Huffman code-length functions
  byte-identical to ``repro.core.entropy``.
* The frozen fixtures ``tests/data/container_v1_{plain,entropy}.bin`` and
  ``legacy_stream.bin`` decode to ``expected_v1.npy`` / ``expected_legacy.npy``
  exactly, with no JAX involved.
* Malformed, truncated and future-version inputs raise the port's
  ``FZFormatError``; corrupt entropy blobs raise ``EntropyError``.

On jax 0.9 the reference needs two aliases; the ``ref`` fixture sets them for
one test and clears JAX's caches afterwards, so no other test sees them.
"""
import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import entropy as jent
from repro.core import fz as jfz
from repro_torch.core import entropy as ent
from repro_torch.data.fields import make_field

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture
def ref(monkeypatch):
    """The reference's ``fz`` module with the jax 0.9 aliases, for one test."""
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
    yield jfz
    jax.clear_caches()


def assert_same(ref_arr, port):
    """Equal shape and values; floats equal bit for bit."""
    a = np.asarray(ref_arr)
    b = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


def assert_same_container(jc, c):
    for f in c.FIELDS:
        assert_same(getattr(jc, f), getattr(c, f))
    assert tuple(jc.shape) == c.shape
    assert jc.dtype_name == c.dtype_name


def _field(shape=(20, 20, 10), kind="smooth", seed=9, jumps=False):
    x = make_field(kind, shape, seed=seed)
    if jumps:
        x[..., ::9] += 30.0 * (x.max() - x.min())
    return x


def _port_container(x, cfg):
    return rt.compress(torch.from_numpy(x), cfg, device="cpu")


# ---------------------------------------------------------------------------
# Cold form against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("code_mode", ["sign_mag", "zigzag"])
@pytest.mark.parametrize("exact_outliers", [True, False])
@pytest.mark.parametrize("entropy", [False, True, "auto"])
def test_bytes_match_reference(ref, code_mode, exact_outliers, entropy):
    x = _field(jumps=exact_outliers)
    kw = dict(eb=1e-6 if exact_outliers else 1e-3, code_mode=code_mode,
              exact_outliers=exact_outliers)
    jcfg, cfg = jfz.FZConfig(**kw), rt.FZConfig(**kw)
    jc = ref.compress(jnp.asarray(x), jcfg)
    c = _port_container(x, cfg)
    raw = ref.to_bytes(jc, jcfg, entropy=entropy)
    assert rt.to_bytes(c, cfg, entropy=entropy) == raw
    if exact_outliers:
        assert int(c.n_outliers) > 0
    jback, jbcfg = ref.from_bytes(raw)
    back, bcfg = rt.from_bytes(raw, device="cpu")
    assert_same_container(jback, back)
    assert (bcfg.code_mode, bcfg.exact_outliers, bcfg.eb) == \
        (jbcfg.code_mode, jbcfg.exact_outliers, jbcfg.eb)
    assert bcfg.use_kernels is True          # the port keeps its kernel route
    assert_same(ref.decompress_bytes(raw), rt.decompress_bytes(raw, device="cpu"))


@pytest.mark.parametrize("entropy", [False, True])
def test_capacities_restore_the_container_field_for_field(ref, entropy):
    x = _field(jumps=True)
    cfg = rt.FZConfig(eb=1e-6)
    c = _port_container(x, cfg)
    assert int(c.n_outliers) > 0
    raw = rt.to_bytes(c, cfg, entropy=entropy)
    cap, ocap = int(c.payload.shape[0]), int(c.outlier_idx.shape[0])
    back, _ = rt.from_bytes(raw, capacity=cap, outlier_capacity=ocap, device="cpu")
    for f in c.FIELDS:
        assert torch.equal(getattr(c, f), getattr(back, f)), f
    jback, _ = ref.from_bytes(raw, capacity=cap, outlier_capacity=ocap)
    assert_same_container(jback, back)
    assert c.wire_bytes() == back.wire_bytes() == jback.wire_bytes()
    stored = min(int(c.nnz_blocks), cap)
    with pytest.raises(rt.FZFormatError, match="capacity"):
        rt.from_bytes(raw, capacity=stored - 1, device="cpu")
    with pytest.raises(rt.FZFormatError, match="outlier_capacity"):
        rt.from_bytes(raw, outlier_capacity=int(c.n_outliers) - 1, device="cpu")


def test_container_on_either_device_and_bf16_accounting():
    x = torch.from_numpy(_field()).to(torch.bfloat16)
    cfg = rt.FZConfig(eb=1e-3)
    c = rt.compress(x, cfg, device="cpu")
    back, _ = rt.from_bytes(rt.to_bytes(c, cfg), device="cpu")
    assert back.dtype_name == "bfloat16" and back.raw_bytes() == x.numel() * 2
    assert torch.equal(rt.decompress(back, cfg, device="cpu"), rt.decompress(c, cfg, device="cpu"))


def test_auto_probe_skips_noise_and_selects_on_a_field():
    noise = np.random.default_rng(0).standard_normal(8192).astype(np.float32)
    cfg = rt.FZConfig(eb=1e-4)
    raw = rt.to_bytes(_port_container(noise, cfg), cfg, entropy="auto")
    assert not struct.unpack_from("<H", raw, 6)[0] & rt.core.fz.FLAG_ENTROPY
    c = _port_container(_field(shape=(32, 32, 16)), rt.FZConfig(eb=1e-3))
    plain = rt.to_bytes(c, cfg, entropy=False)
    auto = rt.to_bytes(c, cfg, entropy="auto")
    assert struct.unpack_from("<H", auto, 6)[0] & rt.core.fz.FLAG_ENTROPY
    assert len(auto) < len(plain)
    with pytest.raises(ValueError, match="entropy"):
        rt.to_bytes(c, cfg, entropy="always")


# ---------------------------------------------------------------------------
# Frozen fixtures and malformed input (no JAX)
# ---------------------------------------------------------------------------

def test_frozen_v1_fixtures_decode_bit_exactly():
    expected = np.load(DATA / "expected_v1.npy")
    for name, entropy in (("container_v1_plain.bin", False),
                          ("container_v1_entropy.bin", True)):
        raw = (DATA / name).read_bytes()
        assert bool(struct.unpack_from("<H", raw, 6)[0] & rt.core.fz.FLAG_ENTROPY) is entropy
        assert_same(expected, rt.decompress_bytes(raw, device="cpu"))


def test_frozen_legacy_stream_decodes_bit_exactly():
    raw = (DATA / "legacy_stream.bin").read_bytes()
    c, cfg = rt.from_bytes(raw, device="cpu")
    assert cfg.exact_outliers and c.dtype_name == "float32" and len(c.shape) == 1
    assert_same(np.load(DATA / "expected_legacy.npy"), rt.decompress(c, cfg, device="cpu"))
    assert_same(np.load(DATA / "expected_legacy.npy"), rt.decompress_bytes(raw, device="cpu"))


def _raw():
    cfg = rt.FZConfig(eb=1e-3)
    return rt.to_bytes(_port_container(_field(shape=(16, 16)), cfg), cfg)


def test_future_version_raises():
    raw = bytearray(_raw())
    struct.pack_into("<H", raw, 4, rt.core.fz.CONTAINER_VERSION + 1)
    with pytest.raises(rt.FZFormatError, match="not supported"):
        rt.from_bytes(bytes(raw), device="cpu")


@pytest.mark.parametrize("junk", [b"", b"abc", b"\x00" * 64, b"FZGC"])
def test_garbage_raises(junk):
    with pytest.raises(rt.FZFormatError):
        rt.from_bytes(junk, device="cpu")


@pytest.mark.parametrize("cut", [0.5, 0.9, 0.99])
def test_truncated_container_raises(cut):
    raw = _raw()
    with pytest.raises(rt.FZFormatError, match="truncated"):
        rt.from_bytes(raw[: int(len(raw) * cut)], device="cpu")


def test_unknown_dtype_code_and_bad_legacy_length_raise():
    raw = bytearray(_raw())
    raw[9] = 77
    with pytest.raises(rt.FZFormatError, match="dtype"):
        rt.from_bytes(bytes(raw), device="cpu")
    legacy = (DATA / "legacy_stream.bin").read_bytes()
    with pytest.raises(rt.FZFormatError, match="length"):
        rt.from_bytes(legacy + b"\x00", device="cpu")


# ---------------------------------------------------------------------------
# Entropy coder against the reference's
# ---------------------------------------------------------------------------

def _byte_cases():
    rng = np.random.default_rng(3)
    fib = np.concatenate([np.full(int(v), i, np.uint8) for i, v in enumerate(
        [1, 1, 2, 3, 5, 8, 13, 21, 34, 55, 89, 144, 233, 377, 610, 987, 1597, 2584, 4181])])
    return {
        "uniform": rng.integers(0, 256, 10000).astype(np.uint8),
        "skewed": np.minimum(rng.geometric(0.3, 20000), 255).astype(np.uint8),
        "one-symbol": np.full(5000, 7, np.uint8),
        "one-byte": np.array([200], np.uint8),
        "empty": np.zeros(0, np.uint8),
        "fibonacci": rng.permutation(fib),          # forces the length limit
    }


@pytest.mark.parametrize("name", list(_byte_cases()))
@pytest.mark.parametrize("chunk", [7, 1000, ent.DEFAULT_CHUNK])
def test_entropy_matches_reference(name, chunk):
    data = _byte_cases()[name]
    counts = np.bincount(data, minlength=256)
    lengths, est = ent.plan(counts, data.size, chunk)
    jlengths, jest = jent.plan(counts, data.size, chunk)
    np.testing.assert_array_equal(lengths, jlengths)
    assert est == jest
    np.testing.assert_array_equal(ent.canonical_codes(lengths), jent.canonical_codes(jlengths))
    blob = ent.encode(data.tobytes(), chunk)
    assert blob == jent.encode(data.tobytes(), chunk)
    assert len(blob) == est
    assert ent.decode(blob) == data.tobytes() == jent.decode(blob)
    assert int(lengths.max(initial=0)) <= ent.MAX_CODE_LEN


def test_entropy_rejects_corrupt_blobs():
    blob = ent.encode(_byte_cases()["skewed"].tobytes())
    for bad in (blob[:100], blob[: len(blob) - 50]):
        with pytest.raises(ent.EntropyError):
            ent.decode(bad)
    flipped = bytearray(blob)
    flipped[-200] ^= 0xFF
    with pytest.raises(ent.EntropyError):
        ent.decode(bytes(flipped))
