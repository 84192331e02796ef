"""The port's compressor against the reference, bit for bit, on the CPU.

* ``fz.compress``/``decompress`` of both packages: every container field and
  the reconstruction, over 1-3D and non-tile-multiple shapes, float32 and
  bfloat16, both code modes, strict and paper mode, a quarter payload
  capacity, outliers present and the outlier capacity exceeded. The port runs
  both its routes (``use_kernels=True``, whose wrappers take their plain
  versions for CPU tensors, and ``use_kernels=False``); the reference runs
  its plain route.
* The port's plain K4/K5/K6 against the reference's fused Pallas kernels in
  interpret mode.
* Containers carried across with ``repro_torch.interop``, both ways.

On jax 0.9 the reference needs two aliases (``jax.core.trace_state_clean``
and ``pltpu.TPUCompilerParams``); the ``ref`` fixture sets them for one test
and clears JAX's caches afterwards, so no other test sees them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import fz as jfz
from repro_torch import interop, kernels
from repro_torch.core import shuffle
from repro_torch.data.fields import make_field


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
    assert int(jc.used_bytes()) == c.used_bytes()


def _inputs(kind, shape, dtype, seed=0, jumps=False):
    """Same data for both packages: (numpy float32 view, port tensor, reference array)."""
    x = np.zeros(shape, np.float32) if kind == "zeros" else make_field(kind, shape, seed=seed)
    if jumps:
        x[..., ::9] += 30.0 * (x.max() - x.min())
    t = torch.from_numpy(x).to(dtype)
    x32 = t.to(torch.float32).numpy()            # bf16 rounding done once, by torch
    j = jnp.asarray(x32).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return x32, t, j


def _cfgs(**kw):
    port = {"kernels": rt.FZConfig(**kw), "plain": rt.FZConfig(**kw, use_kernels=False)}
    return port, jfz.FZConfig(**kw)


CASES = [
    # kind, shape, dtype, cfg kwargs, jumps
    ("particle", (5000,), torch.float32, {}, False),
    ("particle", (70001,), torch.float32, dict(exact_outliers=False), False),
    ("smooth", (37, 130), torch.float32, dict(code_mode="zigzag"), False),
    ("smooth", (37, 130), torch.bfloat16, dict(eb=1e-2), False),
    ("turbulent", (9, 33, 70), torch.float32, dict(capacity_frac=0.25), False),
    ("turbulent", (9, 33, 70), torch.bfloat16,
     dict(code_mode="zigzag", exact_outliers=False), False),
    ("wavefront", (16, 20, 24), torch.float32, dict(eb=1e-4), False),
    ("turbulent", (7, 129), torch.float32, dict(eb=1e-5), True),                 # outliers
    ("smooth", (6, 17, 40), torch.float32,
     dict(eb=1e-5, outlier_frac=1e-3), True),                                    # K exceeded
    ("particle", (8192,), torch.float32,
     dict(eb=1e-5, exact_outliers=False), True),                                 # saturation
    ("smooth", (3, 4096), torch.float32, dict(eb=1e-3, eb_mode="abs"), False),
    ("particle", (4096,), torch.bfloat16,
     dict(eb=1e-5, capacity_frac=0.25, code_mode="zigzag"), True),
    ("particle", (1,), torch.float32, {}, False),
    ("smooth", (3, 1, 7), torch.float32, dict(code_mode="zigzag"), False),
    ("zeros", (64, 64), torch.float32, {}, False),                               # rel floor
]


def _reference_compress(ref, j, jcfg):
    """The reference's container for ``jcfg``.

    In abs mode the reference's ``compress`` bakes the bound into its jit as a
    constant, and XLA on the CPU then turns ``x / (2 eb)`` into a multiply by
    the reciprocal, which rounds some near-ties the other way (ROADMAP.md,
    queue 3). Its ``compress_with_eb`` takes the same bound as a traced value
    and keeps the true divide that the Pallas kernels and the port use, so
    abs mode is held against that.
    """
    if jcfg.eb_mode == "abs":
        return ref.compress_with_eb(j, jnp.float32(jcfg.eb), jcfg)
    return ref.compress(j, jcfg)


@pytest.mark.parametrize("kind,shape,dtype,kw,jumps", CASES,
                         ids=[f"{c[0]}-{'x'.join(map(str, c[1]))}-{i}"
                              for i, c in enumerate(CASES)])
@pytest.mark.parametrize("route", ["kernels", "plain"])
def test_compress_decompress_match_reference(ref, kind, shape, dtype, kw, jumps, route):
    _, t, j = _inputs(kind, shape, dtype, seed=len(shape), jumps=jumps)
    port_cfgs, jcfg = _cfgs(**kw)
    cfg = port_cfgs[route]
    jc = _reference_compress(ref, j, jcfg)
    c = rt.compress(t, cfg, device="cpu")
    assert_same_container(jc, c)
    assert_same(ref.decompress(jc, jcfg), rt.decompress(c, cfg, device="cpu"))
    if jumps and kw.get("exact_outliers", True):
        assert int(c.n_outliers) > 0
    if "outlier_frac" in kw:
        assert int(c.n_outliers) == c.outlier_idx.numel()    # capacity exceeded


@pytest.mark.parametrize("route", ["kernels", "plain"])
def test_compress_with_eb_matches_reference(ref, route):
    _, t, j = _inputs("turbulent", (12, 50), torch.float32, seed=5)
    port_cfgs, jcfg = _cfgs(eb=0.0, eb_mode="abs")
    jc = ref.compress_with_eb(j, jnp.float32(3e-3), jcfg)
    c = rt.compress_with_eb(t, 3e-3, port_cfgs[route], device="cpu")
    assert_same_container(jc, c)


@pytest.mark.parametrize("eb_mode,value", [("rel", 1.0), ("rel", 0.0), ("rel", -3.5),
                                           ("abs", 1.0)])
def test_resolve_eb_matches_reference(ref, eb_mode, value):
    x = make_field("smooth", (40, 40), seed=6) * value
    cfg = rt.FZConfig(eb=1e-3, eb_mode=eb_mode)
    jcfg = jfz.FZConfig(eb=1e-3, eb_mode=eb_mode)
    assert_same(ref.resolve_eb(jnp.asarray(x), jcfg), rt.resolve_eb(torch.from_numpy(x), cfg))


def test_roundtrip_holds_the_error_bound():
    x32, t, _ = _inputs("turbulent", (10, 40, 30), torch.float32, seed=7)
    rec, c = rt.roundtrip(t, rt.FZConfig(eb=1e-3), device="cpu")
    err = float(np.max(np.abs(rec.numpy() - x32)))
    assert err <= float(c.eb_abs) * (1 + 2**-20) + float(np.max(np.abs(x32))) * 2**-22
    assert c.compression_ratio() > 1.0


# ---------------------------------------------------------------------------
# Plain K4/K5/K6 against the reference's fused kernels (Pallas interpret mode)
# ---------------------------------------------------------------------------

KERNEL_SHAPES = [(5000,), (37, 130), (9, 33, 70)]


@pytest.mark.parametrize("shape", KERNEL_SHAPES)
def test_plain_k4_k5_k6_match_reference_kernels(ref, shape):
    from repro.kernels import fused_compress as jfc
    from repro.kernels import fused_decode as jfd
    x = make_field("turbulent" if len(shape) > 1 else "particle", shape, seed=9)
    eb = np.float32(1e-3 * (x.max() - x.min()))
    cap = rt.FZConfig(capacity_frac=0.5).payload_capacity(x.size)
    code_mode = "zigzag" if len(shape) == 2 else "sign_mag"

    jk4 = jfc.fused_compress(jnp.asarray(x), jnp.float32(eb), capacity=cap,
                             code_mode=code_mode, interpret=True)
    k4 = kernels.fused_compress(torch.from_numpy(x), torch.tensor(eb), capacity=cap,
                                code_mode=code_mode)
    for w, g in zip(jk4, k4):
        assert_same(w, g)

    codes = np.random.default_rng(9).geometric(0.4, size=x.size).astype(np.int32) - 1
    flat = shuffle.pad_to_tiles(torch.from_numpy(codes)).to(torch.uint16)
    jk5 = jfc.fused_shuffle_encode(jnp.asarray(flat.numpy()), capacity=cap, interpret=True)
    for w, g in zip(jk5, kernels.fused_shuffle_encode(flat, capacity=cap)):
        assert_same(w, g)

    oidx = np.array([0, x.size // 3, x.size - 1, x.size], np.int32)   # last slot: fill value
    oval = np.array([70000, -5, 123456, 0], np.int32)
    jk6 = jfd.fused_decompress(jk4[0], jk4[1], jnp.float32(eb), shape=shape,
                               code_mode=code_mode, outlier_idx=jnp.asarray(oidx),
                               outlier_val=jnp.asarray(oval), interpret=True)
    k6 = kernels.fused_decompress(k4[0], k4[1], torch.tensor(eb), shape=shape,
                                  code_mode=code_mode, outlier_idx=torch.from_numpy(oidx),
                                  outlier_val=torch.from_numpy(oval))
    assert_same(jk6, k6)


# ---------------------------------------------------------------------------
# interop: containers across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exact_outliers", [True, False])
def test_reference_container_decompressed_by_port(ref, exact_outliers):
    _, t, j = _inputs("turbulent", (8, 30, 40), torch.float32, seed=10, jumps=True)
    jcfg = jfz.FZConfig(eb=1e-4, exact_outliers=exact_outliers)
    jc = ref.compress(j, jcfg)
    fields = {f: np.asarray(getattr(jc, f)) for f in interop.NUMPY_DTYPES}
    c = interop.from_reference(fields, jc.shape, jc.dtype_name, device="cpu")
    cfg = rt.FZConfig(eb=1e-4, exact_outliers=exact_outliers)
    assert_same(ref.decompress(jc, jcfg), rt.decompress(c, cfg, device="cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_container_decompressed_by_reference(ref, dtype):
    _, t, _ = _inputs("smooth", (20, 300), dtype, seed=11)
    cfg = rt.FZConfig(eb=1e-3, code_mode="zigzag")
    c = rt.compress(t, cfg, device="cpu")
    arrays = interop.to_numpy(c)
    assert {k: v.dtype for k, v in arrays.items()} == {
        k: np.dtype(v) for k, v in interop.NUMPY_DTYPES.items()}
    jc = jfz.FZCompressed(**{k: jnp.asarray(v) for k, v in arrays.items()},
                          shape=c.shape, dtype_name=c.dtype_name)
    jcfg = jfz.FZConfig(eb=1e-3, code_mode="zigzag")
    assert_same(ref.decompress(jc, jcfg), rt.decompress(c, cfg, device="cpu"))
    back = interop.from_reference(arrays, c.shape, c.dtype_name, device="cpu")
    for f in c.FIELDS:
        assert_same(getattr(c, f).numpy(), getattr(back, f))


def test_from_reference_rejects_missing_fields():
    with pytest.raises(KeyError):
        interop.from_reference({"bitflags": np.zeros(16, np.uint32)}, (10,), "float32",
                               device="cpu")
