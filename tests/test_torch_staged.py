"""The port's staged route, batch form and tree form against the reference, on the CPU.

* The plain K1/K2/K3 (what the wrappers run for CPU tensors) against the
  reference's ``lorenzo_quant`` / ``bitshuffle_flag`` / ``bitunshuffle_tiles``
  Pallas kernels in interpret mode: 1-3D, odd shapes, float32/bfloat16, both
  code modes, saturating deltas; exact (tolerance 0).
* ``FZConfig(kernel_mode="staged")`` against the reference's
  ``FZConfig(use_kernels=True, kernel_mode="staged")``: every container field
  and the reconstruction, bit for bit, at payload capacity 1.0 and 0.25, with
  the outlier channel on and off.
* ``compress_batch_with_eb`` / ``decompress_batch`` against the reference's
  vmapped forms, and each row against its single-row call;
  ``tree_compress`` / ``tree_decompress`` against the reference's.

Inputs stay at about 30k elements or fewer: the Pallas interpreter is slow. On jax 0.9
the reference needs two aliases; the ``ref`` fixture sets them for one test
and clears JAX's caches afterwards, so no other test sees them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.core import fz as jfz
from repro_torch import kernels
from repro_torch.core import encode as enc
from repro_torch.core import shuffle
from repro_torch.data.fields import make_field
from repro_torch.kernels import ops

TILE = shuffle.TILE


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


def _inputs(kind, shape, dtype, seed=0, jumps=False):
    """Same data for both packages: (port tensor, reference array)."""
    x = make_field(kind, shape, seed=seed)
    if jumps:
        x[..., ::9] += 30.0 * (x.max() - x.min())
    t = torch.from_numpy(x).to(dtype)
    x32 = t.to(torch.float32).numpy()            # bf16 rounding done once, by torch
    j = jnp.asarray(x32).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return t, j


def _codes(seed, n_tiles):
    """u16 code tiles with the zero-heavy skew of real streams and an all-zero stretch."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 1 << 16, size=n_tiles * TILE, dtype=np.int64)
    c[rng.random(c.size) < 0.7] = 0
    c[TILE // 2: TILE // 2 + 700] = 0
    return c.astype(np.uint16).reshape(n_tiles, TILE)


# ---------------------------------------------------------------------------
# Plain K1/K2/K3 against the reference's staged kernels (interpret mode)
# ---------------------------------------------------------------------------

K1_CASES = [
    # kind, shape, eb relative to the range, jumps (saturating deltas)
    ("particle", (5000,), 1e-3, False),
    ("smooth", (37, 130), 1e-3, False),
    ("turbulent", (9, 33, 40), 1e-3, False),
    ("turbulent", (5, 7, 11), 1e-6, True),
    # the layouts of the card kernel's walk along the leading axis: a plane of
    # exactly one tile, a plane of 4101 (not a multiple of 8 or 16), one plane,
    # 2-D rows longer than a tile, and 7 planes (not a multiple of a chunk of
    # 2 or 4 planes)
    ("turbulent", (4, 64, 64), 1e-3, False),
    ("turbulent", (5, 3, 1367), 1e-3, False),
    ("smooth", (1, 70, 70), 1e-3, False),
    ("smooth", (3, 5000), 1e-3, False),
    ("turbulent", (7, 64, 64), 1e-4, False),
]


@pytest.mark.parametrize("kind,shape,eb_rel,jumps", K1_CASES,
                         ids=[f"{c[0]}-{'x'.join(map(str, c[1]))}" for c in K1_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("code_mode", ["sign_mag", "zigzag"])
def test_plain_k1_matches_reference_kernel(ref, kind, shape, eb_rel, jumps, dtype, code_mode):
    from repro.kernels import lorenzo_quant as jlq
    t, j = _inputs(kind, shape, dtype, seed=len(shape), jumps=jumps)
    x32 = t.to(torch.float32)
    eb = np.float32(eb_rel * float(x32.max() - x32.min()))
    want = jlq.lorenzo_quant(j, jnp.float32(eb), code_mode=code_mode, interpret=True)
    got = kernels.lorenzo_quant(t, torch.tensor(eb), code_mode=code_mode)
    assert got.dtype == torch.uint16 and np.asarray(want).dtype == np.uint16
    assert_same(want, got)
    if jumps:   # saturated codes are present
        top = 0xFFFF if code_mode == "zigzag" else 0x7FFF
        assert int((got.to(torch.int32) & 0x7FFF if code_mode == "sign_mag"
                    else got.to(torch.int32)).max()) == top


@pytest.mark.parametrize("n_tiles", [1, 2, 3, 5])
def test_plain_k2_k3_match_reference_kernels(ref, n_tiles):
    from repro.kernels import bitshuffle_flag as jbsf
    codes = _codes(n_tiles, n_tiles)
    j_shuffled, j_flags = jbsf.bitshuffle_flag(jnp.asarray(codes), interpret=True)
    shuffled, flags = kernels.bitshuffle_flag(torch.from_numpy(codes))
    assert shuffled.dtype == torch.uint16 and flags.dtype == torch.uint8
    assert_same(j_shuffled, shuffled)
    assert_same(j_flags, flags)
    assert 0 < int(flags.sum()) < flags.numel()          # both kinds of block occur
    back = kernels.bitunshuffle_tiles(shuffled)
    assert back.dtype == torch.uint16
    assert_same(jbsf.bitunshuffle_tiles(j_shuffled, interpret=True), back)
    assert_same(codes, back)


def test_staged_ops_match_the_plain_stages():
    """The staged wrappers take the plain stages' signatures and give their results."""
    codes = torch.from_numpy(_codes(7, 2).astype(np.int32)).reshape(-1)
    words = shuffle.bitshuffle(codes)
    assert torch.equal(ops.bitshuffle(codes).to(torch.int32), words)
    assert torch.equal(ops.bitunshuffle(words).to(torch.int32), codes)
    for cap in (1, 100, 1024):
        for got, want in zip(ops.bitshuffle_flag_encode(codes, capacity=cap),
                             enc.encode(words, capacity=cap)):
            assert got.dtype == want.dtype and torch.equal(got, want)
    with pytest.raises(ValueError, match="multiple of TILE"):
        ops.bitshuffle_flag_encode(codes[:100], capacity=4)


# ---------------------------------------------------------------------------
# The staged route against the reference's staged route
# ---------------------------------------------------------------------------

STAGED_CASES = [
    # kind, shape, dtype, cfg kwargs, jumps
    ("turbulent", (9, 33, 50), torch.float32, {}, False),
    ("turbulent", (9, 33, 50), torch.float32, dict(exact_outliers=False), False),
    ("turbulent", (9, 33, 50), torch.float32, dict(capacity_frac=0.25), False),
    ("smooth", (37, 130), torch.float32,
     dict(capacity_frac=0.25, code_mode="zigzag", exact_outliers=False), False),
    ("particle", (5000,), torch.bfloat16, dict(exact_outliers=False), False),
    ("turbulent", (7, 129), torch.float32, dict(eb=1e-5), True),                 # outliers
    ("particle", (4096,), torch.float32, dict(eb=1e-5, exact_outliers=False), True),  # saturation
]


@pytest.mark.parametrize("kind,shape,dtype,kw,jumps", STAGED_CASES,
                         ids=[f"{c[0]}-{'x'.join(map(str, c[1]))}-{i}"
                              for i, c in enumerate(STAGED_CASES)])
def test_staged_route_matches_reference(ref, kind, shape, dtype, kw, jumps):
    t, j = _inputs(kind, shape, dtype, seed=3, jumps=jumps)
    cfg = rt.FZConfig(kernel_mode="staged", **kw)
    jcfg = jfz.FZConfig(use_kernels=True, kernel_mode="staged", **kw)
    jc = ref.compress(j, jcfg)
    c = rt.compress(t, cfg, device="cpu")
    assert_same_container(jc, c)
    assert int(jc.used_bytes()) == c.used_bytes()
    assert_same(ref.decompress(jc, jcfg), rt.decompress(c, cfg, device="cpu"))
    if jumps and kw.get("exact_outliers", True):
        assert int(c.n_outliers) > 0
    # the port's three routes agree
    for other in (rt.FZConfig(kernel_mode="fused", **kw), rt.FZConfig(use_kernels=False, **kw)):
        c2 = rt.compress(t, other, device="cpu")
        for f in c.FIELDS:
            assert torch.equal(getattr(c, f), getattr(c2, f)), f


# ---------------------------------------------------------------------------
# Batch and tree forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row_shape,kw", [((3000,), {}),
                                          ((20, 64), dict(exact_outliers=False)),
                                          ((5000,), dict(kernel_mode="staged"))])
def test_batch_forms_match_reference_and_single_rows(ref, row_shape, kw):
    rows = np.stack([make_field("turbulent" if len(row_shape) > 1 else "particle",
                                row_shape, seed=s) for s in range(3)])
    eb = np.float32(2e-3)
    cfg = rt.FZConfig(**kw)
    jcfg = jfz.FZConfig(**{k: v for k, v in kw.items() if k != "kernel_mode"})
    jc = ref.compress_batch_with_eb(jnp.asarray(rows), jnp.float32(eb), jcfg)
    c = rt.compress_batch_with_eb(torch.from_numpy(rows), eb, cfg, device="cpu")
    assert_same_container(jc, c)
    assert c.nnz_blocks.shape == (3,) and c.shape == row_shape
    assert c.wire_bytes() == jc.wire_bytes()
    y = rt.decompress_batch(c, cfg, device="cpu")
    assert y.shape == (3, *row_shape)
    assert_same(ref.decompress_batch(jc, jcfg), y)
    for i in range(3):
        one = rt.compress_with_eb(torch.from_numpy(rows[i]), eb, cfg, device="cpu")
        for f in c.FIELDS:
            assert torch.equal(getattr(c, f)[i], getattr(one, f)), (i, f)
        assert torch.equal(y[i], rt.decompress(one, cfg, device="cpu"))


def test_batch_forms_reject_unbatched_input():
    with pytest.raises(ValueError, match="batch"):
        rt.compress_batch_with_eb(torch.zeros(4096), 1e-3, rt.FZConfig(), device="cpu")
    with pytest.raises(ValueError, match="batch"):
        rt.compress_batch_with_eb(torch.zeros(0, 4096), 1e-3, rt.FZConfig(), device="cpu")
    single = rt.compress(torch.linspace(0, 1, 5000), rt.FZConfig(), device="cpu")
    with pytest.raises(ValueError, match="batch"):
        rt.decompress_batch(single, rt.FZConfig(), device="cpu")


def test_tree_forms_match_reference(ref):
    fields = {"w": make_field("smooth", (64, 80), seed=1),
              "v": make_field("particle", (5000,), seed=2),
              "b": make_field("smooth", (10,), seed=3),                   # < 1 tile
              "h": make_field("smooth", (2, 2, 2, 600), seed=4),          # 4D
              "bf": make_field("turbulent", (4096,), seed=5)}
    steps = np.arange(7, dtype=np.int32)

    def tree(f, as_bf16, ints):
        return {"w": f(fields["w"]), "rest": [f(fields["v"]), (f(fields["b"]), ints)],
                "h": f(fields["h"]), "bf": as_bf16(fields["bf"])}
    port_tree = tree(torch.from_numpy, lambda a: torch.from_numpy(a).to(torch.bfloat16),
                     torch.from_numpy(steps))
    ref_tree = tree(jnp.asarray, lambda a: jnp.asarray(torch.from_numpy(a).to(torch.bfloat16)
                                                       .float().numpy()).astype(jnp.bfloat16),
                    jnp.asarray(steps))
    cfg, jcfg = rt.FZConfig(eb=1e-3), jfz.FZConfig(eb=1e-3)
    jt = ref.tree_compress(ref_tree, jcfg)
    pt = rt.tree_compress(port_tree, cfg, device="cpu")
    for key in ("w", "bf"):
        assert isinstance(pt[key], rt.FZCompressed)
        assert_same_container(jt[key], pt[key])
    assert_same_container(jt["rest"][0], pt["rest"][0])
    assert isinstance(pt["rest"], list) and isinstance(pt["rest"][1], tuple)
    for passed in (pt["rest"][1][0], pt["rest"][1][1], pt["h"]):
        assert isinstance(passed, torch.Tensor)
    dtypes = {"w": jnp.float32, "rest": [jnp.float32, (jnp.float32, jnp.int32)],
              "h": jnp.float32, "bf": jnp.bfloat16}
    tdtypes = {"w": torch.float32, "rest": [torch.float32, (torch.float32, torch.int32)],
               "h": torch.float32, "bf": torch.bfloat16}
    jout = ref.tree_decompress(jt, jcfg, dtypes)
    pout = rt.tree_decompress(pt, cfg, tdtypes, device="cpu")
    assert pout["bf"].dtype == torch.bfloat16
    for a, b in ((jout["w"], pout["w"]), (jout["rest"][0], pout["rest"][0]),
                 (jout["h"], pout["h"]), (jout["rest"][1][1], pout["rest"][1][1])):
        assert_same(a, b)
    assert_same(jnp.asarray(jout["bf"], jnp.float32), pout["bf"].float())
