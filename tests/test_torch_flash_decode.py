"""K7 flash-decode and the paged decode attention against the reference, on the CPU.

* The plain K7 (what ``repro_torch.kernels.flash_decode`` runs for CPU
  tensors) against the reference's Pallas ``flash_decode`` kernel in
  interpret mode and against ``repro.dist.flash_decode.decode_partials``:
  kv_tile 16 / 32 / 128 clamped to the slice, ``shard_offset``, a length past
  the slice, G in {1, 4}, float32 and bfloat16 K/V, the paged and the
  contiguous entry. Tolerance 2e-4 (float32 sums in another order), the
  reference's own pin in ``tests/test_kernels.py``.
* Fully masked rows are exactly (m, num, den) = (-1e30, 0, 0).
* ``paged_decode_attention`` (plain and kernel route) with and without the
  ``k_new``/``v_new`` fold-in, against the reference's ``decode_attention``
  and ``paged_decode_attention`` at 2e-4, mirroring ``tests/test_kvpool.py``.

On jax 0.9 the reference needs two aliases; the ``ref`` fixture sets them for
one test and clears JAX's caches afterwards, so no other test sees them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import flash_decode as jdist
from repro.models.attention import decode_attention as j_decode_attention
from repro.serve.kvpool import attention as jpaged
from repro_torch.dist import flash_decode as tdist
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref as kref
from repro_torch.models.attention import decode_attention
from repro_torch.serve.kvpool import paged_decode_attention, pages_from_cache

TOL = 2e-4


@pytest.fixture
def ref(monkeypatch):
    """The reference's Pallas flash-decode module with the jax 0.9 aliases, for one test."""
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
    from repro.kernels import flash_decode as jfd
    yield jfd
    jax.clear_caches()


def _inputs(seed, B, H, KVH, D, S, bf16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if bf16:
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    return (jnp.asarray(q), jk, jv), (torch.from_numpy(q), tk, tv)


def _close(want, got, tol=TOL):
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, rtol=0)


def _empty_rows_exact(parts, rows):
    m, num, den = parts
    for b in rows:
        assert torch.all(m[b] == -1e30) and torch.all(num[b] == 0) and torch.all(den[b] == 0)


# B, H, KVH, D, S, kv_tile, shard_offset, lengths (a length past the slice and
# a fully masked row in each)
CONTIGUOUS = [
    (3, 8, 2, 16, 64, 16, 0, [0, 64, 17]),
    (3, 8, 2, 16, 64, 32, 0, [5, 80, 0]),
    (2, 4, 4, 32, 50, 128, 0, [50, 0]),        # kv_tile clamped to S, G = 1
    (2, 4, 1, 32, 45, 16, 0, [0, 33]),         # ragged last tile, G = 4
    (3, 8, 2, 16, 40, 16, 24, [20, 70, 30]),   # shard_offset: row 0 fully masked
    (2, 8, 2, 64, 96, None, 32, [140, 31]),
]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CONTIGUOUS, ids=[f"c{i}" for i in range(len(CONTIGUOUS))])
def test_plain_k7_matches_reference_kernel_and_partials(ref, case, bf16):
    B, H, KVH, D, S, tile, off, lengths = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, B, H, KVH, D, S, bf16)
    length = np.asarray(lengths, np.int32)
    got = fd.decode_partials(tq, tk, tv, torch.from_numpy(length), shard_offset=off,
                             kv_tile=tile, device="cpu")
    want_kernel = ref.decode_partials(jq, jk, jv, jnp.asarray(length), shard_offset=off,
                                      kv_tile=tile, interpret=True)
    want_plain = jdist.decode_partials(jq, jk, jv, jnp.asarray(length), shard_offset=off)
    _close(want_kernel, got)
    _close(want_plain, got)
    _close(want_plain, tdist.decode_partials(tq, tk, tv, torch.from_numpy(length),
                                             shard_offset=off))
    _empty_rows_exact(got, [b for b, n in enumerate(lengths) if n - off <= 0])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 4])
def test_plain_k7_paged_matches_reference_and_contiguous(ref, G, bf16):
    B, KVH, D, ps, P = 3, 2, 16, 8, 5
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, B, G * KVH, KVH, D, P * ps, bf16)
    length = np.asarray([0, 17, 40], np.int32)
    jkp, jvp = jpaged.pages_from_cache(jk, jv, ps)
    tkp, tvp = pages_from_cache(tk, tv, ps)
    got = fd.decode_partials_pages(tq, tkp, tvp, torch.from_numpy(length), device="cpu")
    _close(ref.decode_partials_pages(jq, jkp, jvp, jnp.asarray(length), interpret=True), got)
    _close([t.numpy() for t in fd.decode_partials(tq, tk, tv, torch.from_numpy(length),
                                                  kv_tile=ps, device="cpu")], got)
    _empty_rows_exact(got, [0])


def test_all_lanes_empty_is_exactly_zero():
    _, (tq, tk, tv) = _inputs(3, 2, 8, 2, 16, 32, False)
    zero = torch.zeros(2, dtype=torch.int32)
    _empty_rows_exact(fd.decode_partials(tq, tk, tv, zero, device="cpu"), [0, 1])
    kp, vp = pages_from_cache(tk, tv, 8)
    _empty_rows_exact(fd.decode_partials_pages(tq, kp, vp, zero, device="cpu"), [0, 1])
    _empty_rows_exact(fd.decode_partials(tq, tk[:, :0], tv[:, :0], zero, device="cpu"),
                      [0, 1])
    out = fd.flash_decode(tq, tk, tv, zero, device="cpu")
    assert torch.all(out == 0)


def test_flash_decode_matches_decode_attention():
    (jq, jk, jv), (tq, tk, tv) = _inputs(4, 3, 8, 2, 16, 64, False)
    length = np.asarray([1, 64, 23], np.int32)
    want = j_decode_attention(jq, jk, jv, jnp.asarray(length))
    got = fd.flash_decode(tq, tk, tv, torch.from_numpy(length), kv_tile=16, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    np.testing.assert_allclose(decode_attention(tq, tk, tv, torch.from_numpy(length)).numpy(),
                               np.asarray(want), atol=TOL, rtol=0)


def test_plain_version_is_the_tiled_online_softmax():
    """``flash_decode_ref`` over tiles equals one softmax over the slice."""
    _, (tq, tk, tv) = _inputs(5, 2, 4, 2, 16, 48, False)
    q4 = fd.prep_q(tq, 2)
    le = torch.tensor([48, 13], dtype=torch.int32)
    tiled = kref.flash_decode_ref(q4, tk.reshape(2, 6, 8, 2, 16), tv.reshape(2, 6, 8, 2, 16), le)
    whole = kref.flash_decode_ref(q4, tk[:, None], tv[:, None], le)
    out_t = fd.combine_partials(*tiled)
    out_w = fd.combine_partials(*whole)
    torch.testing.assert_close(out_t, out_w, atol=1e-6, rtol=0)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_paged_attention_matches_decode_attention(ref, use_kernels):
    rng = np.random.default_rng(23)
    B, H, KVH, D, S, ps = 3, 8, 2, 16, 64, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    length = np.asarray([1, 64, 17], np.int32)
    kp, vp = pages_from_cache(torch.from_numpy(k), torch.from_numpy(v), ps)
    out = paged_decode_attention(torch.from_numpy(q), kp, vp, torch.from_numpy(length),
                                 use_kernels=use_kernels)
    want = j_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(length))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL, rtol=0)
    jkp, jvp = jpaged.pages_from_cache(jnp.asarray(k), jnp.asarray(v), ps)
    want_paged = jpaged.paged_decode_attention(jnp.asarray(q), jkp, jvp, jnp.asarray(length),
                                               use_kernels=use_kernels)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_paged), atol=TOL, rtol=0)

    # new-token fold-in: the token at position `length` without touching the
    # pages == the oracle with the token scattered into the contiguous cache
    lengths2 = np.asarray([0, 40, 17], np.int32)
    k_new = rng.standard_normal((B, KVH, D)).astype(np.float32)
    v_new = rng.standard_normal((B, KVH, D)).astype(np.float32)
    onehot = (np.arange(S)[None, :] == lengths2[:, None])[:, :, None, None]
    k_ins = np.where(onehot, k_new[:, None], k)
    v_ins = np.where(onehot, v_new[:, None], v)
    want_new = j_decode_attention(jnp.asarray(q), jnp.asarray(k_ins), jnp.asarray(v_ins),
                                  jnp.asarray(lengths2 + 1))
    out_new = paged_decode_attention(torch.from_numpy(q), kp, vp, torch.from_numpy(lengths2),
                                     k_new=torch.from_numpy(k_new),
                                     v_new=torch.from_numpy(v_new), use_kernels=use_kernels)
    np.testing.assert_allclose(out_new.numpy(), np.asarray(want_new), atol=TOL, rtol=0)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_paged_attention_empty_lanes_return_zero(use_kernels):
    """Length-0 lanes return exactly 0 on both routes (num == den == 0, though the
    renormalization weight is exp(0) == 1 when every page is empty)."""
    rng = np.random.default_rng(29)
    B, H, KVH, D, S, ps = 2, 4, 2, 8, 32, 8
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    kp, vp = pages_from_cache(k, v, ps)
    out = paged_decode_attention(q, kp, vp, torch.zeros(B, dtype=torch.int32),
                                 use_kernels=use_kernels)
    assert torch.all(out == 0)
    mixed = torch.tensor([0, 20], dtype=torch.int32)
    out = paged_decode_attention(q, kp, vp, mixed, use_kernels=use_kernels)
    assert torch.all(out[0] == 0)
    torch.testing.assert_close(out[1], decode_attention(q, k, v, mixed)[1], atol=TOL, rtol=0)


def test_bf16_pages_with_strided_view():
    """The pool's gathered view (B and P strided, pages contiguous) reads the
    same as a contiguous copy."""
    rng = np.random.default_rng(31)
    B, P, ps, L, KVH, D = 2, 3, 8, 2, 2, 16
    slab = torch.from_numpy(rng.standard_normal((B, P, 2, L, ps, KVH, D)).astype(np.float32))
    kv = slab.to(torch.bfloat16).permute(2, 3, 0, 1, 4, 5, 6)
    k, v = kv[0][1], kv[1][1]
    assert not k.is_contiguous()
    q = torch.from_numpy(rng.standard_normal((B, 4, D)).astype(np.float32))
    length = torch.tensor([9, 24], dtype=torch.int32)
    got = fd.decode_partials_pages(q, k, v, length, device="cpu")
    want = fd.decode_partials_pages(q, k.contiguous(), v.contiguous(), length, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# K7's split over pages: the plain split-then-combine against the reference's
# unsplit partials
# ---------------------------------------------------------------------------

# lengths: empty, inside the first page, a page border (the split border at one
# page a split), the border of two splits of 3 pages, past the slice
SPLIT_LENGTHS = [0, 5, 8, 24, 100]


@pytest.mark.parametrize("splits", [1, 2, "per_page"])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_plain_split_k7_matches_reference_unsplit(ref, G, splits):
    B, KVH, D, ps, P = len(SPLIT_LENGTHS), 2, 16, 8, 6
    n_splits = P if splits == "per_page" else splits
    (jq, jk, jv), (tq, tk, tv) = _inputs(6 + G, B, G * KVH, KVH, D, P * ps, False)
    length = np.asarray(SPLIT_LENGTHS, np.int32)
    tkp, tvp = pages_from_cache(tk, tv, ps)
    le = fd.length_eff(torch.from_numpy(length), 0, P * ps)
    got = kref.flash_decode_split_ref(fd.prep_q(tq, KVH), tkp, tvp, le, n_splits)
    jkp, jvp = jpaged.pages_from_cache(jk, jv, ps)
    _close(ref.decode_partials_pages(jq, jkp, jvp, jnp.asarray(length), interpret=True), got)
    _close(jdist.decode_partials(jq, jk, jv, jnp.asarray(length), shard_offset=0), got)
    _empty_rows_exact(got, [0])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_plain_split_k7_contiguous_tiles_with_offset(ref, bf16):
    """Splits of kv_tile-sized tiles of a contiguous slice with a shard offset:
    a row fully before the slice, one ending inside the ragged last tile."""
    B, H, KVH, D, S, tile, off = 3, 8, 2, 32, 45, 8, 10
    (jq, jk, jv), (tq, tk, tv) = _inputs(9, B, H, KVH, D, S, bf16)
    length = np.asarray([4, 60, 33], np.int32)
    T = -(-S // tile)
    pad = (0, 0, 0, 0, 0, T * tile - S)
    kt, vt = (torch.nn.functional.pad(t, pad).reshape(B, T, tile, KVH, D) for t in (tk, tv))
    le = fd.length_eff(torch.from_numpy(length), off, S)
    want = jdist.decode_partials(jq, jk, jv, jnp.asarray(length), shard_offset=off)
    for n_splits in (1, 2, 3, T):
        got = kref.flash_decode_split_ref(fd.prep_q(tq, KVH), kt, vt, le, n_splits)
        _close(want, got)
        _empty_rows_exact(got, [0])


def test_combine_of_all_empty_splits_is_exactly_empty():
    m = torch.full((4, 2, 3, 5), kref.NEG_INF)
    num, den = torch.zeros(4, 2, 3, 5, 7), torch.zeros(4, 2, 3, 5)
    _empty_rows_exact(kref.combine_splits_ref(m, num, den), [0, 1])


@pytest.mark.parametrize("B,KVH", [(1, 1), (4, 4), (2, 8), (16, 8), (64, 8)])
def test_split_count_fills_the_card_with_non_empty_splits(B, KVH):
    for T in (1, 2, 5, 13, 64, 1000):
        s = fd.split_count(B, KVH, T)
        tps = -(-T // s)
        assert 1 <= s <= T and (s - 1) * tps < T <= s * tps      # no split empty
        assert s == T or B * KVH * s >= fd.TARGET_CTAS // 2
    assert fd.split_count(4, 4, 13) == 13                       # Yi-6B: one page a split


def test_wrapper_runs_the_plain_split_on_the_cpu():
    _, (tq, tk, tv) = _inputs(10, 4, 32, 4, 32, 13 * 8, True)
    kp, vp = pages_from_cache(tk, tv, 8)
    length = torch.tensor([0, 8, 50, 104], dtype=torch.int32)
    got = fd.decode_partials_pages(tq, kp, vp, length, device="cpu")
    want = kref.flash_decode_split_ref(fd.prep_q(tq, 4), kp, vp, length, 13)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _empty_rows_exact(got, [0])
