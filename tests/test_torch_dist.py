"""The port's wire (``repro_torch.dist``) against the reference, in one process on the CPU.

* ``resolve_spec`` / ``logical_to_mesh_axes`` entry for entry over a table of
  logical specs, shapes and stand-in meshes, under both profiles;
  ``placements`` and ``replan_batch``.
* Wire accounting: ``wire_bytes_per_leaf`` and ``gathered_bytes_per_leaf``
  equal to the reference's and to ``FZCompressed.wire_bytes()``.
* ``assign_buckets`` equal in keys, element counts, wire bytes and bypass on
  the reference's seeded random trees and the production-order tree, and the
  plan's gauges equal to ``repro.obs``'s.
* ``reduce_stacked(mesh=None)`` bit-identical to the reference's at 2, 3 and
  4 pods over three error-feedback steps (a bypass, an int and a bfloat16
  leaf; capacity 1.0 and 0.5; disabled too), the bucketed form bit-identical
  to both, and the reference's error bounds on the reduce.
* ``grad_boundary`` a bit-exact identity forward and backward.
* The popcount of the flags equals ``nnz_blocks`` on the reference's containers.
* ``combine_shards`` (the collective-free combine of ``flash_decode_shard``)
  within 2e-4 of the reference's ``decode_attention``.

The multi-rank forms run as gloo processes in ``tests/test_torch_dist_multiproc.py``.
On jax 0.9 the reference needs two aliases; the ``ref`` fixture sets them for
one test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import FZConfig, compress, obs, pytree
from repro_torch.ckpt import elastic
from repro_torch.dist import bucketed_reduce as bkt
from repro_torch.dist import compat, sharding
from repro_torch.dist import compressed_allreduce as car
from repro_torch.dist import flash_decode as fdp


@pytest.fixture
def ref(monkeypatch):
    """The reference's dist package with the jax 0.9 aliases, for one test."""
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
    from repro import dist
    yield dist
    jax.clear_caches()


@pytest.fixture
def clean_obs():
    from repro import obs as jobs
    for m in (obs, jobs):
        m.reset()
        m.clear_events()
    yield jobs
    for m in (obs, jobs):
        m.reset()
        m.clear_events()


class StandIn:
    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


MESHES = {
    "data16_model16": StandIn(data=16, model=16),
    "pod2_data16_model16": StandIn(pod=2, data=16, model=16),
    "data8": StandIn(data=8),
    "pod2_data4": StandIn(pod=2, data=4),
    "model4": StandIn(model=4),
    "pod1_data4_model2": StandIn(pod=1, data=4, model=2),
}
SPECS = [(("fsdp", "tp"), (64, 32)), (("fsdp", "tp"), (64, 10)), ((None, "tp"), (7, 48)),
         (("dp",), (64,)), (("dp",), (16,)), (("dp",), (8,)), (("tp", "fsdp"), (48, 64)),
         (("dp", "fsdp"), (32, 32)), (("fsdp",), (3,)), (("unknown",), (64,)), ((), ()),
         (("fsdp", None, "tp"), (16, 5, 32)), (("dp", None), (4, 8)), (("tp",), (64, 64)),
         (("fsdp", "fsdp"), (64, 64)), (("dp", "tp", "fsdp"), (128, 32, 16))]


@pytest.mark.parametrize("profile", ["tp", "zero3"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_resolve_spec_matches_reference(profile, mesh_name):
    from repro.dist import sharding as jshd
    mesh = MESHES[mesh_name]
    try:
        jshd.set_profile(profile)
        sharding.set_profile(profile)
        assert sharding.get_profile() == jshd.get_profile() == profile
        assert sharding.logical_to_mesh_axes(mesh) == jshd.logical_to_mesh_axes(mesh)
        for logical, shape in SPECS:
            want = tuple(jshd.resolve_spec(logical, shape, mesh))
            got = sharding.resolve_spec(logical, shape, mesh)
            assert got == want, (logical, shape)
    finally:
        jshd.set_profile("tp")
        sharding.set_profile("tp")


def test_profile_names_and_stand_in_axes():
    with pytest.raises(ValueError):
        sharding.set_profile("fsdp")
    mesh = MESHES["pod2_data4"]
    assert compat.axis_names(mesh) == ("pod", "data")
    assert compat.axis_size(mesh, "data") == 4
    x = {"a": torch.ones(2)}
    assert compat.optimization_barrier(x) is x


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES["pod2_data16_model16"]
    assert sharding.placements(("data", "model"), mesh) == (Replicate(), Shard(0), Shard(1))
    assert sharding.placements((("pod", "data"),), mesh) == (Shard(0), Shard(0), Replicate())
    assert sharding.placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sharding.placements((("data", "pod"),), mesh)
    logical = {"w": ("fsdp", "tp"), "b": ("tp",), "n": ()}
    ab = {"w": torch.empty(64, 32, device="meta"), "b": torch.empty(10, device="meta"),
          "n": torch.empty((), device="meta")}
    sh = sharding.tree_shardings(logical, ab, mesh)
    assert sh["w"].spec == ("data", "model") and sh["b"].spec == (None,) and sh["n"].spec == ()
    assert sh["w"].placements == (Replicate(), Shard(0), Shard(1))


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_replan_batch_matches_reference(mesh_name):
    from repro.ckpt import elastic as jel
    mesh = MESHES[mesh_name]
    for gb in (64, 96, 7):
        try:
            want = jel.replan_batch(gb, mesh)
        except ValueError:
            with pytest.raises(ValueError):
                elastic.replan_batch(gb, mesh)
            continue
        assert elastic.replan_batch(gb, mesh) == want


def test_pytree_flattens_as_jax():
    tree = {"z": [1, (2, 3)], "a": {"y": 4, "b": None, "c": 5}, "m": (6,)}
    want = [(jax.tree_util.keystr(p), v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert pytree.leaves_with_keys(tree) == want
    again = pytree.unflatten(tree, [v for _, v in want])
    assert again == tree and list(again) == list(tree)
    assert pytree.tree_map(lambda a, b: a + b, tree, tree)["z"] == [2, (4, 6)]


# ---------------------------------------------------------------------------
# Wire accounting and bucket plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capf", [0.5, 0.75, 1.0])
@pytest.mark.parametrize("n", [1 << 14, 1 << 16, 1 << 20])
def test_wire_bytes_equal_reference_and_container(ref, n, capf):
    from repro.dist import bucketed_reduce as jbkt
    from repro.dist.compressed_allreduce import GradCompressionConfig as JCfg
    jcfg, cfg = JCfg(capacity_frac=capf), car.GradCompressionConfig(capacity_frac=capf)
    want = ref.compressed_allreduce.wire_bytes_per_leaf(n, jcfg)
    assert car.wire_bytes_per_leaf(n, cfg) == want
    assert bkt.gathered_bytes_per_leaf(n, cfg) == jbkt.gathered_bytes_per_leaf(n, jcfg)
    assert bkt.gathered_bytes_per_leaf(n, cfg) == want["compressed"] - 8
    c = compress(torch.zeros(n), cfg.fz_config(), device="cpu")
    assert c.wire_bytes() == want["compressed"]
    strict = FZConfig(capacity_frac=capf)
    fields = car.container_field_bytes(n, strict)
    c = compress(torch.zeros(n), strict, device="cpu")
    assert {f: getattr(c, f).nbytes for f in c.FIELDS} == fields


def _random_tree(seed: int, abstract):
    """The reference's seeded random tree (tests/test_bucketed_reduce.py)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for i in range(int(rng.integers(1, 10))):
        nd = int(rng.integers(1, 4))
        shape = tuple(int(rng.integers(1, 33)) * (8 if d == 0 else 4) for d in range(nd))
        tree[f"leaf{i:02d}"] = abstract(shape, "float32")
    if rng.integers(0, 2):
        tree["layers"] = {"w": abstract((64, 64), "float32")}
    return tree


def _jax_abstract(shape, dtype):
    return jax.ShapeDtypeStruct(shape, jnp.dtype(dtype))


def _meta(shape, dtype):
    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def _same_plan(plan, jplan):
    assert plan.n_buckets == jplan.n_buckets
    for b, jb in zip(plan.buckets, jplan.buckets):
        assert (b.index, b.keys, b.n_elems, b.wire_bytes, b.tag) == \
            (jb.index, jb.keys, jb.n_elems, jb.wire_bytes, jb.tag)
    assert plan.bypass == jplan.bypass


@pytest.mark.parametrize("bucket_bytes", [1 << 12, 1 << 15, 1 << 20])
def test_assign_buckets_equal_reference_on_random_trees(ref, bucket_bytes):
    from repro.dist.compressed_allreduce import GradCompressionConfig as JCfg
    kw = dict(enabled=True, min_leaf_size=1024, overlap=True, bucket_bytes=bucket_bytes)
    for seed in range(12):
        jplan = ref.bucketed_reduce.assign_buckets(_random_tree(seed, _jax_abstract), JCfg(**kw))
        tree = _random_tree(seed, _meta)
        plan = bkt.assign_buckets(tree, car.GradCompressionConfig(**kw))
        _same_plan(plan, jplan)
        assert plan == bkt.assign_buckets(dict(reversed(list(tree.items()))),
                                          car.GradCompressionConfig(**kw))


def _production_tree(abstract):
    return {"embed": abstract((256, 64), "float32"),
            "layers": {"wq": abstract((2, 64, 64), "float32"),
                       "norm": abstract((2, 64), "float32"),
                       "ints": abstract((2, 4096), "int32")},
            "final_norm": abstract((4096,), "float32"),
            "unembed": abstract((64, 256), "float32"),
            "scale": abstract((2,), "bfloat16"),
            "emb_bf16": abstract((64, 96), "bfloat16")}


@pytest.mark.parametrize("bucket_bytes", [1, 20_000, 1 << 30])
def test_assign_buckets_production_order_and_gauges(ref, clean_obs, bucket_bytes):
    from repro.dist.compressed_allreduce import GradCompressionConfig as JCfg
    jobs = clean_obs
    kw = dict(enabled=True, min_leaf_size=1024, overlap=True, bucket_bytes=bucket_bytes)
    jplan = ref.bucketed_reduce.assign_buckets(_production_tree(_jax_abstract), JCfg(**kw))
    plan = bkt.assign_buckets(_production_tree(_meta), car.GradCompressionConfig(**kw))
    _same_plan(plan, jplan)
    if bucket_bytes == 1:
        assert [k for b in plan.buckets for k in b.keys] == [
            "['unembed']", "['final_norm']", "['emb_bf16']", "['layers']['wq']", "['embed']"]
    gauges = {k: v for k, v in obs.snapshot()["gauges"].items() if k.startswith("dist_")}
    want = {k: v for k, v in jobs.snapshot()["gauges"].items() if k.startswith("dist_")}
    assert gauges == want and gauges["dist_n_buckets"] == plan.n_buckets
    exp = bkt.expected_cross_pod_bytes(plan, car.GradCompressionConfig(**kw), n_pods=3)
    assert exp == ref.bucketed_reduce.expected_cross_pod_bytes(jplan, JCfg(**kw), n_pods=3)


@pytest.mark.parametrize("enabled", [True, False])
def test_error_state_matches_reference(ref, enabled):
    from repro.dist.compressed_allreduce import GradCompressionConfig as JCfg
    kw = dict(enabled=enabled, min_leaf_size=1024)
    want = ref.compressed_allreduce.init_error_state(_production_tree(_jax_abstract), 3, JCfg(**kw))
    got = car.init_error_state(_production_tree(_meta), 3, car.GradCompressionConfig(**kw),
                               device="cpu")
    assert [(k, tuple(v.shape)) for k, v in pytree.leaves_with_keys(got)] == \
        [(jax.tree_util.keystr(p), tuple(v.shape))
         for p, v in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert all(v.dtype == torch.float32 and not v.any() for v in pytree.leaves(got))
    sh = car.error_state_shardings(_production_tree(_meta), car.GradCompressionConfig(**kw),
                                   MESHES["pod2_data4"])
    if enabled:
        assert sh["embed"].spec == ("pod",) and sh["layers"]["ints"].spec == ()
    else:
        assert sh == {}


# ---------------------------------------------------------------------------
# The reduce: bit parity with the reference's inline oracle
# ---------------------------------------------------------------------------

def _grads(n_pods: int, step: int) -> dict:
    """Seeded numpy gradients, stacked over pods: a bypass leaf, an int leaf and
    a bfloat16 leaf (as float32 values, cast by the caller)."""
    rng = np.random.default_rng(11)
    scale = np.float32(1.0 + 0.25 * step)
    f = lambda *s: rng.standard_normal((n_pods,) + s).astype(np.float32) * scale  # noqa: E731
    return {"layers": {"wq": f(2, 64, 64), "wk": f(2, 32, 64)},
            "unembed": f(64, 80),
            "bias": f(8),
            "count": rng.integers(-50, 50, (n_pods, 4096)).astype(np.int32) * (step + 1),
            "emb_bf16": f(48, 96)}


def _to_jax(tree):
    return {k: _to_jax(v) if isinstance(v, dict) else
            (jnp.asarray(v).astype(jnp.bfloat16) if k.endswith("bf16") else jnp.asarray(v))
            for k, v in tree.items()}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else
            (torch.from_numpy(v).to(torch.bfloat16) if k.endswith("bf16") else
             torch.from_numpy(v))
            for k, v in tree.items()}


def _bits(x) -> np.ndarray:
    """Bits of a leaf of either package, as a numpy integer array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32) if x.dtype == torch.float32 else x.numpy()
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same_tree(port_tree, ref_tree):
    got = pytree.leaves_with_keys(port_tree)
    want = [(jax.tree_util.keystr(p), v)
            for p, v in jax.tree_util.tree_flatten_with_path(ref_tree)[0]]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w)), k
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)


def _abstract(tree):
    return pytree.tree_map(lambda g: torch.empty(g.shape[1:], dtype=g.dtype, device="meta"), tree)


@pytest.mark.parametrize("capf,enabled", [(1.0, True), (0.5, True), (1.0, False)])
@pytest.mark.parametrize("n_pods", [2, 3, 4])
def test_reduce_stacked_bit_identical_to_reference(ref, n_pods, capf, enabled):
    """Three steps of error feedback: the reduced gradients and the error state
    equal the reference's inline oracle bit for bit, and the bucketed form
    (one leaf a bucket, all leaves in one) equals both."""
    from repro.dist.compressed_allreduce import GradCompressionConfig as JCfg
    kw = dict(enabled=enabled, eb=1e-4, min_leaf_size=1024, capacity_frac=capf)
    jcfg, cfg = JCfg(**kw), car.GradCompressionConfig(**kw)
    g0 = _to_torch(_grads(n_pods, 0))
    jerr = ref.compressed_allreduce.init_error_state(
        jax.tree.map(lambda g: jax.ShapeDtypeStruct(g.shape[1:], g.dtype),
                     _to_jax(_grads(n_pods, 0))), n_pods, jcfg)
    err = car.init_error_state(_abstract(g0), n_pods, cfg, device="cpu")
    errs_b = {bb: car.init_error_state(_abstract(g0), n_pods, cfg, device="cpu")
              for bb in (1, 1 << 30)}
    for step in range(3):
        g = _grads(n_pods, step)
        jred, jerr = ref.compressed_allreduce.reduce_stacked(_to_jax(g), jerr, jcfg)
        red, err = car.reduce_stacked(_to_torch(g), err, cfg)
        assert_same_tree(red, jred)
        assert_same_tree(err, jerr)
        for bb in errs_b:
            cfg_b = car.GradCompressionConfig(**kw, overlap=True, bucket_bytes=bb)
            red_b, errs_b[bb] = bkt.reduce_stacked_bucketed(_to_torch(g), errs_b[bb], cfg_b)
            assert_same_tree(red_b, jred)
            assert_same_tree(errs_b[bb], jerr)


def test_reduce_within_the_error_bound_and_feedback_helps():
    """The reference's bounds (tests/test_dist.py section 2) on the port's
    inline reduce: max|reduced - exact mean| <= 2 eb range, and the two-round
    mean no worse than one round."""
    cfg = car.GradCompressionConfig(enabled=True, eb=1e-4, min_leaf_size=1024)
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal((2, 64, 64)).astype(np.float32)),
         "b": torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))}
    err = car.init_error_state(_abstract(g), 2, cfg, device="cpu")
    red, err = car.reduce_stacked(g, err, cfg)
    exact = {k: v.mean(0) for k, v in g.items()}
    w_rng = float(g["w"].max() - g["w"].min())
    err1 = float((red["w"] - exact["w"]).abs().max())
    assert err1 <= 2 * 1e-4 * w_rng
    torch.testing.assert_close(red["b"], exact["b"], rtol=1e-6, atol=0)
    red2, _ = car.reduce_stacked(g, err, cfg)
    err2 = float(((red["w"] + red2["w"]) / 2 - exact["w"]).abs().max())
    assert err2 <= err1 + 1e-7


def test_pod_mean_is_xla_mean():
    """A sum in pod order times float32(1/n): at 3 and 5 pods ``torch.mean``
    differs from XLA in the last bit, this does not."""
    rng = np.random.default_rng(5)
    for n in (2, 3, 4, 5, 7, 8):
        d = rng.standard_normal((n, 20_000)).astype(np.float32)
        want = np.asarray(jnp.mean(jnp.asarray(d), axis=0))
        got = car.pod_mean(list(torch.from_numpy(d))).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("capf", [1.0, 0.5, 0.05])
def test_popcount_of_flags_is_nnz_blocks(ref, capf):
    from repro.core import fz as jfz
    x = np.cumsum(np.random.default_rng(2).standard_normal(300_000)).astype(np.float32)
    x[50_000:120_000] = 0.0
    for exact in (True, False):
        c = jfz.compress(jnp.asarray(x), jfz.FZConfig(eb=1e-4, capacity_frac=capf,
                                                       exact_outliers=exact))
        flags = torch.from_numpy(np.array(c.bitflags))
        assert int(car.popcount(flags)) == int(c.nnz_blocks)
        pc = compress(torch.from_numpy(x), FZConfig(eb=1e-4, capacity_frac=capf,
                                                    exact_outliers=exact), device="cpu")
        assert int(car.popcount(pc.bitflags)) == int(pc.nnz_blocks) == int(c.nnz_blocks)


# ---------------------------------------------------------------------------
# grad_boundary
# ---------------------------------------------------------------------------

def _loss(params, x, tap):
    layers = tap(params["layers"], "layers") if tap else params["layers"]
    h = x
    for i in range(layers["w"].shape[0]):
        h = torch.tanh(h @ layers["w"][i] + layers["b"][i])
    out = tap({"unembed": params["unembed"], "tag": "kept"}, "unembed") if tap else \
        {"unembed": params["unembed"], "tag": "kept"}
    assert out["tag"] == "kept"
    return ((h @ out["unembed"]) ** 2).mean()


def test_grad_boundary_is_bit_exact_identity():
    g = torch.Generator().manual_seed(0)
    params = {"layers": {"w": torch.randn(3, 16, 16, generator=g) * 0.3,
                         "b": torch.randn(3, 16, generator=g)},
              "unembed": torch.randn(16, 40, generator=g)}
    x = torch.randn(8, 16, generator=g)

    def run(tap):
        p = pytree.tree_map(lambda t: t.clone().requires_grad_(True), params)
        loss = _loss(p, x, tap)
        loss.backward()
        return loss.detach(), pytree.tree_map(lambda t: t.grad, p)

    base_l, base_g = run(None)
    tap_l, tap_g = run(bkt.grad_boundary)
    assert torch.equal(base_l.view(torch.int32), tap_l.view(torch.int32))
    for a, b in zip(pytree.leaves(base_g), pytree.leaves(tap_g)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    t = {"a": torch.ones(3), "n": 4}
    assert bkt.grad_boundary(t)["n"] == 4 and torch.equal(bkt.grad_boundary(t)["a"], t["a"])
    assert bkt.grad_boundary({"n": 1}) == {"n": 1}


# ---------------------------------------------------------------------------
# flash_decode_shard's combine, without collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("lengths", [[60, 33, 64, 1], [40, 33, 47, 1]])
def test_combine_shards_matches_decode_attention(use_kernels, lengths):
    from repro.models.attention import decode_attention
    B, S, H, KVH, D, n_shards = 4, 64, 8, 4, 16, 4
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    length = np.asarray(lengths, np.int32)
    want = np.asarray(decode_attention(*(jnp.asarray(a) for a in (q, k, v, length))))
    s = S // n_shards
    parts = [fdp.shard_partials(torch.from_numpy(q), torch.from_numpy(k[:, i * s:(i + 1) * s]),
                                torch.from_numpy(v[:, i * s:(i + 1) * s]),
                                torch.from_numpy(length), shard_offset=i * s,
                                use_kernels=use_kernels, device="cpu")
             for i in range(n_shards)]
    if max(lengths) <= 3 * s:          # the last shard lies past every length
        m, num, den = parts[-1]
        assert bool((m == fdp.NEG_INF).all()) and not num.any() and not den.any()
    got = fdp.combine_shards(parts)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
