"""The dry-run tooling (``launch/hlo_cost.py``, ``hlo_analysis.py``,
``dryrun.py``) on fake process groups in this process: the counterparts of
the reference's ``tests/test_dist.py`` checks of its HLO cost model, the
depth extrapolation against a direct count, the CLI, and the K4/K6 custom ops
the dry-run carries on ``meta`` tensors.

Every fake group is ended after its test (``dryrun.end_fake_group``), so no
other test in the worker sees one.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import bucketed_reduce as bkt
from repro_torch.dist.compressed_allreduce import GradCompressionConfig, init_error_state
from repro_torch.launch import dryrun, hlo_analysis, hlo_cost

SRC = Path(__file__).resolve().parents[1] / "src"
REF_KEYS = {"arch", "shape", "mesh", "compressed_grads", "microbatches", "opt", "full",
            "devices", "param_count", "active_param_count", "cost_model", "roofline",
            "elapsed_s"}


@pytest.fixture
def fake():
    yield dryrun.fake_mesh
    dryrun.end_fake_group()


def _dt(shape, mesh, placements, dtype=torch.bfloat16):
    """A DTensor of ``shape`` whose blocks are meta tensors."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    local, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def test_cost_model_counts_per_device_flops_and_collectives(fake):
    """The reference's ``test_dist.py`` check: ``x @ w`` with x (512, 512) over
    (data, model) and w (512, 256) rows over model, on a (2, 4) mesh: a
    device's FLOPs are an eighth of the product's, and a collective runs."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = fake((2, 4), ("data", "model"))
    x = _dt((512, 512), mesh, [Shard(0), Shard(1)])
    w = _dt((512, 256), mesh, [Replicate(), Shard(0)])
    _, trace = hlo_cost.record(lambda: torch.sum((x @ w).to(torch.float32) ** 2).full_tensor())
    r = hlo_cost.analyze(trace)
    assert r["flops"] == 2 * 512 * 512 * 256 / 8
    assert r["collective_bytes"] > 0
    assert set(r) >= {"flops", "bytes", "collective_bytes", "cross_pod_bytes",
                      "collective_detail", "cross_pod_by_tag"}


@pytest.mark.parametrize("huge_buckets", [False, True])
def test_per_bucket_cross_pod_bytes_equal_the_analytic_model(fake, huge_buckets):
    """The reference's ``test_dist.py`` bucket check: the bucketed reduce's
    gathers on a fake (2, 2, 1) pod mesh, each bucket's cross-pod bytes equal
    ``expected_cross_pod_bytes`` (capacity-sized containers)."""
    from repro_torch.dist.compressed_allreduce import wire_bytes_per_leaf
    mesh = fake((2, 2, 1), ("pod", "data", "model"))
    meta = lambda *s: torch.empty(s, device="meta")        # noqa: E731
    g = {"layers": {"wq": meta(1, 32, 64), "wk": meta(1, 32, 64)}, "unembed": meta(1, 64, 64),
         "b": meta(1, 64)}
    abstract = {"layers": {"wq": meta(32, 64), "wk": meta(32, 64)}, "unembed": meta(64, 64),
                "b": meta(64)}
    gc0 = GradCompressionConfig(enabled=True, eb=1e-4, min_leaf_size=1024, kernel_mode="fused")
    wire1 = wire_bytes_per_leaf(64 * 64, gc0)["compressed"]
    gc = GradCompressionConfig(enabled=True, eb=1e-4, min_leaf_size=1024, overlap=True,
                               kernel_mode="fused",
                               bucket_bytes=(1 << 30) if huge_buckets else wire1 + 1)
    plan = bkt.assign_buckets(abstract, gc)
    err = init_error_state(abstract, 1, gc, device="meta")
    _, trace = hlo_cost.record(bkt.reduce_stacked_bucketed, g, err, gc, mesh, plan)
    r = hlo_cost.analyze(trace, devices_per_pod=2, tag_pattern=bkt.BUCKET_TAG_PATTERN)
    want = bkt.expected_cross_pod_bytes(plan, gc, n_pods=2)
    assert len(want) == (1 if huge_buckets else 3)
    assert {t: d["all-gather"] for t, d in r["cross_pod_by_tag"].items()} == \
        {t: float(v) for t, v in want.items()}
    assert r["cross_pod_bytes"] >= sum(want.values())


@pytest.mark.parametrize("arch,shape,full", [
    ("yi-6b", "decode_32k", 4),
    ("yi-6b", "prefill_32k", 4),
    ("dbrx-132b", ShapeConfig("t", 64, 16, "train"), 3),
    ("zamba2-2.7b", "long_500k", 3),          # superblocks of 2 layers
])
def test_depth_extrapolation_equals_a_direct_count(fake, arch, shape, full):
    """``run_cell`` on a fake (2, 2, 2) mesh at SMOKE, counted at depths 1 and 2
    and extrapolated, equals a direct count at the full depth."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    r = dryrun.run_cell(arch, shape, "multi", smoke=True, mesh_shape=(2, 2, 2),
                        full_depth=full)
    assert r["extrapolated_from"]["depths"] == [1, 2]
    assert r["extrapolated_from"]["full_depth"] == full
    cfg = configs.get(arch, smoke=True)
    unit = cfg.shared_attn_every or 1
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    direct = dryrun.count_step(dataclasses.replace(cfg, n_layers=full * unit), shp,
                               fake((2, 2, 2), ("pod", "data", "model")))
    for key in ("flops", "bytes", "collective_bytes", "cross_pod_bytes"):
        assert r["cost_model"][key] == pytest.approx(direct["cost"][key], rel=1e-9), key
    assert r["param_count"] == direct["param_count"]
    assert r["devices"] == 8 and REF_KEYS <= set(r)


@pytest.mark.parametrize("skip", [False, True])
def test_counted_attention_pair_equals_the_full_loop(fake, monkeypatch, skip):
    """A meta forward counts one chunk pair of the chunked attention for all of
    them: its FLOPs, bytes, collectives and memory tally equal those of the
    whole loop run on the same meta DTensors (4 x 4 chunk pairs of 512)."""
    from repro_torch import configs
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_CAUSAL_SKIP", skip)
    cfg = configs.get("yi-6b", smoke=True)
    shape = ShapeConfig("p", 2048, 4, "prefill")
    mesh = fake((2, 2), ("data", "model"))
    one_pair = dryrun.count_step(cfg, shape, mesh)
    monkeypatch.setattr(attention, "_counting_only", lambda x: False)
    loop = dryrun.count_step(cfg, shape, mesh)
    for key in ("flops", "bytes", "collective_bytes", "n_computations"):
        assert one_pair["cost"][key] == pytest.approx(loop["cost"][key], rel=1e-12), key
    assert one_pair["memory"] == loop["memory"]


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_moe_experts_run_on_their_own_ranks(fake, kind):
    """The experts' products split over ``tp`` as the experts' weights do: from
    a (2, 1) to a (2, 2) data x model mesh, each rank's share of them halves
    (dbrx-132b SMOKE, 4 experts). They ran whole on every rank of ``tp`` when
    the split was taken from the dispatch mask, which is whole there."""
    import dataclasses
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get("dbrx-132b", smoke=True), n_layers=1)
    shape = ShapeConfig("t", 512, 4, kind)

    def experts_flops(mesh_shape):
        cost = dryrun.count_step(cfg, shape, fake(mesh_shape, ("data", "model")))["cost"]
        return sum(v for k, v in cost["flops_by_site"].items() if "moe.py:experts:" in k)
    whole, split = experts_flops((2, 1)), experts_flops((2, 2))
    assert whole > 0 and split == whole / 2


def test_cli_runs_a_production_cell_without_jax(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --mesh
    single``: 256 fake ranks, the reference's JSON keys, no jax imported."""
    out = tmp_path / "cell.json"
    code = ("import sys, runpy; sys.argv = ['dryrun', '--arch', 'yi-6b', '--shape', "
            f"'train_4k', '--mesh', 'single', '--out', {str(out)!r}]; "
            "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__'); "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("XLA_FLAGS", None)
    p = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(out.read_text())
    assert REF_KEYS <= set(r)
    assert r["devices"] == 256 and r["param_count"] == 6_061_035_520
    assert set(r["full"]["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                        "alias_bytes", "peak_device_bytes"}
    assert set(r["roofline"]) >= {"compute_s", "memory_s", "collective_s", "cross_pod_s",
                                  "bottleneck", "step_time_lower_bound_s", "model_flops",
                                  "useful_flops_ratio"}
    assert 0 < r["roofline"]["useful_flops_ratio"] <= 1.02
    assert r["extrapolated_from"]["full_depth"] == 32


def test_roofline_terms_use_the_h100_datasheet():
    assert (hlo_analysis.PEAK_FLOPS, hlo_analysis.HBM_BW, hlo_analysis.LINK_BW,
            hlo_analysis.DCN_BW) == (989e12, 3.35e12, 450e9, 50e9)
    t = hlo_analysis.roofline_terms(989e12, 3.35e12 / 2, 0.0, 50e9 / 4)
    assert t["bottleneck"] == "compute" and t["step_time_lower_bound_s"] == 1.0
    assert t["cross_pod_s"] == 0.25
    assert hlo_analysis.model_flops(10, 7, "train") == 420.0
    assert hlo_analysis.model_flops(10, 7, "decode") == 140.0
    m = hlo_analysis.memory_summary({"argument_bytes": 5, "output_bytes": 3, "temp_bytes": 7,
                                     "alias_bytes": 2})
    assert m["peak_device_bytes"] == 13


def test_materialized_shapes_and_memory_traffic():
    x = torch.arange(4096, dtype=torch.int32)
    out, trace = hlo_cost.record(lambda t: (t.to(torch.uint16).reshape(64, 64), t * 2), x)
    assert (64, 64) in hlo_cost.materialized_shapes(trace) or \
        (4096,) in hlo_cost.materialized_shapes(trace)
    assert hlo_cost.materialized_shapes(trace, min_elems=4097) == set()
    m = hlo_cost.compiled_memory_traffic(trace, (x,), out)
    assert m["argument_bytes"] == 4096 * 4 and m["output_bytes"] == 4096 * 2 + 4096 * 4
    assert m["traffic_bytes"] == m["argument_bytes"] + m["output_bytes"] + 2 * m["temp_bytes"]


def test_step_report_takes_the_cost_models_leaf_form(fake):
    from repro_torch import obs
    from repro_torch.obs import report
    obs.reset()
    try:
        with obs.span("dist.bucket0_reduce"):
            pass
        rep = report.step_report(bytes_by_tag={"bucket0_reduce": {"all-gather": 640.0}})
        row = next(r for r in rep.rows if r["span"] == "dist.bucket0_reduce")
        assert row["bytes"] == 640.0
    finally:
        obs.reset()


def test_k4_k6_custom_ops_on_meta_and_on_the_cpu():
    from repro_torch import kernels
    from repro_torch.kernels import ops
    meta = torch.empty(10_000, device="meta")
    bf, pl, nnz = ops._k4(meta, torch.empty((), device="meta"), 77, "sign_mag")
    assert (bf.shape, bf.dtype, pl.shape, pl.dtype, nnz.shape) == \
        ((48,), torch.uint32, (77, 8), torch.uint16, ())
    assert ops._k6(bf, pl, torch.empty((), device="meta"), [100, 100], "sign_mag",
                   None, None).shape == (100, 100)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(10_000).astype(np.float32))
    eb = torch.tensor(1e-3, dtype=torch.float32)
    got = ops._k4(x, eb, 200, "sign_mag")
    want = kernels.fused_compress(x, eb, capacity=200)
    for a, b in zip(got, want):
        assert torch.equal(a.to(torch.int64), b.to(torch.int64))
    assert torch.equal(ops._k6(*got[:2], eb, [10_000], "sign_mag", None, None),
                       kernels.fused_decompress(*got[:2], eb, shape=(10_000,)))


@pytest.mark.parametrize("profile", ["tp", "zero3"])
def test_distribute_tree_lays_out_by_the_profile_as_the_reference(fake, monkeypatch, profile):
    """``distribute_tree`` puts each leaf's dimensions on the mesh axes the
    reference's ``resolve_spec`` gives under the profile, and ``gather_tree``
    gives the full leaves back."""
    import jax._src.core as jcore
    import jax
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
    from repro.dist import sharding as rshd
    from repro_torch import configs, pytree
    from repro_torch.dist import sharding as shd
    from repro_torch.models import zoo
    mesh = fake((2, 2, 2), ("pod", "data", "model"))
    stand_in = type("Mesh", (), {"axis_names": ("pod", "data", "model"),
                                 "shape": {"pod": 2, "data": 2, "model": 2}})()
    model = zoo.build(configs.get("dbrx-132b", smoke=True))
    monkeypatch.setattr(shd, "_profile", profile)
    monkeypatch.setattr(rshd, "_profile", profile)
    tree = shd.distribute_tree(model.abstract_params(), model.param_specs(), mesh)
    names = ("pod", "data", "model")
    specs = shd._logical_leaves(model.param_specs())      # a spec tuple is a leaf
    for (key, t), spec in zip(pytree.leaves_with_keys(tree), specs, strict=True):
        want = tuple(rshd.resolve_spec(tuple(spec), tuple(t.shape), stand_in))
        want += (None,) * (t.ndim - len(want))
        got = [None] * t.ndim
        for m, p in enumerate(t.placements):
            if p.is_shard():
                got[p.dim] = names[m] if got[p.dim] is None else (
                    (got[p.dim],) if isinstance(got[p.dim], str) else got[p.dim]) + (names[m],)
        assert tuple(got) == want, key
    full = shd.gather_tree(tree)
    assert [tuple(t.shape) for t in pytree.leaves(full)] == \
        [tuple(t.shape) for t in pytree.leaves(model.abstract_params())]
