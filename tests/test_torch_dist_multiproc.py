"""The port's multi-rank wire and elastic resharding, as gloo processes on the CPU.

Each test starts one Python process a rank (world size 2, 3 and 4), joined by
a ``file://`` store under the test's ``tmp_path`` (no TCP port: the suite runs
several workers at once). Every rank passes ``device="cpu"``. The test waits
at most ``TIMEOUT`` seconds for all of them and kills any that remain, so no
process outlives its test. The ranks run only the port; the reference runs
in the test's own process and the ranks' results are held against it:

* the distributed ``reduce_stacked`` and ``reduce_stacked_bucketed`` (one
  rank a pod) equal the reference's inline ``reduce_stacked`` bit for bit over
  three error-feedback steps -- the reduced tree on every rank, each rank's
  own residual -- and the disabled config's exact mean too;
* the gathered bytes each bucket hands to the collectives equal
  ``expected_cross_pod_bytes`` exactly, and the barrier form's equal their sum;
* ``flash_decode_shard`` at (B 4, S 64, H 8, KVH 4, D 16) over 4 ranks, with
  lengths [60, 33, 64, 1] and a set whose last shard lies past every length,
  within 2e-4 of the reference's ``decode_attention`` (K7's plain version and
  the plain partials);
* ``elastic.reshard`` from a (2, 2) ``(data, model)`` mesh to a (4,) ``data``
  mesh leaves every value identical, and ``ckpt.restore`` lays a checkpoint
  out on the new mesh.

Run one rank by hand: ``python tests/test_torch_dist_multiproc.py CASE RANK
WORLD DIR [MESH]``.
"""
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
TIMEOUT = 120                # seconds for all ranks of one test
STEPS = 3
EB, MIN_LEAF = 1e-4, 1024
FLASH = dict(B=4, S=64, H=8, KVH=4, D=16)
FLASH_LENGTHS = ([60, 33, 64, 1], [40, 33, 47, 1])


def grads(n_pods: int, step: int) -> dict:
    """Seeded numpy gradients stacked over pods (float32; ``*_bf16`` leaves are
    cast to bfloat16 by each package): a bypass leaf and an int leaf too."""
    rng = np.random.default_rng(23)
    scale = np.float32(1.0 + 0.25 * step)
    f = lambda *s: rng.standard_normal((n_pods,) + s).astype(np.float32) * scale  # noqa: E731
    return {"layers": {"wq": f(2, 32, 64), "wk": f(2, 16, 64)},
            "unembed": f(64, 48),
            "final_norm": f(4096),
            "bias": f(8),
            "count": rng.integers(-50, 50, (n_pods, 2048)).astype(np.int32) * (step + 1),
            "emb_bf16": f(32, 96)}


def _torch_tree(tree, sl=slice(None)):
    return {k: _torch_tree(v, sl) if isinstance(v, dict) else
            (torch.from_numpy(v[sl]).to(torch.bfloat16) if k.endswith("bf16")
             else torch.from_numpy(v[sl].copy()))
            for k, v in tree.items()}


def flash_inputs():
    rng = np.random.default_rng(0)
    B, S, H, KVH, D = (FLASH[k] for k in ("B", "S", "H", "KVH", "D"))
    return (rng.standard_normal((B, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KVH, D)).astype(np.float32),
            rng.standard_normal((B, S, KVH, D)).astype(np.float32))


# ---------------------------------------------------------------------------
# The ranks (run as ``__main__``; the port only)
# ---------------------------------------------------------------------------

def _rank_reduce(rank, world, out, mesh_shape):
    from repro_torch import obs, pytree
    from repro_torch.dist import bucketed_reduce as bkt
    from repro_torch.dist import compat
    from repro_torch.dist import compressed_allreduce as car
    names = ("pod",) if len(mesh_shape) == 1 else ("pod", "data")
    mesh = compat.make_mesh(mesh_shape, names, device_type="cpu")
    n_pods = mesh_shape[0]
    pod = mesh.get_local_rank("pod")
    kw = dict(enabled=True, eb=EB, min_leaf_size=MIN_LEAF)
    cfgs = {"barrier": car.GradCompressionConfig(**kw)}
    for bb in (1, 1 << 30):
        cfgs[f"bucketed{bb}"] = car.GradCompressionConfig(**kw, overlap=True, bucket_bytes=bb)
    g0 = _torch_tree(grads(n_pods, 0), slice(pod, pod + 1))
    abstract = pytree.tree_map(lambda g: torch.empty(g.shape[1:], dtype=g.dtype, device="meta"),
                               g0)
    errs = {name: car.init_error_state(abstract, 1, cfg, device="cpu")
            for name, cfg in cfgs.items()}
    res = {"pod": pod}
    for step in range(STEPS):
        g = _torch_tree(grads(n_pods, step), slice(pod, pod + 1))
        for name, cfg in cfgs.items():
            obs.reset()
            if name == "barrier":
                red, errs[name] = car.reduce_stacked(g, errs[name], cfg, mesh)
            else:
                plan = bkt.assign_buckets(abstract, cfg)
                red, errs[name] = bkt.reduce_stacked_bucketed(g, errs[name], cfg, mesh, plan=plan)
                res[f"expected {name}"] = bkt.expected_cross_pod_bytes(plan, cfg, n_pods)
            res[f"{name} {step}"] = (red, errs[name])
            res[f"bytes {name} {step}"] = car.gathered_bytes()
    res["disabled"] = car.reduce_stacked(g, {}, car.GradCompressionConfig(), mesh)[0]
    torch.save(res, out)


def _rank_flash(rank, world, out, mesh_shape):
    from repro_torch.dist import compat
    from repro_torch.dist import flash_decode as fdp
    mesh = compat.make_mesh((world,), ("model",), device_type="cpu")
    q, k, v = flash_inputs()
    s = FLASH["S"] // world
    i = mesh.get_local_rank("model")
    res = {}
    for lengths in FLASH_LENGTHS:
        for use_kernels in (True, False):
            res[(tuple(lengths), use_kernels)] = fdp.flash_decode_shard(
                torch.from_numpy(q), torch.from_numpy(k[:, i * s:(i + 1) * s].copy()),
                torch.from_numpy(v[:, i * s:(i + 1) * s].copy()),
                torch.tensor(lengths, dtype=torch.int32), mesh=mesh, axis="model",
                shard_offset=i * s, use_kernels=use_kernels, device="cpu")
    torch.save(res, out)


def _rank_reshard(rank, world, out, mesh_shape):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch import ckpt, pytree
    from repro_torch.ckpt import elastic
    from repro_torch.dist import compat, sharding
    g = torch.Generator().manual_seed(3)
    tree = {"w": torch.randn(8, 12, generator=g), "b": torch.randn(6, generator=g),
            "emb": torch.randn(16, 4, generator=g).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}
    logical = {"w": ("fsdp", "tp"), "b": ("tp",), "emb": ("dp", None), "step": ()}
    mesh_a = compat.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    mesh_b = compat.make_mesh((4,), ("data",), device_type="cpu")
    on_a = elastic.reshard(tree, logical, mesh_a)
    on_b = elastic.reshard(on_a, logical, mesh_b)
    for t in (on_a, on_b):
        for key, x in pytree.leaves_with_keys(t):
            assert isinstance(x, DTensor), key
    res = {"a_specs": {k: sharding.resolve_spec(logical[k], tuple(tree[k].shape), mesh_a)
                       for k in tree},
           "a_local": pytree.tree_map(lambda x: x.to_local(), on_a),
           "b_local": pytree.tree_map(lambda x: x.to_local(), on_b),
           "b_full": pytree.tree_map(lambda x: x.full_tensor(), on_b),
           "replan": elastic.replan_batch(64, mesh_b)}
    root = Path(out).parent / "ckpt"
    if rank == 0:
        ckpt.save(str(root), 4, tree, device="cpu")
    dist.barrier()
    restored, meta = ckpt.restore(str(root), tree, device="cpu",
                                  shardings=sharding.tree_shardings(logical, tree, mesh_b))
    res["restored_local"] = pytree.tree_map(lambda x: x.to_local(), restored)
    res["restored_full"] = pytree.tree_map(lambda x: x.full_tensor(), restored)
    res["meta"] = meta
    torch.save(res, out)


CASES = {"reduce": _rank_reduce, "flash": _rank_flash, "reshard": _rank_reshard}


def _rank_main(case, rank, world, directory, mesh=""):
    import torch.distributed as dist
    rank, world = int(rank), int(world)
    mesh_shape = tuple(int(s) for s in mesh.split("x")) if mesh else (world,)
    dist.init_process_group("gloo", init_method=f"file://{directory}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT))
    try:
        CASES[case](rank, world, os.path.join(directory, f"rank{rank}.pt"), mesh_shape)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

def _spawn(case, world, tmp_path, mesh=""):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC)] + [p for p in
                                                      env.get("PYTHONPATH", "").split(os.pathsep)
                                                      if p])
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, str(HERE), case, str(r), str(world),
                               str(tmp_path), mesh], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    deadline = time.monotonic() + TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{err[-4000:]}"
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture
def ref(monkeypatch):
    """The reference's dist package with the jax 0.9 aliases, for one test."""
    import jax
    import jax._src.core as jcore
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(jax.core, "trace_state_clean", jcore.trace_state_clean, raising=False)
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)
    from repro import dist
    yield dist
    jax.clear_caches()


def _reference_steps(ref, n_pods):
    import jax
    import jax.numpy as jnp
    from repro.dist.compressed_allreduce import GradCompressionConfig as JCfg

    def to_jax(tree):
        return {k: to_jax(v) if isinstance(v, dict) else
                (jnp.asarray(v).astype(jnp.bfloat16) if k.endswith("bf16") else jnp.asarray(v))
                for k, v in tree.items()}
    cfg = JCfg(enabled=True, eb=EB, min_leaf_size=MIN_LEAF)
    g0 = to_jax(grads(n_pods, 0))
    err = ref.compressed_allreduce.init_error_state(
        jax.tree.map(lambda g: jax.ShapeDtypeStruct(g.shape[1:], g.dtype), g0), n_pods, cfg)
    out = []
    for step in range(STEPS):
        red, err = ref.compressed_allreduce.reduce_stacked(to_jax(grads(n_pods, step)), err, cfg)
        out.append((red, err))
    disabled, _ = ref.compressed_allreduce.reduce_stacked(to_jax(grads(n_pods, STEPS - 1)), {},
                                                          JCfg())
    return out, disabled


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32) if x.dtype == torch.float32 else x.numpy()
    import jax.numpy as jnp
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(port_tree, ref_tree, pod=None):
    """Bit equality, leaf for leaf; ``pod``: the reference's stacked error state
    against one rank's own slice (empty placeholders as they are)."""
    import jax
    from repro_torch import pytree
    got = pytree.leaves_with_keys(port_tree)
    want = [(jax.tree_util.keystr(p), v)
            for p, v in jax.tree_util.tree_flatten_with_path(ref_tree)[0]]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        w = np.asarray(w)
        if pod is not None and w.shape[0]:
            w = w[pod:pod + 1]
        assert tuple(g.shape) == w.shape, k
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)


@pytest.mark.parametrize("world,mesh", [(2, ""), (3, ""), (4, ""), (4, "2x2")])
def test_distributed_reduce_bit_identical_to_reference(ref, tmp_path, world, mesh):
    n_pods = int(mesh.split("x")[0]) if mesh else world
    ranks = _spawn("reduce", world, tmp_path, mesh)
    want, want_disabled = _reference_steps(ref, n_pods)
    for r, res in enumerate(ranks):
        pod = res["pod"]
        assert pod == (r // 2 if mesh == "2x2" else r)
        for step, (jred, jerr) in enumerate(want):
            for name in ("barrier", "bucketed1", f"bucketed{1 << 30}"):
                red, err = res[f"{name} {step}"]
                _assert_same(red, jred)
                _assert_same(err, jerr, pod)
                counted = res[f"bytes {name} {step}"]
                bypass = counted.pop("bypass")
                assert bypass == n_pods * (8 * 4 + 2048 * 4)
                if name == "barrier":
                    expected = sum(res[f"expected bucketed{1 << 30}"].values())
                    assert sum(counted.values()) == expected
                else:
                    assert counted == res[f"expected {name}"]
        _assert_same(res["disabled"], want_disabled)
    assert len(ranks[0][f"expected bucketed{1}"]) == 5


def test_flash_decode_shard_matches_decode_attention(tmp_path):
    import jax.numpy as jnp
    from repro.models.attention import decode_attention
    q, k, v = flash_inputs()
    ranks = _spawn("flash", 4, tmp_path)
    for lengths in FLASH_LENGTHS:
        want = np.asarray(decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(lengths, jnp.int32)))
        for res in ranks:
            for use_kernels in (True, False):
                got = res[(tuple(lengths), use_kernels)].numpy()
                np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(ranks[0][(tuple(lengths), True)].numpy(),
                                      ranks[3][(tuple(lengths), True)].numpy())


def _raw(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def test_elastic_reshard_keeps_every_value(tmp_path):
    ranks = _spawn("reshard", 4, tmp_path)
    g = torch.Generator().manual_seed(3)
    tree = {"w": torch.randn(8, 12, generator=g), "b": torch.randn(6, generator=g),
            "emb": torch.randn(16, 4, generator=g).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}
    assert ranks[0]["a_specs"] == {"w": ("data", "model"), "b": ("model",),
                                   "emb": ("data", None), "step": ()}
    for r, res in enumerate(ranks):
        d, m = divmod(r, 2)                              # (data, model) coordinates on mesh a
        a = res["a_local"]
        assert torch.equal(a["w"], tree["w"][4 * d:4 * d + 4, 6 * m:6 * m + 6])
        assert torch.equal(a["b"], tree["b"][3 * m:3 * m + 3])
        assert torch.equal(a["emb"].view(torch.int16), tree["emb"][8 * d:8 * d + 8].view(torch.int16))
        b = res["b_local"]
        assert torch.equal(b["w"], tree["w"][2 * r:2 * r + 2])
        assert torch.equal(b["b"], tree["b"])               # no model axis: replicated
        assert torch.equal(b["emb"].view(torch.int16), tree["emb"][4 * r:4 * r + 4].view(torch.int16))
        for key in ("b_full", "restored_full"):
            for name in tree:
                assert torch.equal(_raw(res[key][name]), _raw(tree[name])), (key, name)
        for name in tree:
            assert torch.equal(_raw(res["restored_local"][name]), _raw(b[name])), name
        assert res["meta"] == {"step": 4} and res["replan"] == {"dp_shards": 4, "per_shard": 16}


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
