"""Bucketed, overlap-ready FZ-compressed cross-pod gradient reduce: the port of
``repro/dist/bucketed_reduce.py``.

The barrier reduce in ``compressed_allreduce`` hops every leaf after the
whole backward pass. This module issues the same per-leaf math in
size-targeted buckets, in backward production order, so that a bucket's
transfer can start while later gradients are still being produced:

  * ``assign_buckets`` partitions the gradient tree into buckets of about
    ``GradCompressionConfig.bucket_bytes`` of wire bytes: a pure function of
    the abstract tree and the config, so the error-feedback residuals stay
    aligned with their leaves across steps and restarts. Leaves are ordered
    unembed, final norm, the layer stack, embed (ties broken on the leaf
    path) and buckets are contiguous runs of that order.
  * ``reduce_stacked_bucketed`` runs one hop a bucket, each under an
    ``obs.span("dist.bucket<i>_reduce")``; with a ``pod`` mesh each leaf runs
    ``compressed_allreduce.pod_hop_body``, inline the shared ``reference_hop``.
    The per-leaf math is the barrier reduce's, so both are bit-identical.
  * ``grad_boundary`` is an autograd identity (forward and backward) that
    marks a parameter group's gradient boundary, where the reference installs
    a ``custom_vjp`` whose backward is an ``optimization_barrier``.

Wire accounting: ``gathered_bytes_per_leaf`` counts the fields a hop
gathers, and ``expected_cross_pod_bytes`` the bytes of each bucket's gathers
(their outputs); the distributed hops count exactly these bytes under the
bucket's tag (``compressed_allreduce.gathered_bytes``).

Differences from the reference: the plan's gauges (``dist_n_buckets``,
``dist_bucket_wire_bytes{bucket}``) are published on every call (there is no
trace time to avoid), and the inline form opens the bucket's span too.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import obs, pytree
from . import compat
from .compressed_allreduce import (GradCompressionConfig, _compressible, _numel,
                                   container_field_bytes, exact_mean, gathered_fields,
                                   pod_group, pod_hop_body, reference_hop,
                                   wire_bytes_per_leaf)

# Backward production order of the transformer's top-level parameter groups;
# unknown groups slot in with the layer stack.
_PRODUCTION_RANK = {"unembed": 0, "final_norm": 1, "layers": 2, "embed": 4}
_DEFAULT_RANK = 2


def _top_level_name(path: tuple) -> str:
    for kind, k in path:
        if kind in ("key", "attr"):
            return str(k)
    return ""


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One reduce hop: a contiguous production-order run of leaves."""
    index: int
    keys: tuple[str, ...]          # leaf paths (jax.tree_util.keystr form)
    n_elems: tuple[int, ...]       # flattened element count per leaf
    wire_bytes: int                # one pod's compressed bytes on the link

    @property
    def tag(self) -> str:
        """The hop's tag: its span's name and its gathered bytes' key."""
        return f"bucket{self.index}_reduce"


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    buckets: tuple[Bucket, ...]
    bypass: tuple[str, ...]        # small/non-float leaves: reduced exactly

    @property
    def n_buckets(self) -> int:
        return len(self.buckets)


def assign_buckets(grads_abstract: Any, cfg: GradCompressionConfig) -> BucketPlan:
    """Deterministic leaf -> bucket assignment from the abstract gradient tree
    (anything with ``.shape`` and ``.dtype`` at the leaves).

    Leaves are packed greedily in production order until the next leaf would
    push the bucket past ``cfg.bucket_bytes`` of wire traffic; a leaf larger
    than the target gets a bucket of its own.
    """
    ordered, bypass = [], []
    wire_cache: dict[int, int] = {}
    for path, ab in pytree.flatten_with_path(grads_abstract)[0]:
        key = pytree.keystr(path)
        shape = tuple(ab.shape)
        if not _compressible(shape, ab.dtype, cfg):
            bypass.append(key)
            continue
        n = _numel(shape)
        if n not in wire_cache:
            wire_cache[n] = int(wire_bytes_per_leaf(n, cfg)["compressed"])
        rank = _PRODUCTION_RANK.get(_top_level_name(path), _DEFAULT_RANK)
        ordered.append((rank, key, n, wire_cache[n]))
    ordered.sort(key=lambda t: (t[0], t[1]))

    buckets: list[Bucket] = []
    cur_keys: list[str] = []
    cur_ns: list[int] = []
    cur_bytes = 0

    def flush():
        nonlocal cur_keys, cur_ns, cur_bytes
        if cur_keys:
            buckets.append(Bucket(index=len(buckets), keys=tuple(cur_keys),
                                  n_elems=tuple(cur_ns), wire_bytes=cur_bytes))
            cur_keys, cur_ns, cur_bytes = [], [], 0

    for _, key, n, wb in ordered:
        if cur_keys and cur_bytes + wb > cfg.bucket_bytes:
            flush()
        cur_keys.append(key)
        cur_ns.append(n)
        cur_bytes += wb
    flush()
    plan = BucketPlan(buckets=tuple(buckets), bypass=tuple(sorted(bypass)))
    obs.gauge("dist_n_buckets").set(plan.n_buckets)
    for b in plan.buckets:
        obs.gauge("dist_bucket_wire_bytes", bucket=b.tag).set(b.wire_bytes)
    return plan


# ---------------------------------------------------------------------------
# Wire accounting: what each bucket's hop gathers
# ---------------------------------------------------------------------------

def gathered_bytes_per_leaf(n_elems: int, cfg: GradCompressionConfig) -> int:
    """Bytes of one leaf's container that a hop gathers from each pod: the
    fields the decompress-mean reads (``bitflags``, ``payload``, ``eb_abs``,
    and the outlier fields in strict mode). It differs from
    ``wire_bytes_per_leaf`` by the ``nnz_blocks`` / ``n_outliers``
    bookkeeping scalars, which the receiver does not need."""
    fzc = cfg.fz_config()
    sizes = container_field_bytes(n_elems, fzc)
    return sum(sizes[f] for f in gathered_fields(fzc))


def expected_cross_pod_bytes(plan: BucketPlan, cfg: GradCompressionConfig,
                             n_pods: int) -> dict[str, int]:
    """Bytes of each bucket's gathers, keyed by its tag: a gather's output is
    ``n_pods`` times the leaf's gathered bytes."""
    return {b.tag: n_pods * sum(gathered_bytes_per_leaf(n, cfg) for n in b.n_elems)
            for b in plan.buckets}


BUCKET_TAG_PATTERN = r"(bucket\d+_reduce)"


# ---------------------------------------------------------------------------
# Gradient-boundary taps
# ---------------------------------------------------------------------------

class _Boundary(torch.autograd.Function):
    """Identity forward and backward, bit for bit."""

    @staticmethod
    def forward(ctx, *tensors):
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return compat.optimization_barrier(grads)


def grad_boundary(tree: Any, name: str = "") -> Any:
    """Identity marking a parameter-group gradient boundary: the tensor leaves
    of ``tree`` pass through one autograd node, unchanged forward and
    backward (so arming it changes neither the loss nor any gradient bit).
    Non-tensor leaves pass through untouched."""
    flat = pytree.leaves(tree)
    idx = [i for i, t in enumerate(flat) if isinstance(t, torch.Tensor)]
    if not idx:
        return tree
    with torch.profiler.record_function(f"grad_boundary_{name}" if name else "grad_boundary"):
        out = _Boundary.apply(*(flat[i] for i in idx))
    flat = list(flat)
    for i, t in zip(idx, out):
        flat[i] = t
    return pytree.unflatten(tree, flat)


# ---------------------------------------------------------------------------
# The bucketed reduce
# ---------------------------------------------------------------------------

def _bucket_hop(xs: list[torch.Tensor], fzc, group, tag: str):
    """One bucket's hop: per-leaf compress -> gather -> mean, each leaf's
    ``(n_pods, n)`` float32 input (gradient plus replayed residual) on its own.
    Returns (means, residuals)."""
    with obs.span(f"dist.{tag}", leaves=len(xs)):
        if group is not None:
            outs = [pod_hop_body(x[0], fzc, group=group, tag=tag) for x in xs]
        else:
            outs = [reference_hop(x, fzc) for x in xs]
    return [r for r, _ in outs], [e for _, e in outs]


def reduce_stacked_bucketed(g_stack: Any, err_state: Any, cfg: GradCompressionConfig,
                            mesh=None, plan: BucketPlan | None = None) -> tuple[Any, Any]:
    """Bucketed compressed mean over a stacked leading pod dimension.

    Drop-in for ``compressed_allreduce.reduce_stacked`` plus an optional
    precomputed ``plan`` (None rebuilds it from ``g_stack``'s shapes).
    Bit-identical outputs: per leaf the math is unchanged, only the issue
    granularity differs.
    """
    group = pod_group(mesh)
    if not cfg.enabled:
        return pytree.tree_map(lambda g: exact_mean(g, group), g_stack), err_state

    fzc = cfg.fz_config()
    if plan is None:
        abstract = pytree.tree_map(
            lambda g: torch.empty(tuple(g.shape[1:]), dtype=g.dtype, device="meta"), g_stack)
        plan = assign_buckets(abstract, cfg)
    g_leaves = pytree.leaves_with_keys(g_stack)
    e_leaves = pytree.leaves_with_keys(err_state)
    g_map, e_map = dict(g_leaves), dict(e_leaves)

    red_map: dict[str, torch.Tensor] = {}
    new_e_map: dict[str, torch.Tensor] = {}
    for key in plan.bypass:
        red_map[key] = exact_mean(g_map[key], group)
        new_e_map[key] = e_map[key]          # empty placeholder, untouched

    # hops in production order: bucket 0's gathers are issued first
    for bucket in plan.buckets:
        xs, leaf_shapes, leaf_dtypes = [], [], []
        for key in bucket.keys:
            g, e = g_map[key], e_map[key]
            n_pods = g.shape[0]
            leaf_shapes.append(tuple(g.shape[1:]))
            leaf_dtypes.append(g.dtype)
            xs.append(g.to(torch.float32).reshape(n_pods, -1) + e.reshape(n_pods, -1))
        reds, resids = _bucket_hop(xs, fzc, group, bucket.tag)
        for key, red, res, shp, dt in zip(bucket.keys, reds, resids, leaf_shapes, leaf_dtypes):
            red_map[key] = red.reshape(shp).to(dt)
            new_e_map[key] = res.reshape((res.shape[0],) + shp)

    red = pytree.unflatten(g_stack, [red_map[k] for k, _ in g_leaves])
    new_err = pytree.unflatten(err_state, [new_e_map[k] for k, _ in e_leaves])
    return red, new_err
