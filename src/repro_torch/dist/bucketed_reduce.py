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
  * ``BucketReducer`` runs one hop a bucket, each under an
    ``obs.span("dist.bucket<i>_reduce")``; with a ``pod`` mesh each leaf runs
    ``compressed_allreduce.pod_hop_body``, inline the shared ``reference_hop``.
    The per-leaf math is the barrier reduce's, so both are bit-identical.
    The training step's overlap form feeds it from the model's gradient
    boundaries during the backward, and it issues each bucket once its
    gradients are final, on a side stream on the card; ``reduce_stacked_bucketed``
    hands it every gradient at once.
  * ``grad_boundary`` is an autograd identity (forward and backward) that
    marks a parameter group's gradient boundary, where the reference installs
    a ``custom_vjp`` whose backward is an ``optimization_barrier``. Its
    backward can hand the group's gradients to a callback (the reducer's tap):
    the reference leaves the early issue to XLA's scheduler, the port issues
    the bucket itself.

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
from . import compat, sharding
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
    """Identity forward and backward, bit for bit. ``on_grads`` (or None) is
    handed the cotangents when the backward reaches the boundary."""

    @staticmethod
    def forward(ctx, on_grads, *tensors):
        ctx.on_grads = on_grads
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = compat.optimization_barrier(grads)
        if ctx.on_grads is not None:
            ctx.on_grads(grads)
        return (None, *grads)


def grad_boundary(tree: Any, name: str = "", on_grads=None) -> Any:
    """Identity marking a parameter-group gradient boundary: the tensor leaves
    of ``tree`` pass through one autograd node, unchanged forward and
    backward (so arming it changes neither the loss nor any gradient bit).
    Non-tensor leaves pass through untouched. ``on_grads(grads)``, if given, is
    called from the backward with the tensor leaves' gradients, in order."""
    flat = pytree.leaves(tree)
    idx = [i for i, t in enumerate(flat) if isinstance(t, torch.Tensor)]
    if not idx:
        return tree
    with torch.profiler.record_function(f"grad_boundary_{name}" if name else "grad_boundary"):
        out = _Boundary.apply(on_grads, *(flat[i] for i in idx))
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


IN_BACKWARD = "dist_buckets_issued_in_backward"


class BucketReducer:
    """One step's bucketed reduce, each bucket's hop issued as soon as its
    gradients are final.

    Gradients arrive per pod slot (``start_pod``), from the model's gradient
    boundaries during the backward (``tap``, installed with ``nn.set_grad_tap``
    for the forward) and after it (``settle``, which takes the leaves no
    boundary delivered). With ``n_micro`` passes a slot, a leaf's arrivals are
    summed in float32 from zeros and scaled by ``1 / n_micro``, as the step's
    accumulation does. A leaf is final once every slot has all its passes; the
    buckets are issued in plan order, each once all its leaves are final.
    ``finish`` issues what is left and the bypass leaves and returns
    ``(reduced, new error state)``. The counter ``dist_buckets_issued_in_backward``
    counts the buckets a boundary issued, before the backward had ended.

    With ``stream`` (a CUDA stream), the hops run on it, after the work the
    current stream has queued when the bucket is issued, so a bucket's
    compress, gather and decode run beside the rest of the backward;
    ``finish`` makes the current stream wait for it. The reducer holds every
    gradient until then. The per-leaf math is ``reduce_stacked``'s, so the
    result is bit-identical to it at any issue time.
    """

    def __init__(self, err_state: Any, cfg: GradCompressionConfig, plan: BucketPlan,
                 group=None, *, n_slots: int = 1, n_micro: int = 1, stream=None):
        self._err, self._plan, self._group = err_state, plan, group
        self._e_map = dict(pytree.leaves_with_keys(err_state))
        self._fzc = cfg.fz_config()
        self._n_slots, self._n_micro, self._stream = n_slots, n_micro, stream
        self._keys = set(plan.bypass).union(*(b.keys for b in plan.buckets))
        self._parts: dict[str, list] = {}        # key -> per slot: [arrivals, tensor]
        self._final: dict[str, list] = {}        # key -> per slot: final gradient
        self._slot, self._seen = 0, set()
        self._next = 0                           # the next bucket to issue
        self._red: dict[str, torch.Tensor] = {}
        self._new_err: dict[str, torch.Tensor] = {}
        self._in_backward = False

    def start_pod(self, slot: int) -> None:
        """The passes that follow are the gradients of pod slot ``slot``."""
        self._slot = slot

    def tap(self, tree: Any, name: str = "") -> Any:
        """A ``nn.grad_tap``: ``tree`` is the parameter group ``name`` (a
        top-level key of the parameter tree)."""
        keys = [k for k, _ in pytree.leaves_with_keys({name: tree})]
        tensors = [k for k, t in zip(keys, pytree.leaves(tree)) if isinstance(t, torch.Tensor)]

        def on_grads(grads):
            self._in_backward = True
            try:
                for key, g in zip(tensors, grads):
                    if key in self._keys and g is not None:
                        self._arrive(key, g)
                self._issue_ready()
            finally:
                self._in_backward = False
        return grad_boundary(tree, name, on_grads)

    def settle(self, grads: Any) -> None:
        """End of one pass: ``grads`` (the whole tree) supplies every leaf its
        boundary did not deliver in this pass."""
        for key, g in pytree.leaves_with_keys(grads):
            if key in self._keys and key not in self._seen:
                self._arrive(key, g)
        self._seen = set()
        self._issue_ready()

    def _arrive(self, key: str, g: torch.Tensor) -> None:
        self._seen.add(key)
        g = sharding.gather(g)              # a sharded step's gradient: the pod's whole leaf
        if self._n_micro == 1:
            self._final.setdefault(key, [None] * self._n_slots)[self._slot] = g
            return
        slot = self._parts.setdefault(key, [[0, None] for _ in range(self._n_slots)])[self._slot]
        if slot[1] is None:
            slot[1] = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        slot[0], slot[1] = slot[0] + 1, slot[1] + g.to(torch.float32)
        if slot[0] == self._n_micro:
            self._final.setdefault(key, [None] * self._n_slots)[self._slot] = \
                slot[1] * (1.0 / self._n_micro)
            slot[1] = None

    def _ready(self, key: str) -> bool:
        return all(g is not None for g in self._final.get(key, [None]))

    def _stacked(self, key: str) -> torch.Tensor:
        gs = self._final[key]
        return torch.stack(gs) if len(gs) > 1 else gs[0][None]

    def _issue_ready(self) -> None:
        buckets = self._plan.buckets
        while self._next < len(buckets) and all(map(self._ready, buckets[self._next].keys)):
            self._issue(buckets[self._next])
            self._next += 1

    def _issue(self, bucket: Bucket) -> None:
        if self._in_backward:
            obs.counter(IN_BACKWARD).inc()
        if self._stream is None:
            return self._hop(bucket)
        self._stream.wait_stream(torch.cuda.current_stream(self._stream.device))
        with torch.cuda.stream(self._stream):
            self._hop(bucket)

    def _hop(self, bucket: Bucket) -> None:
        xs, shapes, dtypes = [], [], []
        for key in bucket.keys:
            g, e = self._stacked(key), self._e_map[key]
            n_pods = g.shape[0]
            shapes.append(tuple(g.shape[1:]))
            dtypes.append(g.dtype)
            xs.append(g.to(torch.float32).reshape(n_pods, -1) + e.reshape(n_pods, -1))
        reds, resids = _bucket_hop(xs, self._fzc, self._group, bucket.tag)
        for key, red, res, shp, dt in zip(bucket.keys, reds, resids, shapes, dtypes):
            self._red[key] = red.reshape(shp).to(dt)
            self._new_err[key] = res.reshape((res.shape[0],) + shp)

    def finish(self, treedef: Any) -> tuple[Any, Any]:
        """Issue what is left; ``(reduced, new error state)`` with the reduced
        tree shaped as ``treedef`` (the parameter tree)."""
        missing = [k for k in self._keys if not self._ready(k)]
        if missing:
            raise ValueError(f"no gradient arrived for {sorted(missing)[:3]}")
        self._issue_ready()
        for key in self._plan.bypass:
            self._red[key] = exact_mean(self._stacked(key), self._group)
            self._new_err[key] = self._e_map[key]     # empty placeholder, untouched
        if self._stream is not None:
            torch.cuda.current_stream(self._stream.device).wait_stream(self._stream)
        red = pytree.unflatten(treedef, [self._red[k] for k, _ in
                                         pytree.leaves_with_keys(treedef)])
        new_err = pytree.unflatten(self._err, [self._new_err[k] for k, _ in
                                               pytree.leaves_with_keys(self._err)])
        return red, new_err


def reduce_stacked_bucketed(g_stack: Any, err_state: Any, cfg: GradCompressionConfig,
                            mesh=None, plan: BucketPlan | None = None) -> tuple[Any, Any]:
    """Bucketed compressed mean over a stacked leading pod dimension.

    Drop-in for ``compressed_allreduce.reduce_stacked`` plus an optional
    precomputed ``plan`` (None rebuilds it from ``g_stack``'s shapes): a
    ``BucketReducer`` given every gradient at once. Bit-identical outputs: per
    leaf the math is unchanged, only the issue granularity differs.
    """
    group = pod_group(mesh)
    if not cfg.enabled:
        return pytree.tree_map(lambda g: exact_mean(g, group), g_stack), err_state
    if plan is None:
        abstract = pytree.tree_map(
            lambda g: torch.empty(tuple(g.shape[1:]), dtype=g.dtype, device="meta"), g_stack)
        plan = assign_buckets(abstract, cfg)
    n_slots = pytree.leaves(g_stack)[0].shape[0]
    r = BucketReducer(err_state, cfg, plan, group, n_slots=n_slots)
    for slot in range(n_slots):
        r.start_pod(slot)
        r.settle(pytree.tree_map(lambda g: g[slot], g_stack))
    return r.finish(g_stack)
