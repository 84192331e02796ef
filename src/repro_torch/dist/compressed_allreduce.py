"""FZ-compressed cross-pod gradient mean with error feedback: the port of
``repro/dist/compressed_allreduce.py`` (the paper's §2.4 wire compression).

Each pod compresses its local gradient (plus the carried error-feedback
residual) into the fixed-shape FZ container; the containers, not the raw
float32 tensors, cross the pod boundary; every pod decompresses all of them
and the reduced gradient is the mean of the reconstructions. The pod's own
quantization error goes back into the error state and is replayed into the
next round's input, so the time-averaged reduced gradient converges to the
exact mean.

Two forms, bit-identical to each other and to the reference's inline
``reduce_stacked(mesh=None)``:

* ``mesh=None`` (or a mesh without a ``pod`` dimension): the stacked
  ``(n_pods, ...)`` tree in one process, as the reference's inline oracle.
* A ``DeviceMesh`` with a ``pod`` dimension: one rank a pod. Each rank passes
  its own ``(1, ...)`` slice and residual, all-gathers the container fields
  over the ``pod`` group, and gets back the reduced tree (the same on every
  rank) and its own residual.

What crosses the link: each gathered field (``bitflags``, ``payload``,
``eb_abs``, and the outlier fields in strict mode -- the fields
``bucketed_reduce.gathered_bytes_per_leaf`` names) goes through one
``all_gather`` as a ``uint8`` view and is viewed back on arrival (gloo takes
neither uint16 nor uint32, and NCCL has no uint16). The receiving side
takes ``nnz_blocks`` as the popcount of the gathered flags: the count of
nonzero blocks, unclipped, as the sender has it. Every byte handed to a
gather is counted under its tag (``obs`` counter ``dist_gathered_bytes{tag}``,
read by :func:`gathered_bytes`); the reference reads these bytes from the
compiled HLO (``launch/hlo_cost``).

The pod mean is a sum in pod order times ``float32(1 / n_pods)``, the way
XLA on the CPU computes the reference's ``jnp.mean(d, axis=0)``; a division,
as ``torch.mean`` does, differs in the last bit at 3 or 5 pods.

Differences from the reference: ``use_kernels`` defaults to True (the
port's ``FZConfig`` default), so compress runs K4 (paper mode) and
decompress K6 on the card; the wire accounting is computed from the
container's field sizes instead of an ``eval_shape`` (equal to
``FZCompressed.wire_bytes()``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from .. import obs, pytree
from ..core import encode as enc
from ..core.fz import FZCompressed, FZConfig, compress, decompress
from ..device import resolve_device
from . import compat
from .sharding import NamedSharding


@dataclasses.dataclass(frozen=True)
class GradCompressionConfig:
    """Static configuration for the compressed cross-pod reduce."""
    enabled: bool = False
    eb: float = 1e-4               # error bound on each pod's gradient
    eb_mode: str = "rel"           # relative to the leaf's value range
    code_mode: str = "sign_mag"
    capacity_frac: float = 1.0     # container payload capacity vs worst case
    min_leaf_size: int = 4096      # elements; smaller leaves reduce exactly
    # bucketed issue (dist/bucketed_reduce.py): ``bucket_bytes`` of wire
    # traffic a hop; ``overlap`` routes a training step through it
    overlap: bool = False
    bucket_bytes: int = 4 << 20
    # the kernel route of every per-leaf FZ hop (both reduces share it, so the
    # barrier reduce stays the bucketed one's bit-parity oracle); False is the
    # plain route
    use_kernels: bool = True
    kernel_mode: str = "auto"

    def fz_config(self) -> FZConfig:
        # exact_outliers off: saturation error (like dropped blocks when
        # capacity_frac < 1) is absorbed by the error-feedback residual.
        return FZConfig(eb=self.eb, eb_mode=self.eb_mode, code_mode=self.code_mode,
                        capacity_frac=self.capacity_frac, exact_outliers=False,
                        use_kernels=self.use_kernels, kernel_mode=self.kernel_mode)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _compressible(shape: tuple[int, ...], dtype: torch.dtype,
                  cfg: GradCompressionConfig) -> bool:
    return dtype.is_floating_point and _numel(shape) >= cfg.min_leaf_size


def container_field_bytes(n_elems: int, fzc: FZConfig) -> dict[str, int]:
    """Bytes of each field of the container of an ``n_elems`` stream (capacity-sized)."""
    k = fzc.outlier_capacity(n_elems)
    return {"bitflags": 4 * enc.flag_words(FZConfig.n_blocks(n_elems)),
            "payload": 2 * enc.BLOCK_WORDS * fzc.payload_capacity(n_elems),
            "nnz_blocks": 4, "outlier_idx": 4 * k, "outlier_val": 4 * k,
            "n_outliers": 4, "eb_abs": 4}


def wire_bytes_per_leaf(n_elems: int, cfg: GradCompressionConfig) -> dict:
    """Bytes a single float32 leaf of ``n_elems`` puts on the cross-pod link.

    The container's fields are capacity-sized, so the cost is a function of
    the element count and the config alone; it equals
    ``FZCompressed.wire_bytes()``.
    """
    raw = 4 * n_elems
    compressed = sum(container_field_bytes(n_elems, cfg.fz_config()).values())
    return {"raw": raw, "compressed": compressed, "reduction": raw / compressed}


def init_error_state(grads_abstract: Any, n_pods: int, cfg: GradCompressionConfig, *,
                     device="cuda") -> Any:
    """Zero error-feedback residuals, stacked over the leading pod dim.

    ``grads_abstract``: a tree of anything with ``.shape`` and ``.dtype``
    (tensors, meta tensors). Bypass leaves (small / non-float: reduced
    exactly) carry an empty float32 placeholder. A rank of the distributed
    form holds its own residual: ``n_pods=1``.
    """
    if not cfg.enabled:
        return {}
    dev = resolve_device(device, allow_meta=True)     # meta: the dry-run's shapes

    def one(ab):
        if _compressible(tuple(ab.shape), ab.dtype, cfg):
            return torch.zeros((n_pods,) + tuple(ab.shape), dtype=torch.float32, device=dev)
        return torch.zeros((0,), dtype=torch.float32, device=dev)
    return pytree.tree_map(one, grads_abstract)


def error_state_shardings(grads_abstract: Any, cfg: GradCompressionConfig, mesh) -> Any:
    """Shardings for the error state: the stacked pod dim on the pod axis."""
    if not cfg.enabled:
        return {}
    has_pod = "pod" in compat.axis_names(mesh)

    def one(ab):
        if _compressible(tuple(ab.shape), ab.dtype, cfg) and has_pod:
            return NamedSharding(mesh, ("pod",))
        return NamedSharding(mesh, ())
    return pytree.tree_map(one, grads_abstract)


# ---------------------------------------------------------------------------
# The per-leaf math
# ---------------------------------------------------------------------------

def pod_mean(d: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean of the pods' tensors as XLA computes ``jnp.mean(d, axis=0)`` on the
    CPU: a sum in pod order, the adds written out, times ``float32(1 / n)``."""
    acc = d[0].clone()
    for t in d[1:]:
        acc.add_(t)
    return acc.mul_(float(np.float32(1.0 / len(d))))


def _roundtrip_per_pod(x: torch.Tensor, fzc: FZConfig) -> torch.Tensor:
    """(n_pods, n) -> each pod's compress + decompress reconstruction, stacked."""
    return torch.stack([decompress(compress(x[p], fzc, device=x.device), fzc, device=x.device)
                        for p in range(x.shape[0])])


def reference_hop(x: torch.Tensor, fzc: FZConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Inline reduce hop: (n_pods, n) -> (mean (n,), residual (n_pods, n))."""
    d = _roundtrip_per_pod(x, fzc)
    return pod_mean(list(d)), x - d


_GATHERED = "dist_gathered_bytes"


def gathered_bytes() -> dict[str, int]:
    """Bytes of every gather's output since the registry's last ``obs.reset()``,
    by tag: a bucket's tag, a leaf's path (the barrier form), ``"bypass"``
    (the exact mean of small leaves). The ``dist_gathered_bytes{tag}``
    counters of :mod:`repro_torch.obs`."""
    prefix = _GATHERED + "{tag="
    return {k[len(prefix):-1]: int(v) for k, v in obs.snapshot()["counters"].items()
            if k.startswith(prefix)}


def _gather_fn():
    import torch.distributed as dist
    return getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def gather_bytes(t: torch.Tensor, group, tag: str | None) -> torch.Tensor:
    """All-gather ``t`` over ``group`` as a ``uint8`` view -> ``(world, *t.shape)``
    in ``t``'s dtype. Counts the output's bytes under ``tag`` (nothing for None:
    the trainer's loss and checkpoint gathers are not gradient traffic)."""
    import torch.distributed as dist
    world = dist.get_world_size(group)
    src = t.contiguous().reshape(-1).view(torch.uint8)
    out = torch.empty(world * src.numel(), dtype=torch.uint8, device=src.device)
    if tag is None:
        _gather_fn()(out, src, group=group)
    else:
        # the range names the gather for the dry-run's cost model (``cross_pod_by_tag``)
        with torch.profiler.record_function(f"dist.gather.{tag}"):
            _gather_fn()(out, src, group=group)
        obs.counter(_GATHERED, tag=tag).inc(out.numel())
    return out.view(world, -1).view(t.dtype).reshape((world,) + tuple(t.shape))


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of a uint32 tensor, summed -> int32 scalar on its device."""
    x = words.to(torch.int64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return x.sum().to(torch.int32)


def gathered_fields(fzc: FZConfig) -> tuple[str, ...]:
    """The container fields the decompress-mean reads: what crosses the link."""
    fields = ("bitflags", "payload", "eb_abs")
    if fzc.exact_outliers:
        fields += ("outlier_idx", "outlier_val", "n_outliers")
    return fields


def pod_hop_body(xi: torch.Tensor, fzc: FZConfig, *, group,
                 tag: str = "") -> tuple[torch.Tensor, torch.Tensor]:
    """One leaf's wire hop on one rank of the ``pod`` group.

    ``xi``: this pod's (n,) float32 slice (gradient + replayed residual).
    Compress locally, all-gather the container fields over ``group``,
    decompress every pod's container, mean; the residual is against this
    pod's own reconstruction. Returns (mean (n,), residual (1, n)).
    """
    import torch.distributed as dist
    dev = xi.device
    c = compress(xi, fzc, device=dev)
    got = {f: gather_bytes(getattr(c, f), group, tag) for f in gathered_fields(fzc)}
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    d = []
    for p in range(dist.get_world_size(group)):
        cp = FZCompressed(
            bitflags=got["bitflags"][p], payload=got["payload"][p],
            nnz_blocks=popcount(got["bitflags"][p]),
            outlier_idx=got["outlier_idx"][p] if fzc.exact_outliers else empty,
            outlier_val=got["outlier_val"][p] if fzc.exact_outliers else empty,
            n_outliers=(got["n_outliers"][p] if fzc.exact_outliers
                        else torch.zeros((), dtype=torch.int32, device=dev)),
            eb_abs=got["eb_abs"][p], shape=c.shape, dtype_name=c.dtype_name)
        d.append(decompress(cp, fzc, device=dev))
    return pod_mean(d), (xi - d[dist.get_rank(group)])[None]


def pod_group(mesh):
    """The ``pod`` dimension's process group of ``mesh``, or None (the inline form)."""
    if mesh is None or "pod" not in compat.axis_names(mesh):
        return None
    return mesh.get_group("pod")


def exact_mean(g: torch.Tensor, group=None) -> torch.Tensor:
    """The exact pod mean of a stacked leaf (bypass leaves, the disabled config),
    in float32 and cast back. With a group, ``g`` is this rank's (1, ...) slice."""
    if group is not None:
        g = gather_bytes(g, group, "bypass").reshape((-1,) + tuple(g.shape[1:]))
    return pod_mean([g[p].to(torch.float32) for p in range(g.shape[0])]).to(g.dtype)


def reduce_stacked(g_stack: Any, err_state: Any, cfg: GradCompressionConfig,
                   mesh=None) -> tuple[Any, Any]:
    """Compressed mean over a stacked leading pod dimension.

    ``g_stack`` leaves are ``(n_pods, *leaf_shape)``; returns the reduced
    ``(*leaf_shape)`` tree plus the updated error state. Leaves below
    ``min_leaf_size`` (and non-float leaves) are reduced exactly and their
    error placeholder passes through untouched. With a mesh that has a
    ``pod`` dimension each rank passes its own ``(1, ...)`` slice and gets its
    own residual (see the module docstring).
    """
    group = pod_group(mesh)
    if not cfg.enabled:
        return pytree.tree_map(lambda g: exact_mean(g, group), g_stack), err_state

    fzc = cfg.fz_config()
    g_leaves = pytree.leaves_with_keys(g_stack)
    e_leaves = pytree.leaves(err_state)
    if len(g_leaves) != len(e_leaves):
        raise ValueError(f"gradient tree has {len(g_leaves)} leaves, the error state "
                         f"{len(e_leaves)}")
    reds, errs = [], []
    for (key, g), e in zip(g_leaves, e_leaves):
        n_pods, leaf_shape = g.shape[0], tuple(g.shape[1:])
        if not _compressible(leaf_shape, g.dtype, cfg):
            reds.append(exact_mean(g, group))
            errs.append(e)
            continue
        x = g.to(torch.float32).reshape(n_pods, -1) + e.reshape(n_pods, -1)
        if group is not None:
            red, new_e = pod_hop_body(x[0], fzc, group=group, tag=key)
        else:
            red, new_e = reference_hop(x, fzc)
        reds.append(red.reshape(leaf_shape).to(g.dtype))
        errs.append(new_e.reshape((n_pods,) + leaf_shape))
    return pytree.unflatten(g_stack, reds), pytree.unflatten(err_state, errs)
