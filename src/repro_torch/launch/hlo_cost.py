"""Per-device cost model over a dispatch trace: the port of ``repro/launch/hlo_cost.py``.

The port has no HLO. What stands in for it is a trace of the operations one
rank runs while the step runs once: :func:`record` runs a function under
:class:`CostTrace`, a ``TorchDispatchMode``. A DTensor operation is let
through to DTensor (the mode answers ``NotImplemented``), which lowers it to
operations on this rank's blocks and to collectives; those come back to the
mode on local tensors, so every count is per device, on local (shard) shapes,
as the reference's counts are on a partitioned module's shapes. DTensor's
sharding propagation runs each operation once more on global shapes, on fake
tensors of its own; the trace skips every operation on a fake tensor.

The models are the reference's:

* FLOPs: ``2 * prod(out) * prod(contracted)`` for every ``mm`` / ``bmm`` /
  ``addmm`` / ``baddbmm`` (and ``mv`` / ``dot``); an ``einsum`` or ``matmul``
  reaches the trace as these;
* bytes: the dot-adjacent model, each product's operands plus its output;
* collectives, ring model: all-gather its output bytes, all-reduce twice its
  output, reduce-scatter its input, all-to-all and permutes their output. A
  collective whose group spans ranks of two pods (``devices_per_pod``) counts
  as cross-pod. ``tag_pattern`` is matched against the names of the
  ``record_function`` ranges open around a cross-pod collective (the pod hop
  names each gather ``dist.gather.<tag>``); ``cross_pod_by_tag[tag][collective]``
  sums the matches. The pod hop's containers are capacity-sized, as the
  reference's HLO shapes are static, so these bytes are the analytic model's.

The trace runs eagerly, so a loop runs its body every time: there is no trip
count to recover. The dry-run counts shallow steps and extrapolates in depth
(``launch/dryrun.py``); where a loop's iterations all have the same shapes,
the model may run one under ``nn.repeated(n)``, and the trace counts it ``n``
times (the chunked attention of a forward on ``meta`` tensors).

:func:`materialized_shapes` and :func:`compiled_memory_traffic` read the same
trace: the distinct shapes of the operations' ``uint16`` outputs, and
``args + outputs + 2 * intermediates`` from the bytes of the tensors recorded.
The trace also keeps a live-bytes tally of the storages the operations make
(``peak_bytes``): what XLA's buffer assignment reports, without its reuse.
``flops_by_site`` splits the FLOPs by the port's source line that issued each
product (a backward product by the line that started the backward) and the
product's local shapes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import sys
import weakref
from collections import defaultdict
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode

from ..models import nn

_MATMULS = ("mm", "bmm", "addmm", "baddbmm", "mv", "dot")
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# operation (overload packet name) -> (collective, byte rule)
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "_allgather_base_": ("all-gather", "out"),
    "allgather_": ("all-gather", "out"),
    "all_reduce": ("all-reduce", "out2"),
    "all_reduce_coalesced": ("all-reduce", "out2"),
    "allreduce_": ("all-reduce", "out2"),
    "reduce_scatter_tensor": ("reduce-scatter", "in"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "in"),
    "_reduce_scatter_base_": ("reduce-scatter", "in"),
    "all_to_all_single": ("all-to-all", "out"),
    "alltoall_base_": ("all-to-all", "out"),
}


_PORT = str(Path(__file__).resolve().parents[1])
_NOT_SITES = (str(Path(__file__).resolve()), str(Path(_PORT, "dist", "sharding.py")))


def _site() -> str:
    """``file:function:line`` of the innermost frame of the port outside this module and
    ``dist/sharding.py``; where that is in ``models/nn.py``, ``<-`` the first
    frame outside it that called in."""
    f, found = sys._getframe(2), []
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(_PORT) and fn not in _NOT_SITES:
            found.append(f"{fn[len(_PORT) + 1:]}:{f.f_code.co_name}:{f.f_lineno}")
            if not fn.endswith("nn.py"):
                break
        f = f.f_back
    return " <- ".join(found[:1] + found[1:][-1:]) or "outside the port"


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_fake(t: torch.Tensor) -> bool:
    return isinstance(t, FakeTensor)


def _matmul_flops(name: str, args) -> tuple[float, list[torch.Tensor]]:
    """(FLOPs, operands) of one product."""
    if name in ("addmm", "baddbmm"):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    if name == "dot":
        return 2.0 * a.numel(), [a, b]
    if name == "mv":
        return 2.0 * a.shape[0] * a.shape[1], [a, b]
    k = a.shape[-1]
    out = a.numel() // k * b.shape[-1]
    return 2.0 * out * k, [a, b]


def _group_ranks(args) -> tuple[int, ...]:
    """The global ranks of a collective's group: a functional collective names
    its group (the last string argument; the others name reduce ops), a c10d
    one passes it."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in args if isinstance(a, str)]
    if names:
        return tuple(dist.get_process_group_ranks(_resolve_process_group(names[-1])))
    for a in args:
        if isinstance(a, torch.ScriptObject):
            return tuple(dist.get_process_group_ranks(dist.ProcessGroup.unbox(a)))
    return ()


@dataclasses.dataclass
class Collective:
    kind: str
    bytes: float
    ranks: tuple[int, ...]
    ranges: tuple[str, ...]      # the record_function ranges open around it


class CostTrace(TorchDispatchMode):
    """Records one rank's operations (see the module docstring)."""

    def __init__(self, memory: bool = True):
        super().__init__()
        self.memory = memory
        self.flops = 0.0
        self.flops_by_site: dict[str, float] = defaultdict(float)
        self.dot_bytes = 0.0
        self.collectives: list[Collective] = []
        self.u16_shapes: set[tuple[int, ...]] = set()
        self.out_bytes = 0.0                # every new storage an operation made
        self.live = 0
        self.peak = 0
        self._ranges: list[tuple[object, str]] = []   # (handle, name), innermost last
        self._storages: set[int] = set()
        self.weight = 1.0

    def __enter__(self):
        nn.set_repeat_hook(self._repeated)
        return super().__enter__()

    def __exit__(self, *exc):
        nn.set_repeat_hook(None)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def _repeated(self, n: float):
        self.weight *= n
        try:
            yield
        finally:
            self.weight /= n

    # the live-bytes tally: a storage counts from the operation that makes it
    # until its last reference goes
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages.add(key)
        self.live += n
        self.out_bytes += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._storages.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        name = func._overloadpacket.__name__ if hasattr(func, "_overloadpacket") else str(func)
        out = func(*args, **kwargs)
        if name == "_record_function_enter_new":
            self._ranges.append((out, args[0]))
            return out
        if name == "_record_function_exit":
            if self._ranges:                # the ranges nest: the exit closes the innermost
                self._ranges.pop()
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(_is_fake(t) for t in ins + outs):
            return out                      # DTensor's propagation on global shapes
        in_storages = {id(t.untyped_storage()) for t in ins} if self.memory else ()
        for t in outs:
            if self.memory and id(t.untyped_storage()) not in in_storages:
                self._track(t)
            if t.dtype == torch.uint16:
                self.u16_shapes.add(tuple(t.shape))
        if name in _MATMULS:
            flops, operands = _matmul_flops(name, args)
            self.flops += self.weight * flops
            shapes = "x".join(str(tuple(t.shape)) for t in operands)
            self.flops_by_site[f"{_site()} {name}{shapes}"] += self.weight * flops
            self.dot_bytes += self.weight * (sum(_nbytes(t) for t in operands)
                                             + sum(_nbytes(t) for t in outs))
        elif name in _COLLECTIVE_OPS:
            kind, rule = _COLLECTIVE_OPS[name]
            if rule == "in":
                b = _nbytes(args[1] if name.startswith("_reduce_scatter_base") else args[0])
            elif name in ("_allgather_base_",):
                b = _nbytes(args[0])
            elif name in ("allgather_", "allreduce_"):
                b = sum(_nbytes(t) for t in _tensors(args[0]))
            else:
                b = sum(_nbytes(t) for t in outs)
            if rule == "out2":
                b *= 2
            self.collectives.append(Collective(kind, self.weight * b, _group_ranks(args),
                                               tuple(r for _, r in self._ranges)))
        return out


def record(fn, *args, memory: bool = True):
    """Run ``fn(*args)`` once under a :class:`CostTrace` -> (out, trace); with
    ``memory`` False the live-bytes tally is not kept (a faster trace where
    only the counts are read).

    Activation checkpoints recompute whole (``set_checkpoint_early_stop(False)``):
    PyTorch's early stop ends a recompute from inside its last product, past
    the trace, while that product's kernel still runs. A run to hold against
    the trace (the profiler's) sets the same."""
    from torch.utils.checkpoint import set_checkpoint_early_stop
    tr = CostTrace(memory)
    with set_checkpoint_early_stop(False), tr:
        out = fn(*args)
    tr._ranges = []
    return out, tr


def crosses_pod(ranks: tuple[int, ...], devices_per_pod: int) -> bool:
    """True if a collective's group holds ranks of more than one pod."""
    return len({r // devices_per_pod for r in ranks}) > 1


def analyze(trace: CostTrace, devices_per_pod: int | None = None,
            tag_pattern: str | None = None) -> dict:
    """The reference's keys (``flops``, ``bytes``, ``collective_bytes``,
    ``cross_pod_bytes``, ``collective_detail``, ``cross_pod_by_tag``) from a
    trace; ``n_computations`` is the number of collectives recorded."""
    tag_re = re.compile(tag_pattern) if tag_pattern else None
    coll = cross = 0.0
    detail: dict[str, float] = defaultdict(float)
    by_tag: dict[str, dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for c in trace.collectives:
        if devices_per_pod and crosses_pod(c.ranks, devices_per_pod):
            cross += c.bytes
            detail[c.kind + "@pod"] += c.bytes
            if tag_re is not None:
                for r in reversed(c.ranges):
                    mt = tag_re.search(r)
                    if mt:
                        by_tag[mt.group(1) if mt.groups() else mt.group(0)][c.kind] += c.bytes
                        break
        else:
            coll += c.bytes
            detail[c.kind] += c.bytes
    return {"flops": trace.flops, "bytes": trace.dot_bytes, "collective_bytes": coll,
            "cross_pod_bytes": cross, "collective_detail": dict(detail),
            "cross_pod_by_tag": {t: dict(d) for t, d in by_tag.items()},
            "n_computations": len(trace.collectives),
            "flops_by_site": dict(sorted(trace.flops_by_site.items(), key=lambda kv: -kv[1]))}


def materialized_shapes(trace: CostTrace, *, min_elems: int = 0) -> set[tuple[int, ...]]:
    """Distinct shapes of the ``uint16`` tensors the traced operations made with
    at least ``min_elems`` elements: a pipeline that round-trips a u16 code
    stream through memory makes one of at least the stream's length."""
    out = set()
    for s in trace.u16_shapes:
        n = 1
        for d in s:
            n *= d
        if n >= min_elems:
            out.add(s)
    return out


def compiled_memory_traffic(trace: CostTrace, args, outputs) -> dict:
    """``args + outputs + 2 * intermediates`` bytes: ``args`` and ``outputs`` are
    the traced call's, the intermediates every other storage its operations
    made. ``traffic_ratio`` normalises by ``args + outputs``."""
    a = sum(_nbytes(t) for t in _tensors(args))
    o = sum(_nbytes(t) for t in _tensors(outputs))
    temp = max(trace.out_bytes - o, 0)
    traffic = a + o + 2 * temp
    return {"argument_bytes": a, "output_bytes": o, "temp_bytes": temp,
            "traffic_bytes": traffic, "traffic_ratio": traffic / max(a + o, 1)}
