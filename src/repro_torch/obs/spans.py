"""Timed, nested spans that are safe inside a CUDA graph capture. The port of
``repro/obs/spans.py``.

``with span("kvpool.park", pages=n):`` does three things at once:

  * **metrics** — host wall time (``time.perf_counter_ns``) lands in the
    log-bucketed histogram ``span_ms{span=<name>}`` and bumps
    ``span_calls{span=<name>}``;
  * **events** — a completed span appends one event to the bounded in-memory
    ring (``events()``), which the exporters in ``obs.trace`` turn into a
    Chrome ``trace_event`` JSON / JSONL log;
  * **profiler names** — while a ``torch.profiler`` capture runs, the body
    runs under ``torch.profiler.record_function(name)``, so the kernels it
    launches fall inside a range of that name (``--profile-dir``); on a CUDA
    card under an NVTX tool (Nsight) it also runs inside
    ``torch.cuda.nvtx.range_push`` / ``range_pop``, so Nsight shows the same
    names. These take the place of the reference's
    ``jax.profiler.TraceAnnotation`` and ``jax.named_scope``. Neither is
    entered where it would record nothing: each costs microseconds a span on
    the host-bound paths that spans wrap.

A span records no device time and reads no device value: no CUDA event, no
synchronisation. Device time per region comes from a ``torch.profiler``
capture, whose kernels fall inside the ``record_function`` ranges. Attributes
are rendered without reading device memory: a tensor becomes its shape, dtype
and device, never its values (``str()`` of a CUDA tensor copies it to the
host).

Trace-time discipline (the reference's jit discipline; pinned in
tests/test_torch_obs.py): a span entered while a CUDA graph is captured on the
current stream or ``torch.compile`` traces (:func:`trace_time`) records **no
runtime timing** — only ``span_traces{span=...}`` and a single
``cat="jit-trace"`` ring event measuring how long capturing that region took.
Nothing of the span enters the captured graph: a replay runs no Python and
records nothing, so ``span_traces`` counts captures.

Nesting is tracked with a ``contextvars`` stack: every event carries its
depth and parent span name, and the stack is restored on exit even under
reentrancy or exceptions. A span's exit only queues its metrics and event
(``registry._queued``), applied before the next read of the registry or the
ring: on the card's host-bound paths every Python operation of a span shows
in the time of the call it wraps. :func:`count` queues a counter's increment
the same way.

Events are stamped with ``time.perf_counter_ns``; the exporters of
``obs.trace`` move them onto the Unix-epoch clock of ``torch.profiler``'s
traces.
"""
from __future__ import annotations

import contextvars
import functools
import os
import threading
import time
from collections import deque

import torch

from . import registry as _reg

_stack: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "obs_span_stack", default=())

DEFAULT_RING_CAPACITY = 65_536

# the ring holds each event as a tuple in this order; events() makes the dicts
_EVENT_KEYS = ("name", "cat", "ts", "dur", "pid", "tid", "depth", "parent", "args")
_ring_lock = threading.Lock()
_ring: deque = deque(maxlen=DEFAULT_RING_CAPACITY)
# the process id every event carries, read once (a system call per event is
# not free in a sandboxed host) and again in a forked child
_pid = os.getpid()


def _refresh_pid() -> None:
    global _pid
    _pid = os.getpid()


os.register_at_fork(after_in_child=_refresh_pid)


def events() -> list[dict]:
    """Snapshot of the event ring, oldest first."""
    _reg.apply_deferred()
    with _ring_lock:
        ring = list(_ring)
    return [dict(zip(_EVENT_KEYS, ev)) for ev in ring]


def clear_events() -> None:
    _reg.apply_deferred()         # the queued spans' metrics stay
    with _ring_lock:
        _ring.clear()


def ring_capacity() -> int:
    return _ring.maxlen


def set_ring_capacity(n: int) -> None:
    """Rebound the ring (keeps the newest events that still fit)."""
    global _ring
    _reg.apply_deferred()
    with _ring_lock:
        _ring = deque(_ring, maxlen=int(n))


def current_stack() -> tuple:
    """The active span-name stack for this context (outermost first)."""
    return tuple(s.name for s in _stack.get())


@functools.cache
def _has_cuda() -> bool:
    """Whether this process has a CUDA card (asked once: spans sit on hot paths)."""
    return torch.cuda.is_available()


@functools.cache
def _nvtx() -> bool:
    """Whether spans push NVTX ranges: on a card, with an NVTX tool injected
    (Nsight Systems and Nsight Compute set ``NVTX_INJECTION64_PATH`` for the
    process they profile). Without a tool the ranges go nowhere, and the two
    calls a span cost measurably on the host-bound hot paths."""
    return _has_cuda() and bool(os.environ.get("NVTX_INJECTION64_PATH"))


# hot-path aliases: a span runs on paths where every lookup shows
_is_compiling = torch.compiler.is_compiling
_current_stream = getattr(torch._C, "_cuda_getCurrentStream", None)
_now = time.perf_counter_ns
_get_ident = threading.get_ident
_queued = _reg._queued


def trace_time() -> bool:
    """True while ``torch.compile`` traces or a CUDA graph is captured on the
    current stream: work issued now is recorded, not run."""
    if _is_compiling():
        return True
    if not _has_cuda():
        return False
    # nothing is captured on the legacy default stream (stream id 0, where the
    # port's work runs; CUDA refuses to capture it), so only another current
    # stream needs the capture query, which costs microseconds on some hosts
    if _current_stream(-1)[0] == 0:     # -1: the current device
        return False
    return torch.cuda.is_current_stream_capturing()


# True while a torch.profiler (or autograd profiler) capture runs
_profiling = torch._C._autograd._profiler_enabled


def count(name: str, labels: dict, n: int = 1) -> None:
    """``counter(name, **labels).inc(n)`` queued (``registry._queued``), as a
    span's exit queues its metrics: nothing while recording is off or at
    trace time. The fz path's host syncs count here (``fz_host_syncs``)."""
    if _reg._enabled and not trace_time():
        _queued.append((_reg.add_now, (name, labels, n)))
        if len(_queued) >= _reg.QUEUE_LIMIT:
            _reg.apply_deferred()


_PLAIN = frozenset((bool, int, float, str, type(None)))


def _clean_attrs(attrs: dict) -> dict:
    """JSON-safe args: scalars pass; a tensor becomes its shape, dtype and
    device (never its values: no device read); anything else is stringified
    and truncated. Attributes of plain scalars only (the instrumented call
    sites') are returned as they are: a span never changes its attrs."""
    for v in attrs.values():
        if type(v) not in _PLAIN:
            break
    else:
        return attrs
    out = {}
    for k, v in attrs.items():
        if isinstance(v, (bool, int, float, str)) or v is None:
            out[k] = v
        elif isinstance(v, torch.Tensor):
            out[k] = (f"Tensor{list(v.shape)} {str(v.dtype).removeprefix('torch.')} "
                      f"{v.device}")[:64]
        else:
            out[k] = str(v)[:64]
    return out


def _record(name: str, cat: str, t0_us: float, dur_us: float,
            depth: int, parent: str | None, attrs: dict, tid: int | None = None) -> None:
    ev = (name, cat, t0_us, dur_us, _pid, threading.get_ident() if tid is None else tid,
          depth, parent, _clean_attrs(attrs))
    with _ring_lock:
        _ring.append(ev)


def _finish(name: str, runtime: bool, t0_ns: int, dur_us: float, depth: int,
            parent: str | None, attrs: dict, tid: int, leaves=None, then=None) -> None:
    """A completed span's metrics and ring event (queued by its exit; updates
    whatever ``enabled()`` says now: the span decided when it was entered).
    ``leaves``: the leaf spans that reported into it, (name, t0, dur, attrs),
    recorded first (they completed first) with its trace-time decision;
    ``then``: (fn, *args), applied after it if it ran."""
    for leaf_name, leaf_t0, leaf_dur, leaf_attrs in leaves or ():
        _finish(leaf_name, runtime, leaf_t0, leaf_dur, depth + 1, name, leaf_attrs, tid)
    labels = {"span": name}
    if runtime:
        _reg.add_now("span_calls", labels)
        _reg.observe_now("span_ms", labels, dur_us / 1e3)
        _record(name, "span", t0_ns / 1e3, dur_us, depth, parent, attrs, tid)
        if then is not None:
            then[0](*then[1:])
    else:
        # trace-time span: one event per capture, and the only
        # (intentional) footprint of a span inside a captured region
        _reg.add_now("span_traces", labels)
        _record(name, "jit-trace", t0_ns / 1e3, dur_us, depth, parent, attrs, tid)


_OFF = ()          # the frame of an entry while recording was disabled


def _open_ranges(name: str):
    """Open the profiler ranges of a runtime entry (a ``record_function`` under
    a profiler capture, an NVTX range under an NVTX tool) -> (runtime,
    record_function or None, whether an NVTX range was pushed)."""
    runtime = not trace_time()
    ranged = None
    if runtime and _profiling():
        ranged = torch.profiler.record_function(name)
        ranged.__enter__()
    nvtx = runtime and _nvtx()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    return runtime, ranged, nvtx


def _close_ranges(ranged, nvtx: bool, exc_type, exc, tb) -> None:
    if nvtx:
        torch.cuda.nvtx.range_pop()
    if ranged is not None:
        ranged.__exit__(exc_type, exc, tb)


class span:
    """Context manager / decorator for one named scope. Reentrant: the same
    instance can be entered recursively (each entry keeps its own frame).
    ``runtime`` tells whether its last entry ran (False: at trace time).

    Where no profiler range is due (no ``torch.profiler`` capture, no NVTX
    tool) the trace-time check, the parent and the depth are taken at exit,
    after the body: the same answers for a span inside or around a capture,
    and less host work before the kernels the span wraps are launched.

    Two slots serve code that owns the body (the fz entry points), set inside
    the ``with`` block and taken by the next exit: ``leaves``, a list that
    the :class:`leaf` spans directly inside report into, so that they share
    this span's trace-time decision (the owner guarantees no capture starts
    between), and ``then``, ``(fn, *args)`` applied with this span's
    bookkeeping if the span ran (the fz dispatch accounting)."""

    __slots__ = ("name", "attrs", "runtime", "leaves", "then", "_frame", "_outer")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.runtime = True
        self.leaves = None
        self.then = None
        self._frame = None             # the innermost entry's frame
        self._outer = None             # the frames of enclosing entries, if reentered

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(self.name, **self.attrs):
                return fn(*args, **kwargs)
        return wrapped

    def __enter__(self):
        if self._frame is not None:
            if self._outer is None:
                self._outer = []
            self._outer.append(self._frame)
        if not _reg._enabled:
            self._frame = _OFF
            return self
        if _profiling() or _nvtx():
            # ranges open only at runtime, so this entry decides now
            runtime, ranged, nvtx = _open_ranges(self.name)
            self.runtime = runtime
        else:
            runtime, ranged, nvtx = None, None, False       # decided at exit
        self._frame = (_stack.set(_stack.get() + (self,)), runtime, ranged, nvtx, _now())
        return self

    def __exit__(self, exc_type, exc, tb):
        frame = self._frame
        self._frame = self._outer.pop() if self._outer else None
        if frame is _OFF:
            return False
        token, runtime, ranged, nvtx, t0 = frame
        dur_us = (_now() - t0) / 1e3
        if ranged is not None or nvtx:
            _close_ranges(ranged, nvtx, exc_type, exc, tb)
        _stack.reset(token)
        if runtime is None:
            self.runtime = runtime = not trace_time()
        stack = _stack.get()
        leaves, then = self.leaves, self.then
        if leaves is not None or then is not None:
            self.leaves = self.then = None
        # queue the bookkeeping (registry._queued)
        _queued.append((_finish, (self.name, runtime, t0, dur_us, len(stack),
                                  stack[-1].name if stack else None, self.attrs, _get_ident(),
                                  leaves, then)))
        if len(_queued) >= _reg.QUEUE_LIMIT:
            _reg.apply_deferred()
        return False


class leaf:
    """A span for a hot innermost region, one that opens no span inside it
    (the fz stage spans): the same metrics, event and profiler ranges as
    :class:`span`, its parent and depth those of the spans around it, but it
    does not push itself on the span stack, which saves the stack's cost on
    the host-bound paths it wraps. Directly inside a span that collects
    ``leaves`` it reports there and takes that span's trace-time decision;
    elsewhere it decides and queues itself. One entry at a time."""

    __slots__ = ("name", "attrs", "_t0", "_ranges")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self._t0 = None

    def __enter__(self):
        if _reg._enabled:
            self._ranges = _open_ranges(self.name) if _profiling() or _nvtx() else None
            self._t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        t0 = self._t0
        if t0 is None:
            return False
        self._t0 = None
        dur_us = (_now() - t0) / 1e3
        ranges = self._ranges
        stack = _stack.get()
        top = stack[-1] if stack else None
        if ranges is None:
            if top is not None and top.leaves is not None:
                top.leaves.append((self.name, t0, dur_us, self.attrs))
                return False
            runtime = not trace_time()
        else:
            runtime, ranged, nvtx = ranges
            _close_ranges(ranged, nvtx, exc_type, exc, tb)
        _queued.append((_finish, (self.name, runtime, t0, dur_us, len(stack),
                                  top.name if top is not None else None, self.attrs,
                                  _get_ident())))
        if len(_queued) >= _reg.QUEUE_LIMIT:
            _reg.apply_deferred()
        return False
