"""Metric registry: counters, gauges, log-bucketed histograms. The port of
``repro/obs/registry.py``: the same operations give the same snapshot, key
for key and value for value. What differs serves the hot paths, which on the
card share a host-bound loop with the kernel launches:

* the lookup of an existing metric is cheaper (one or two labels skip the
  sort; ``Registry._lookup`` reads an existing metric without the lock, a dict
  read being atomic; creation still happens under it);
* a hot path may queue its updates of the default registry in ``_queued``
  as ``(fn, args)``: a span's exit does (with the fz dispatch accounting it
  carries), so a call pays for a tuple, not for the bookkeeping. The queue
  is applied in order before any lookup, ``find``, ``snapshot`` or ``reset``
  of the default registry, and whenever ``QUEUE_LIMIT`` updates are waiting,
  so every read sees every update made before it. Whether to record is
  decided when an update is queued (``enabled()`` then), not when it is
  applied: the queued functions update unconditionally (:func:`add_now`,
  :func:`observe_now`).

Dependency-free process-wide telemetry primitives. Every metric is keyed by
``(name, labels)`` — asking the registry for the same key returns the same
instance, so instrumented code can re-resolve its metrics on every call
without double counting. ``snapshot()`` flattens the whole registry into a
plain dict (JSON-ready) keyed ``name{k=v,...}``; that dict is the single
source of truth the legacy stat views (``PoolStats`` / ``TraceStats``) are
derived from.

Histograms are log-bucketed (base ``2**(1/8)``, ~9% relative resolution):
``observe`` is O(1), quantiles walk the sparse bucket table and interpolate
inside the winning bucket, and the exact min/max/sum/count ride along so
``p100`` is exact. Good enough to rank kernel stages and spot tail
regressions; not a replacement for a real profile (that is what the span
layer's ``torch.profiler`` ranges are for).

``enabled()`` / ``set_enabled(False)`` gate every mutation: disabling turns
``inc``/``set``/``observe`` into early returns, which is how the bench tier
pins the instrumentation overhead (<5%) without a separate build.
"""
from __future__ import annotations

import math
import threading
from collections import deque

_LOG_BASE = 2.0 ** 0.125          # ~9% relative bucket resolution
_INV_LOG = 1.0 / math.log(_LOG_BASE)

_state_lock = threading.Lock()
_enabled = True

# queued updates applied at once past this: a flush of 1024 costs a few ms of
# host time, landing in one call in every hundred or two of a hot loop
QUEUE_LIMIT = 1024
_queued: deque = deque()          # (fn, args) updates of DEFAULT, oldest first


def apply_deferred() -> None:
    """Apply the queued updates, oldest first."""
    while True:
        try:
            fn, args = _queued.popleft()
        except IndexError:
            return
        fn(*args)


def add_now(name: str, labels: dict, n: int = 1) -> None:
    """``counter(name, **labels).inc(n)`` whatever ``enabled()`` says now: a
    queued update, decided when it was queued."""
    DEFAULT._lookup(Counter, name, labels).value += n


def observe_now(name: str, labels: dict, v: float) -> None:
    """``histogram(name, **labels).observe(v)`` regardless of ``enabled()``
    (see :func:`add_now`)."""
    DEFAULT._lookup(Histogram, name, labels)._add(float(v))


def enabled() -> bool:
    return _enabled


def set_enabled(value: bool) -> bool:
    """Flip global metric recording; returns the previous value."""
    global _enabled
    with _state_lock:
        prev = _enabled
        _enabled = bool(value)
    return prev


class disabled:
    """Context manager: suspend all metric/span recording inside the block."""

    def __enter__(self):
        self._prev = set_enabled(False)
        return self

    def __exit__(self, *exc):
        set_enabled(self._prev)
        return False


def _label_key(labels: dict) -> str:
    if not labels:
        return ""
    if len(labels) == 1:
        for k, v in labels.items():
            return f"{{{k}={v}}}"
    if len(labels) == 2:
        a, b = labels
        if b < a:
            a, b = b, a
        return f"{{{a}={labels[a]},{b}={labels[b]}}}"
    return "{" + ",".join([f"{k}={labels[k]}" for k in sorted(labels)]) + "}"


class Counter:
    """Monotonic int counter."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name, self.labels = name, labels
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if _enabled:
            self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name, self.labels = name, labels
        self.value = 0.0

    def set(self, v: float) -> None:
        if _enabled:
            self.value = float(v)

    def max(self, v: float) -> None:
        """High-water update: keep the larger of current and ``v``."""
        if _enabled:
            v = float(v)
            if v > self.value:
                self.value = v


class Histogram:
    """Sparse log-bucketed histogram with exact count/sum/min/max."""

    __slots__ = ("name", "labels", "buckets", "count", "sum", "min", "max")

    def __init__(self, name: str, labels: dict):
        self.name, self.labels = name, labels
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    @staticmethod
    def _index(v: float) -> int:
        # clamp to a tiny positive floor so zero/negative observations land
        # in the lowest bucket instead of blowing up the log
        return int(math.floor(math.log(max(v, 1e-12)) * _INV_LOG))

    def observe(self, v: float) -> None:
        if not _enabled:
            return
        self._add(float(v))

    def _add(self, v: float) -> None:
        idx = self._index(v)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def percentile(self, q: float) -> float:
        """Approximate quantile (q in [0, 100]); exact at the endpoints."""
        if self.count == 0:
            return 0.0
        if q <= 0:
            return self.min
        if q >= 100:
            return self.max
        target = q / 100.0 * self.count
        seen = 0
        for idx in sorted(self.buckets):
            n = self.buckets[idx]
            if seen + n >= target:
                lo = _LOG_BASE ** idx
                hi = lo * _LOG_BASE
                frac = (target - seen) / n
                est = lo + (hi - lo) * frac
                return min(max(est, self.min), self.max)
            seen += n
        return self.max

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p99": 0.0}
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                "p50": self.percentile(50), "p99": self.percentile(99)}


class Registry:
    """(name, labels) -> metric instance; snapshot-able to a plain dict."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple[str, str], object] = {}

    def _sync(self) -> None:
        """Apply the queued updates before the default registry is read."""
        if _queued and self is DEFAULT:
            apply_deferred()

    def _get(self, cls, name: str, labels: dict):
        self._sync()
        return self._lookup(cls, name, labels)

    def _lookup(self, cls, name: str, labels: dict):
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m.__class__ is cls:
            return m
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, dict(labels))
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {key} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def find(self, name: str, **labels):
        """Existing metric or None (read-side: never creates)."""
        self._sync()
        return self._metrics.get((name, _label_key(labels)))

    def snapshot(self) -> dict:
        """Flatten to ``{"counters": {...}, "gauges": {...}, "histograms":
        {...}}`` with ``name{label=value,...}`` string keys — JSON-ready."""
        self._sync()
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            items = list(self._metrics.items())
        for (name, lk), m in items:
            key = name + lk
            if isinstance(m, Counter):
                out["counters"][key] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][key] = m.value
            else:
                out["histograms"][key] = m.summary()
        return out

    def reset(self) -> None:
        self._sync()              # queued span events still reach the ring
        with self._lock:
            self._metrics.clear()


# the process-wide default registry; module-level helpers below bind to it
DEFAULT = Registry()


def counter(name: str, **labels) -> Counter:
    return DEFAULT.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return DEFAULT.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return DEFAULT.histogram(name, **labels)


def snapshot() -> dict:
    return DEFAULT.snapshot()


def reset() -> None:
    DEFAULT.reset()
