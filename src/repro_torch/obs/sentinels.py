"""Always-on health monitors over the metric registry. The port of
``repro/obs/sentinels.py``: the same defaults, sampling, slack, rounding term
and drift rule.

Three sentinel families, all cheap enough to leave on in production:

  * **error-bound violations** — the compressor's one hard promise is
    ``|x - D(C(x))|_inf <= eb`` (+ documented f32-rounding allowance; strict
    only with exact outliers, see core/quant.py). Instrumented call sites
    (the kvpool cold tier today) sample a just-written container every
    ``eb_sample_every``-th compression — the first one always, so short
    smoke traces still exercise the check — decompress it transiently, and
    compare the max abs error against the configured bound.
    ``sentinel_eb_violations{tier=...}`` must stay 0; ``assert_healthy``
    raises otherwise.
  * **compression-ratio drift** — per tier (``wire`` gradient hops,
    ``kv_cold`` parked pages, ``ckpt`` checkpoints) an EWMA of the achieved
    ratio; a sample further than ``ratio_drift_factor``x from the EWMA (after
    warmup) bumps ``sentinel_ratio_drift{tier=...}``. Drift is a flag, not a
    failure (a workload shift legitimately moves the ratio): it is reported
    by ``violations()`` but only fails ``assert_healthy(strict_drift=True)``.
  * **scheduler health** — queue-depth gauges (waiting/running/parked
    lanes), preemption counters, and a starvation gauge (oldest waiting
    request's age in steps), fed by the kvpool scheduler each step.

``assert_healthy()`` is the one hook callers need: the serving scheduler
calls it every step (the reference's trainer too; training is not ported
yet); it reads only counters, so it is O(#tiers). Nothing here reads a device
value: callers pass plain floats.
"""
from __future__ import annotations

import dataclasses

from . import registry as _reg


class HealthError(RuntimeError):
    """A sentinel recorded a violation (see ``violations()``)."""


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    eb_sample_every: int = 16      # check the 1st, then every Nth compression
    eb_slack: float = 1e-3         # multiplicative slack on eb_abs
    ratio_drift_factor: float = 4.0
    ratio_ewma_alpha: float = 0.2
    ratio_warmup: int = 3          # samples before drift can flag


CONFIG = SentinelConfig()


def configure(cfg: SentinelConfig) -> None:
    global CONFIG
    CONFIG = cfg


# -- error-bound violations ---------------------------------------------------

def should_check_eb(tier: str) -> bool:
    """Deterministic sampling decision; bumps the per-tier consideration
    counter. The first compression of a tier is always checked."""
    if not _reg.enabled():
        return False
    c = _reg.counter("sentinel_eb_considered", tier=tier)
    sample = c.value % max(CONFIG.eb_sample_every, 1) == 0
    c.inc()
    return sample


def check_error_bound(tier: str, max_err: float, eb_abs: float,
                      max_abs: float = 0.0) -> bool:
    """Record one sampled roundtrip check; True if the bound held.

    ``max_err`` is the measured ``|src - rec|_inf`` (caller computes it — the
    sentinel never touches device arrays itself), ``eb_abs`` the resolved
    absolute bound, ``max_abs`` the source's ``|x|_inf`` for the f32-rounding
    allowance (the same ``|x| * 2^-22`` term the property suite documents).
    """
    if not _reg.enabled():
        return True
    max_err, eb_abs = float(max_err), float(eb_abs)
    tol = eb_abs * (1.0 + CONFIG.eb_slack) + float(max_abs) * 2.0 ** -22 + 1e-30
    _reg.counter("sentinel_eb_checks", tier=tier).inc()
    _reg.gauge("sentinel_eb_last_max_err", tier=tier).set(max_err)
    ok = max_err <= tol
    if not ok:
        _reg.counter("sentinel_eb_violations", tier=tier).inc()
        _reg.gauge("sentinel_eb_worst_excess", tier=tier).max(max_err - tol)
    return ok


# -- compression-ratio drift --------------------------------------------------

def note_ratio(tier: str, ratio: float) -> None:
    """Feed one achieved compression-ratio sample into the tier's EWMA."""
    if not _reg.enabled():
        return
    ratio = float(ratio)
    n = _reg.counter("sentinel_ratio_samples", tier=tier)
    ewma = _reg.gauge("sentinel_ratio_ewma", tier=tier)
    _reg.gauge("sentinel_ratio_last", tier=tier).set(ratio)
    if n.value == 0:
        ewma.set(ratio)
    else:
        if n.value >= CONFIG.ratio_warmup and ewma.value > 0:
            f = CONFIG.ratio_drift_factor
            if ratio > ewma.value * f or ratio < ewma.value / f:
                _reg.counter("sentinel_ratio_drift", tier=tier).inc()
        a = CONFIG.ratio_ewma_alpha
        ewma.set((1 - a) * ewma.value + a * ratio)
    n.inc()


# -- scheduler health ---------------------------------------------------------

def note_scheduler(waiting: int, running: int, parked: int,
                   oldest_wait_steps: int) -> None:
    """Per-step queue-depth / starvation gauges from the serving scheduler."""
    if not _reg.enabled():
        return
    _reg.gauge("sched_waiting", subsystem="kvpool").set(waiting)
    _reg.gauge("sched_running", subsystem="kvpool").set(running)
    _reg.gauge("sched_parked", subsystem="kvpool").set(parked)
    _reg.gauge("sched_oldest_wait_steps", subsystem="kvpool").set(
        oldest_wait_steps)
    _reg.gauge("sched_max_wait_steps", subsystem="kvpool").max(
        oldest_wait_steps)


# -- the health hook ----------------------------------------------------------

def violations(registry: _reg.Registry | None = None) -> dict:
    """All nonzero violation/drift counters, keyed by metric{labels}."""
    snap = (registry or _reg.DEFAULT).snapshot()
    return {k: v for k, v in snap["counters"].items()
            if v and (k.startswith("sentinel_eb_violations")
                      or k.startswith("sentinel_ratio_drift"))}


def assert_healthy(*, strict_drift: bool = False) -> None:
    """Raise :class:`HealthError` on any error-bound violation (and, with
    ``strict_drift``, on ratio drift). The scheduler's per-step hook."""
    bad = violations()
    if not strict_drift:
        bad = {k: v for k, v in bad.items()
               if k.startswith("sentinel_eb_violations")}
    if bad:
        raise HealthError(f"sentinel violations: {bad}")
