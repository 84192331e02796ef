"""Empirical tuner: budget-check, parity-gate, then measure and cache. The port
of ``repro/tune/tuner.py``.

``tune_op`` is the whole contract in one function, in eligibility order:

  1. **cache hit** -- a valid entry for ``(backend, op, shape-bucket, dtype,
     arch)`` short-circuits everything: zero re-measurements on a warm cache
     (pinned by tests/test_torch_tune.py and ``chip_smoke.py`` phase 13).
  2. **static budget skip** -- candidates declaring ``kernel_specs`` are run
     through :func:`repro_torch.analysis.resources.analyze_spec` at the
     context geometry; an ``smem-overflow`` or ``reg-overflow`` finding skips
     the candidate (logged + counted + recorded in the entry) instead of
     measuring a launch the card would refuse. On the card the libraries are
     built first, so the register figures come from ptxas.
  3. **parity gate** -- every surviving non-reference candidate's output is
     checked against the reference implementation (bit-identity for decode
     paths, the error-bound invariant for compress, a tolerance for
     attention). Rejected candidates are recorded and *never eligible*,
     however fast they would have been.
  4. **measurement** -- warmup calls then median-of-k wall time per eligible
     candidate, each timed call bracketed by ``torch.cuda.synchronize`` on
     the card, inside an ``obs.span("tune.measure", ...)`` so the timings
     land in the metrics registry and trace exporters.

A candidate that raises propagates the error: only a budget skip or a
parity rejection removes a candidate. The winner (min median) is written to
the persistent cache and the in-process dispatch memo is refreshed, so
subsequent ``kernel_mode="auto"`` dispatches read it with near-zero
overhead.

On the card (backend ``cuda``) the tuner is stricter than the reference's:
the plain route (the op's reference impl, ``reference`` or ``jnp``) is the
parity oracle and is measured for the record, but it is never the winner --
the port's entry points never give way to the plain version on the card. A
candidate that the budget check skips or the parity gate rejects there is a
fault, not a choice: :class:`TuneError` is raised, naming it, and nothing is
cached. On the CPU, where every wrapper runs its plain version, the
reference's rules hold as they are.

A workload is ``(op, n, dtype)`` or ``(op, n, dtype, geometry)``: the
geometry (a dict) reaches the op's context builder, so a caller measures
the shape its traffic has (the engine's paged attention, a 3-D field); the
cache key stays ``n``'s bucket, as the reference's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from . import registry
from .cache import TuneCache, cache_key, shape_bucket

BUDGET_RULES = ("smem-overflow", "reg-overflow")


class TuneError(RuntimeError):
    """No eligible candidate survived the budget and parity gates, or on the
    card a kernel candidate was skipped or rejected. ``skipped``, ``rejected``
    and ``measured_us`` are the tuning's record, as an entry would hold it."""

    def __init__(self, msg: str, *, skipped=None, rejected=None, measured_us=None):
        super().__init__(msg)
        self.skipped = dict(skipped or {})
        self.rejected = dict(rejected or {})
        self.measured_us = dict(measured_us or {})


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _budget_skip(cand: registry.Candidate, ctx: dict) -> str | None:
    """Static resource check; returns the skip reason or None."""
    if cand.kernel_specs is None:
        return None
    from ..analysis import resources
    dev = ctx.get("device")
    ptxas = resources.ptxas_info(build=dev is not None and dev.type == "cuda")
    for spec in cand.kernel_specs(ctx):
        for f in resources.analyze_spec(spec, ptxas):
            if f.rule in BUDGET_RULES:
                return f"{f.rule} ({spec.name}): {f.message}"
    return None


def _measure_us(runner, dev: torch.device, *, warmup: int, k: int) -> float:
    for _ in range(warmup):
        runner()
    _sync(dev)
    ts = []
    for _ in range(k):
        _sync(dev)
        t0 = time.perf_counter()
        runner()
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts) * 1e6)


def tune_op(op_name: str, *, n: int, dtype: str, geometry: dict | None = None,
            cache: TuneCache | None = None, k: int = 3, warmup: int = 1,
            force: bool = False, log=print, device="cuda") -> tuple[dict, bool]:
    """Tune one op at one workload point on ``device``; returns ``(entry,
    measured)``. ``geometry``: keyword arguments of the op's context builder
    (the traffic's shape beyond ``n``), kept in the entry.

    ``measured`` is False exactly when the entry came from the cache -- the
    invariant the double run pins.
    """
    from . import dispatch
    dev = resolve_device(device)
    if cache is None:
        cache = dispatch.active_cache()
    backend, arch = dispatch.backend(dev), dispatch.arch(dev)
    key = cache_key(backend, op_name, n, dtype, arch)
    hit = cache.get(key)
    if hit is not None and not force:
        obs.counter("tune_cache", result="hit", site="tuner").inc()
        return hit, False
    obs.counter("tune_cache", result="miss", site="tuner").inc()

    spec = registry.op(op_name)
    ctx = spec.make_context(n=n, dtype=dtype, device=dev, **(geometry or {}))
    cands = registry.candidates(op_name, backend=backend)
    if not any(c.impl == spec.reference for c in cands):
        raise TuneError(f"{op_name}: reference impl {spec.reference!r} "
                        f"not registered for backend {backend!r}")
    ref_out = None
    measured: dict[str, float] = {}
    skipped: dict[str, str] = {}
    rejected: dict[str, str] = {}
    # reference first: every other candidate is gated against its output
    for cand in sorted(cands, key=lambda c: c.impl != spec.reference):
        why = _budget_skip(cand, ctx)
        if why is not None:
            skipped[cand.impl] = why
            obs.counter("tune_skipped", op=op_name, impl=cand.impl).inc()
            log(f"tune: {op_name}[{cand.impl}] n={n} skipped: {why}")
            continue
        runner = cand.make_runner(ctx)
        out = runner()
        _sync(dev)
        if cand.impl == spec.reference:
            ref_out = out
        else:
            if ref_out is None:
                rejected[cand.impl] = "no reference output to gate against"
                continue
            err = spec.parity(ctx, out, ref_out)
            if err is not None:
                rejected[cand.impl] = err
                obs.counter("tune_parity_rejected", op=op_name,
                            impl=cand.impl).inc()
                log(f"tune: {op_name}[{cand.impl}] n={n} REJECTED "
                    f"({spec.gate} gate): {err}")
                continue
        with obs.span("tune.measure", op=op_name, impl=cand.impl):
            measured[cand.impl] = _measure_us(runner, dev, warmup=warmup, k=k)
        obs.counter("tune_measurements", op=op_name, impl=cand.impl).inc()
    record = {"skipped": skipped, "rejected": rejected, "measured_us": measured}
    if backend == "cuda" and (skipped or rejected):
        raise TuneError(f"{op_name} n={n} {dtype}: on the card a kernel route was skipped "
                        f"or rejected (skipped={skipped}, rejected={rejected}); nothing "
                        "is cached", **record)
    # on the card the plain route is the oracle, never the winner
    eligible = {i: t for i, t in measured.items()
                if backend != "cuda" or i != spec.reference}
    if not eligible:
        raise TuneError(f"{op_name}: no candidate survived "
                        f"(skipped={skipped}, rejected={rejected})", **record)
    winner = min(eligible, key=eligible.get)
    entry = {
        "impl": winner, "measured_us": measured, "skipped": skipped,
        "rejected": rejected, "backend": backend, "arch": arch,
        "op": op_name, "bucket": shape_bucket(n), "dtype": dtype,
        "gate": spec.gate, "k": k, "warmup": warmup,
    }
    if geometry:
        entry["geometry"] = geometry
    cache.put(key, entry)
    cache.save()
    dispatch.invalidate_memo()
    obs.counter("tune_selected", op=op_name, impl=winner, site="tuner").inc()
    pretty = ", ".join(f"{i}={measured[i]:.0f}us" for i in sorted(measured))
    log(f"tune: {op_name} n={n} {dtype} [{backend}/{arch}] -> "
        f"{winner} ({pretty})")
    return entry, True


def ensure_tuned(workloads, *, cache: TuneCache | None = None, k: int = 3,
                 warmup: int = 1, force: bool = False, log=print,
                 device="cuda") -> dict:
    """Tune a list of ``(op, n, dtype[, geometry])`` points on ``device``;
    returns a summary dict with per-point results plus hit/miss/measurement
    totals."""
    from . import dispatch
    dev = resolve_device(device)
    if cache is None:
        cache = dispatch.active_cache()
    results, hits, misses, n_measured = [], 0, 0, 0
    for op_name, n, dtype, *geometry in workloads:
        geometry = geometry[0] if geometry else None
        entry, measured_now = tune_op(op_name, n=n, dtype=dtype, geometry=geometry,
                                      cache=cache, k=k, warmup=warmup, force=force,
                                      log=log, device=dev)
        hits += not measured_now
        misses += measured_now
        n_measured += len(entry["measured_us"]) if measured_now else 0
        results.append({"op": op_name, "n": n, "dtype": dtype, "geometry": geometry,
                        "impl": entry["impl"], "measured": measured_now,
                        "measured_us": entry["measured_us"],
                        "skipped": entry["skipped"],
                        "rejected": entry["rejected"]})
    return {"results": results, "hits": hits, "misses": misses,
            "measurements": n_measured, "backend": dispatch.backend(dev),
            "arch": dispatch.arch(dev), "cache_path": str(cache.path),
            "cache_entries": len(cache)}
