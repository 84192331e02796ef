"""Per-backend kernel registry: ops, candidate implementations, parity gates.
The port of ``repro/tune/registry.py``, with the port's backends: ``cuda``
(the CUDA kernels on the card) and ``cpu`` (the wrappers' plain versions).

An :class:`OpSpec` names a tunable operation and its *reference*
implementation (the correctness oracle), and each :class:`Candidate`
registers one implementation of that op together with the backends it may
run on. New routes join by registering more candidates -- callers never grow
another ``if backend == ...`` arm.

The registry is deliberately data-only: measurement and selection live in
:mod:`tuner`, the cached-winner lookup in :mod:`dispatch`. The built-in
candidates (reference / staged / fused FZ routes, jnp / kernel decode
attention) are registered by importing :mod:`impls`, which happens lazily on
first lookup so ``repro_torch.tune`` stays import-light.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

BACKENDS = ("cpu", "cuda")


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """One tunable operation.

    ``make_context(n=..., dtype=..., device=...)`` builds the shared workload
    (inputs, precomputed reference artifacts, on ``device``) every candidate of
    the op runs against.
    ``parity(ctx, out, ref_out)`` returns ``None`` when ``out`` is acceptable
    against the reference output, else a human-readable rejection reason —
    bit-identity for decode paths, the error-bound invariant for compress.
    ``gate`` labels the parity discipline for logs and cache entries.
    """
    name: str
    reference: str
    make_context: Callable[..., dict]
    parity: Callable[[dict, object, object], str | None]
    gate: str


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One implementation of an op on some backends.

    ``make_runner(ctx)`` returns a zero-arg callable producing the op's
    output (the tuner synchronizes the card around it for timing).
    ``kernel_specs(ctx)``, when present, builds the
    :mod:`repro_torch.analysis` KernelSpecs this candidate would launch at the
    context's geometry -- the tuner statically checks them against the card's
    limits and *skips* (never measures) candidates whose launch the card would
    refuse (shared memory or registers).
    """
    op: str
    impl: str
    make_runner: Callable[[dict], Callable[[], object]]
    backends: tuple[str, ...] = BACKENDS
    kernel_specs: Callable[[dict], list] | None = None


_OPS: dict[str, OpSpec] = {}
_CANDS: dict[str, dict[str, Candidate]] = {}
_builtin_loaded = False


def _ensure_builtin() -> None:
    global _builtin_loaded
    if not _builtin_loaded:
        _builtin_loaded = True
        from . import impls  # noqa: F401  -- registers the built-in candidates


def register_op(spec: OpSpec) -> OpSpec:
    _OPS[spec.name] = spec
    _CANDS.setdefault(spec.name, {})
    return spec


def register(cand: Candidate) -> Candidate:
    if cand.op not in _OPS:
        raise KeyError(f"candidate {cand.impl!r} for unregistered op {cand.op!r}")
    _CANDS[cand.op][cand.impl] = cand
    return cand


def op(name: str) -> OpSpec:
    _ensure_builtin()
    try:
        return _OPS[name]
    except KeyError:
        raise KeyError(f"unknown tunable op {name!r}; known: {sorted(_OPS)}") from None


def ops() -> tuple[str, ...]:
    _ensure_builtin()
    return tuple(sorted(_OPS))


def candidates(op_name: str, backend: str | None = None) -> list[Candidate]:
    _ensure_builtin()
    cands = list(_CANDS.get(op_name, {}).values())
    if backend is not None:
        cands = [c for c in cands if backend in c.backends]
    return cands


@contextlib.contextmanager
def scoped(cand: Candidate):
    """Temporarily register a candidate (tests seed wrong-output impls)."""
    register(cand)
    try:
        yield cand
    finally:
        if _CANDS.get(cand.op, {}).get(cand.impl) is cand:
            del _CANDS[cand.op][cand.impl]
