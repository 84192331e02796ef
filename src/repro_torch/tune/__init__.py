"""repro_torch.tune -- empirical kernel autotuner with a parity-gated winner
cache. The port of ``repro.tune``.

The registry (:mod:`registry`) names tunable ops and their per-backend
candidate implementations (backends ``cuda`` and ``cpu``); the tuner
(:mod:`tuner`) times the candidates -- after statically budget-checking them
against :mod:`repro_torch.analysis` and parity-gating every one against the
reference route -- and persists the winner in a versioned JSON cache
(:mod:`cache`); dispatch (:mod:`dispatch`) is the near-zero-overhead lookup
the hot paths call when ``kernel_mode="auto"`` (the ``FZConfig`` default)
resolves to a concrete route, and where the serving engine decides whether
paged decode runs K7.

Pre-tune from the command line::

    python -m repro_torch.tune --smoke                 # on the card
    python -m repro_torch.tune --smoke --device cpu --cache "$TMPDIR/tc.json"
    python -m repro_torch.tune --dump                  # print the cached table

A faster-but-wrong candidate can never be selected: the parity gate
(bit-identity for decode paths, the error-bound invariant for compress)
runs before any candidate becomes eligible for timing. On the card the
plain routes are that gate's oracle and never a winner, and a kernel route
that is skipped or rejected raises :class:`TuneError`.

:mod:`impls` (which imports the compressor) is loaded on first use, so the
compressor can import :mod:`dispatch` without a cycle.
"""
from .cache import SCHEMA_VERSION, TuneCache, cache_key, shape_bucket  # noqa: F401
from .dispatch import (active_cache, arch, backend, configure,  # noqa: F401
                       decode_attention_impl, fz_fallback_mode, invalidate_memo,
                       reset, resolve_fz)
from .registry import Candidate, OpSpec  # noqa: F401
from .tuner import TuneError, ensure_tuned, tune_op  # noqa: F401

_LAZY = ("attn_cache_elems", "attention_geometry", "fz_impl_config", "evil_candidate")


def __getattr__(name):
    if name in _LAZY:
        from . import impls
        return getattr(impls, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
