"""Persistent tuning cache: versioned JSON, keyed by (backend, op, bucket, dtype, arch).
The port of ``repro/tune/cache.py``: the same schema, layout, keys and
recovery rules, so a cache file the port writes is byte-identical to the
reference's for the same entries, and each package loads the other's.

The cache is the "pay once" half of the tuner contract: an empirical sweep
(warmup + median-of-k per candidate, parity-gated — see :mod:`tuner`) is
expensive, so its winner is written down and every later dispatch is a dict
lookup. Keys collapse the shape axis to the next power of two
(:func:`shape_bucket`): kernel-path crossover points move slowly with size,
so nearby shapes share one measurement instead of each paying their own.

Robustness rules, all pinned in tests/test_tune.py (and, on the port,
tests/test_torch_tune.py):

  * **schema invalidation** — a file whose ``schema`` field differs from
    :data:`SCHEMA_VERSION` is discarded wholesale (entry semantics may have
    changed); the next tune repopulates and rewrites it.
  * **corrupted-file recovery** — truncated or non-JSON files never raise:
    the cache loads empty (``status`` records why, a
    ``tune_cache{result=invalid}`` counter fires) and the next save writes a
    clean file.
  * **atomic writes** — save goes through a same-directory temp file +
    ``os.replace`` so a crash mid-write can only leave the old file or the
    new one, never a truncated hybrid.

The default location is ``$REPRO_TORCH_TUNE_CACHE`` when set (tests point the
process at tmp dirs with ``dispatch.configure``), else
``~/.cache/repro_torch/tune_cache.json``. Deliberate difference: the
reference's are ``$REPRO_TUNE_CACHE`` and ``~/.cache/repro/``, so the port
never writes the reference's cache (whose ``gpu`` / ``interpret`` entries
would mean other measurements).
"""
from __future__ import annotations

import json
import os
import pathlib
import tempfile

from .. import obs

SCHEMA_VERSION = 1
ENV_VAR = "REPRO_TORCH_TUNE_CACHE"


def default_path() -> pathlib.Path:
    env = os.environ.get(ENV_VAR)
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "repro_torch" / "tune_cache.json"


def shape_bucket(n: int) -> int:
    """Collapse an element count to the next power of two (min 1)."""
    if n <= 1:
        return 1
    return 1 << (int(n) - 1).bit_length()


def cache_key(backend: str, op: str, n: int, dtype: str, arch: str) -> str:
    """Flat string key: ``backend|op|pow2:<bucket>|dtype|arch``."""
    return f"{backend}|{op}|pow2:{shape_bucket(n)}|{dtype}|{arch}"


class TuneCache:
    """In-memory view of one cache file; load() never raises on bad files."""

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = pathlib.Path(path) if path is not None else default_path()
        self.entries: dict[str, dict] = {}
        self.status = "unloaded"

    def load(self) -> "TuneCache":
        try:
            raw = json.loads(self.path.read_text())
        except FileNotFoundError:
            self.status = "missing"
            return self
        except (OSError, UnicodeDecodeError, json.JSONDecodeError):
            self.status = "corrupt"
            obs.counter("tune_cache", result="invalid", site="load").inc()
            return self
        if (not isinstance(raw, dict)
                or raw.get("schema") != SCHEMA_VERSION
                or not isinstance(raw.get("entries"), dict)):
            self.status = "schema-mismatch"
            obs.counter("tune_cache", result="invalid", site="load").inc()
            return self
        self.entries = dict(raw["entries"])
        self.status = "ok"
        return self

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        doc = {"schema": SCHEMA_VERSION, "entries": self.entries}
        fd, tmp = tempfile.mkstemp(dir=self.path.parent,
                                   prefix=self.path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def get(self, key: str) -> dict | None:
        e = self.entries.get(key)
        return e if isinstance(e, dict) and e.get("impl") else None

    def put(self, key: str, entry: dict) -> None:
        self.entries[key] = entry

    def __len__(self) -> int:
        return len(self.entries)
