"""One cell of ``BENCHMARK.json``: set-up, the measured window, the traced
passes and the check, driven by the cell's files.

Everything that belongs to one configuration, traffic mix, proxy or metric
is a file found by its name under the checkout's root:

* ``fzbench/configs/<config>.json``: the field set (proxy kind, shape, names);
* ``fzbench/proxies/<kind>.py``: ``make(shape, generator, device)``;
* ``fzbench/traffic/<mix>.json``: direction, the ``FZConfig`` fields, the loop;
* ``fzbench/metrics/<metric>.py``: ``read(record) -> float | None``.

The generator knows one loop, which a mix has to name: closed, with one
client that visits the configuration's fields (drawn from the run's seed)
round-robin, in an order drawn from the seed, and starts a call only
when the previous one has ended (compress: the stored size ``used_bytes()``
is read, which waits for the card; decompress: the stream is synchronised).
Another loop, or a float dtype other than float32, needs an edit here or in
``fields.py`` and ``reference/``. Each call is stamped by a pair of CUDA
events, one at entry and one after its end, both recorded while the card is
idle, so a call's time is read on the card's clock.
"""
from __future__ import annotations

import importlib.util
import json
import random
import sys
import tempfile
import time
from array import array
from pathlib import Path

import torch

from . import fields as fieldgen
from . import yardstick
from .reference import check

WARM_PASSES = 2          # passes over the fields in set-up, holding answers as the window does
HOLD_VISITS = 3          # each field keeps its answer at one of its first visits (seeded)
PROFILED_PASSES = 5      # passes over the fields in the profiled window (--trace 1)
_ENDS = {"compress": "size_read", "decompress": "stream_sync"}


class Bench:
    """``BENCHMARK.json`` and the files it names, under a checkout's ``root``."""

    def __init__(self, root):
        self.root = Path(root)
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.manifest["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        mix = json.loads((self.root / "fzbench" / "traffic" / f"{name}.json").read_text())
        if (mix["loop"], mix["clients"], mix["order"]) != ("closed", 1, "round_robin") \
                or _ENDS.get(mix["direction"]) != mix["ends"]:
            raise ValueError(f"traffic {name}: the generator runs one closed round-robin "
                             f"client, compress ending at the size read and decompress at "
                             f"the stream's end; got {mix}")
        return mix

    def metrics(self, workload: str, trace: bool) -> list[dict]:
        """The end-to-end (``trace`` False) or per-layer metrics this cell reports."""
        def applies(m):
            return "workloads" not in m or workload in m["workloads"]
        e2e = [m for m in self.manifest["end_to_end"] if applies(m)]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.manifest["per_layer"] if applies(m)
                and ("workloads" in m or m["moves"] in moved)]

    def proxies(self) -> Path:
        return self.root / "fzbench" / "proxies"

    def reader(self, name: str):
        path = self.root / "fzbench" / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"fzbench_metric_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class _Stamps:
    """A pair of timing stamps a call: CUDA events on the card (each recorded
    once in set-up, so none is created inside the window), the host clock on
    the CPU (the tests' runs)."""

    def __init__(self, device: torch.device, n: int):
        self.cuda = device.type == "cuda"
        self.ev = []
        self._grow(2 * n)

    def _grow(self, n: int) -> None:
        for _ in range(n):
            if self.cuda:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
            else:
                e = _HostEvent()
            self.ev.append(e)

    def pair(self, k: int):
        if 2 * k + 1 >= len(self.ev):
            self._grow(len(self.ev))
        return self.ev[2 * k], self.ev[2 * k + 1]

    def ms(self, k: int) -> float:
        return self.ev[2 * k].elapsed_time(self.ev[2 * k + 1])


class _HostEvent:
    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, other: "_HostEvent") -> float:
        return (other.t - self.t) * 1e3


def _stored(c) -> int:
    """The stored size a writer must know, the program's ``used_bytes()``: it
    reads the container's two counts, which waits for the card. The check holds
    it against the reference's."""
    return c.used_bytes()


def _build(cuda: bool) -> dict:
    """The program's kernels built (a checkout's first run) or found built,
    timed apart from the rest of set-up."""
    if not cuda:
        return {"build_s": 0.0, "compiled": []}
    from repro_torch.kernels import build
    t = time.perf_counter()
    logs = build.build()
    return {"build_s": time.perf_counter() - t, "compiled": sorted(logs)}


def _route(snapshot: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in sorted(snapshot["counters"].items())
                     if k.startswith("fz_dispatches"))


def run(bench: Bench, workload: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, log=sys.stderr) -> dict:
    """Run one cell on ``device`` -> the result line's object, ``checks`` last.
    ``t_start``: the process's start on ``time.perf_counter``'s clock."""
    from repro_torch import obs
    from repro_torch.core import fz

    cell = bench.cell(workload)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    fzcfg = fz.FZConfig(**mix["fz"])
    direction = mix["direction"]
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.current_stream(device).synchronize()

    built = _build(cuda)
    t_fields = time.perf_counter()
    fields = [fieldgen.make_field(cfg["proxy"], cfg["shape"], cfg["dtype"], seed, cfg["name"],
                                  i, device, bench.proxies())
              for i in range(len(cfg["fields"]))]
    sync()
    raw = fields[0].numel() * fields[0].element_size()
    containers = None
    if direction == "compress":
        inputs = fields

        def call(x):
            return fz.compress(x, fzcfg, device=device)

        def finish(c, i):
            return _stored(c)
    else:
        containers = [fz.compress(x, fzcfg, device=device) for x in fields]
        stored = [_stored(c) for c in containers]
        inputs = containers

        def call(c):
            return fz.decompress(c, fzcfg, device=device)

        def finish(y, i):
            sync()
            return stored[i]

    n = len(inputs)
    rng = random.Random(f"fzbench:{seed}")
    order = rng.sample(range(n), n)          # the fields' visiting order, every pass
    hold = [rng.randrange(HOLD_VISITS) for _ in range(n)]

    def loop(calls: int | None, deadline: float | None, stamps: _Stamps | None):
        """Closed loop over the fields -> (completed calls as (field, stored
        bytes, stamp index), answers per field, failed). The log is kept
        unboxed, so the loop leaves no objects of its own for the collector."""
        visits, last, held, failed = [0] * n, {}, {}, 0
        done = (array("i"), array("q"), array("q"))
        k = 0
        while calls is None or k < calls:
            i = order[k % n]
            if stamps is not None:
                a, b = stamps.pair(k)
                a.record()
            try:
                out = call(inputs[i])
                size = finish(out, i)
            except Exception as exc:        # a failed call counts; the loop goes on
                if not failed:
                    print(f"call {k} (field {i}) failed: {exc!r}", file=log)
                failed, out, size = failed + 1, None, None
            if stamps is not None:
                b.record()
            if out is not None:
                if visits[i] == hold[i]:
                    held[i] = out
                last[i] = out
                done[0].append(i)
                done[1].append(size)
                done[2].append(k)
            visits[i] += 1
            k += 1
            if deadline is not None and time.perf_counter() >= deadline:
                break
        answers = [[held[i]] if i in held else [] for i in range(n)]
        for i, out in last.items():
            if all(out is not h for h in answers[i]):
                answers[i].append(out)
        return done, answers, failed

    sync()
    # set-up: warm every call of the window, and the allocator's pool for the held answers
    t_warm = time.perf_counter()
    loop(WARM_PASSES * n, None, None)
    sync()
    per_call = (time.perf_counter() - t_warm) / (WARM_PASSES * n)
    stamps = _Stamps(device, int(seconds / max(per_call, 1e-4) * 1.5) + 64)
    sync()
    snap = obs.snapshot()
    print(f"route: {_route(snap) or 'no fz_dispatches counted'}", file=log)
    print(f"kernels: {built['build_s']:.3f} s, compiled {built['compiled'] or 'none'}",
          file=log)
    print(f"set-up: until the fields {t_fields - t_start:.3f} s, fields and set-up "
          f"containers {t_warm - t_fields:.3f} s, warm calls and stamps "
          f"{time.perf_counter() - t_warm:.3f} s", file=log)
    obs.reset()
    obs.clear_events()

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    done, answers, failed = loop(None, t0 + seconds, stamps)
    window_s = time.perf_counter() - t0
    sync()
    calls = [{"field": i, "raw": raw, "stored": size, "ms": stamps.ms(k)}
             for i, size, k in zip(*done)]
    record = {"direction": direction, "calls": calls, "window_s": window_s,
              "setup_s": setup_s, "obs": obs.snapshot()}
    attempted = len(calls) + failed
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                "memory_peak_bytes": peak}
    print(f"window: {attempted} calls in {window_s:.3f} s, {failed} failed; "
          f"set-up {setup_s:.3f} s; peak {peak} bytes", file=log)

    breakdown = None
    if trace:
        end_range = yardstick.SIZE_RANGE if direction == "compress" else yardstick.WAIT_RANGE
        record.update(_profile(call, finish, inputs, order, raw, end_range, device, sync))
        record["hbm_bytes_per_s"] = yardstick.HBM_BYTES_PER_S.get(kind)
        w = yardstick.window(record["events"])
        if w is not None:
            dev_info["busy_s"] = yardstick.busy(record["events"], *w) / 1e6
            dev_info["window_s"] = (w[1] - w[0]) / 1e6
        breakdown = yardstick.breakdown(record["events"], f"fz.{direction}")

    metrics = {}
    for m in bench.metrics(workload, trace):
        value = bench.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    del inputs, calls, record, stamps
    t_check = time.perf_counter()
    totals = check.judge(direction, fields, answers, containers, mix["fz"], log)
    n_answers = sum(len(a) for a in answers)
    print(f"reference check: {n_answers} answers of {n} fields in "
          f"{time.perf_counter() - t_check:.3f} s", file=log)
    checks = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in totals.items()}
    correct = (failed == 0 and n_answers > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["setup"] = {"compiled": bool(built["compiled"]), "build_s": built["build_s"]}
    out["checks"] = checks
    return out


def _profile(call, finish, inputs, order, raw, end_range: str, device, sync) -> dict:
    """A warm pass, then ``PROFILED_PASSES`` passes inside the window range,
    under torch.profiler -> the trace's events and the window's calls' bytes.
    ``end_range`` names the harness's range around what ends a call (the size
    read or the stream wait). The warm pass keeps the profiler's start-up (its
    first call idles the card for about 2 ms) out of the window."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    n = len(inputs)
    profiled = []

    def passes(calls: int, log: list | None):
        for k in range(calls):
            i = order[k % n]
            out = call(inputs[i])
            with record_function(end_range):
                size = finish(out, i)
            if log is not None:
                log.append({"raw": raw, "stored": size})
            del out
    sync()
    with profile(activities=acts) as prof:
        passes(n, None)
        with record_function(yardstick.WINDOW_RANGE):
            passes(PROFILED_PASSES * n, profiled)
        sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return {"events": events, "profiled": profiled}
