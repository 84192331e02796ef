"""repro_torch.obs — metrics / span / sentinel telemetry for the port. The port
of ``repro.obs``, with the same public names.

One layer that the port's subsystems (core FZ, the kernel routes, the kvpool,
the engine, the launcher) report into. Five pieces:

  * :mod:`registry`  — counters / gauges / log-bucketed histograms, labeled,
    process-wide, snapshot-able to a plain dict (``obs.snapshot()``);
  * :mod:`spans`     — ``with obs.span("kvpool.park", pages=n):`` nested
    timed scopes feeding the histograms, a bounded event ring, and
    ``torch.profiler.record_function`` ranges (NVTX ranges under Nsight) so
    the same names appear in ``torch.profiler`` and Nsight traces of the card;
  * :mod:`trace`     — exporters: Chrome ``trace_event`` JSON and JSONL;
  * :mod:`sentinels` — always-on health monitors (error-bound violations,
    ratio drift, scheduler starvation) behind ``obs.assert_healthy()``;
  * :mod:`gcpause`   — a ``gc.callbacks`` hook, installed on import: each
    Python collection in ``gc_pause_ms{gen=}`` and ``gc_collections{gen=}``,
    and under a ``torch.profiler`` capture a ``py.gc`` range (no ring event).

How to read a StepReport
------------------------
``obs.step_report()`` returns one row per span name: call count, p50/p99/max
milliseconds of host wall time, and total time; pass ``bytes_by_tag=`` and
rows whose span name carries a matching tag gain a bytes column and the
implied GB/s. ``report.render()`` prints it; ``--metrics-out`` JSONs it.

How to open the traces
----------------------
Run the launcher (``python -m repro_torch.launch.serve``) with
``--trace-out trace.json`` and load the file at https://ui.perfetto.dev (or
``chrome://tracing``): spans are complete events nested by timestamp on one
track per thread. Category ``jit-trace`` marks spans recorded while a CUDA
graph was captured (or ``torch.compile`` traced): they ran no work
themselves. On the card add ``--profile-dir DIR`` for a ``torch.profiler``
Chrome trace: the span names appear there as ``record_function`` ranges, and
each kernel's launch falls inside the range of the span that issued it, which
is where device time per region is read (spans record host time only); a
Python collection shows there as a ``py.gc`` range.

Both files are on one clock, the Unix epoch: an event's time is its ``ts``
(microseconds) plus the document's ``baseTimeNanoseconds`` (the obs
exporters write the key as kineto does; JSONL ``ts`` counts from the epoch
itself). To overlay them, move each file's events onto one base (add its
``baseTimeNanoseconds`` / 1e3 to every ``ts``, subtract the other's) and merge
the ``traceEvents`` lists into one document, keeping the obs events' ``pid``
apart from the profiler's; the spans' host ranges then lie over the
profiler's ``record_function`` ranges of the same names.

What each sentinel means
------------------------
  * ``sentinel_eb_violations{tier=...}`` — a sampled container decompressed
    to more than the configured error bound (plus the documented f32
    rounding allowance). Always a bug: the compressor's contract is broken.
    ``assert_healthy()`` raises on it; the scheduler calls that hook every
    step.
  * ``sentinel_ratio_drift{tier=...}`` — the achieved compression ratio
    moved more than ``ratio_drift_factor``x from its EWMA for a tier
    (``kv_cold`` parked pages / ``kv_cold_entropy`` entropy-coded parked
    blobs). A flag, not a failure: it usually means the data distribution
    changed, but a sudden drift is the first symptom of a mis-resolved bound.
  * ``sched_waiting / sched_running / sched_parked / sched_max_wait_steps``
    — serving queue depths and the starvation high-water (longest any
    request waited for admission), sampled every scheduler step.

Cold-tier entropy counters
--------------------------
``fz.to_bytes`` / ``fz.from_bytes`` bump
``entropy_stage{op=encode|decode, selected=true|false, tier=...}`` — one
increment per serialized container, labeled with whether the probe selected
the entropy stage and which tier asked (``kv_cold_entropy``, or ``adhoc``
for untiered calls). The serializers do not feed the ratio EWMAs; the pool
samples ``note_ratio`` inside its sentinel check.

FZ call counters
----------------
Each fz entry point counts ``fz_dispatches{op,path}`` once a call. The fz
path's host reads of device values count in ``fz_host_syncs{site=...}``:
``used_bytes`` (two a ``FZCompressed.used_bytes()``), ``dual_quantize``
(strict mode's ``nonzero``) and ``compact_blocks`` (the ``nonzero`` of the
staged and plain routes' compaction); the sites are those the host-sync
lint's baseline names. A fused paper compress and its size read count 2, a
strict one 3, a staged strict one 4.

Hot-path discipline: no span, counter or histogram reads a device value, so
telemetry adds no synchronisation; the one sync it adds is the pool's sampled
sentinel check (the first park, then every 16th). Spans entered during a CUDA
graph capture record no runtime state (see :mod:`spans`). The paths it wraps
are host-bound on the card, so spans, the fz dispatch and sync counts and the
GC hook queue their bookkeeping (``registry._queued``), applied before the
next read of the registry or the ring. ``obs.disabled()`` suspends all
recording — ``chip_smoke.py`` uses it to pin the instrumentation overhead of
a compressor round trip under 5%.
"""
from . import gcpause  # noqa: F401  (installs the GC hook)
from .registry import (DEFAULT, Registry, counter, disabled, enabled,  # noqa: F401
                       gauge, histogram, reset, set_enabled, snapshot)
from .report import StepReport, step_report  # noqa: F401
from .sentinels import (CONFIG, HealthError, SentinelConfig,  # noqa: F401
                        assert_healthy, check_error_bound, configure,
                        note_ratio, note_scheduler, should_check_eb,
                        violations)
from .spans import (clear_events, current_stack, events,  # noqa: F401
                    ring_capacity, set_ring_capacity, span)
from .trace import chrome_trace, write_chrome_trace, write_jsonl  # noqa: F401

__all__ = [
    "DEFAULT", "Registry", "counter", "disabled", "enabled", "gauge", "histogram",
    "reset", "set_enabled", "snapshot",
    "StepReport", "step_report",
    "CONFIG", "HealthError", "SentinelConfig", "assert_healthy", "check_error_bound",
    "configure", "note_ratio", "note_scheduler", "should_check_eb", "violations",
    "clear_events", "current_stack", "events", "ring_capacity", "set_ring_capacity", "span",
    "chrome_trace", "write_chrome_trace", "write_jsonl",
]
