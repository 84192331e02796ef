"""Shared CLI plumbing for telemetry artifacts. The port of ``repro/obs/cli.py``.

A launcher grows the same three flags; this module keeps the parser wiring
and the end-of-run export logic in one place:

  --trace-out PATH     write the span event ring as a Chrome trace_event
                       JSON (load in Perfetto / chrome://tracing)
  --metrics-out PATH   dump the metric registry snapshot as JSON
  --profile-dir DIR    bracket the run with torch.profiler.profile (CPU
                       activity, plus CUDA when the run's device is the card)
                       and write its Chrome trace into DIR, the counterpart
                       of the reference's jax.profiler start_trace/stop_trace

Usage::

    from repro_torch.obs import cli as obs_cli
    obs_cli.add_args(parser)
    args = parser.parse_args()
    obs_cli.start(args, device=dev)
    ...                      # run
    obs_cli.finish(args)     # writes whatever was requested
"""
from __future__ import annotations

import json
import os

import torch
from torch.profiler import ProfilerActivity, profile

from . import registry, sentinels, trace

PROFILE_FILE = "torch_profile.pt.trace.json"    # written into --profile-dir


def add_args(p) -> None:
    """Attach the telemetry flags to an argparse parser."""
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write span events as Chrome trace JSON (Perfetto)")
    p.add_argument("--metrics-out", default=None, metavar="PATH",
                   help="write the metric registry snapshot as JSON")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="capture a torch.profiler trace into DIR")


def start(args, *, device="cuda") -> None:
    """Begin any capture that must bracket the run: a ``torch.profiler``
    capture of the CPU, and of the card when ``device`` is a CUDA device.
    The capture is kept on ``args`` until :func:`finish`."""
    if getattr(args, "profile_dir", None):
        activities = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        args.profiler = profile(activities=activities)
        args.profiler.start()


def finish(args, *, metadata: dict | None = None) -> None:
    """Write the requested artifacts; safe to call when no flag was set."""
    prof = getattr(args, "profiler", None)
    if prof is not None:
        if ProfilerActivity.CUDA in prof.activities:
            torch.cuda.synchronize()          # the last kernels land in the capture
        prof.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, PROFILE_FILE)
        prof.export_chrome_trace(path)
        args.profiler = None
        print(f"profiler trace -> {path}")
    if getattr(args, "trace_out", None):
        trace.write_chrome_trace(args.trace_out, metadata=metadata)
        print(f"chrome trace -> {args.trace_out}")
    if getattr(args, "metrics_out", None):
        snap = registry.snapshot()
        snap["sentinel_violations"] = sentinels.violations()
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        print(f"metrics snapshot -> {args.metrics_out}")
