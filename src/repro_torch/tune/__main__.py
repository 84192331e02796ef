"""``python -m repro_torch.tune`` -- pre-tune the kernel table / dump the cache.
The port of the reference's ``python -m repro.tune``, with ``--device
{cuda,cpu}`` (default ``cuda``, as every entry point of the port).

The smoke workload set covers the reference's points: the FZ property/bench
leaves (one-tile and bench-grid sizes, f32 + bf16) and the serve-smoke
decode-attention geometry. ``--json`` prints a machine-readable summary
(per-point winner + hit/miss/measurement totals); a second invocation on the
same cache is pure cache hits with ``measurements: 0``.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import cache as _cache
from . import dispatch, registry
from .impls import attn_cache_elems
from .tuner import ensure_tuned

_COUNTERS = ("tune_cache{", "tune_selected{", "tune_measurements{", "tune_skipped{",
             "tune_parity_rejected{")

# (op, n, dtype) points matching the CI dispatch sites: 4096 = one-tile
# property leaves, 65536 = the bench smoke grid (32*64*32), bf16 = KV pages;
# the attention point is the serve smoke pool geometry (seq_capacity=32,
# glm4-9b smoke heads)
SMOKE_WORKLOADS = (
    ("fz.compress", 4096, "float32"),
    ("fz.decompress", 4096, "float32"),
    ("fz.compress", 65536, "float32"),
    ("fz.decompress", 65536, "float32"),
    ("fz.compress", 65536, "bfloat16"),
    ("fz.decompress", 65536, "bfloat16"),
    ("decode_attention", attn_cache_elems(32, 2, 64), "bfloat16"),
)

FULL_NS = (4096, 65536, 1 << 20)


def _full_workloads():
    out = []
    for n in FULL_NS:
        for dtype in ("float32", "bfloat16"):
            out.append(("fz.compress", n, dtype))
            out.append(("fz.decompress", n, dtype))
    for s in (1024, 4096):
        out.append(("decode_attention", attn_cache_elems(s, 2, 64),
                    "bfloat16"))
    return tuple(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune",
        description="pre-tune the kernel dispatch table")
    ap.add_argument("--smoke", action="store_true",
                    help="tune the small CI workload set")
    ap.add_argument("--cache", default=None,
                    help=f"cache file (default ${_cache.ENV_VAR} "
                         f"or ~/.cache/repro_torch/tune_cache.json)")
    ap.add_argument("--ops", default=None,
                    help="comma-separated op filter (default: all)")
    ap.add_argument("--k", type=int, default=3, help="timing reps per candidate")
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--force", action="store_true",
                    help="re-measure even on cache hits")
    ap.add_argument("--json", action="store_true",
                    help="print a machine-readable summary to stdout")
    ap.add_argument("--dump", action="store_true",
                    help="print the cached table and exit (no tuning)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the candidates run (default: the card)")
    args = ap.parse_args(argv)

    tc = dispatch.configure(args.cache)
    log = (lambda *a: print(*a, file=sys.stderr)) if args.json else print

    if args.dump:
        doc = {"schema": _cache.SCHEMA_VERSION, "path": str(tc.path),
               "status": tc.status, "entries": tc.entries}
        if args.json:
            print(json.dumps(doc, indent=1, sort_keys=True))
        else:
            print(f"# {tc.path} [{tc.status}]")
            for key in sorted(tc.entries):
                e = tc.entries[key]
                us = ", ".join(f"{i}={v:.0f}us" for i, v in
                               sorted(e.get("measured_us", {}).items()))
                print(f"{key} -> {e.get('impl')} ({us})")
        return 0

    workloads = SMOKE_WORKLOADS if args.smoke else _full_workloads()
    if args.ops:
        keep = {o.strip() for o in args.ops.split(",")}
        unknown = keep - set(registry.ops())
        if unknown:
            ap.error(f"unknown ops {sorted(unknown)}; known {registry.ops()}")
        workloads = tuple(w for w in workloads if w[0] in keep)

    summary = ensure_tuned(workloads, cache=tc, k=args.k, warmup=args.warmup,
                           force=args.force, log=log, device=args.device)
    # this process's tune_* counters ride along as evidence: a second run on
    # the same cache is pure hits on tune_cache{result=hit,...}
    from .. import obs
    summary["counters"] = {k: v for k, v in obs.snapshot()["counters"].items()
                           if k.startswith(_COUNTERS)}
    if args.json:
        print(json.dumps(summary, indent=1, sort_keys=True))
    else:
        print(f"tuned {summary['misses']} point(s), {summary['hits']} cache "
              f"hit(s), {summary['measurements']} measurement(s) "
              f"[{summary['backend']}/{summary['arch']}] -> "
              f"{summary['cache_path']}")
        for r in summary["results"]:
            print(f"  {r['op']} n={r['n']} {r['dtype']}: {r['impl']}"
                  f"{'' if r['measured'] else ' (cached)'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
