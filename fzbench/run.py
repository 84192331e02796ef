"""Run one cell of ``BENCHMARK.json`` on the CUDA card and print its result.

    python3 fzbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Standard output ends with one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared with
the reference beside its limit, which are also the last lines on standard
error. The program is the checkout's ``src/repro_torch``; its kernels are
built into ``src/repro_torch/_build`` at the first run and loaded from there
after. The exit code is not 0, and no result is printed, without a card (or
with fewer than the cell asks for), or when a module of JAX or of the JAX
package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = frozenset(("jax", "jaxlib", "flax", "repro"))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.partition(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc!r})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program and the benchmark's package, from this checkout only
    sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]
    # an empty tuning cache: kernel_mode="auto" resolves as for a new user
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(Path(tempfile.gettempdir())
                                               / "fzbench-tune-cache.json")
    import torch
    import repro_torch  # noqa: F401  (the program: absent, the run stops here)
    from fzbench import harness

    bench = harness.Bench(ROOT)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fzbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = harness.run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"fzbench: modules of JAX or the JAX package are loaded: {loaded}",
              file=sys.stderr)
        return 3
    print(f"card: {power_line()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
