"""Measurements that back findings in PERF.md, run on the card's machine.

    python tools/chip_probes.py tune-variants [--src DIR] [--repeat N]
    python tools/chip_probes.py serve-steps [--src DIR] [--repeat N]
    python tools/chip_probes.py attention-loop

``tune-variants`` tunes, ``--repeat`` times, the six points of chip_smoke.py's
phase 13 at its timing size (100 x 500 x 500 float32): compress and
decompress at the 3-D paper-mode point, the 3-D strict-mode point and the
1-D paper-mode stream, each forced into a fresh cache. It prints every
route's measured microseconds and the route each point chose, so the spread
of the phase's variant gate (a variant must choose the route the paper-mode
point chose) can be read for the package under ``--src`` (default: this
checkout's ``src``). Needs a CUDA card.

``serve-steps`` serves chip_smoke.py's phase-8 trace (Yi-6B at its
published config, random weights from seed 0, 12 pool slots, 4 lanes, rel
eb 1e-4) on the kernel route once to warm up and then ``--repeat`` times,
and prints each run's host seconds, decode steps, host ms a decode step and
K4/K6/K7 launches, for the package under ``--src``. Needs a CUDA card.

``attention-loop`` counts the dry-run cell dbrx-132b prefill_32k single
(``launch.dryrun.count_step``) at depths 1 and 2 on the production fake
mesh, once as the dry-run does (a forward on meta tensors runs one attention
chunk pair and counts it for all) and once running every chunk pair, and
prints the seconds, FLOPs and memory tally of each. Runs on the host alone;
no card is needed.

Each line is one JSON object; the last line of ``tune-variants`` sums up.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TIMING_SHAPE = (100, 500, 500)       # chip_smoke.py's TIMING_SHAPE
TIMING_N = 100 * 500 * 500


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def tune_variants(repeat: int) -> None:
    import torch
    from repro_torch import tune
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("tune-variants needs a CUDA card")
    print(json.dumps({"card": card_line(), "torch": torch.__version__,
                      "package": tune.__file__}), flush=True)
    build.build()
    points = [(op, TIMING_N, "float32", g)
              for g in ({"shape": TIMING_SHAPE, "mode": "paper"},
                        {"shape": TIMING_SHAPE, "mode": "strict"},
                        {"shape": (TIMING_N,), "mode": "paper"})
              for op in ("fz.compress", "fz.decompress")]
    flips = 0
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(repeat):
            res = tune.ensure_tuned(points, cache=tune.TuneCache(Path(tmp) / f"{i}.json"),
                                    force=True, device="cuda", log=lambda *a, **k: None)
            chosen = {}
            for r in res["results"]:
                chosen.setdefault(r["op"], r["impl"])      # the paper-mode 3-D point
                same = r["impl"] == chosen[r["op"]]
                flips += not same
                print(json.dumps({"run": i, "op": r["op"], "geometry": r["geometry"],
                                  "impl": r["impl"], "gate_holds": same,
                                  "measured_us": r["measured_us"]}), flush=True)
    print(json.dumps({"runs": repeat, "variant_choices_differing": flips}), flush=True)


def serve_steps(repeat: int) -> None:
    import torch
    from repro_torch import configs, kernels
    from repro_torch.kernels import build
    from repro_torch.models import zoo
    from repro_torch.serve.kvpool import tracegen
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    if not torch.cuda.is_available():
        raise SystemExit("serve-steps needs a CUDA card")
    print(json.dumps({"card": card_line(), "torch": torch.__version__,
                      "package": kernels.__file__}), flush=True)
    build.build()
    dev = torch.device("cuda")
    model = zoo.build(configs.get("yi-6b"))
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    trace = tracegen.TraceGenConfig(**chip_smoke.SERVE_TRACE)
    for i in range(repeat + 1):
        kernels.reset_launch_counts()
        _, stats, _, seconds = chip_smoke.serve_trace(model, params, dev, trace, True)
        counts = kernels.launch_counts()
        print(json.dumps({"run": i, "warm_up": i == 0, "seconds": seconds,
                          "decode_steps": stats.decode_steps,
                          "ms_a_decode_step": 1e3 * seconds / stats.decode_steps,
                          "launches": {k: counts[k] for k in ("fused_compress",
                                                              "fused_decompress",
                                                              "flash_decode")}}),
              flush=True)


def attention_loop(arch: str = "dbrx-132b", shape_name: str = "prefill_32k") -> None:
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.models import attention

    cfg = configs.get(arch)
    unit = dryrun._depth_unit(cfg)
    mesh = dryrun.production_mesh(False)
    one_pair = attention._counting_only
    try:
        for label, counting in (("one pair counted for all", one_pair),
                                ("every pair run", lambda x: False)):
            attention._counting_only = counting
            for depth in (1, 2):
                t0 = time.time()
                r = dryrun.count_step(dataclasses.replace(cfg, n_layers=depth * unit),
                                      SHAPES[shape_name], mesh)
                print(json.dumps({"arch": arch, "shape": shape_name, "depth": depth,
                                  "attention": label, "seconds": time.time() - t0,
                                  "flops": r["cost"]["flops"], "bytes": r["cost"]["bytes"],
                                  "memory": r["memory"]}), flush=True)
    finally:
        attention._counting_only = one_pair
        dryrun.end_fake_group()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="probe", required=True)
    tv = sub.add_parser("tune-variants")
    tv.add_argument("--src", default=str(ROOT / "src"))
    tv.add_argument("--repeat", type=int, default=5)
    ss = sub.add_parser("serve-steps")
    ss.add_argument("--src", default=str(ROOT / "src"))
    ss.add_argument("--repeat", type=int, default=3)
    sub.add_parser("attention-loop")
    args = p.parse_args(argv)
    sys.path.insert(0, getattr(args, "src", str(ROOT / "src")))
    if args.probe == "tune-variants":
        tune_variants(args.repeat)
    elif args.probe == "serve-steps":
        serve_steps(args.repeat)
    else:
        attention_loop()


if __name__ == "__main__":
    main()
