"""The control of ``correct``: the plain reference put in the program's place
and computed one precision below the configuration's float32, in bfloat16.

* ``fz.compress`` becomes the reference's compress of the field rounded to
  bfloat16 (the timed call of compress cells, the set-up's containers of
  decompress cells, which the check also judges);
* ``fz.decompress`` becomes the reference's decoder with a bfloat16
  dequantizing product (the timed call of decompress cells).

Every other step of a run is the harness's own: set-up, window, check. Each
control run has to come out not correct; its readings are the upper ends the
limits sit below (PERF.md). The benchmark's own runs never run this.

    python3 fzbench/control.py --workload <cell> --seeds 1 2 3 --seconds 3

prints one JSON line a seed: the seed, ``correct`` and each compared number.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent


def control_compress(x, cfg, *, device=None):
    import torch
    from fzbench.reference import fz_ref
    ref = fz_ref.compress(x.to(torch.bfloat16), eb=cfg.eb, eb_mode=cfg.eb_mode,
                          code_mode=cfg.code_mode, exact_outliers=cfg.exact_outliers,
                          outlier_frac=cfg.outlier_frac)
    dev = ref.payload.device
    size = fz_ref.stored_bytes(x.numel(), ref.nnz, ref.n_outliers)
    return types.SimpleNamespace(
        bitflags=ref.bitflags, payload=ref.payload, outlier_idx=ref.outlier_idx,
        outlier_val=ref.outlier_val, eb_abs=ref.eb_abs, shape=ref.shape,
        nnz_blocks=torch.tensor(ref.nnz, dtype=torch.int32, device=dev),
        n_outliers=torch.tensor(ref.n_outliers, dtype=torch.int32, device=dev),
        used_bytes=lambda: size)


def control_decompress(c, cfg, *, device=None):
    import torch
    from fzbench.reference import fz_ref
    nnz = min(int(c.nnz_blocks), c.payload.shape[0])
    n_out = min(int(c.n_outliers), c.outlier_idx.numel()) if cfg.exact_outliers else 0
    return fz_ref.decompress(c.bitflags, c.payload[:nnz], c.eb_abs, tuple(c.shape),
                             code_mode=cfg.code_mode, outlier_idx=c.outlier_idx[:n_out],
                             outlier_val=c.outlier_val[:n_out], out_dtype=torch.bfloat16)


def run_control(bench, workload: str, seed: int, seconds: float, device, log=sys.stderr) -> dict:
    """One harness run of ``workload`` with the control in the program's place."""
    from fzbench import harness
    from repro_torch.core import fz
    with mock.patch.object(fz, "compress", control_compress), \
            mock.patch.object(fz, "decompress", control_decompress):
        return harness.run(bench, workload, seed, seconds, False, device,
                           time.perf_counter(), log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from fzbench import harness
    if not torch.cuda.is_available():
        print("fzbench control: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.Bench(ROOT)
    for seed in args.seeds:
        out = run_control(bench, args.workload, seed, args.seconds, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "checks": {k: v["value"] for k, v in out["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
