"""The paper's core use case as a CLI: compress scientific fields and report
the paper's metrics (CR, bitrate, PSNR, SSIM) across error bounds. The port of
``examples/compress_field.py``.

    python -m repro_torch.examples.compress_field --kind wavefront
    python -m repro_torch.examples.compress_field --kind turbulent --shape 16 16 8 --device cpu

The default route: strict mode, so strict K4 (K4 with the exact outlier
channel) and K6 on the card. ``main`` returns the CSV rows
it prints.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import fz, metrics
from repro_torch.data import FIELD_KINDS, make_field

EBS = (1e-2, 5e-3, 1e-3, 5e-4, 1e-4)


def main(argv: list[str] | None = None) -> list[str]:
    p = argparse.ArgumentParser()
    p.add_argument("--kind", choices=FIELD_KINDS, default="wavefront")
    p.add_argument("--shape", type=int, nargs=3, default=(128, 128, 64))
    p.add_argument("--code-mode", choices=["sign_mag", "zigzag"], default="sign_mag")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = args.device

    f = torch.from_numpy(make_field(args.kind, tuple(args.shape), seed=0)).to(dev)
    raw_mb = f.numel() * 4 / 1e6
    print(f"{args.kind} field {tuple(f.shape)} = {raw_mb:.1f} MB, "
          f"codes={args.code_mode}")
    print("eb_rel,CR,bitrate,PSNR_dB,SSIM(mid-slice),max_err,bound")
    rows = []
    for eb in EBS:
        cfg = fz.FZConfig(eb=eb, code_mode=args.code_mode)
        rec, c = fz.roundtrip(f, cfg, device=dev)
        mid = f.shape[0] // 2
        ssim = metrics.ssim2d(f[mid], rec[mid]) if f.ndim == 3 else float("nan")
        cr = c.compression_ratio()
        br = metrics.bitrate(c.raw_bytes(), c.used_bytes(), f.dtype)
        rows.append(f"{eb:.0e},{cr:.2f},{br:.2f},"
                    f"{metrics.psnr(f, rec):.2f},{ssim:.4f},"
                    f"{metrics.max_abs_err(f, rec):.3e},{float(c.eb_abs):.3e}")
        print(rows[-1])
    return rows


if __name__ == "__main__":
    main()
