"""Quickstart: error-bounded lossy compression of a scientific field. The port of
``examples/quickstart.py``.

    python -m repro_torch.examples.quickstart                  # on the card
    python -m repro_torch.examples.quickstart --device cpu --shape 16 16 8

The flow is the reference's: three relative bounds through the default route
(fused: strict K4 with the exact outlier channel, K6 back), the
bfloat16 source accounting, the cold tier through ``to_bytes`` /
``decompress_bytes``, and the kernel path. Differences: the kernel path is the
staged CUDA route (K1, K2, K3; the reference's Pallas kernels), and the
bit-identity to the plain route that the reference prints is checked;
``--shape`` sizes the field (the reference's is fixed at (128, 128, 64), the
default here); ``--device`` as every entry point of the port.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import fz, metrics
from repro_torch.data import make_field


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--shape", type=int, nargs=3, default=(128, 128, 64))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = args.device

    field = torch.from_numpy(make_field("turbulent", tuple(args.shape), seed=0)).to(dev)
    raw_mb = field.numel() * field.element_size() / 1e6   # dtype-correct bytes
    print(f"field: {tuple(field.shape)} {str(field.dtype).removeprefix('torch.')}, "
          f"{raw_mb:.1f} MB")

    out = {"bounds": []}
    for eb in (1e-2, 1e-3, 1e-4):
        cfg = fz.FZConfig(eb=eb, eb_mode="rel")        # paper-style relative bound
        rec, comp = fz.roundtrip(field, cfg, device=dev)
        cr, psnr = comp.compression_ratio(), metrics.psnr(field, rec)
        print(f"eb={eb:g}: "
              f"CR={cr:6.2f}x  "
              f"PSNR={psnr:6.2f} dB  "
              f"max|err|={metrics.max_abs_err(field, rec):.3e} "
              f"(bound {float(comp.eb_abs):.3e})")
        out["bounds"].append({"eb": eb, "cr": cr, "psnr": psnr})

    # source-dtype accounting: a bfloat16 input is charged 2 bytes/value
    # (comp.raw_bytes() == n * 2, not the float32-inflated n * 4), so the
    # printed ratio is honest for half-precision slabs like KV caches
    bf = field.to(torch.bfloat16)
    cfg = fz.FZConfig(eb=1e-3, eb_mode="rel")
    comp = fz.compress(bf, cfg, device=dev)
    assert int(comp.raw_bytes()) == bf.numel() * 2
    print(f"bfloat16 source: raw {int(comp.raw_bytes()) / 1e6:.1f} MB, "
          f"CR={comp.compression_ratio():.2f}x (dtype-correct)")

    # cold tier: serialize to the versioned byte container, optionally with
    # the second-stage entropy coder (docs/CONTAINER_FORMAT.md); decode
    # routes on the header flag and reconstruction is bit-exact
    cfg = fz.FZConfig(eb=1e-3, eb_mode="rel")
    comp = fz.compress(field, cfg, device=dev)
    plain = fz.to_bytes(comp, cfg, entropy=False)
    cold = fz.to_bytes(comp, cfg, entropy="auto")
    assert torch.equal(fz.decompress_bytes(cold, device=dev), fz.decompress(comp, cfg, device=dev))
    print(f"cold tier: plain {len(plain) / 1e6:.2f} MB -> "
          f"entropy {len(cold) / 1e6:.2f} MB "
          f"(x{len(plain) / len(cold):.2f} on top of FZ)")

    # kernel path: the staged CUDA route, one kernel a stage (K1, K2, K3; each
    # wrapper's plain version on the CPU), held to the plain route
    cfg = fz.FZConfig(eb=1e-3, use_kernels=True, exact_outliers=False, kernel_mode="staged")
    rec, comp = fz.roundtrip(field, cfg, device=dev)
    ref_rec, ref_comp = fz.roundtrip(field, fz.FZConfig(eb=1e-3, use_kernels=False,
                                                        exact_outliers=False), device=dev)
    assert torch.equal(rec, ref_rec) and all(
        torch.equal(getattr(comp, f), getattr(ref_comp, f)) for f in comp.FIELDS)
    print(f"staged-kernel path: CR={comp.compression_ratio():.2f}x "
          f"(bit-identical to the reference path)")
    out["kernel_cr"] = comp.compression_ratio()
    return out


if __name__ == "__main__":
    main()
