#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's fused FZ compressor end to end on one CUDA card.

    python3 chip_smoke.py          # from the root of the repository, on a card

Phases (each prints its own lines):

  0. the card's name and power limit, torch and CUDA versions;
  1. build the kernels from src/repro_torch/csrc with nvcc;
  2. hold K4 fused_compress, K5 fused_shuffle_encode and K6 fused_decompress
     against their plain PyTorch versions on the card, bit for bit, at the
     main path's shapes and at small odd shapes, float32 and bfloat16, both
     code modes, payload capacity 1.0 and 0.25;
  3. run the main path through the public entry points (``compress`` /
     ``decompress``, kernels on) on SDRBench-sized proxies at rel eb 1e-2,
     1e-3, 1e-4, strict and paper mode; every container and reconstruction
     must equal the plain route's (``use_kernels=False``) on the card, and
     the error bound must hold wherever no delta overflowed the outlier
     channel;
  4. the card's containers and reconstructions against the CPU path's at
     (100, 500, 500), bit for bit;
  5. the kernels' launch counts from phase 3, each above 0;
  6. CUDA-event times at (100, 500, 500): each kernel, its plain version and
     its bound; compress/decompress GB/s and ratio, kernels and plain route.

The last three lines are the card's name and power limit, a JSON line of the
kernels and ``{"ok": true, "device": {...}}``. Any failure raises and the
script exits non-zero without those lines; so does a machine without a CUDA
card, or a directory without the rest of the repository.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM non-tensor float32 rate (NVIDIA data sheet)

# Scalar operations per code the function itself needs (not the kernel's
# redundant neighbour work): K4 divide + round + Lorenzo + code + shuffle
# bits + flag; K5 shuffle bits + flag; K6 unshuffle + code + prefix sums +
# dequantize. Far below the byte bound at every shape used here.
OPS_PER_CODE = {"fused_compress": 32, "fused_shuffle_encode": 20, "fused_decompress": 24}

SMALL_SHAPES = [(5000,), (37, 130), (9, 33, 70)]
MAIN_FIELDS = [
    # name, kind, shape: SDRBench sizes (Hurricane 100x500x500, Nyx 512^3);
    # HACC's 280,953,867 particles are cut to 2**26 for time
    ("Hurricane-like smooth", "smooth", (100, 500, 500)),
    ("Nyx-like turbulent", "turbulent", (512, 512, 512)),
    ("HACC-like particle (cut from 280953867)", "particle", (1 << 26,)),
]
EBS = (1e-2, 1e-3, 1e-4)
TIMING_SHAPE = (100, 500, 500)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    from repro_torch import kernels
    from repro_torch.core import metrics, quant, shuffle
    from repro_torch.data.fields import make_field
    from repro_torch.kernels import build, ref

    t_start = time.time()
    dev = torch.device("cuda")
    card = card_line()
    say(0, f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s)")

    # -- 1. build ---------------------------------------------------------
    t0 = time.time()
    logs = build.build()
    for src in build.SOURCES:
        build.library(src)
    say(1, f"kernels built in {time.time() - t0:.1f} s "
           f"({'compiled ' + ', '.join(logs) if logs else 'found built'}) into {rt.BUILD_DIR}")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or ("spill" in line and "0 bytes spill stores" not in line):
                say(1, f"  {src}: {line.strip()}")

    # -- 2. kernels against their plain versions ---------------------------
    def bits(t):
        """Integers by value, float32 by its bits."""
        if t.dtype in (torch.uint16, torch.uint32):
            return t.to(torch.int64)
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def same(a, b):
        return a.shape == b.shape and torch.equal(bits(a), bits(b.to(a.device)))

    max_err = {name: 0.0 for name in kernels.WRAPPERS}

    def hold(name, got, want, what):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            err = float((g.to(torch.int64) - w.to(torch.int64)).abs().max()
                        if g.dtype != torch.float32 else (g.double() - w.double()).abs().max())
            max_err[name] = max(max_err[name], err)
            if not same(g, w):
                raise AssertionError(f"{name} differs from its plain version at {what}: "
                                     f"max |kernel - plain| = {err}")

    def field(kind, shape, seed=0):
        return torch.from_numpy(make_field(kind, shape, seed=seed)).to(dev)

    t0 = time.time()
    fields = {name: field(kind, shape) for name, kind, shape in MAIN_FIELDS}
    torch.cuda.synchronize()
    say(2, f"made the main-path fields in {time.time() - t0:.1f} s")
    t0 = time.time()
    cases = 0
    shape_sets = [(f"small {s}", field("turbulent" if len(s) > 1 else "particle", s, seed=1))
                  for s in SMALL_SHAPES] + [(name, x) for name, x in fields.items()]
    for label, x32 in shape_sets:
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            eb = rt.resolve_eb(x, rt.FZConfig(eb=1e-3))
            for code_mode in ("sign_mag", "zigzag"):
                for capf in (1.0, 0.25):
                    what = f"{label} {dtype} {code_mode} capacity {capf}"
                    cap = rt.FZConfig(capacity_frac=capf).payload_capacity(x.numel())
                    k4 = kernels.fused_compress(x, eb, capacity=cap, code_mode=code_mode)
                    hold("fused_compress", k4,
                         ref.fused_compress_ref(x, eb, capacity=cap, code_mode=code_mode), what)
                    args = dict(shape=tuple(x.shape), code_mode=code_mode)
                    hold("fused_decompress", kernels.fused_decompress(k4[0], k4[1], eb, **args),
                         ref.fused_decompress_ref(k4[0], k4[1], eb, **args), what)
                    if dtype == torch.float32:      # the strict route: codes + outliers
                        ocap = rt.FZConfig().outlier_capacity(x.numel())
                        codes, oidx, oval, _ = quant.dual_quantize(
                            x, eb, code_mode=code_mode, outlier_capacity=ocap)
                        flat = shuffle.pad_to_tiles(codes.reshape(-1)).to(torch.uint16)
                        k5 = kernels.fused_shuffle_encode(flat, capacity=cap)
                        hold("fused_shuffle_encode", k5,
                             ref.fused_shuffle_encode_ref(flat, capacity=cap), what)
                        hold("fused_decompress",
                             kernels.fused_decompress(k5[0], k5[1], eb, outlier_idx=oidx,
                                                      outlier_val=oval, **args),
                             ref.fused_decompress_ref(k5[0], k5[1], eb, outlier_idx=oidx,
                                                      outlier_val=oval, **args), what)
                    cases += 1
        torch.cuda.synchronize()
    say(2, f"K4, K5, K6 bit-identical to their plain versions in {cases} cases "
           f"({time.time() - t0:.1f} s); max |kernel - plain|: {max_err}")

    # -- 3. the main path -----------------------------------------------------
    kernels.reset_launch_counts()
    t0 = time.time()
    for name, x in fields.items():
        maxabs = float(x.abs().max())
        for exact in (True, False):
            mode = "strict" if exact else "paper"
            for eb_rel in EBS:
                cfg = rt.FZConfig(eb=eb_rel, exact_outliers=exact)
                c = rt.compress(x, cfg)
                y = rt.decompress(c, cfg)
                plain = rt.FZConfig(eb=eb_rel, exact_outliers=exact, use_kernels=False)
                c0 = rt.compress(x, plain)
                for f in c.FIELDS:
                    if not same(getattr(c, f), getattr(c0, f)):
                        raise AssertionError(f"{name} {mode} eb={eb_rel}: container field {f} "
                                             "differs from the plain route")
                if not same(y, rt.decompress(c0, plain)):
                    raise AssertionError(f"{name} {mode} eb={eb_rel}: reconstruction differs "
                                         "from the plain route")
                if y.shape != x.shape or y.dtype != torch.float32 or not bool(torch.isfinite(y).all()):
                    raise AssertionError(f"{name} {mode} eb={eb_rel}: bad reconstruction "
                                         f"{y.shape} {y.dtype}")
                eb_abs = float(c.eb_abs)
                err = metrics.max_abs_err(x, y)
                n_over = int(quant.dual_quantize(x, c.eb_abs)[3])
                capacity = cfg.outlier_capacity(x.numel())
                # the bound, with the float32 rounding allowance of the
                # reference's own property test (tests/test_fz_properties.py)
                limit = eb_abs * (1 + 2**-20) + maxabs * 2**-22
                line = (f"{name} {tuple(x.shape)} {mode} eb={eb_rel}: CR "
                        f"{c.compression_ratio():.3f} PSNR {metrics.psnr(x, y):.2f} dB "
                        f"max_err/eb {err / eb_abs:.6f} overflowing deltas {n_over} "
                        f"(outlier capacity {capacity})")
                if n_over <= capacity:
                    if not err <= limit:
                        raise AssertionError(f"error bound broken: {line}, limit/eb "
                                             f"{limit / eb_abs:.6f}")
                    say(3, line + " -- bound holds")
                else:
                    say(3, line + " -- outlier capacity exceeded: bound not guaranteed, "
                                  "as in the reference")
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    say(3, f"main path done in {time.time() - t0:.1f} s")

    # -- 4. card against CPU ---------------------------------------------------
    t0 = time.time()
    x = fields["Hurricane-like smooth"]
    for exact in (True, False):
        cfg = rt.FZConfig(eb=1e-3, exact_outliers=exact)
        c = rt.compress(x, cfg)
        c_cpu = rt.compress(x.cpu(), cfg, device="cpu")
        for f in c.FIELDS:
            if not same(getattr(c_cpu, f), getattr(c, f)):
                raise AssertionError(f"card and CPU differ in container field {f}")
        if not same(rt.decompress(c_cpu, cfg, device="cpu"), rt.decompress(c, cfg)):
            raise AssertionError("card and CPU reconstructions differ")
    say(4, f"card == CPU at {TIMING_SHAPE}, strict and paper: every container field and "
           f"the reconstruction bit for bit ({time.time() - t0:.1f} s)")

    # -- 5. launch counts ------------------------------------------------------
    say(5, f"launches on the main path (phase 3): {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # -- 6. times at (100, 500, 500) ------------------------------------------
    def cuda_ms(fn, iters=20, warmup=3):
        """Time per call between CUDA events around back-to-back calls: the
        larger of the device time and the host time of a call."""
        for _ in range(warmup):
            fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / iters

    def device_ms(fn, iters=20, warmup=3):
        """Device time per call: the calls are queued behind a sleep kernel,
        so the card runs them back to back whatever the host's overhead.
        Only for calls that never wait on the card."""
        for _ in range(warmup):
            fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        ev[0].record()
        torch.cuda._sleep(200_000_000)
        ev[1].record()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t) * 1e3
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms >= ev[0].elapsed_time(ev[1]):
            raise RuntimeError(f"queueing {iters} calls took {host_ms:.1f} ms, longer "
                               "than the sleep ahead of them: device time not isolated")
        return ev[1].elapsed_time(ev[2]) / iters

    def breakdown(fn, iters=5):
        """Card time per call of each CUDA kernel a call launches (torch.profiler)."""
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((e.key.removeprefix("void ").split("(")[0].split("<")[0],
                        e.count / iters, e.self_device_time_total / iters)
                       for e in prof.key_averages() if e.self_device_time_total > 0),
                      key=lambda r: -r[2])
        if not rows:
            return "not measured (the profiler saw no device time)"
        return ", ".join(f"{name} {count:g}x {us:.1f} us" for name, count, us in rows[:6])

    n = x.numel()
    cfg = rt.FZConfig(eb=1e-3)
    eb = rt.resolve_eb(x, cfg)
    cap = cfg.payload_capacity(n)
    ocap = cfg.outlier_capacity(n)
    codes, oidx, oval, _ = quant.dual_quantize(x, eb, outlier_capacity=ocap)
    flat = shuffle.pad_to_tiles(codes.reshape(-1)).to(torch.uint16)
    bf, payload, nnz = kernels.fused_shuffle_encode(flat, capacity=cap)
    used = min(int(nnz), cap) * 16
    flag_bytes = bf.numel() * 4
    work = {
        "fused_compress": (
            lambda: kernels.fused_compress(x, eb, capacity=cap),
            lambda: ref.fused_compress_ref(x, eb, capacity=cap),
            n * 4 + flag_bytes + used + 4),
        "fused_shuffle_encode": (
            lambda: kernels.fused_shuffle_encode(flat, capacity=cap),
            lambda: ref.fused_shuffle_encode_ref(flat, capacity=cap),
            flat.numel() * 2 + flag_bytes + used + 4),
        "fused_decompress": (
            lambda: kernels.fused_decompress(bf, payload, eb, shape=tuple(x.shape),
                                             outlier_idx=oidx, outlier_val=oval),
            lambda: ref.fused_decompress_ref(bf, payload, eb, shape=tuple(x.shape),
                                             outlier_idx=oidx, outlier_val=oval),
            flag_bytes + used + oidx.numel() * 8 + n * 4),
    }
    sources = {"fused_compress": ("fz_compress.cu", "fused_compress.py:246"),
               "fused_shuffle_encode": ("fz_compress.cu", "fused_compress.py:324"),
               "fused_decompress": ("fz_decompress.cu", "fused_decode.py:153")}
    rows = []
    for name, (kern, plain, nbytes) in work.items():
        ms, call_ms, plain_ms = device_ms(kern), cuda_ms(kern), cuda_ms(plain, iters=5)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n * OPS_PER_CODE[name] / FP32_OPS_PER_S * 1e3
        bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
        say(6, f"{card} | {name} at {TIMING_SHAPE}: {ms:.4f} ms on the card "
               f"({call_ms:.4f} ms a call with the host's share; plain {plain_ms:.4f} ms), "
               f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB), "
               f"{100 * bound_ms / ms:.1f}% of bound")
        say(6, f"{card} | {name} per call on the card: {breakdown(kern)}")
        src, replaces = sources[name]
        rows.append({"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
                     "replaces": f"src/repro/kernels/{replaces}", "launches": launches[name],
                     "max_abs_err": max_err[name], "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    raw = n * 4
    for exact in (True, False):
        for use_kernels in (True, False):
            c_cfg = rt.FZConfig(eb=1e-3, exact_outliers=exact, use_kernels=use_kernels)
            c = rt.compress(x, c_cfg)
            c_ms = cuda_ms(lambda: rt.compress(x, c_cfg), iters=10)
            d_ms = cuda_ms(lambda: rt.decompress(c, c_cfg), iters=10)
            # card-only times where the route never waits on the card
            card_c = (f" (card {device_ms(lambda: rt.compress(x, c_cfg), iters=10):.3f} ms)"
                      if use_kernels and not exact else "")
            card_d = (f" (card {device_ms(lambda: rt.decompress(c, c_cfg), iters=10):.3f} ms)"
                      if use_kernels else "")
            if use_kernels:
                say(6, f"{card} | fz kernels {'strict' if exact else 'paper'} compress per call "
                       f"on the card: {breakdown(lambda: rt.compress(x, c_cfg))}")
            say(6, f"{card} | fz {'kernels' if use_kernels else 'plain'} "
                   f"{'strict' if exact else 'paper'} sign_mag eb=1e-3 rel, smooth "
                   f"{TIMING_SHAPE} float32: compress {c_ms:.3f} ms = "
                   f"{raw / c_ms / 1e6:.1f} GB/s{card_c}, decompress {d_ms:.3f} ms = "
                   f"{raw / d_ms / 1e6:.1f} GB/s{card_d}, CR {c.compression_ratio():.3f}")

    say(6, f"total {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
