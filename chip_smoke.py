#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's FZ compressor end to end on one CUDA card.

    python3 chip_smoke.py          # from the root of the repository, on a card

Phases (each prints its own lines):

  0. the card's name and power limit, torch and CUDA versions;
  1. build the kernels from src/repro_torch/csrc with nvcc, one process per
     source, all at once;
  2. hold every kernel against its plain PyTorch version on the card, bit
     for bit, at the main path's shapes and at small odd shapes, float32 and
     bfloat16, both code modes: K1 lorenzo_quant, K2 bitshuffle_flag and K3
     bitunshuffle_tiles (the staged route), K4 fused_compress, K5
     fused_shuffle_encode and K6 fused_decompress (the fused route; payload
     capacity 1.0 and 0.25);
  3. run the main paths through the public entry points (``compress`` /
     ``decompress``) on SDRBench-sized proxies at rel eb 1e-2, 1e-3, 1e-4,
     strict and paper mode: the fused route (the default) and the staged
     route (``kernel_mode="staged"``). Every container and reconstruction of
     both must equal the plain route's (``use_kernels=False``) on the card,
     and the error bound must hold wherever no delta overflowed the outlier
     channel;
  3b. the cold and batch forms at (100, 500, 500): ``to_bytes`` (entropy
     off, on, "auto") -> ``decompress_bytes`` on the card, exact; the frozen
     fixtures of tests/data decoded on the card, bit for bit; the 100 planes
     as a batch through ``compress_batch_with_eb`` / ``decompress_batch``,
     each row equal to its single-row call;
  4. the card's containers and reconstructions against the CPU path's at
     (100, 500, 500), bit for bit;
  5. the kernels' launch counts on each path of phases 3 and 3b (counts set
     to 0 just before each path's calls and read just after), each kernel
     above 0 on its path;
  6. CUDA-event times at (100, 500, 500): each kernel, its plain version and
     its bound; compress/decompress GB/s and ratio of the fused, staged and
     plain routes.

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
# redundant neighbour work): K1 divide + round + Lorenzo + code; K2 shuffle
# bits + flag; K3 unshuffle bits; K4 = K1 + K2; K5 = K2; K6 unshuffle + code +
# prefix sums + dequantize. Far below the byte bound at every shape used here.
OPS_PER_CODE = {"lorenzo_quant": 12, "bitshuffle_flag": 20, "bitunshuffle_tiles": 16,
                "fused_compress": 32, "fused_shuffle_encode": 20, "fused_decompress": 24}
KERNEL_PATH = {"lorenzo_quant": "staged", "bitshuffle_flag": "staged",
               "bitunshuffle_tiles": "staged", "fused_compress": "fused",
               "fused_shuffle_encode": "fused", "fused_decompress": "fused"}
FIXTURES = ("tests/data/container_v1_plain.bin", "tests/data/container_v1_entropy.bin",
            "tests/data/legacy_stream.bin")

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
    import numpy as np
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
                what = f"{label} {dtype} {code_mode}"
                k1 = kernels.lorenzo_quant(x, eb, code_mode=code_mode)
                hold("lorenzo_quant", k1, ref.lorenzo_quant_ref(x, eb, code_mode=code_mode), what)
                tiles = shuffle.pad_to_tiles(k1.reshape(-1)).reshape(-1, shuffle.TILE)
                k2 = kernels.bitshuffle_flag(tiles)
                hold("bitshuffle_flag", k2, ref.bitshuffle_flag_ref(tiles), what)
                k3 = kernels.bitunshuffle_tiles(k2[0])
                hold("bitunshuffle_tiles", k3, ref.bitunshuffle_ref(k2[0]), what)
                if not same(k3, tiles):
                    raise AssertionError(f"K3 does not invert K2 at {what}")
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
    say(2, f"K1-K6 bit-identical to their plain versions in {cases} cases "
           f"({time.time() - t0:.1f} s); max |kernel - plain|: {max_err}")

    # -- 3. the main paths: fused and staged routes ---------------------------
    # each path's launches: counts set to 0 just before its calls, read just after
    path_launches = {path: dict.fromkeys(kernels.WRAPPERS, 0)
                     for path in ("fused", "staged", "cold and batch")}

    def drive(path, fn):
        kernels.reset_launch_counts()
        out = fn()
        for name, count in kernels.launch_counts().items():
            path_launches[path][name] += count
        return out

    t0 = time.time()
    for name, x in fields.items():
        maxabs = float(x.abs().max())
        for exact in (True, False):
            mode = "strict" if exact else "paper"
            for eb_rel in EBS:
                cfg = rt.FZConfig(eb=eb_rel, exact_outliers=exact)
                staged = rt.FZConfig(eb=eb_rel, exact_outliers=exact, kernel_mode="staged")
                plain = rt.FZConfig(eb=eb_rel, exact_outliers=exact, use_kernels=False)
                c, y = drive("fused", lambda: (lambda c: (c, rt.decompress(c, cfg)))(
                    rt.compress(x, cfg)))
                cs, ys = drive("staged", lambda: (lambda c: (c, rt.decompress(c, staged)))(
                    rt.compress(x, staged)))
                c0 = rt.compress(x, plain)
                y0 = rt.decompress(c0, plain)
                for route, cc, yy, other, oc, oy in (("fused", c, y, "plain", c0, y0),
                                                     ("staged", cs, ys, "plain", c0, y0),
                                                     ("staged", cs, ys, "fused", c, y)):
                    for f in c.FIELDS:
                        if not same(getattr(cc, f), getattr(oc, f)):
                            raise AssertionError(f"{name} {mode} eb={eb_rel}: {route} container "
                                                 f"field {f} differs from the {other} route")
                    if not same(yy, oy):
                        raise AssertionError(f"{name} {mode} eb={eb_rel}: {route} reconstruction "
                                             f"differs from the {other} route")
                if (y.shape != x.shape or y.dtype != torch.float32
                        or not bool(torch.isfinite(y).all())):
                    raise AssertionError(f"{name} {mode} eb={eb_rel}: bad reconstruction "
                                         f"{y.shape} {y.dtype}")
                eb_abs = float(c.eb_abs)
                err = metrics.max_abs_err(x, y)
                n_over = int(quant.dual_quantize(x, c.eb_abs)[3])
                capacity = cfg.outlier_capacity(x.numel())
                # the bound, with the float32 rounding allowance of the
                # reference's own property test (tests/test_fz_properties.py)
                limit = eb_abs * (1 + 2**-20) + maxabs * 2**-22
                line = (f"{name} {tuple(x.shape)} {mode} eb={eb_rel}: fused == staged == plain; "
                        f"CR {c.compression_ratio():.3f} PSNR {metrics.psnr(x, y):.2f} dB "
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
    say(3, f"main paths done in {time.time() - t0:.1f} s")

    # -- 3b. cold and batch forms ---------------------------------------------
    t0 = time.time()
    x = fields["Hurricane-like smooth"]
    for exact in (True, False):
        cfg = rt.FZConfig(eb=1e-3, exact_outliers=exact)
        c = drive("cold and batch", lambda: rt.compress(x, cfg))
        y = rt.decompress(c, rt.FZConfig(eb=1e-3, exact_outliers=exact, use_kernels=False))
        for entropy in (False, True, "auto"):
            t1 = time.perf_counter()
            raw = rt.to_bytes(c, cfg, entropy=entropy)
            to_ms = (time.perf_counter() - t1) * 1e3
            t1 = time.perf_counter()
            yb = drive("cold and batch", lambda: rt.decompress_bytes(raw))
            torch.cuda.synchronize()
            from_ms = (time.perf_counter() - t1) * 1e3
            if not same(yb, y):
                raise AssertionError(f"decompress_bytes (entropy={entropy}) differs from the "
                                     "container's reconstruction")
            back, _ = rt.from_bytes(raw, capacity=c.payload.shape[0],
                                    outlier_capacity=c.outlier_idx.shape[0])
            for f in c.FIELDS:
                if not same(getattr(back, f), getattr(c, f)):
                    raise AssertionError(f"from_bytes field {f} differs (entropy={entropy})")
            say("3b", f"{card} | {TIMING_SHAPE} {'strict' if exact else 'paper'} eb=1e-3 "
                      f"entropy={entropy}: {len(raw)} bytes, CR {c.raw_bytes() / len(raw):.3f} "
                      f"(hot form {c.compression_ratio():.3f}); to_bytes {to_ms:.1f} ms "
                      f"(host), decompress_bytes {from_ms:.1f} ms (host + card): exact")
    for path in FIXTURES:
        raw = (ROOT / path).read_bytes()
        want = np.load(ROOT / "tests" / "data" / ("expected_legacy.npy" if "legacy" in path
                                                   else "expected_v1.npy"))
        got = drive("cold and batch", lambda: rt.decompress_bytes(raw))
        if not same(got, torch.from_numpy(want)):
            raise AssertionError(f"{path} does not decode bit for bit on the card")
    say("3b", f"the fixtures {', '.join(FIXTURES)} decode on the card bit for bit")
    for staged in (False, True):
        cfg = rt.FZConfig(eb=1e-3, kernel_mode="staged" if staged else "auto",
                          exact_outliers=not staged)
        eb = rt.resolve_eb(x, cfg)
        cb = drive("cold and batch", lambda: rt.compress_batch_with_eb(x, eb, cfg))
        yb = drive("cold and batch", lambda: rt.decompress_batch(cb, cfg))
        for i in range(x.shape[0]):
            one = rt.compress_with_eb(x[i], eb, cfg)
            for f in one.FIELDS:
                if not same(getattr(cb, f)[i], getattr(one, f)):
                    raise AssertionError(f"batch row {i} field {f} differs from its single call")
            if not same(yb[i], rt.decompress(one, cfg)):
                raise AssertionError(f"batch row {i} reconstruction differs from its single call")
        say("3b", f"batch of {x.shape[0]} rows {tuple(x.shape[1:])} "
                  f"({'staged paper' if staged else 'fused strict'}): every row equals its "
                  f"single-row call, container and reconstruction")
    say("3b", f"cold and batch forms done in {time.time() - t0:.1f} s")

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
    for path, counts in path_launches.items():
        say(5, f"launches on the {path} path: {counts}")
    launches = {name: path_launches[KERNEL_PATH[name]][name] for name in kernels.WRAPPERS}
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} was not launched on the {KERNEL_PATH[name]} path")
    if path_launches["cold and batch"]["fused_decompress"] <= 0:
        raise AssertionError("decompress_bytes did not launch fused_decompress")

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
    tiles = shuffle.pad_to_tiles(kernels.lorenzo_quant(x, eb).reshape(-1)).reshape(
        -1, shuffle.TILE)
    shuffled, _ = kernels.bitshuffle_flag(tiles)
    n_pad = tiles.numel()
    work = {
        "lorenzo_quant": (
            lambda: kernels.lorenzo_quant(x, eb),
            lambda: ref.lorenzo_quant_ref(x, eb),
            n * 4 + n * 2),
        "bitshuffle_flag": (
            lambda: kernels.bitshuffle_flag(tiles),
            lambda: ref.bitshuffle_flag_ref(tiles),
            n_pad * 2 + n_pad * 2 + n_pad // 8),
        "bitunshuffle_tiles": (
            lambda: kernels.bitunshuffle_tiles(shuffled),
            lambda: ref.bitunshuffle_ref(shuffled),
            n_pad * 2 + n_pad * 2),
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
    sources = {"lorenzo_quant": ("fz_staged.cu", "lorenzo_quant.py:111"),
               "bitshuffle_flag": ("fz_staged.cu", "bitshuffle_flag.py:86"),
               "bitunshuffle_tiles": ("fz_staged.cu", "bitshuffle_flag.py:109"),
               "fused_compress": ("fz_compress.cu", "fused_compress.py:246"),
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
    routes = {"fused": {}, "staged": dict(kernel_mode="staged"), "plain": dict(use_kernels=False)}
    for exact in (True, False):
        for route, kw in routes.items():
            c_cfg = rt.FZConfig(eb=1e-3, exact_outliers=exact, **kw)
            c = rt.compress(x, c_cfg)
            c_ms = cuda_ms(lambda: rt.compress(x, c_cfg), iters=10)
            d_ms = cuda_ms(lambda: rt.decompress(c, c_cfg), iters=10)
            # card-only times where the route never waits on the card (strict
            # mode's outlier channel and the staged compaction call nonzero)
            card_c = (f" (card {device_ms(lambda: rt.compress(x, c_cfg), iters=10):.3f} ms)"
                      if route == "fused" and not exact else "")
            card_d = (f" (card {device_ms(lambda: rt.decompress(c, c_cfg), iters=10):.3f} ms)"
                      if route != "plain" else "")
            if route != "plain":
                say(6, f"{card} | fz {route} {'strict' if exact else 'paper'} compress per call "
                       f"on the card: {breakdown(lambda: rt.compress(x, c_cfg))}")
            if route == "staged":
                say(6, f"{card} | fz staged {'strict' if exact else 'paper'} decompress per "
                       f"call on the card: {breakdown(lambda: rt.decompress(c, c_cfg))}")
            say(6, f"{card} | fz {route} "
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
