#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one CUDA card: the FZ compressor and
the serving path (Yi-6B over the paged FZ KV pool with K7 flash-decode).

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
     plain routes;
  7. K7 flash-decode against its plain version on the card at 2e-4 (float32
     sums in another order): the serving geometry (KVH 4, G 8, D 128, pages
     of 64, bfloat16, 4 lanes, lengths 0 / mid-page / page-aligned / full),
     small odd shapes (page 7, D 64, G 1 and 4, float32 and bfloat16,
     shard_offset > 0, length past the slice) and the contiguous entry; fully
     masked rows exactly (m, num, den) = (-1e30, 0, 0);
  8. the serving path at Yi-6B's full config (32 layers, d_model 4096,
     random bfloat16 weights from a torch.Generator seeded 0 on the card): an
     8-request tracegen trace through ``Engine.serve`` with the paged FZ KV
     pool (24 slots of 64 tokens, 4 lanes), once on the kernel route (K7,
     K4, K6) and once on the plain route. Every request completes, the pool
     drains, the trace preempts and reads cold pages, K7 launches once per
     layer per decode step, every parked page is within the error bound and
     the two routes' TraceStats are identical. Tokens: at every
     decode step of the plain run the kernel route's decode runs on the same
     cache and tokens (teacher-forced); its greedy token must agree with the
     plain route's in >= 90% of lane-steps, and every disagreement must lie
     at a near tie (the plain logits' top-2 gap no larger than the largest
     logit difference between the routes). The free-running agreement of
     the two runs is reported beside that of two plain routes (paged
     partials vs contiguous), not gated: once one greedy token differs the
     rest of the request differs, and bfloat16 logits of random weights
     over a 64000-word vocabulary tie often. On one gathered page set the
     kernel route's decode logits are held against the plain route's;
  9. the whole-cache path at Yi-6B: ``Engine.generate`` with the cache parked
     (K4) and resumed (K6) between steps, batch 2, prompt 512, 16 tokens;
  10. serving times: tokens/s and ms per decode step, a torch.profiler split
     of one decode step (K7, the page gather, cold-page K6 decodes, the
     matmuls), and K7's time, plain time, byte bound and the
     ``scaled_dot_product_attention`` yardstick (never called by the port).

bfloat16 GEMMs are set to reduce in float32
(``allow_bf16_reduced_precision_reduction = False``), as the reference's
``dense`` accumulates; the port's modules change no global state.

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
               "fused_shuffle_encode": "fused", "fused_decompress": "fused",
               "flash_decode": "serving"}
K7_TOL = 2e-4              # K7 vs its plain version: float32 sums in another order
# K7 cases: B, H, KVH, D, pages P (or slice length S), page size (0: the
# contiguous entry), dtype, lengths, kv_tile, shard_offset
K7_CASES = [
    (4, 32, 4, 128, 13, 64, "bfloat16", [0, 100, 128, 832], None, 0),   # serving geometry
    (4, 32, 4, 128, 13, 64, "float32", [700, 31, 64, 1], None, 0),
    (3, 4, 4, 64, 5, 7, "float32", [0, 20, 35], None, 0),               # ps 7, G 1
    (3, 4, 1, 64, 5, 7, "bfloat16", [3, 40, 36], None, 0),              # G 4
    (2, 8, 2, 64, 50, 0, "float32", [60, 17], 16, 7),                   # offset, overlong
    (2, 8, 8, 64, 50, 0, "bfloat16", [0, 49], None, 0),
    (3, 16, 4, 128, 300, 0, "bfloat16", [300, 250, 0], 128, 0),
]
# the serving trace and pool (Yi-6B full config, cut in depth of nothing)
SERVE_TRACE = dict(seed=0, n_requests=8, vocab=64000, n_templates=2, template_len=(384, 512),
                   template_reuse=0.6, suffix_len=(64, 256), n_new=(16, 32),
                   priorities=(0, 1), arrival_rate=1.0)
# num_pages 24 forced no preemption on this trace (the schedule does not depend on
# the data, so the port's scheduler shows it on the CPU); 12 forces one
SERVE_POOL = dict(page_size=64, seq_capacity=832, num_pages=12, cold_after=2, eb=1e-4)
SERVE_LANES = 4
TOKEN_AGREEMENT = 0.9      # the reference's own bar (tests/test_kvpool.py), held per step
LOGIT_REL_TOL = 0.05       # teacher-forced logits, kernel vs plain route: 5% of max|logit|
SCHED_FIELDS = ("decode_steps", "admissions", "preemptions", "resumes", "completed",
                "tiered_pages", "pool_compressions", "pool_decompressions", "prefix_hits",
                "prefill_tokens", "prefill_tokens_saved", "cow_promotions",
                "shared_cold_reads_deduped", "decompress_dispatches", "ttft_steps",
                "itl_steps")
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


def serving_phases(card, dev, drive, path_launches, max_err, cuda_ms, device_ms) -> dict:
    """Phases 7-10: K7 against its plain version, the Yi-6B serving trace on both
    routes, the whole-cache path and the serving times. Returns K7's row."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch import configs, kernels
    from repro_torch.core import fz
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    from repro_torch.models import zoo
    from repro_torch.serve import Engine, KVCompressionConfig, PoolConfig
    from repro_torch.serve.kvpool import ContinuousBatcher, tracegen

    # -- 7. K7 against its plain version ---------------------------------------
    t0 = time.time()
    g = torch.Generator().manual_seed(7)
    for B, H, KVH, D, P, ps, dtype, lengths, tile, off in K7_CASES:
        dt = getattr(torch, dtype)
        q = torch.randn(B, H, D, generator=g).to(dev)
        shape = (B, P, ps, KVH, D) if ps else (B, P, KVH, D)
        k, v = (torch.randn(*shape, generator=g).to(dt).to(dev) for _ in range(2))
        length = torch.tensor(lengths, dtype=torch.int32, device=dev)
        q4 = fd.prep_q(q, KVH)
        if ps:
            le = fd.length_eff(length, 0, P * ps)
            got = fd.decode_partials_pages(q, k, v, length)
            want = ref.flash_decode_ref(q4, k, v, le)
        else:
            tl = min(tile or fd.KV_TILE, P)
            T = -(-P // tl)
            le = fd.length_eff(length, off, P)
            got = fd.decode_partials(q, k, v, length, kv_tile=tile, shard_offset=off)
            pad = (0, 0, 0, 0, 0, T * tl - P)
            want = ref.flash_decode_ref(q4, F.pad(k, pad).reshape(B, T, tl, KVH, D),
                                        F.pad(v, pad).reshape(B, T, tl, KVH, D), le)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        max_err["flash_decode"] = max(max_err["flash_decode"], err)
        what = f"B={B} H={H} KVH={KVH} D={D} {'pages ' + str(P) + 'x' + str(ps) if ps else 'S=' + str(P)} {dtype} lengths={lengths} kv_tile={tile} offset={off}"
        if not err <= K7_TOL:
            raise AssertionError(f"K7 differs from its plain version by {err} at {what}")
        for b, n in enumerate(lengths):
            if n - off <= 0 and not (bool((got[0][b] == fd.NEG_INF).all())
                                     and bool((got[1][b] == 0).all())
                                     and bool((got[2][b] == 0).all())):
                raise AssertionError(f"K7 fully masked row {b} is not (-1e30, 0, 0) at {what}")
        say(7, f"K7 == plain within {err:.3g} (tolerance {K7_TOL}) at {what}")
    say(7, f"K7 cases done in {time.time() - t0:.1f} s")

    # -- 8. the serving path at Yi-6B ------------------------------------------
    t0 = time.time()
    cfg = configs.get("yi-6b")
    model = zoo.build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    n_params = model.param_count()
    say(8, f"Yi-6B full config ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
           f"heads, {cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}): "
           f"{n_params} parameters, {n_params * 2 / 1e9:.2f} GB bf16, random from "
           f"torch.Generator seed 0 on the card in {time.time() - t0:.1f} s")
    trace_cfg = tracegen.TraceGenConfig(**SERVE_TRACE)
    reqs = tracegen.generate(trace_cfg)
    say(8, "trace: " + ", ".join(f"req {r.req_id}: prompt {len(r.tokens)} new {r.n_new} "
                                 f"prio {r.priority} at {r.arrive_at}" for r in reqs))

    def serve(use_kernels, parked=None, teacher=None, paged=None):
        """The trace through ``Engine.serve`` on one route. ``parked`` collects each
        parked page's raw data; ``teacher`` collects, at each step of the plain
        contiguous decode, the kernel route's decode on the same cache and tokens;
        ``paged`` overrides the decode wiring (the plain paged partials)."""
        eng = Engine(model, params, pool=PoolConfig(**SERVE_POOL, use_kernels=use_kernels),
                     device=dev)
        pool = eng.make_pool()
        if parked is not None:
            store = pool._park_store

            def park_store(page, comp):
                parked.append((pool.slots[page.slot].clone(), comp, pool.eb_abs))
                store(page, comp)
            pool._park_store = park_store
        if teacher is not None:
            step = eng.decode_step

            def decode_step(cache, tokens):
                logits, new_cache = step(cache, tokens)
                L, B, S, KVH, hd = cache["k"].shape
                ps = SERVE_POOL["page_size"]
                pages = {"k": cache["k"].reshape(L, B, S // ps, ps, KVH, hd),
                         "v": cache["v"].reshape(L, B, S // ps, ps, KVH, hd),
                         "length": cache["length"]}
                lk, _ = model.decode_paged(params, pages, tokens, use_kernels=True)
                act = cache["length"] > 0
                lp, lk = logits.float()[act], lk.float()[act]
                top2 = lp.topk(2, dim=-1).values
                differ = lk.argmax(-1) != lp.argmax(-1)
                teacher.append((int(act.sum()), int(differ.sum()),
                                float((lk - lp).abs().max()),
                                (top2[:, 0] - top2[:, 1])[differ].tolist()))
                return logits, new_cache
            eng.decode_step = decode_step
        torch.cuda.synchronize()
        t = time.perf_counter()
        if paged is None:
            out, stats, pool = eng.serve(tracegen.generate(trace_cfg), max_batch=SERVE_LANES,
                                         pool=pool)
        else:
            batcher = ContinuousBatcher(eng, pool, max_batch=SERVE_LANES)
            batcher.paged_decode = paged
            out, stats = batcher.run(tracegen.generate(trace_cfg))
        torch.cuda.synchronize()
        return out, stats, pool, time.perf_counter() - t

    parked = []
    out_k, st_k, pool_k, wall_k = drive("serving", lambda: serve(True, parked))
    launches = path_launches["serving"]
    n_tok = sum(len(v) for v in out_k.values())
    say(8, f"{card} | kernel route: {st_k.completed} requests, {n_tok} tokens in "
           f"{st_k.decode_steps} decode steps, {wall_k:.2f} s ({n_tok / wall_k:.1f} tokens/s, "
           f"{1e3 * wall_k / st_k.decode_steps:.1f} ms a decode step, prefills included); "
           f"{st_k.admissions} admissions, {st_k.preemptions} preemptions, {st_k.resumes} "
           f"resumes, {st_k.tiered_pages} tiered pages, {st_k.pool_compressions} compressions, "
           f"{st_k.pool_decompressions} cold reads, {st_k.prefix_hits} prefix hits, "
           f"{st_k.cow_promotions} CoW; latency (steps) {tracegen.latency_summary(st_k)}; "
           f"launches {launches}")
    if st_k.completed != len(reqs) or pool_k.pages or pool_k.n_free_slots() != pool_k.cfg.num_pages:
        raise AssertionError("the serving trace did not complete and drain the pool")
    if st_k.preemptions < 1 or st_k.pool_decompressions < 1 or st_k.tiered_pages < 1:
        raise AssertionError("the serving trace forced no preemption, tiering or cold read: "
                             "lower num_pages")
    if launches["flash_decode"] != st_k.decode_steps * cfg.n_layers:
        raise AssertionError(f"K7 launched {launches['flash_decode']} times, not decode steps "
                             f"x layers = {st_k.decode_steps * cfg.n_layers}")
    if launches["fused_compress"] <= 0 or launches["fused_decompress"] <= 0:
        raise AssertionError("the pool did not compress through K4 and read through K6")
    plain_fz = fz.FZConfig(exact_outliers=False, use_kernels=False)
    worst = 0.0
    for raw, comp, eb_abs in parked:
        x = raw.reshape(-1).float()
        rec = fz.decompress(comp, plain_fz)
        err, eb = float((x - rec).abs().max()), float(eb_abs)
        limit = eb * (1 + 2**-20) + float(x.abs().max()) * 2**-22
        if not err <= limit:
            raise AssertionError(f"a parked page breaks the error bound: max_err {err} > {limit}")
        worst = max(worst, err / eb)
    say(8, f"all {len(parked)} parked pages within the bound (eb_abs {float(parked[0][2]):.4g}; "
           f"worst max_err/eb {worst:.6f})")
    del parked

    out_p, st_p, _, wall_p = serve(False)
    for f in SCHED_FIELDS:
        if getattr(st_p, f) != getattr(st_k, f):
            raise AssertionError(f"TraceStats.{f} differs: kernel {getattr(st_k, f)} vs plain "
                                 f"{getattr(st_p, f)}")
    if st_p != st_k:
        raise AssertionError(f"TraceStats differ: kernel {st_k} vs plain {st_p}")
    say(8, f"{card} | plain route: {wall_p:.2f} s ({n_tok / wall_p:.1f} tokens/s); TraceStats "
           f"identical, every scheduling count and the byte high-water marks (used / demand / "
           f"logical): kernel {st_k.high_water_used_bytes} / {st_k.high_water_demand_bytes} / "
           f"{st_k.high_water_logical_bytes}, plain {st_p.high_water_used_bytes} / "
           f"{st_p.high_water_demand_bytes} / {st_p.high_water_logical_bytes}")

    def agreement(a, b):
        return float(np.mean([float((a[i] == b[i]).mean()) for i in a]))

    teacher = []
    out_t, _, _, _ = serve(False, teacher=teacher)
    out_pp, _, _, _ = serve(False, paged=True)
    steps = sum(n for n, _, _, _ in teacher)
    differ = sum(d for _, d, _, _ in teacher)
    d_max = max(d for _, _, d, _ in teacher)
    gaps = sorted(g for _, _, _, gs in teacher for g in gs)
    tf_agree = 1 - differ / steps
    say(8, f"{card} | tokens, teacher-forced (the kernel route's decode on the plain run's cache "
           f"and tokens at every step): same greedy token in {tf_agree:.4f} of {steps} "
           f"lane-steps (bar {TOKEN_AGREEMENT}); top-2 gaps of the plain logits where they "
           f"differ {gaps}; max|logits kernel - plain| {d_max:.4g}. Free-running (not gated): "
           f"kernel vs plain route {agreement(out_k, out_p):.4f}; two plain routes, paged "
           f"partials vs contiguous, {agreement(out_pp, out_p):.4f}")
    if agreement(out_t, out_p) != 1.0:
        raise AssertionError("the teacher-forced plain run is not the plain run")
    if tf_agree < TOKEN_AGREEMENT:
        raise AssertionError(f"teacher-forced token agreement {tf_agree} < {TOKEN_AGREEMENT}")
    if gaps and gaps[-1] > d_max:
        raise AssertionError(f"the routes pick different tokens at a top-2 gap of {gaps[-1]}, "
                             f"beyond the logit difference {d_max}: not a near tie")

    # one gathered page set: 4 lanes, the first 4 prompts, the older half of each
    # sequence's pages parked (cold)
    eng_k = Engine(model, params, pool=PoolConfig(**SERVE_POOL), device=dev)
    eng_p = Engine(model, params, pool=PoolConfig(**SERVE_POOL, use_kernels=False), device=dev)
    pool = PoolConfig(**{**SERVE_POOL, "num_pages": 64})
    pool = Engine(model, params, pool=pool, device=dev).make_pool()
    first = []
    for i, r in enumerate(reqs[:SERVE_LANES]):
        logits, cache = eng_k.prefill({"tokens": torch.as_tensor(r.tokens, device=dev)[None]})
        pool.write_prefill(i, cache["k"], cache["v"], len(r.tokens), step=0)
        pids = [p.page_id for p in pool.pages_of(i)]
        pool.compress_pages(pids[: len(pids) // 2])
        first.append(int(torch.argmax(logits[0])))
    lanes = list(range(SERVE_LANES))
    tokens = torch.tensor(first, dtype=torch.int32, device=dev)
    pages = pool.gather_pages(lanes)
    lk, (kk, vk) = eng_k.decode_step_paged(pages, tokens)
    lp, (kp, vp) = eng_p.decode_step_paged(pages, tokens)
    lc, _ = eng_p.decode_step(pool.gather(lanes), tokens)
    scale = float(lp.float().abs().max())
    d_kp = float((lk.float() - lp.float()).abs().max())
    d_kc = float((lk.float() - lc.float()).abs().max())
    same_top = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    say(8, f"teacher-forced decode step on {SERVE_LANES} lanes (lengths "
           f"{pages['length'].tolist()}, {sum(p.state == 'compressed' for p in pool.pages.values())}"
           f" cold pages): max|logits kernel - plain paged| {d_kp:.4g}, kernel - plain "
           f"contiguous {d_kc:.4g}, max|logit| {scale:.4g} (tolerance {LOGIT_REL_TOL} x max|logit|"
           f"); same argmax in {same_top:.2f} of lanes; step K/V max diff "
           f"{float((kk.float() - kp.float()).abs().max()):.4g}")
    if not (d_kp <= LOGIT_REL_TOL * scale and d_kc <= LOGIT_REL_TOL * scale):
        raise AssertionError("teacher-forced logits of the kernel route differ from the plain "
                             "route beyond the tolerance")
    say(8, f"serving phase done in {time.time() - t0:.1f} s")

    # -- 9. the whole-cache path -------------------------------------------------
    t0 = time.time()
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 512), dtype=np.int32)}
    eng_w = Engine(model, params, kv_compress=KVCompressionConfig(enabled=True, eb=1e-4),
                   device=dev)
    toks_w, cache_w = drive("whole-cache",
                            lambda: eng_w.generate(batch, 16, park_between=True))
    toks_0, _ = eng_w.generate(batch, 16)
    parked_w = eng_w.park(cache_w)
    from repro_torch.serve.engine import cache_bytes, compressed_cache_bytes
    wl = path_launches["whole-cache"]
    agree_w = float((toks_w == toks_0).float().mean())
    say(9, f"{card} | whole-cache generate, batch 2, prompt 512, 16 tokens, parked and resumed "
           f"between steps: tokens {tuple(toks_w.shape)}, agreement with the never-parked run "
           f"{agree_w:.4f}; cache {cache_bytes(cache_w)} B -> {compressed_cache_bytes(parked_w)}"
           f" B parked; launches {wl} ({time.time() - t0:.1f} s)")
    if tuple(toks_w.shape) != (2, 16) or wl["fused_compress"] <= 0 or wl["fused_decompress"] <= 0:
        raise AssertionError("the whole-cache path did not run through K4 and K6")

    # -- 10. serving times --------------------------------------------------------
    from torch.profiler import ProfilerActivity, profile

    def step():
        pg = pool.gather_pages(lanes)
        return eng_k.decode_step_paged(pg, tokens)

    gather_ms = cuda_ms(lambda: pool.gather_pages(lanes), iters=10)
    decode_ms = cuda_ms(lambda: eng_k.decode_step_paged(pages, tokens), iters=10)
    decode_plain_ms = cuda_ms(lambda: eng_p.decode_step_paged(pages, tokens), iters=5)
    step_ms = cuda_ms(step, iters=10)
    step()
    torch.cuda.synchronize()
    groups = {"K7 flash_decode": ("flash_decode",), "K6 cold-page decode": (
        "decode_tiles", "add_residuals", "scan_columns", "scan_rows_dequant"),
        "matmuls": ("gemm", "nvjet", "sm90", "cutlass", "xmma", "cublas", "Kernel2"),
        "copies (page gather, stacking)": ("copy", "Copy", "cat", "Cat", "stack")}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    split = dict.fromkeys([*groups, "other"], 0.0)
    top = []
    for e in prof.key_averages():
        us = e.self_device_time_total / 3
        if us <= 0:
            continue
        top.append((us, e.key[:60]))
        name = next((grp for grp, keys in groups.items() if any(k in e.key for k in keys)),
                    "other")
        split[name] += us
    total_us = sum(split.values())
    say(10, f"{card} | one decode step at Yi-6B, 4 lanes (lengths {pages['length'].tolist()}), "
            f"{sum(p.state == 'compressed' for p in pool.pages.values())} cold pages: "
            f"gather_pages {gather_ms:.3f} ms, decode_step_paged {decode_ms:.3f} ms (plain "
            f"paged {decode_plain_ms:.3f} ms), gather + decode {step_ms:.3f} ms; weight "
            f"floor {n_params * 2 / HBM_BYTES_PER_S * 1e3:.3f} ms")
    if total_us:
        say(10, f"{card} | device time of one gather + decode step: " + ", ".join(
            f"{name} {us / 1e3:.3f} ms ({100 * us / total_us:.1f}%)" for name, us in
            split.items()) + f"; total {total_us / 1e3:.3f} ms")
        say(10, "top kernels: " + "; ".join(f"{k} {us:.1f} us" for us, k in
                                             sorted(top, reverse=True)[:8]))
    else:
        say(10, "step split not measured (the profiler saw no device time)")

    # K7 at one layer of the gathered page set, its plain version, bound, yardstick
    k0, v0, le = pages["k"][0], pages["v"][0], pages["length"]
    Bq, P, ps, KVH, D = k0.shape
    q = torch.randn(Bq, cfg.n_heads, D, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev).to(torch.bfloat16)
    q4 = fd.prep_q(q, KVH)
    le_eff = fd.length_eff(le, 0, P * ps)
    k7 = lambda: fd.flash_decode_partials(q4, k0, v0, le_eff)   # noqa: E731
    ms = device_ms(k7, iters=50)
    call_ms = cuda_ms(lambda: fd.decode_partials_pages(q, k0, v0, le), iters=50)
    plain_ms = cuda_ms(lambda: ref.flash_decode_ref(q4, k0, v0, le_eff), iters=10)
    H = cfg.n_heads
    valid = int(le.sum())
    nbytes = 2 * valid * KVH * D * k0.element_size() + q4.numel() * 4 + 2 * Bq * H * 4 \
        + Bq * H * D * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 4 * valid * H * D / FP32_OPS_PER_S * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    S = P * ps
    kc = k0.reshape(Bq, S, KVH, D).transpose(1, 2).contiguous()    # (B, KVH, S, D)
    vc = v0.reshape(Bq, S, KVH, D).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=dev)[None, :] < le[:, None].long())[:, None, None, :]
    qs = q[:, :, None, :]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, kc, vc, attn_mask=mask,
                                                                enable_gqa=True), iters=50)
    say(10, f"{card} | K7 at one layer of the page set (B {Bq}, {P} pages of {ps}, KVH {KVH}, "
            f"G {H // KVH}, D {D}, bf16, {valid} valid positions): {ms:.4f} ms on the card "
            f"({call_ms:.4f} ms a call with the host's share), plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB), {100 * bound_ms / ms:.1f}%"
            f" of bound; scaled_dot_product_attention (enable_gqa, length mask, contiguous K/V) "
            f"{library_ms:.4f} ms")
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:98",
            "launches": path_launches["serving"]["flash_decode"],
            "max_abs_err": max_err["flash_decode"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


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

    # bfloat16 GEMMs reduce split-K partials in float32, as the reference's
    # dense accumulates (set here: the port's modules change no global state)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
                     for path in ("fused", "staged", "cold and batch", "serving",
                                  "whole-cache")}

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
    for name in kernels.WRAPPERS:
        if KERNEL_PATH[name] == "serving":
            continue                      # phase 8
        count = path_launches[KERNEL_PATH[name]][name]
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
                     "replaces": f"src/repro/kernels/{replaces}",
                     "launches": path_launches[KERNEL_PATH[name]][name],
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

    rows.append(serving_phases(card, dev, drive, path_launches, max_err, cuda_ms, device_ms))
    say(10, f"total {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
