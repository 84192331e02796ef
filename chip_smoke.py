#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one CUDA card: the FZ compressor, the
serving path (Yi-6B over the paged FZ KV pool with K7 flash-decode), the
gradient wire and checkpoints, training (Yi-6B's width, K4/K6 in the
compressed gradient mean of every step), the MoE and M-RoPE decoders
(dbrx-132b, llama4-scout-17b-a16e, qwen2-vl-72b at their published widths),
the recurrent and audio families (rwkv6-3b, zamba2-2.7b, whisper-tiny at
their published sizes, their whole caches parked through K4/K6), the four
examples at their own sizes, and the analysis passes with the host-sync lint's
runtime twin.

    python3 chip_smoke.py          # from the root of the repository, on a card

Phases (each prints its own lines):

  0. the card's name and power limit, torch and CUDA versions;
  1. build the kernels from src/repro_torch/csrc with nvcc, one process per
     source, all at once;
  2. hold every kernel against its plain PyTorch version on the card, bit
     for bit, at the main path's shapes and at small odd shapes, float32 and
     bfloat16, both code modes: K1 lorenzo_quant, K2 bitshuffle_flag and K3
     bitunshuffle_tiles (the staged route), K4 fused_compress, strict K4
     fused_compress_strict (K4 with the exact outlier channel, against
     ``dual_quantize`` + K5's plain version), K5 fused_shuffle_encode (off
     the routes since strict K4, held on the codes of ``dual_quantize``) and
     K6 fused_decompress (the fused route; payload capacity 1.0 and 0.25);
     strict K4 also at rel eb 1e-5 and 1e-6 on the 1-D HACC-like field, whose
     overflows fill and then pass its channel; K6 at its edge shapes (rows longer than a
     tile, rows of one element, the serving page) with outlier slots in no
     order, repeated, at the fill index n, and overflowing a tile's bin; K4,
     strict K4 (at a bound whose overflows pass the channel) and K5 at the
     shapes that reach every layout of K4's neighbour windows
     and at the serving page, float32 and bfloat16, both code modes,
     capacity 1.0 and 0.25, the data at its own allocation and 3 elements
     past a 16-byte boundary; K1 at those shapes and at the edges of its walk
     along the leading axis, the same dtypes, places and code modes; K5 at
     tile counts around one wave of its CTAs, capacity 1.0 and 0.25, its
     payload allocated on a freed block of 0xFFFF (a tail left unzeroed would
     show); and K2/K3 at odd tile counts;
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
     (100, 500, 500), bit for bit, and on non-finite and out-of-range inputs
     ([1, nan, inf, -inf, 3e38]: NaN quantizes to 0, the rest saturate),
     strict mode (strict K4) and paper mode (K4);
  5. the kernels' launch counts on each path of phases 3 and 3b (counts set
     to 0 just before each path's calls and read just after), each kernel
     above 0 on its path;
  6. CUDA-event times at (100, 500, 500): each kernel, its plain version and
     its bound (K4, strict K4 and K5 write their whole capacity-sized
     payload, so their bound counts it); strict K4 also at the HACC field's
     size (280,953,867 float32, rel eb 1e-5); K5 also at a quarter capacity,
     one tile and one wave plus a tile; compress/decompress GB/s and ratio of
     the fused, staged and plain routes;
  7. K7 flash-decode against its plain version (the same split of the pages
     and combine) on the card at 2e-4 (float32 sums in another order): the
     serving geometry (KVH 4, G 8, D 128, pages of 64, bfloat16, 4 lanes,
     lengths 0 / mid-page / page-aligned / on a split border / full / past
     the slice; one page a split), 1, 2 and 13 splits, small odd shapes (page
     7, D 64, G 1 and 4, float32 and bfloat16, shard_offset > 0, length past
     the slice), the contiguous entry, phase 16's G 6 and G 5, and the
     geometries of phase 17's attention (zamba2-2.7b: KVH 32, G 1, D 80;
     whisper-tiny: KVH 6, G 1, D 64); fully masked rows exactly (m, num, den)
     = (-1e30, 0, 0);
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
     matmuls); K7's time L2-warm and L2-cold (a 64 MB write between
     launches), plain time, byte bound and the
     ``scaled_dot_product_attention`` yardstick (never called by the port);
     K6 at the serving page (a parked 1-D bfloat16 page of 2,097,152
     elements at the pool's bound) and K4 at the serving page (a raw page of
     the page set, compressed as the pool parks it): time L2-warm and
     L2-cold, plain time and bound;
  11. the paper's comparison on the three proxies at rel eb 1e-2, 1e-3 and
     1e-4: FZ on the fused route in strict and paper mode (compress and
     decompress GB/s with the host included and card-only beside them, CR,
     bitrate, PSNR, max_err/eb, SSIM of the middle plane of 3-D fields), the
     cuSZ-like baseline (host numpy: CR, bitrate, PSNR and host seconds), the
     cuSZx-like baseline and the cuZFP-like one at the rate whose PSNR is
     closest to FZ's (torch-op proxies on the card: round-trip GB/s, CR,
     PSNR), and FZ over cuZFP-like in round-trip speed and CR. Raises on a
     broken error bound;
  12. telemetry (``repro_torch.obs``) on the serving path: phase 8's trace on
     the kernel route against a fresh registry and event ring. The pool's
     sampled sentinel checks ran (``sentinel_eb_checks{tier=kv_cold}`` and
     ``sentinel_ratio_samples`` >= 1) with no violation, the scheduler's
     per-step ``assert_healthy()`` held on every step and wrote its gauges;
     ``PoolStats`` and ``TraceStats`` equal their registry metrics field for
     field; ``fz_dispatches`` equals the pool's dispatch counts; every
     ``sched_*`` / ``kvpool_*`` counter equals the plain route's (phase 8's
     plain run, registry reset before it), the fz path labels differ
     (``fused`` / ``reference``); spans nest ``engine.serve > sched.step >
     kvpool.{gather,park,cold_read} > fz.* > fz.stage.*`` (stages labeled
     ``cuda``). The per-span host-time table (calls, p50, p99, total), the
     tokens/s with ``obs`` on and under ``obs.disabled()`` (not gated), the
     device idle share of a third run under ``torch.profiler``. The launcher
     (``python -m repro_torch.launch.serve --arch yi-6b --smoke --paged``,
     prompts of 32, 8 tokens, so the profiler trace stays small) in a
     subprocess with ``--trace-out``, ``--metrics-out`` and ``--profile-dir``
     into ``chiprun_out/telemetry/``: the Chrome trace holds ``engine.serve``
     and ``sched.step``, the metrics no sentinel violation, the profiler trace
     every K7 kernel inside an ``engine.decode_step_paged`` range. The cost of
     ``obs``: one span alone, on and off; a fused paper-mode compress +
     decompress round trip at (100,
     500, 500) f32, rel eb 1e-3, interleaved with telemetry on and under
     ``obs.disabled()``, medians of 1000 each; raises at 5% or more. A span
     inside a CUDA graph capture records only ``span_traces`` and one
     ``jit-trace`` event, and the replayed graph gives the eager result;
  13. tune and resources (``repro_torch.tune``, ``repro_torch.analysis``). The
     script points the tuner at a fresh cache under ``chiprun_out/tune/`` when
     it starts (the launcher's subprocess too), so phases 1-12 run with an
     empty cache, on the untuned routes. The resource table of every
     ``__global__`` over the shipped space (registers, spill stores and static
     shared bytes from the ptxas logs the build keeps, dynamic shared bytes
     from the C side's queries, threads, CTAs an SM); any ``smem-overflow``
     or ``reg-overflow`` the port's baseline does not list fails, and so does
     a launch point whose C query gave no answer. Then ``ensure_tuned`` on the
     reference's smoke points and the card's own (``fz.compress`` /
     ``fz.decompress`` at the (100, 500, 500) f32 timing field, and at the
     2,097,152-element bf16 serving page; ``decode_attention`` at the
     engine's own paged geometry: Yi-6B's heads, pages of 64, four lanes),
     printing each entry. On the card the plain route is measured as the
     oracle and never chosen, and a kernel route that is skipped or rejected
     raises; a second run is all hits with no measurement. The timing
     point's choice serves its whole size bucket, so the same point in
     strict mode and as a 1-D stream is measured into a cache of its own and
     must choose the same route. The seeded wrong candidate is rejected and
     a seeded candidate whose spec asks for 300 KiB of shared memory is
     skipped and never launched -- each raising, with nothing cached. With
     the tuned cache, "auto" at the timing shape (strict and paper) equals
     the explicit route the cache names, bit for bit, and ``fz_dispatches``
     names it; an ``Engine`` chooses the kernel, and a short trace launches
     K7 once per layer per decode step;
  14. the gradient wire and checkpoints (``repro_torch.dist``, ``repro_torch.ckpt``),
     after phase 8's model is freed. Yi-6B's gradient tree at full width with
     its 32 layers cut to 2 (870,338,560 float32 elements a pod), seeded
     normal gradients from a ``torch.Generator`` on the card, 2 pods inline,
     rel eb 1e-4, paper mode. ``reduce_stacked`` on the kernel route (K4, K6)
     over three error-feedback steps (the same gradients each step), bit for
     bit against the plain route, then against ``reduce_stacked_bucketed`` at
     4 MiB and 1 GiB buckets; the reference's bounds (one round within 2 eb
     range of the exact mean, the two-round mean no worse); host-included ms
     of each 4 MiB bucket hop, ms a step and raw-gradient GB/s, wire bytes;
     K4 and K6 alone at 262,144,000 elements against their bound. Layer 0's
     wk, final_norm and a bypass leaf reduced on the card and on the CPU
     route, bit for bit. NCCL at world size 1: the distributed barrier and
     bucketed reduce equal the inline form at one pod bit for bit, and the
     bytes handed to ``all_gather`` a bucket equal ``expected_cross_pod_bytes``.
     ``flash_decode_shard`` at Yi-6B's decode geometry (B 4, H 32, KVH 4, D 128,
     bf16, 832 positions in 4 shards, the last past every length): K7
     partials combined by ``combine_shards`` within 2e-4 of the plain
     attention, and the whole cache as one shard on NCCL equal to the
     collective-free combine. A ``codec="fz"`` checkpoint of layer 0 of the
     reduced tree (173,023,232 float32 elements; strict K4 to save, K6 to restore)
     plus a bfloat16 leaf: save and restore seconds with the host entropy
     stage split out, ``compression_report``'s ratio, max_err/eb within the
     bound, the bf16 leaf exact, the wk leaf's file equal to the CPU port's.
     Each path's launches of K4, strict K4, K6 and K7 are counted and must be above 0
     where the path runs them; the ``kernels`` JSON gives each kernel's phase-14
     launches as ``wire_launches``;
  15. training (``repro_torch.train``, ``optim``, ``launch``), after phase 14
     frees its memory. Yi-6B at its published width with its 32 layers cut to
     2 (870,338,560 parameters), ``ShapeConfig("local", 4096, 2, "train")``
     (train_4k's seq_len, the global batch cut from 256 to 2), ``TokenStream``
     seed 0, random bfloat16 weights from a ``torch.Generator`` seeded 0,
     through ``Trainer.run`` on ``launch.mesh.make_mesh((1, 1, 1), ("pod",
     "data", "model"))``: NCCL at world size 1, the pod axis that makes the
     step compress, as the reference's step would on one device given that
     mesh (its ``make_local_mesh(pods=1)`` has no pod axis and runs the exact
     reduce). ``GradCompressionConfig(enabled=True)`` (rel eb 1e-4, paper mode,
     capacity 1.0, ``min_leaf_size`` 4096). 2 steps of the kernel route equal 2
     of the plain route from the same start, bit for bit (params, optimizer,
     error state); then the overlap form (4 MiB buckets, each issued from the
     backward on a side stream) and the barrier form in turn from that state:
     each form's first step is its warm-up, printed on its own line with what
     it held (kernel builds, the NCCL communicator's start, the allocator's
     growth) and kept out of every rate; after 4 steps of each the two are
     equal bit for bit; 4 timed steps of each (CUDA events, host included),
     tokens/s, the split of one step (forward + backward, reduce, AdamW, the
     rest), one step of each form under ``torch.profiler`` (device ms and
     launches by kind and the idle share; the share of the hops' time that
     ran beside the main stream) and the peak allocated memory (limit 70 GB).
     Every step launches K4 and K6 once a leaf past ``min_leaf_size``, the
     plain route none. At the smoke size on the same mesh: 4 steps, a restart
     and 2 more equal 6 steps bit for bit (raw codec); with ``codec="fz"`` (strict
     K4 to save, K6 to restore) every FZ leaf equals the plain route's round trip
     bit for bit and is counted within or past its bound (only error-state
     leaves may pass it; the CPU tests show the reference's round trip passes
     it there too). The launcher (``python -m repro_torch.launch.train --arch
     yi-6b --smoke --ckpt-codec fz``, its ``main`` in this process so that
     its strict K4/K6 launches count), 4 steps then 6 on one ``--ckpt-dir``: the
     reference's line format, the second at ``resume_step=4``. Every line of the phase but the launch counts starts
     with the card's name and power limit; the ``kernels`` JSON gives each
     kernel's launches over the phase as ``train_launches``.

  16. the MoE and M-RoPE decoders (``models/moe.py``, ``attention.apply_mrope``),
     after phase 15, one model at a time, each at its published width with its
     depth cut to 2 layers, random bfloat16 weights (the router float32) from a
     ``torch.Generator`` seeded 0 on the card. (a) dbrx-132b (48 query heads
     over 8 KV heads: K7 at G 6; 16 experts, top-4) and (b) llama4-scout-17b-a16e
     (40 over 8: G 5; 16 experts, top-1, a shared expert) each serve phase 8's
     trace and pool on the kernel route (K7, K4 parking, K6 cold reads) and the
     plain route with phase 8's gates: identical ``TraceStats``, every parked
     page within its bound, K7 once a layer a decode step, K4 and K6 launched
     on the kernel route and no kernel on the plain one, teacher-forced token
     agreement of at least 0.9 with every disagreement at a near tie, and the
     kernel route's logits on a gathered page set within ``LOGIT_REL_TOL`` of
     both plain decodes. Printed: tokens/s, ms a decode step, the device split
     of one gather + decode step under torch.profiler (the expert einsums and
     the router with its dispatch masks attributed by their ``moe.experts`` /
     ``moe.route`` ranges; K7, K6, the page gather, the other GEMMs), the idle
     share and the peak memory. (c) qwen2-vl-72b (M-RoPE): ``make_pool``
     refuses the paged pool, and ``Engine.generate(park_between=True)``, batch
     2, prompt 512, 16 tokens, position ids broadcast on t/h/w as the launcher
     does, parks the cache through K4 and resumes it through K6 each step: the
     kernel route's tokens, cache and every parked container equal the plain
     route's bit for bit, and every parked leaf holds its bound. (d) Two
     ``Trainer`` steps of dbrx-132b SMOKE on the one-rank NCCL pod mesh with the
     barrier compressed reduce (K4/K6 once a leaf past ``min_leaf_size``):
     params, optimizer and error state of the kernel route equal the plain
     route's bit for bit. The ``kernels`` JSON gives each kernel's launches on
     each of these paths as ``zoo_launches``.

  17. the recurrent and audio families (``models/rwkv6.py``, ``mamba2.py``,
     ``zamba2.py``, ``whisper.py``), after phase 16, one model at a time, each
     at its published width and depth (nothing cut), random bfloat16 weights
     from a ``torch.Generator`` seeded 0 on the card: (a) rwkv6-3b, (b)
     zamba2-2.7b and (c) whisper-tiny (its audio embeddings zeros, as the
     launcher feeds them). ``make_pool`` refuses each (not a plain k/v/length
     cache), and ``Engine.generate(park_between=True)``, batch 2, prompt 512,
     16 tokens, rel eb 1e-4, parks the whole cache through K4 and resumes it
     through K6 each step: the float32 recurrent states (``wkv``, ``sh_a``,
     ``sh_f``, ``ssm``) and the bfloat16 ``conv``, K/V and cross K/V. Gates:
     the kernel route's tokens, final cache and every parked container equal
     the plain route's bit for bit; every parked leaf holds the reference's
     bound; K4 and K6 launch parks x parked leaves times each, the plain route
     nothing. Printed: tokens/s, ms a prefill and a decode step, park and
     resume ms, each parked leaf's compression ratio, the device split of a
     prefill and of a parked decode step under torch.profiler (the scans
     ``rwkv6._wkv_chunked``, ``mamba2._ssd_chunked`` and ``mamba2._conv`` by
     their ranges; K4, K6, GEMMs, the rest by kind), peak memory, and the
     largest logit difference of prefill 513 against prefill 512 plus one
     decode step. (d) rwkv6-3b cut to 2 layers and zamba2-2.7b to 6 (one
     superblock), each at its published width, train_4k's sequence length and
     a global batch of 2, two ``Trainer`` steps on the one-rank NCCL pod mesh
     through the compressed reduce: params, optimizer and error state of the
     kernel route equal the plain route's bit for bit, K4 = K6 = steps x
     leaves past ``min_leaf_size``. The ``kernels`` JSON gives each kernel's
     launches on each of these paths as ``recurrent_launches``.

  18. the package surface's entry points and the analysis passes, after phase
     17: (a) the four examples (``repro_torch.examples``) in-process at their own
     sizes through their ``main``: quickstart at (128, 128, 64) (the staged
     route's K1-K3 and the default route's strict K4/K6), compress_field at its
     default and at the 512^3 turbulent field (strict K4/K6; its CR column equal to
     the plain route's on the card digit for digit), serve_compressed_kv's full
     mode with ``--kernels`` (K4, K6, K7) and without (no launch; identical
     scheduling counts, tokens agreeing as phase 8's bar), and train_lm (~65M
     parameters) killed at step 55 of 60 and relaunched to 70 in the same
     checkpoint directory (resumed at step 50; strict K4 saves, K6 restores). Each
     example's own asserts hold and each kernel of its path launched; wall
     times printed; the ``kernels`` JSON gives each kernel's launches on each
     example as ``example_launches``. (b) ``python -m repro_torch.analysis
     --check`` with all four passes, the resource pass with the card's ptxas
     figures and C-side shared bytes. (c) the host-sync lint's runtime twin:
     Yi-6B serves phase 8's trace and pool on the kernel route, and fused
     compress / decompress run at (100, 500, 500), under
     ``torch.cuda.set_sync_debug_mode("warn")``; the innermost ``repro_torch``
     frame of every synchronizing call is a function the static ``host-sync``
     findings or the baseline list. The syncs a decode step are printed.

  19. the dry-run and its calibration (``launch/dryrun.py``, ``hlo_cost.py``,
     ``hlo_analysis.py``; ``train.build_prefill_step`` / ``build_decode_step``),
     after phase 18. (a) Six cells on a fake process group of 256 (``single``,
     (16, 16)) or 512 (``multi``, (2, 16, 16)) ranks of a fake ``cuda`` mesh,
     every parameter, state, input and cache a DTensor of ``meta`` blocks:
     yi-6b train_4k single, yi-6b decode_32k multi, dbrx-132b prefill_32k
     single, llama4-scout-17b-a16e train_4k multi with ``--compressed-grads``
     (the bucketed pod hop, K4/K6 by their fake implementations), zamba2-2.7b
     long_500k single and rwkv6-3b train_4k single with ``--opt zero3``. Each
     is counted at depth 1 and 2 and extrapolated to its full depth. Printed:
     devices, parameters, per-device FLOPs, bytes, collective and cross-pod
     bytes, the peak against the card's 80 GB, the bottleneck, the useful
     FLOPs ratio, the elapsed time and the three source lines whose products
     count the most FLOPs (``flops_by_site``); each cell's JSON goes to
     ``chiprun_out/dryrun/``. Gates: every cell runs to its end,
     ``useful_flops_ratio <= 1.02``, and the compressed cell's cross-pod bytes
     of every bucket equal ``expected_cross_pod_bytes`` at both depths. (b)
     Calibration with real tensors on one rank: Yi-6B at its published width
     cut to 2 layers runs ``build_prefill_step`` at prefill_32k's sequence and
     batch 1 on a (1, 1) mesh, ``build_decode_step`` at decode_32k's cache
     length and batch 4, and phase 15's compressed train step on the (1, 1, 1)
     pod mesh (K4/K6 once a leaf past ``min_leaf_size``). Each runs once under
     the cost model's trace and once under ``torch.profiler(with_flops=True)``:
     the cost model's FLOPs equal the profiler's (its ``mm`` / ``addmm`` /
     ``bmm`` / ``baddbmm`` events) within 2%; then its device
     time (CUDA events) is at or above the roofline's
     ``step_time_lower_bound_s``, and the achieved fraction of the bound is
     printed. The ``kernels`` JSON gives each kernel's launches on these
     paths as ``calibration_launches``.

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
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM non-tensor float32 rate (NVIDIA data sheet)

# Scalar operations per code the function itself needs (not the kernel's
# redundant neighbour work): K1 divide + round + Lorenzo + code; K2 shuffle
# bits + flag; K3 unshuffle bits; K4 = K1 + K2; strict K4 = K4 + the overflow
# test; K5 = K2; K6 unshuffle + code + prefix sums + dequantize. Far below the
# byte bound at every shape used here.
OPS_PER_CODE = {"lorenzo_quant": 12, "bitshuffle_flag": 20, "bitunshuffle_tiles": 16,
                "fused_compress": 32, "fused_compress_strict": 36, "fused_shuffle_encode": 20,
                "fused_decompress": 24}
# the path each kernel runs on (K5 was the fused path's strict stage; strict
# K4 replaced it there, so phase 5 asserts it no longer launches; phase 2 holds it)
KERNEL_PATH = {"lorenzo_quant": "staged", "bitshuffle_flag": "staged",
               "bitunshuffle_tiles": "staged", "fused_compress": "fused",
               "fused_compress_strict": "fused", "fused_shuffle_encode": "fused",
               "fused_decompress": "fused", "flash_decode": "serving"}
OFF_PATH = {"fused_shuffle_encode"}
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
    # split over pages: one page a split at the serving geometry (13 splits;
    # 64 and 128 on split borders, 900 past the slice), 2 splits of 2 pages
    # (B x KVH = 128), one split walking 4 pages (B x KVH = 264)
    (4, 32, 4, 128, 13, 64, "bfloat16", [64, 5, 128, 900], None, 0),
    (16, 64, 8, 64, 4, 16, "bfloat16", [0, 5, 32, 100] * 4, None, 0),
    (33, 16, 8, 64, 4, 16, "float32", [0, 5, 16, 100] * 8 + [64], None, 0),
    (2, 16, 8, 128, 1, 64, "bfloat16", [0, 40], None, 0),
    # rows of 24 bytes, not a multiple of 16: copied by plain loads, not cp.async
    (2, 8, 2, 12, 5, 7, "bfloat16", [0, 30], None, 0),
    (3, 4, 4, 6, 50, 0, "float32", [50, 13, 0], 16, 0),
    # phase 16's group sizes, which do not divide the 32 lane groups: dbrx-132b
    # (48 heads over 8 KV heads, G 6) and llama4-scout-17b-a16e (40 over 8, G 5)
    (4, 48, 8, 128, 13, 64, "bfloat16", [0, 100, 128, 832], None, 0),
    (4, 40, 8, 128, 13, 64, "bfloat16", [64, 5, 500, 900], None, 0),
    # the geometries the resource pass takes from zamba2-2.7b (32 heads of 80
    # over 32 KV heads: G 1, a head size the 128-wide template pads) and
    # whisper-tiny (6 heads of 64 over 6: G 1), paged and contiguous
    (4, 32, 32, 80, 13, 64, "bfloat16", [0, 100, 128, 832], None, 0),
    (4, 32, 32, 80, 13, 64, "float32", [64, 5, 500, 900], None, 0),
    (2, 32, 32, 80, 300, 0, "bfloat16", [300, 17], None, 0),
    (4, 6, 6, 64, 13, 64, "bfloat16", [64, 5, 500, 900], None, 0),
    (3, 6, 6, 64, 300, 0, "float32", [0, 299, 128], 128, 0),
]
# K6 at its edge shapes: rows longer than a tile, rows of one element, the
# serving page (a flattened bfloat16 page of 2 x 32 layers x 64 x 4 x 128)
K6_EDGE_SHAPES = [(2**16 + 3,), (3, 9000), (4100, 1), (2, 3, 1), (5, 1, 7), (2097152,)]
# K4 and K5 at every layout of K4's neighbour windows (2-D and 3-D rows of at
# least a tile, 3-D planes of at least a tile with short rows, rows of one
# element) and at the serving page; K2/K3 at odd tile counts
K4_EDGE_SHAPES = [(3, 5000), (2, 3, 5000), (3, 2, 2100), (4100, 1), (2097152,)]
# K1 (also held at K4_EDGE_SHAPES, whose (3, 5000) walks 2-D rows longer than a
# tile) at the edges of its walk along the leading axis: a plane of exactly one
# tile, a plane of 4101 (not a multiple of 8 or 16), one plane, rows of fewer
# than 16 (every code gated), 1103 planes (prime: not a multiple of any chunk
# the card's wave gives), and rows too long for two windows in shared memory
# (the tile step)
K1_WALK_SHAPES = [(4, 64, 64), (5, 3, 1367), (1, 70, 70), (2, 300, 15), (1103, 64, 64),
                  (2, 2, 30000)]
K3_TILE_COUNTS = (1, 3, 5, 9)
# K5 at tile counts around one wave of its CTAs (`wave`: how many the card
# runs at once)
K5_TILES = ("1", "2", "5", "wave - 1", "wave", "wave + 1", "3 * wave + 7")
NONFINITE = [1.0, float("nan"), float("inf"), float("-inf"), 3e38]
L2_FLUSH_BYTES = 64 << 20   # written between launches for L2-cold times (L2 is 50 MB)
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
OBS_OVERHEAD_LIMIT = 0.05  # the reference's bench tier pins obs under 5% of a round trip
# interleaved round trips with telemetry on and off, each: the host of the
# card's machine has slow phases that move a median of 60 by several percent;
# 1000 pairs (about 1.3 s) span them
OBS_ROUND_TRIPS = 1000
TELEMETRY_DIR = ROOT / "chiprun_out" / "telemetry"    # listed in .gitignore
TUNE_DIR = ROOT / "chiprun_out" / "tune"              # the run's fresh tuning cache
# the card's own tuning points: the timing shape (bucket 2^25) and the serving
# page (2 x 32 layers x 64 x 4 x 128 bf16), both directions; decode attention
# at phase 8's pool (Yi-6B: 4 KV heads of 128)
TIMING_N = 100 * 500 * 500
SERVE_PAGE_N = 2097152
EVIL_SMEM = 300 * 1024      # the seeded budget candidate's dynamic shared bytes
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
ZFP_RATES = (2, 4, 6, 8, 10, 12, 14, 16)   # the rate search of benchmarks/bench_rate_distortion.py
TIMING_SHAPE = (100, 500, 500)
# phase 14: Yi-6B's gradient tree at full width, its 32 layers cut to 2 (870,338,560
# float32 elements a pod: embed and unembed 262,144,000 each), 2 pods inline
WIRE_LAYERS, WIRE_PODS, WIRE_STEPS = 2, 2, 3
WIRE_ELEMS = 870_338_560
WIRE_BUCKETS = (4 << 20, 1 << 30)          # bucket_bytes: the default and one far larger
# decode attention at Yi-6B's geometry (B, H, KVH, D), split in shards; the last
# shard lies past every length
FLASH_GEOMETRY, FLASH_POSITIONS, FLASH_SHARDS = (4, 32, 4, 128), 832, 4
# phase 15: training at Yi-6B's width, its 32 layers cut to 2 (as phase 14's tree), at
# train_4k's seq_len with the global batch cut from 256 to 2 for one card
TRAIN_LAYERS, TRAIN_BUCKET, TRAIN_TOTAL = 2, 4 << 20, 10
TRAIN_SHAPE = ("local", 4096, 2, "train")         # ShapeConfig: 8,192 tokens a step
TRAIN_TIMED = 4                                   # timed steps of each form, in turn
TRAIN_PEAK_LIMIT = 70e9                           # bytes allocated; past it the batch is cut
FLASH_LENGTHS = [600, 417, 208, 1]
# phase 16: the MoE and M-RoPE decoders at their published widths, cut to 2 layers
ZOO_SERVED = ("dbrx-132b", "llama4-scout-17b-a16e")
ZOO_VLM = "qwen2-vl-72b"
ZOO_LAYERS = 2
VLM_GENERATE = (2, 512, 16)                       # batch, prompt, tokens (phase 9's)
ZOO_TRAIN_SHAPE = ("local", 128, 4, "train")      # dbrx SMOKE: 512 tokens a step
ZOO_TRAIN_STEPS = 2
# phase 17: the recurrent and audio families at their published width and depth
RECURRENT_SERVED = ("rwkv6-3b", "zamba2-2.7b", "whisper-tiny")
RECURRENT_GENERATE = (2, 512, 16)                 # batch, prompt, tokens (phase 9's)
RECURRENT_EB = 1e-4                               # rel eb of every parked leaf
# training cuts in depth only: rwkv6-3b to 2 layers, zamba2-2.7b to 6 (one superblock)
RECURRENT_TRAIN = (("rwkv6-3b", 2), ("zamba2-2.7b", 6))
RECURRENT_TRAIN_SHAPE = ("local", 4096, 2, "train")   # train_4k's sequence, global batch 2
RECURRENT_TRAIN_STEPS = 2
# the recurrences' own ops, each in a named range for the profiler's split
RECURRENT_RANGES = (("rwkv6", "_wkv_chunked"), ("mamba2", "_ssd_chunked"), ("mamba2", "_conv"))
# phase 18: the four examples at their own sizes, each with the kernels it must
# launch on the card (the defaults: strict mode, so quickstart's bounds and
# compress_field run strict K4/K6; quickstart's kernel path is the staged route;
# the serving example parks cold pages in paper mode through K4; train_lm's FZ
# checkpoints save through strict K4 and restore through K6)
EXAMPLE_PATHS = {
    "quickstart": ("lorenzo_quant", "bitshuffle_flag", "bitunshuffle_tiles",
                   "fused_compress_strict", "fused_decompress"),
    "compress_field": ("fused_compress_strict", "fused_decompress"),
    "compress_field turbulent 512^3": ("fused_compress_strict", "fused_decompress"),
    "serve_compressed_kv --kernels": ("fused_compress", "fused_decompress", "flash_decode"),
    "serve_compressed_kv": (),
    "train_lm": ("fused_compress_strict",),
    "train_lm resumed": ("fused_compress_strict", "fused_decompress"),
}
EXAMPLE_FIELDS = (("compress_field", "wavefront", (128, 128, 64)),   # its default
                  ("compress_field turbulent 512^3", "turbulent", (512, 512, 512)))
# train_lm: the first run to 60 steps is killed at step 55 (an interrupt from its
# data loader), so its newest checkpoint is step 50; the relaunch goes to 70
TRAIN_LM_STEPS, TRAIN_LM_KILL = (60, 70), 55
TRAIN_LM_ARGS: tuple[str, ...] = ()     # the example's own batch 8, sequence 256
TRAIN_LM_DIR = ROOT / "chiprun_out" / "train_lm"      # listed in .gitignore
SYNC_FIELD = (100, 500, 500)       # the compressor's calls under the sync debug mode
# phase 19: the dry-run's cells (arch, shape, mesh, compressed grads, opt) on the
# fake 256/512-rank meshes, and the calibration on real tensors at Yi-6B's width
DRYRUN_CELLS = (("yi-6b", "train_4k", "single", False, "none"),
                ("yi-6b", "decode_32k", "multi", False, "none"),
                ("dbrx-132b", "prefill_32k", "single", False, "none"),
                ("llama4-scout-17b-a16e", "train_4k", "multi", True, "none"),
                ("zamba2-2.7b", "long_500k", "single", False, "none"),
                ("rwkv6-3b", "train_4k", "single", False, "zero3"))
DRYRUN_RATIO_LIMIT = 1.02        # useful FLOPs over counted FLOPs x devices
CALIB_LAYERS = 2
CALIB_PREFILL = ("prefill_calib", 32_768, 1, "prefill")      # prefill_32k's sequence
CALIB_DECODE = ("decode_calib", 32_768, 4, "decode")         # decode_32k's cache length
CALIB_FLOP_TOL = 0.02            # cost model FLOPs against the profiler's
CALIB_PRODUCTS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def breakdown(fn, iters=5):
    """Card time per call of each CUDA kernel a call launches (torch.profiler)."""
    import torch
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


def cuda_ms(fn, iters=20, warmup=3):
    """Time per call between CUDA events around back-to-back calls: the larger
    of the device time and the host time of a call."""
    import torch
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


def outlier_slots(n, kind, seed, dev):
    """K6 outlier slots in no order: 'few' (repeats, fill slots at n, tiles under
    their bin), 'many' (about 300 a tile: every bin overflows) or 'one_tile'
    (500 slots in the first tile)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    if kind == "few":
        idx = np.array([n - 1, n, 0, n // 2, 0, n // 3, n - 1, n, n // 2, 1], np.int64)
    elif kind == "many":
        idx = rng.integers(0, n + 1, size=max(8, n // 14))
    else:
        idx = rng.integers(0, min(n, 4096), size=500)
    val = rng.integers(-2**31, 2**31, size=idx.size)
    val[idx == n] = 0
    return (torch.from_numpy(idx.astype(np.int32)).to(dev),
            torch.from_numpy(val.astype(np.int32)).to(dev))


def serve_trace(model, params, dev, trace_cfg, use_kernels, parked=None, teacher=None,
                paged=None, record=None):
    """A tracegen trace through ``Engine.serve`` on one route, with phase 8's pool
    (``SERVE_POOL``) and lanes. ``parked`` collects each parked page's raw
    data; ``teacher`` collects, at each step of the plain contiguous decode, the
    kernel route's decode on the same cache and tokens; ``paged`` overrides the
    decode wiring (the plain paged partials); ``record`` gets the registry
    snapshot of the run (reset before it). Returns (outputs, stats, pool,
    seconds)."""
    import torch
    from repro_torch import obs
    from repro_torch.serve import Engine, PoolConfig
    from repro_torch.serve.kvpool import ContinuousBatcher, tracegen

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
    if record is not None:
        obs.reset()
        obs.clear_events()
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
    if record is not None:
        record["snapshot"] = obs.snapshot()
    return out, stats, pool, time.perf_counter() - t


def hold_served(phase, card, dev, model, params, trace_cfg, drive, launches,
                record=None) -> dict:
    """Phase 8's gates on one model: the trace on the kernel route (through
    ``drive``, which counts its launches into ``launches``) completes and drains
    the pool, preempts, tiers and reads cold pages; K7 launches once a layer a
    decode step and K4/K6 run; every parked page is within its bound; the plain
    route's ``TraceStats`` are identical; teacher-forced greedy tokens agree in
    at least ``TOKEN_AGREEMENT`` of lane-steps, every disagreement at a near
    tie; the plain route launches no kernel. Returns both runs' outputs, stats
    and seconds."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.core import fz
    from repro_torch.serve.kvpool import tracegen

    cfg = model.cfg
    reqs = tracegen.generate(trace_cfg)
    parked = []
    out_k, st_k, pool_k, wall_k = drive(
        lambda: serve_trace(model, params, dev, trace_cfg, True, parked))
    n_tok = sum(len(v) for v in out_k.values())
    say(phase, f"{card} | {cfg.arch_id} kernel route: {st_k.completed} requests, {n_tok} "
               f"tokens in {st_k.decode_steps} decode steps, {wall_k:.2f} s ({n_tok / wall_k:.1f} "
               f"tokens/s, {1e3 * wall_k / st_k.decode_steps:.1f} ms a decode step, prefills "
               f"included); {st_k.admissions} admissions, {st_k.preemptions} preemptions, "
               f"{st_k.resumes} resumes, {st_k.tiered_pages} tiered pages, "
               f"{st_k.pool_compressions} compressions, {st_k.pool_decompressions} cold reads, "
               f"{st_k.prefix_hits} prefix hits, {st_k.cow_promotions} CoW; latency (steps) "
               f"{tracegen.latency_summary(st_k)}; launches {launches}")
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
    say(phase, f"all {len(parked)} parked pages within the bound (eb_abs "
               f"{float(parked[0][2]):.4g}; worst max_err/eb {worst:.6f})")
    del parked

    kernels.reset_launch_counts()
    out_p, st_p, _, wall_p = serve_trace(model, params, dev, trace_cfg, False, record=record)
    if any(kernels.launch_counts().values()):
        raise AssertionError(f"the plain route launched kernels: {kernels.launch_counts()}")
    for f in SCHED_FIELDS:
        if getattr(st_p, f) != getattr(st_k, f):
            raise AssertionError(f"TraceStats.{f} differs: kernel {getattr(st_k, f)} vs plain "
                                 f"{getattr(st_p, f)}")
    if st_p != st_k:
        raise AssertionError(f"TraceStats differ: kernel {st_k} vs plain {st_p}")
    say(phase, f"{card} | {cfg.arch_id} plain route: {wall_p:.2f} s ({n_tok / wall_p:.1f} "
               f"tokens/s); TraceStats identical, every scheduling count and the byte "
               f"high-water marks (used / demand / logical): kernel {st_k.high_water_used_bytes}"
               f" / {st_k.high_water_demand_bytes} / {st_k.high_water_logical_bytes}, plain "
               f"{st_p.high_water_used_bytes} / {st_p.high_water_demand_bytes} / "
               f"{st_p.high_water_logical_bytes}")

    teacher = []
    out_t, _, _, _ = serve_trace(model, params, dev, trace_cfg, False, teacher=teacher)
    steps = sum(n for n, _, _, _ in teacher)
    differ = sum(d for _, d, _, _ in teacher)
    d_max = max(d for _, _, d, _ in teacher)
    gaps = sorted(g for _, _, _, gs in teacher for g in gs)
    tf_agree = 1 - differ / steps
    say(phase, f"{card} | {cfg.arch_id} tokens, teacher-forced (the kernel route's decode on "
               f"the plain run's cache and tokens at every step): same greedy token in "
               f"{tf_agree:.4f} of {steps} lane-steps (bar {TOKEN_AGREEMENT}); top-2 gaps of the "
               f"plain logits where they differ {gaps}; max|logits kernel - plain| {d_max:.4g}")
    if any(not np.array_equal(out_t[i], out_p[i]) for i in out_p):
        raise AssertionError("the teacher-forced plain run is not the plain run")
    if tf_agree < TOKEN_AGREEMENT:
        raise AssertionError(f"teacher-forced token agreement {tf_agree} < {TOKEN_AGREEMENT}")
    if gaps and gaps[-1] > d_max:
        raise AssertionError(f"the routes pick different tokens at a top-2 gap of {gaps[-1]}, "
                             f"beyond the logit difference {d_max}: not a near tie")
    return {"out_k": out_k, "out_p": out_p, "stats": st_k, "plain_stats": st_p,
            "wall_k": wall_k, "wall_p": wall_p, "n_tok": n_tok, "tf_agree": tf_agree}


def page_set(phase, dev, model, params, reqs) -> dict:
    """One gathered page set: ``SERVE_LANES`` lanes holding the first prompts of
    the trace, the older half of each sequence's pages parked (cold). The kernel
    route's decode logits on it are held within ``LOGIT_REL_TOL`` of the plain
    paged and the plain contiguous decode. Returns the engines, pool, pages,
    lanes and tokens, for the timings."""
    import torch
    from repro_torch.serve import Engine, PoolConfig

    eng_k = Engine(model, params, pool=PoolConfig(**SERVE_POOL), device=dev)
    eng_p = Engine(model, params, pool=PoolConfig(**SERVE_POOL, use_kernels=False), device=dev)
    pool = Engine(model, params, pool=PoolConfig(**{**SERVE_POOL, "num_pages": 64}),
                  device=dev).make_pool()
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
    say(phase, f"{model.cfg.arch_id} teacher-forced decode step on {SERVE_LANES} lanes (lengths "
               f"{pages['length'].tolist()}, "
               f"{sum(p.state == 'compressed' for p in pool.pages.values())} cold pages): "
               f"max|logits kernel - plain paged| {d_kp:.4g}, kernel - plain contiguous "
               f"{d_kc:.4g}, max|logit| {scale:.4g} (tolerance {LOGIT_REL_TOL} x max|logit|); "
               f"same argmax in {same_top:.2f} of lanes; step K/V max diff "
               f"{float((kk.float() - kp.float()).abs().max()):.4g}")
    if not (d_kp <= LOGIT_REL_TOL * scale and d_kc <= LOGIT_REL_TOL * scale):
        raise AssertionError("teacher-forced logits of the kernel route differ from the plain "
                             "route beyond the tolerance")
    return {"eng_k": eng_k, "eng_p": eng_p, "pool": pool, "pages": pages, "lanes": lanes,
            "tokens": tokens}


def serving_phases(card, dev, drive, path_launches, max_err, cuda_ms, device_ms,
                   cold_ms) -> tuple[dict, dict, dict, dict]:
    """Phases 7-10: K7 against its plain version, the Yi-6B serving trace on both
    routes, the whole-cache path and the serving times. Returns K7's row, K6's
    and K4's numbers at the serving page, and what phase 12 serves with (the
    model, its weights, the trace and the plain route's registry snapshot)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch import configs, kernels
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    from repro_torch.models import zoo
    from repro_torch.serve import Engine, KVCompressionConfig
    from repro_torch.serve.kvpool import tracegen

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
            splits = fd.split_count(B, KVH, P)
            le = fd.length_eff(length, 0, P * ps)
            got = fd.decode_partials_pages(q, k, v, length)
            want = ref.flash_decode_split_ref(q4, k, v, le, splits)
        else:
            tl = min(tile or fd.KV_TILE, P)
            T = -(-P // tl)
            splits = fd.split_count(B, KVH, T)
            le = fd.length_eff(length, off, P)
            got = fd.decode_partials(q, k, v, length, kv_tile=tile, shard_offset=off)
            pad = (0, 0, 0, 0, 0, T * tl - P)
            want = ref.flash_decode_split_ref(q4, F.pad(k, pad).reshape(B, T, tl, KVH, D),
                                              F.pad(v, pad).reshape(B, T, tl, KVH, D), le,
                                              splits)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        max_err["flash_decode"] = max(max_err["flash_decode"], err)
        what = f"B={B} H={H} KVH={KVH} D={D} {'pages ' + str(P) + 'x' + str(ps) if ps else 'S=' + str(P)} {dtype} lengths={lengths} kv_tile={tile} offset={off} splits={splits}"
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
    plain_obs = {}
    held = hold_served(8, card, dev, model, params, trace_cfg,
                       lambda fn: drive("serving", fn), path_launches["serving"],
                       record=plain_obs)
    st_p = held["plain_stats"]

    def agreement(a, b):
        return float(np.mean([float((a[i] == b[i]).mean()) for i in a]))

    out_pp, _, _, _ = serve_trace(model, params, dev, trace_cfg, False, paged=True)
    say(8, f"{card} | free-running tokens (not gated): kernel vs plain route "
           f"{agreement(held['out_k'], held['out_p']):.4f}; two plain routes, paged partials "
           f"vs contiguous, {agreement(out_pp, held['out_p']):.4f}")

    # one gathered page set: 4 lanes, the first 4 prompts, the older half of each
    # sequence's pages parked (cold)
    pset = page_set(8, dev, model, params, reqs)
    eng_k, eng_p, pool, pages, lanes, tokens = (pset[k] for k in (
        "eng_k", "eng_p", "pool", "pages", "lanes", "tokens"))
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
        "decode_scan_rows", "bin_residuals", "scan_columns"),
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
    ms_cold = cold_ms(k7, iters=50)
    call_ms = cuda_ms(lambda: fd.decode_partials_pages(q, k0, v0, le), iters=50)
    splits = fd.split_count(Bq, KVH, P)
    plain_ms = cuda_ms(lambda: ref.flash_decode_split_ref(q4, k0, v0, le_eff, splits), iters=10)
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
    say(10, f"{card} | K7 per call on the card: {breakdown(k7)}")
    say(10, f"{card} | K7 at one layer of the page set (B {Bq}, {P} pages of {ps}, KVH {KVH}, "
            f"G {H // KVH}, D {D}, bf16, {valid} valid positions, {splits} splits, "
            f"{splits * Bq * KVH} CTAs): {ms:.4f} ms on the card L2-warm, {ms_cold:.4f} ms "
            f"L2-cold ({call_ms:.4f} ms a call with the host's share), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB), "
            f"{100 * bound_ms / ms:.1f}% of bound warm, {100 * bound_ms / ms_cold:.1f}% cold; "
            f"scaled_dot_product_attention (enable_gqa, length mask, contiguous K/V) "
            f"{library_ms:.4f} ms")
    k7_row = {"name": "flash_decode", "route": "cuda",
              "source": "src/repro_torch/csrc/flash_decode.cu",
              "replaces": "src/repro/kernels/flash_decode.py:98",
              "launches": path_launches["serving"]["flash_decode"],
              "max_abs_err": max_err["flash_decode"], "ms": ms, "ms_l2_cold": ms_cold,
              "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "library_ms": library_ms}

    # K6 at the serving page: one parked page of the page set, as a cold read
    # decodes it (1-D, bfloat16 source, the pool's resolved bound)
    page = next(p for p in pool.pages.values() if p.state == "compressed")
    c = pool._container(page)
    oidx = c.outlier_idx if c.outlier_idx.numel() else None
    oval = c.outlier_val if c.outlier_idx.numel() else None
    args = dict(shape=c.shape, code_mode=pool._fzc.code_mode, outlier_idx=oidx,
                outlier_val=oval)
    k6 = lambda: kernels.fused_decompress(c.bitflags, c.payload, c.eb_abs, **args)  # noqa: E731
    plain6 = lambda: ref.fused_decompress_ref(c.bitflags, c.payload, c.eb_abs, **args)  # noqa
    got, want = k6(), plain6()
    torch.cuda.synchronize()
    max_err["fused_decompress"] = max(max_err["fused_decompress"],
                                      float((got.double() - want.double()).abs().max()))
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("K6 differs from its plain version at the serving page")
    n6 = got.numel()
    used = min(int(c.nnz_blocks), c.payload.shape[0]) * 16
    nbytes6 = c.bitflags.numel() * 4 + used + c.outlier_idx.numel() * 8 + n6 * 4
    bytes6, ops6 = nbytes6 / HBM_BYTES_PER_S * 1e3, n6 * OPS_PER_CODE["fused_decompress"] \
        / FP32_OPS_PER_S * 1e3
    bound6, by6 = max((bytes6, "bytes"), (ops6, "operations"))
    ms6, cold6 = device_ms(k6, iters=50), cold_ms(k6, iters=50)
    plain_ms6 = cuda_ms(plain6, iters=10)
    say(10, f"{card} | K6 at the serving page per call on the card: {breakdown(k6)}")
    say(10, f"{card} | K6 at the serving page ({c.shape}, {c.dtype_name} source, eb_abs "
            f"{float(c.eb_abs):.4g}, {int(c.nnz_blocks)} of {c.payload.shape[0]} blocks): "
            f"{ms6:.4f} ms on the card L2-warm, {cold6:.4f} ms L2-cold; plain {plain_ms6:.4f} "
            f"ms; bound {bound6:.4f} ms by {by6} ({nbytes6 / 1e6:.2f} MB), "
            f"{100 * bound6 / ms6:.1f}% of bound warm, {100 * bound6 / cold6:.1f}% cold; "
            f"bit-identical to its plain version")
    k6_page = {"shape": list(c.shape), "ms": ms6, "ms_l2_cold": cold6, "plain_ms": plain_ms6,
               "bound_ms": bound6, "bound_by": by6}

    # K4 at the serving page: one raw page of the page set, compressed as the
    # pool parks it (1-D bfloat16, the pool's resolved bound and capacity)
    raw = next(p for p in pool.pages.values() if p.slot is not None)
    flat = pool.slots[raw.slot].reshape(-1)
    cap4, mode4 = pool._page_capacity, pool._fzc.code_mode
    k4 = lambda: kernels.fused_compress(flat, pool.eb_abs, capacity=cap4, code_mode=mode4)  # noqa
    plain4 = lambda: ref.fused_compress_ref(flat, pool.eb_abs, capacity=cap4,  # noqa: E731
                                            code_mode=mode4)
    got, want = k4(), plain4()
    torch.cuda.synchronize()
    for g_, w_ in zip(got, want):
        if not torch.equal(g_.to(torch.int64), w_.to(torch.int64)):
            raise AssertionError("K4 differs from its plain version at the serving page")
    n4, nnz4 = flat.numel(), int(got[2])
    nbytes4 = n4 * flat.element_size() + got[0].numel() * 4 + cap4 * 16 + 4   # whole payload
    bytes4, ops4 = nbytes4 / HBM_BYTES_PER_S * 1e3, n4 * OPS_PER_CODE["fused_compress"] \
        / FP32_OPS_PER_S * 1e3
    bound4, by4 = max((bytes4, "bytes"), (ops4, "operations"))
    ms4, cold4 = device_ms(k4, iters=50), cold_ms(k4, iters=50)
    plain_ms4 = cuda_ms(plain4, iters=10)
    say(10, f"{card} | K4 at the serving page per call on the card: {breakdown(k4)}")
    say(10, f"{card} | K4 at the serving page ({n4} elements, {flat.dtype}, eb_abs "
            f"{float(pool.eb_abs):.4g}, {nnz4} of {cap4} blocks): {ms4:.4f} ms on the card "
            f"L2-warm, {cold4:.4f} ms L2-cold; plain {plain_ms4:.4f} ms; bound {bound4:.4f} ms "
            f"by {by4} ({nbytes4 / 1e6:.2f} MB), {100 * bound4 / ms4:.1f}% of bound warm, "
            f"{100 * bound4 / cold4:.1f}% cold; bit-identical to its plain version")
    k4_page = {"shape": [n4], "ms": ms4, "ms_l2_cold": cold4, "plain_ms": plain_ms4,
               "bound_ms": bound4, "bound_by": by4}
    serving = {"model": model, "params": params, "trace_cfg": trace_cfg,
               "plain_snapshot": plain_obs["snapshot"], "plain_stats": st_p}
    return k7_row, k6_page, k4_page, serving


def paper_comparison(card, dev, fields, cuda_ms, device_ms) -> None:
    """Phase 11: the paper's comparison on the card (Fig. 7, §4.3-4.4): FZ on
    the fused route against the cuSZ-, cuSZx- and cuZFP-like baselines on the
    main-path proxies at each error bound. Raises on a broken error bound."""
    import torch
    import repro_torch as rt
    from repro_torch.core import baselines, metrics, quant

    t_phase = time.time()
    say(11, "baselines are this repository's proxies (core/baselines.py), not cuSZ, cuSZx or "
            "cuZFP: cuSZ-like runs host numpy (host seconds, no GB/s); cuSZx-like and "
            "cuZFP-like are torch ops on the card, each call a round trip (GB/s of raw input)")
    for name, x in fields.items():
        raw = x.numel() * 4
        maxabs = float(x.abs().max())
        x_host = x.cpu().numpy()
        mid = x.shape[0] // 2
        # cuZFP-like at every rate of the search once (its PSNR does not depend on eb)
        zfp = {}
        for rate in ZFP_RATES:
            rz, bz = baselines.cuzfp_like(x, rate)
            zfp[rate] = (metrics.psnr(x, rz), bz)
            del rz
        for eb_rel in EBS:
            fz = {}
            for mode, exact in (("strict", True), ("paper", False)):
                cfg = rt.FZConfig(eb=eb_rel, exact_outliers=exact)
                c = rt.compress(x, cfg)
                y = rt.decompress(c, cfg)
                eb_abs = float(c.eb_abs)
                err = metrics.max_abs_err(x, y)
                if mode == "strict":
                    n_over = int(quant.dual_quantize(x, c.eb_abs)[3])
                limit = eb_abs * (1 + 2**-20) + maxabs * 2**-22
                if n_over <= cfg.outlier_capacity(x.numel()) and not err <= limit:
                    raise AssertionError(f"{name} {mode} eb={eb_rel}: error bound broken, "
                                         f"max_err/eb {err / eb_abs:.6f}")
                c_ms = cuda_ms(lambda: rt.compress(x, cfg), iters=5)
                d_ms = cuda_ms(lambda: rt.decompress(c, cfg), iters=5)
                # card-only times: neither mode's compress waits on the card
                card_c = f"{raw / device_ms(lambda: rt.compress(x, cfg), iters=5) / 1e6:.1f}"
                card_d = raw / device_ms(lambda: rt.decompress(c, cfg), iters=5) / 1e6
                ssim = (f", SSIM (middle plane) {metrics.ssim2d(x[mid], y[mid]):.6f}"
                        if x.ndim == 3 else "")
                fz[mode] = dict(rt_ms=c_ms + d_ms, cr=c.compression_ratio(), psnr=metrics.psnr(x, y))
                fz[mode]["text"] = (
                    f"FZ {mode}: compress {raw / c_ms / 1e6:.1f} GB/s (card {card_c}), decompress "
                    f"{raw / d_ms / 1e6:.1f} GB/s (card {card_d:.1f}), CR {c.compression_ratio():.3f}, "
                    f"bitrate {metrics.bitrate(raw, c.used_bytes()):.4f}, PSNR {fz[mode]['psnr']:.2f} dB, "
                    f"max_err/eb {err / eb_abs:.6f}{ssim}")
            t = time.perf_counter()
            cz = baselines.cusz_like(x_host, eb_abs)
            cz_s = time.perf_counter() - t
            psnr_cz = metrics.psnr(x, torch.from_numpy(cz.reconstruction).to(dev))
            eb_t = torch.tensor(eb_abs, dtype=torch.float32, device=dev)
            rx, bx = baselines.cuszx_like(x, eb_t)
            psnr_x = metrics.psnr(x, rx)
            del rx
            x_ms = cuda_ms(lambda: baselines.cuszx_like(x, eb_t), iters=3, warmup=1)
            # the rate whose PSNR is closest to FZ's (benchmarks/bench_rate_distortion.py)
            rate = min(ZFP_RATES, key=lambda r: abs(zfp[r][0] - fz["strict"]["psnr"]))
            psnr_z, bz = zfp[rate]
            z_ms = cuda_ms(lambda: baselines.cuzfp_like(x, rate), iters=3, warmup=1)
            say(11, f"{card} | {name} {tuple(x.shape)} rel eb {eb_rel}: "
                    + "; ".join(fz[m]["text"] for m in fz)
                    + f"; cuSZ-like (host) {cz_s:.2f} s host, CR {raw / cz.compressed_bytes:.3f}, "
                    f"bitrate {metrics.bitrate(raw, cz.compressed_bytes):.4f}, PSNR {psnr_cz:.2f} dB; "
                    f"cuSZx-like (torch-op proxy) {raw / x_ms / 1e6:.1f} GB/s round trip, CR "
                    f"{raw / bx:.3f}, PSNR {psnr_x:.2f} dB; cuZFP-like (torch-op proxy) rate {rate} "
                    f"{raw / z_ms / 1e6:.1f} GB/s round trip, CR {raw / bz:.3f}, PSNR {psnr_z:.2f} "
                    f"dB; FZ / cuZFP-like: round-trip speed " + ", ".join(
                        f"{m} {z_ms / fz[m]['rt_ms']:.2f}x" for m in fz) + ", CR " + ", ".join(
                        f"{m} {fz[m]['cr'] / (raw / bz):.2f}x" for m in fz))
    say(11, f"paper comparison done in {time.time() - t_phase:.1f} s")


def _strip_instance(key: str) -> str:
    """``name{a=1,pool=pool3}`` -> ``name{a=1}``: the per-instance labels go."""
    name, _, labels = key.partition("{")
    kept = [kv for kv in labels.rstrip("}").split(",") if kv and
            not kv.startswith(("pool=", "batcher="))]
    return name + ("{" + ",".join(kept) + "}" if kept else "")


def kernels_by_range(doc: dict, names) -> list[tuple[str, float, str | None]]:
    """Each kernel of a torch.profiler Chrome trace as (name, device us, the
    ``names`` range that holds it, or None): the range whose CPU span holds
    the kernel's launch (matched by correlation id), or whose GPU projection
    holds the kernel."""
    evs = doc["traceEvents"]
    launches = {e["args"]["correlation"]: e for e in evs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    cpu = [e for e in evs if e.get("cat") == "user_annotation" and e["name"] in names]
    gpu = [e for e in evs if e.get("cat") == "gpu_user_annotation" and e["name"] in names]

    def holder(t0, t1, ranges, same=None):
        return next((r["name"] for r in ranges if r["ts"] <= t0 and t1 <= r["ts"] + r["dur"]
                     and (same is None or (r["pid"], r["tid"]) == same)), None)
    out = []
    for k in (e for e in evs if e.get("cat") == "kernel"):
        launch = launches.get(k.get("args", {}).get("correlation"))
        where = None if launch is None else holder(
            launch["ts"], launch["ts"] + launch.get("dur", 0), cpu, (launch["pid"], launch["tid"]))
        out.append((k["name"], float(k["dur"]),
                    where or holder(k["ts"], k["ts"] + k["dur"], gpu)))
    return out


def k7_inside_ranges(doc: dict, range_name: str) -> tuple[int, int]:
    """(K7 kernel events, how many of them lie inside a ``range_name`` range) in
    a torch.profiler Chrome trace (``kernels_by_range``)."""
    k7 = [where for name, _, where in kernels_by_range(doc, {range_name})
          if "flash_decode" in name]
    return len(k7), sum(where is not None for where in k7)


def telemetry_phase(card, dev, serving, x) -> None:
    """Phase 12: ``repro_torch.obs`` on the serving path (phase 8's model and
    trace), the launcher's telemetry files, the cost of ``obs`` on a compressor
    round trip, and a span inside a CUDA graph capture. Raises on any failed
    check."""
    import contextlib
    import statistics
    import torch
    from torch.profiler import ProfilerActivity, profile
    import repro_torch as rt
    from repro_torch import obs
    from repro_torch.obs import cli as obs_cli
    from repro_torch.obs import spans
    from repro_torch.serve import Engine, PoolConfig
    from repro_torch.serve.kvpool import tracegen
    from repro_torch.serve.kvpool.pool import _POOL_METRICS
    from repro_torch.serve.kvpool.scheduler import _SCHED_METRICS

    t_phase = time.time()
    model, params, trace_cfg = serving["model"], serving["params"], serving["trace_cfg"]

    def serve_run():
        """The trace on the kernel route against a fresh registry and ring."""
        eng = Engine(model, params, pool=PoolConfig(**SERVE_POOL), device=dev)
        obs.reset()
        obs.clear_events()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, stats, pool = eng.serve(tracegen.generate(trace_cfg), max_batch=SERVE_LANES)
        torch.cuda.synchronize()
        return out, stats, pool, time.perf_counter() - t

    # -- the kernel route with telemetry on -----------------------------------
    out, st, pool, wall_on = serve_run()
    snap, events, violations, ps = obs.snapshot(), spans.events(), obs.violations(), pool.stats
    report = obs.step_report(meta={"card": card, "trace": "yi-6b, 8 requests"})
    counters, gauges = snap["counters"], snap["gauges"]
    n_tok = sum(len(v) for v in out.values())
    steps = counters.get("span_calls{span=sched.step}", 0)
    if len(events) >= spans.ring_capacity():
        raise AssertionError(f"the event ring overflowed ({len(events)} events)")
    checks = counters.get("sentinel_eb_checks{tier=kv_cold}", 0)
    samples = counters.get("sentinel_ratio_samples{tier=kv_cold}", 0)
    if checks < 1 or samples < 1 or violations:
        raise AssertionError(f"sentinels: {checks} kv_cold checks, {samples} ratio samples, "
                             f"violations {violations}")
    if "sched_running{subsystem=kvpool}" not in gauges or steps < st.decode_steps:
        raise AssertionError(f"the scheduler's health gate did not run every step ({steps} "
                             f"steps, {st.decode_steps} decode steps)")
    say(12, f"sentinels: {checks} sampled kv_cold checks of "
            f"{counters.get('sentinel_eb_considered{tier=kv_cold}', 0)} parks, worst last "
            f"max_err {gauges.get('sentinel_eb_last_max_err{tier=kv_cold}', 0.0):.4g}, "
            f"{samples} ratio samples (EWMA "
            f"{gauges.get('sentinel_ratio_ewma{tier=kv_cold}', 0.0):.3f}), violations "
            f"{violations}; assert_healthy() held at each of {steps} scheduler steps")
    for field, (kind, name) in _POOL_METRICS.items():
        got = (counters if kind == "counter" else gauges).get(f"{name}{{pool={pool._obs_id}}}", 0)
        if getattr(ps, field) != int(got):
            raise AssertionError(f"PoolStats.{field} {getattr(ps, field)} != registry {got}")
    for field, name in _SCHED_METRICS.items():
        got = [v for k, v in counters.items() if k.startswith(f"{name}{{batcher=")]
        if len(got) > 1 or getattr(st, field) != (got[0] if got else 0):
            raise AssertionError(f"TraceStats.{field} {getattr(st, field)} != registry {got}")
    fz_ops = {op: {k: v for k, v in counters.items() if k.startswith(f"fz_dispatches{{op={op},")}
              for op in ("compress", "decompress")}
    if (sum(fz_ops["compress"].values()) != ps.compress_dispatches
            or sum(fz_ops["decompress"].values()) != ps.decompress_dispatches):
        raise AssertionError(f"fz dispatches {fz_ops} != the pool's {ps.compress_dispatches} / "
                             f"{ps.decompress_dispatches}")
    if st != serving["plain_stats"]:
        raise AssertionError("the kernel route's TraceStats differ from phase 8's plain run")
    plain = serving["plain_snapshot"]["counters"]
    ours = {_strip_instance(k): v for k, v in counters.items() if k.startswith(("sched_", "kvpool_"))}
    theirs = {_strip_instance(k): v for k, v in plain.items() if k.startswith(("sched_", "kvpool_"))}
    if ours != theirs:
        raise AssertionError(f"sched_/kvpool_ counters differ: kernel {ours} vs plain {theirs}")
    plain_fz = {k: v for k, v in plain.items() if k.startswith("fz_dispatches")}
    if (not all("path=fused" in k for op in fz_ops.values() for k in op)
            or not all("path=reference" in k for k in plain_fz)
            or {k.replace("path=fused", "path=reference"): v for op in fz_ops.values()
                for k, v in op.items()} != plain_fz):
        raise AssertionError(f"fz_dispatches: kernel {fz_ops} vs plain {plain_fz}")
    say(12, f"PoolStats and TraceStats equal the registry; fz_dispatches {fz_ops} equal the "
            f"pool's ({ps.compress_dispatches} / {ps.decompress_dispatches}); {len(ours)} "
            f"sched_/kvpool_ counters equal the plain route's, fz path labels fused / reference")

    parents = {}
    for ev in events:
        parents.setdefault(ev["name"], set()).add(ev["parent"])
    pool_spans = {"kvpool.gather", "kvpool.park", "kvpool.cold_read"}
    fz_spans = {n for n in parents if n.startswith("fz.") and not n.startswith("fz.stage")}
    fz_calls = fz_spans - {"fz.used_bytes"}     # the pool's size reads nest in any step
    stages = [e for e in events if e["name"].startswith("fz.stage")]
    stage_parents = {e["parent"] for e in stages}
    if (parents.get("sched.step") != {"engine.serve"} or not pool_spans <= set(parents)
            or not all(parents[n] <= {"sched.step", "kvpool.gather"} for n in pool_spans)
            or not set().union(*(parents[n] for n in fz_calls)) <= pool_spans
            or not stage_parents & fz_calls or not stage_parents <= fz_calls | {"kvpool.park"}
            or not all(e["args"].get("backend") == "cuda" and e["cat"] == "span"
                       for e in stages)):
        raise AssertionError(f"span nesting: {parents}")
    say(12, f"span nesting engine.serve > sched.step > kvpool.{{gather,park,cold_read}} > "
            f"{sorted(fz_spans)} > {sorted({e['name'] for e in stages})} (backend cuda), "
            f"{len(events)} events")
    say(12, f"{card} | per-span host time of the kernel-route trace ({n_tok} tokens, "
            f"{st.decode_steps} decode steps, {wall_on:.2f} s, obs on):")
    for line in report.render().splitlines():
        say(12, "  " + line)

    # -- tokens/s with obs off, then the device idle share under the profiler --
    with obs.disabled():
        out_off, _, _, wall_off = serve_run()
    agree = sum(int((out_off[i] == out[i]).all()) for i in out)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, _, wall_prof = serve_run()
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    say(12, f"{card} | serving trace, kernel route: {n_tok / wall_on:.1f} tokens/s with obs on "
            f"({wall_on:.3f} s), {n_tok / wall_off:.1f} tokens/s under obs.disabled() "
            f"({wall_off:.3f} s), not gated (one run each: the host's spread is larger); "
            f"{agree} of {len(out)} requests token-identical. Under torch.profiler (CUDA): "
            f"{wall_prof:.3f} s, {busy_ms:.1f} ms of device time, idle share "
            f"{1 - busy_ms / (wall_prof * 1e3):.3f}")

    # -- the launcher's telemetry files ----------------------------------------
    TELEMETRY_DIR.mkdir(parents=True, exist_ok=True)
    trace_path, metrics_path = TELEMETRY_DIR / "serve_trace.json", TELEMETRY_DIR / "metrics.json"
    prof_dir = TELEMETRY_DIR / "profile"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-6b", "--smoke",
           "--paged", "--prompt-len", "32", "--tokens", "8", "--trace-out", str(trace_path), "--metrics-out", str(metrics_path),
           "--profile-dir", str(prof_dir)]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if proc.returncode != 0:
        raise AssertionError(f"the launcher failed ({proc.returncode}): {proc.stderr[-3000:]}")
    names = {e["name"] for e in json.loads(trace_path.read_text())["traceEvents"]
             if e["ph"] == "X"}
    metrics = json.loads(metrics_path.read_text())
    doc = json.loads((prof_dir / obs_cli.PROFILE_FILE).read_text())
    n_k7, n_in = k7_inside_ranges(doc, "engine.decode_step_paged")
    if not {"engine.serve", "sched.step"} <= names:
        raise AssertionError(f"the launcher's Chrome trace lacks engine.serve / sched.step: {names}")
    if metrics.get("sentinel_violations") != {}:
        raise AssertionError(f"the launcher's metrics: {metrics.get('sentinel_violations')}")
    if n_k7 == 0 or n_in != n_k7:
        raise AssertionError(f"{n_in} of {n_k7} K7 kernel events inside engine.decode_step_paged")
    say(12, f"launcher --trace-out / --metrics-out / --profile-dir in {time.time() - t0:.1f} s: "
            f"{len(names)} span names, sentinel_violations {{}}, "
            f"{metrics['counters'].get('sentinel_eb_checks{tier=kv_cold}', 0)} kv_cold checks; "
            f"{n_in} of {n_k7} K7 kernel events inside engine.decode_step_paged "
            f"({(prof_dir / obs_cli.PROFILE_FILE).stat().st_size / 1e6:.1f} MB trace)")

    # -- the cost of obs on a compressor round trip ----------------------------
    def per_call_us(fn, n=20000):
        fn()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) / n * 1e6

    def one_span():
        with obs.span("chip_smoke.span", n=1, path="fused"):
            pass
    span_on = per_call_us(one_span)
    with obs.disabled():
        span_off = per_call_us(one_span)
    say(12, f"{card} | one span alone: {span_on:.3f} us with obs on (its queued bookkeeping "
            f"included), {span_off:.3f} us under obs.disabled(); spans.trace_time() "
            f"{per_call_us(spans.trace_time):.3f} us")
    obs.reset()
    obs.clear_events()
    cfg = rt.FZConfig(eb=1e-3, exact_outliers=False)

    def round_trip(enabled):
        with contextlib.nullcontext() if enabled else obs.disabled():
            t = time.perf_counter()
            rt.decompress(rt.compress(x, cfg), cfg)
            torch.cuda.synchronize()
            return time.perf_counter() - t
    for _ in range(5):
        round_trip(True)
        round_trip(False)
    on, off = [], []
    for i in range(OBS_ROUND_TRIPS):
        for enabled in ((True, False) if i % 2 == 0 else (False, True)):
            (on if enabled else off).append(round_trip(enabled))
    med_on, med_off = statistics.median(on), statistics.median(off)
    frac = med_on / med_off - 1
    say(12, f"{card} | obs overhead on a fused paper-mode compress + decompress round trip "
            f"{tuple(x.shape)} f32 rel eb 1e-3 ({OBS_ROUND_TRIPS} interleaved each): median "
            f"{med_on * 1e3:.4f} ms on, {med_off * 1e3:.4f} ms off, overhead {100 * frac:.2f}% "
            f"(limit {100 * OBS_OVERHEAD_LIMIT:.0f}%); means {statistics.mean(on) * 1e3:.4f} / "
            f"{statistics.mean(off) * 1e3:.4f} ms (the queued bookkeeping lands in a few "
            f"calls); quartiles on "
            f"{[round(q * 1e3, 4) for q in statistics.quantiles(on, n=4)]}, off "
            f"{[round(q * 1e3, 4) for q in statistics.quantiles(off, n=4)]} ms")
    if frac >= OBS_OVERHEAD_LIMIT:
        raise AssertionError(f"obs costs {100 * frac:.2f}% of a round trip (limit "
                             f"{100 * OBS_OVERHEAD_LIMIT:.0f}%)")

    # -- a span inside a CUDA graph capture ------------------------------------
    obs.reset()
    obs.clear_events()
    a = torch.arange(1 << 20, dtype=torch.float32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):             # warm up off the capture
        b = a * 2 + 1
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        with obs.span("graph.body"):
            b = a * 2 + 1
    a.mul_(3)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    evs = [e for e in spans.events() if e["name"] == "graph.body"]
    if (not torch.equal(b, a * 2 + 1) or len(evs) != 1 or evs[0]["cat"] != "jit-trace"
            or obs.counter("span_traces", span="graph.body").value != 1
            or obs.counter("span_calls", span="graph.body").value != 0):
        raise AssertionError(f"a span in a CUDA graph capture: events {evs}, snapshot "
                             f"{obs.snapshot()['counters']}")
    say(12, "a span inside a CUDA graph capture recorded span_traces 1, one jit-trace event and "
            "no runtime timing; two replays equal the eager result")
    obs.reset()
    obs.clear_events()
    say(12, f"telemetry phase done in {time.time() - t_phase:.1f} s")


def wire_phase(card, dev) -> dict:
    """Phase 14: the gradient wire (``repro_torch.dist``) and checkpoints
    (``repro_torch.ckpt``) at Yi-6B's width. Returns each path's launches.
    Raises on any failed check."""
    import dataclasses
    import gc
    import socket
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    import repro_torch as rt
    from repro_torch import ckpt, configs, kernels, obs, pytree
    from repro_torch.ckpt import checkpoint
    from repro_torch.core import fz as fz_mod
    from repro_torch.dist import bucketed_reduce as bkt
    from repro_torch.dist import compat
    from repro_torch.dist import compressed_allreduce as car
    from repro_torch.dist import flash_decode as fdp
    from repro_torch.kernels import ref
    from repro_torch.models import transformer
    from repro_torch.models.attention import decode_attention

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.time()
    launches = {path: dict.fromkeys(kernels.WRAPPERS, 0)
                for path in ("reduce", "bucketed", "nccl", "shard", "checkpoint")}

    def drive(path, fn):
        kernels.reset_launch_counts()
        out = fn()
        for name, count in kernels.launch_counts().items():
            launches[path][name] += count
        return out

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else (
            t.view(torch.int32) if t.dtype == torch.float32 else t)

    def same_tree(a, b, what):
        la, lb = pytree.leaves_with_keys(a), pytree.leaves_with_keys(b)
        if [k for k, _ in la] != [k for k, _ in lb]:
            raise AssertionError(f"{what}: the trees' leaves differ")
        for (k, x), (_, y) in zip(la, lb):
            if x.shape != y.shape or not torch.equal(bits(x), bits(y.to(x.device))):
                raise AssertionError(f"{what}: leaf {k} differs")

    def synced(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # -- (a) Yi-6B's gradient tree at full width, cut in depth ---------------
    cfg_m = dataclasses.replace(configs.get("yi-6b"), n_layers=WIRE_LAYERS)
    abstract = pytree.tree_map(
        lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"),
        transformer.model_defs(cfg_m))
    n_pod = sum(t.numel() for t in pytree.leaves(abstract))
    if n_pod != WIRE_ELEMS:
        raise AssertionError(f"the cut tree has {n_pod} elements a pod, not {WIRE_ELEMS}")
    gen = torch.Generator(device=dev).manual_seed(0)
    g = pytree.tree_map(lambda a: torch.randn((WIRE_PODS,) + tuple(a.shape), generator=gen,
                                              device=dev), abstract)
    torch.cuda.synchronize()
    raw_bytes = 4 * n_pod * WIRE_PODS
    say(14, f"gradient tree: Yi-6B at full width, {WIRE_LAYERS} stacked layers of 32, "
            f"{n_pod:,} float32 elements a pod ({4 * n_pod / 1e9:.2f} GB), {WIRE_PODS} pods, "
            f"{len(pytree.leaves(g))} leaves; {torch.cuda.memory_allocated() / 1e9:.1f} GB "
            f"allocated on the card")

    # -- (b, c) barrier reduce (kernel route) against the plain route and the
    # bucketed form, three steps of error feedback each, on the same gradients
    gc_k = car.GradCompressionConfig(enabled=True)
    routes = {"plain": (dataclasses.replace(gc_k, use_kernels=False), car.reduce_stacked)}
    plans = {}
    for bb in WIRE_BUCKETS:
        cfg_b = dataclasses.replace(gc_k, overlap=True, bucket_bytes=bb)
        plans[bb] = bkt.assign_buckets(abstract, cfg_b)
        routes[f"bucketed {bb}"] = (cfg_b, lambda g_, e_, c_, p_=plans[bb]:
                                    bkt.reduce_stacked_bucketed(g_, e_, c_, plan=p_))
    eb = gc_k.eb
    reduce_s, route_s = [], {}
    for route, (cfg_o, reduce_o) in routes.items():
        err_k = car.init_error_state(abstract, WIRE_PODS, gc_k)
        err_o = car.init_error_state(abstract, WIRE_PODS, cfg_o)
        reds = []              # the first two rounds, for the bounds
        for step in range(WIRE_STEPS):
            (red_k, err_k), sec = synced(lambda: drive("reduce", lambda: car.reduce_stacked(
                g, err_k, gc_k)))
            reduce_s.append(sec)
            path = "bucketed" if route.startswith("bucketed") else None
            (red_o, err_o), sec = synced(lambda: drive(path, lambda: reduce_o(g, err_o, cfg_o))
                                         if path else reduce_o(g, err_o, cfg_o))
            route_s.setdefault(route, []).append(sec)
            same_tree(red_k, red_o, f"step {step}: reduced, kernel route vs {route}")
            same_tree(err_k, err_o, f"step {step}: error state, kernel route vs {route}")
            del red_o
            if route == "plain" and step < 2:
                reds.append(red_k)
            del red_k
        say(14, f"reduce_stacked on the kernel route == {route}, reduced tree and error state "
                f"bit for bit over {WIRE_STEPS} steps")
        if route == "plain":
            # the reference's bounds: one round within 2 eb range of the exact
            # mean, the mean of two rounds no worse (the same gradients each step)
            worst1 = worst2 = 0.0
            for key, gl in pytree.leaves_with_keys(g):
                exact = car.pod_mean([gl[p] for p in range(WIRE_PODS)])
                r1 = dict(pytree.leaves_with_keys(reds[0]))[key]
                r2 = dict(pytree.leaves_with_keys(reds[1]))[key]
                rng_ = float(gl.max() - gl.min())
                e1 = float((r1 - exact).abs().max())
                e2 = float(((r1 + r2) / 2 - exact).abs().max())
                if e1 > 2 * eb * rng_ or e2 > e1 + 1e-7:
                    raise AssertionError(f"{key}: one round {e1} (bound {2 * eb * rng_}), two "
                                         f"rounds {e2}")
                worst1, worst2 = max(worst1, e1 / (eb * rng_)), max(worst2, e2 / (eb * rng_))
            say(14, f"error bounds hold on every leaf: max|reduced - exact mean| / (eb range) "
                    f"{worst1:.4f} after one round (limit 2), {worst2:.4f} for the mean of two")
            del reds
        if route == f"bucketed {WIRE_BUCKETS[0]}":
            # host-included time of each bucket hop on the final error state
            plan, cfg_b = plans[WIRE_BUCKETS[0]], routes[route][0]
            gm, em = dict(pytree.leaves_with_keys(g)), dict(pytree.leaves_with_keys(err_o))
            hop_ms = []
            for b in plan.buckets:
                xs = [gm[k].reshape(WIRE_PODS, -1) + em[k].reshape(WIRE_PODS, -1) for k in b.keys]
                _, sec = synced(lambda: bkt._bucket_hop(xs, cfg_b.fz_config(), None, b.tag))
                hop_ms.append((b.tag, len(b.keys), sum(b.n_elems), sec * 1e3))
                del xs
            say(14, f"{card} | bucket hops at {WIRE_BUCKETS[0] >> 20} MiB ({plan.n_buckets} "
                    f"buckets, {WIRE_PODS} pods inline, host included): "
                    + ", ".join(f"{t} {n} leaves {e:,} el {ms:.2f} ms" for t, n, e, ms in hop_ms))
        del err_k, err_o
        gc.collect()
    wire = sum(car.wire_bytes_per_leaf(t.numel(), gc_k)["compressed"]
               for t in pytree.leaves(abstract) if t.numel() >= gc_k.min_leaf_size)
    gathered = sum(bkt.expected_cross_pod_bytes(plans[WIRE_BUCKETS[0]], gc_k, 1).values())
    best = min(reduce_s)
    say(14, f"{card} | reduce_stacked kernel route, {WIRE_PODS} pods inline: "
            f"{', '.join(f'{s * 1e3:.1f}' for s in reduce_s)} ms a step (host included), best "
            f"{best * 1e3:.1f} ms = {raw_bytes / best / 1e9:.1f} GB/s of raw float32 gradients; "
            + "; ".join(f"{r} {', '.join(f'{t * 1e3:.1f}' for t in ts)} ms"
                        for r, ts in route_s.items()))
    say(14, f"{card} | wire bytes a pod {wire:,} (gathered {gathered:,}) against raw float32 "
            f"{4 * n_pod:,}: {4 * n_pod / wire:.4f}x smaller at capacity_frac "
            f"{gc_k.capacity_frac}; plans: " + ", ".join(
                f"{bb >> 20} MiB -> {p.n_buckets} buckets" for bb, p in plans.items()))

    # K4 and K6 alone at the largest stream of the path: one pod's embed leaf
    x = g["embed"][0].reshape(-1)
    fzc = gc_k.fz_config()
    ebx, n = rt.resolve_eb(x, fzc), x.numel()
    cap = fzc.payload_capacity(n)
    bf, pl, _ = kernels.fused_compress(x, ebx, capacity=cap)
    k46 = {"fused_compress": (lambda: kernels.fused_compress(x, ebx, capacity=cap),
                              lambda: ref.fused_compress_ref(x, ebx, capacity=cap),
                              n * 4 + bf.numel() * 4 + cap * 16 + 4),
           "fused_decompress": (lambda: kernels.fused_decompress(bf, pl, ebx, shape=(n,)),
                                lambda: ref.fused_decompress_ref(bf, pl, ebx, shape=(n,)),
                                bf.numel() * 4 + pl.numel() * 2 + 4 + n * 4)}

    def event_ms(fn, iters):
        fn()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(iters):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / iters
    for name, (fn, plain, nbytes) in k46.items():
        ms, plain_ms = event_ms(fn, 5), event_ms(plain, 2)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        say(14, f"{card} | {name} at {n:,} elements (1-D f32, paper mode, capacity 1.0): "
                f"{ms:.4f} ms a launch, plain {plain_ms:.4f} ms, bound {bound:.4f} ms by bytes "
                f"({nbytes / 1e9:.3f} GB), {100 * bound / ms:.1f}% of bound")
    del x, bf, pl, k46

    # the subset on the card and on the CPU: layer 0's wk, final_norm, a bypass leaf
    sub = {"layers": {"wk": g["layers"]["wk"][:, 0].clone()},
           "final_norm": g["final_norm"].clone(), "bias": g["final_norm"][:, :8].clone()}
    sub_cpu = pytree.tree_map(lambda t: t.cpu(), sub)
    ab_sub = pytree.tree_map(lambda t: torch.empty(t.shape[1:], device="meta"), sub)
    e_card = car.init_error_state(ab_sub, WIRE_PODS, gc_k)
    e_cpu = car.init_error_state(ab_sub, WIRE_PODS, gc_k, device="cpu")
    t0 = time.time()
    for step in range(WIRE_STEPS):
        r_card, e_card = drive("reduce", lambda: car.reduce_stacked(sub, e_card, gc_k))
        r_cpu, e_cpu = car.reduce_stacked(sub_cpu, e_cpu, gc_k)
        same_tree(r_cpu, r_card, f"subset step {step}: reduced, CPU vs card")
        same_tree(e_cpu, e_card, f"subset step {step}: error state, CPU vs card")
    say(14, f"subset (layer 0 wk {sub['layers']['wk'][0].numel():,} elements, final_norm, a "
            f"bypass leaf): card == CPU route bit for bit over {WIRE_STEPS} steps "
            f"({time.time() - t0:.1f} s)")
    del sub, sub_cpu, e_card, e_cpu, r_card, r_cpu

    # -- (d) NCCL at world size 1: the distributed form against the inline one
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        mesh = compat.make_mesh((1,), ("pod",))
        g1 = pytree.tree_map(lambda t: t[:1], g)
        plan = plans[WIRE_BUCKETS[0]]
        cfg_b = dataclasses.replace(gc_k, overlap=True, bucket_bytes=WIRE_BUCKETS[0])
        red_i, err_i = car.reduce_stacked(g1, car.init_error_state(abstract, 1, gc_k), gc_k)
        obs.reset()
        (red_d, err_d), sec_d = synced(lambda: drive("nccl", lambda: car.reduce_stacked(
            g1, car.init_error_state(abstract, 1, gc_k), gc_k, mesh)))
        counted = car.gathered_bytes()
        counted.pop("bypass", None)           # small leaves' exact mean: in no bucket
        same_tree(red_i, red_d, "NCCL barrier reduce vs inline, reduced")
        same_tree(err_i, err_d, "NCCL barrier reduce vs inline, error state")
        expected = bkt.expected_cross_pod_bytes(plan, cfg_b, 1)
        if sum(counted.values()) != sum(expected.values()):
            raise AssertionError(f"NCCL barrier gathered {sum(counted.values())} bytes, the "
                                 f"model {sum(expected.values())}")
        del red_d, err_d
        obs.reset()
        (red_b, err_b), sec_b = synced(lambda: drive("nccl", lambda: bkt.reduce_stacked_bucketed(
            g1, car.init_error_state(abstract, 1, cfg_b), cfg_b, mesh, plan=plan)))
        counted = car.gathered_bytes()
        counted.pop("bypass", None)
        same_tree(red_i, red_b, "NCCL bucketed reduce vs inline, reduced")
        same_tree(err_i, err_b, "NCCL bucketed reduce vs inline, error state")
        if counted != expected:
            raise AssertionError(f"NCCL bucketed gathered {counted}, the model {expected}")
        del red_b, err_b, red_i, err_i, g1
        say(14, f"{card} | NCCL at world size 1: the barrier and bucketed reduce equal the "
                f"inline form at 1 pod bit for bit; the bytes each of the {plan.n_buckets} "
                f"buckets handed to all_gather equal expected_cross_pod_bytes "
                f"({sum(expected.values()):,} in all); barrier {sec_d * 1e3:.1f} ms, bucketed "
                f"{sec_b * 1e3:.1f} ms (host included)")

        # -- (e) flash_decode_shard: K7 partials at each offset, the factored combine
        rng = np.random.default_rng(0)
        B, H, KVH, D = FLASH_GEOMETRY
        S, shards = FLASH_POSITIONS, FLASH_SHARDS
        q = torch.from_numpy(rng.standard_normal((B, H, D), dtype=np.float32)).to(dev) \
            .to(torch.bfloat16)
        k = torch.from_numpy(rng.standard_normal((B, S, KVH, D), dtype=np.float32)).to(dev) \
            .to(torch.bfloat16)
        v = torch.from_numpy(rng.standard_normal((B, S, KVH, D), dtype=np.float32)).to(dev) \
            .to(torch.bfloat16)
        length = torch.tensor(FLASH_LENGTHS, dtype=torch.int32, device=dev)
        want = decode_attention(q.float(), k, v, length)
        s_sh = S // shards
        parts = drive("shard", lambda: [fdp.shard_partials(
            q, k[:, i * s_sh:(i + 1) * s_sh], v[:, i * s_sh:(i + 1) * s_sh], length,
            shard_offset=i * s_sh) for i in range(shards)])
        m_last, num_last, den_last = parts[-1]
        if max(FLASH_LENGTHS) > (shards - 1) * s_sh or not (
                bool((m_last == fdp.NEG_INF).all()) and not num_last.any() and not den_last.any()):
            raise AssertionError("the last shard is not empty: (m, num, den) != (-1e30, 0, 0)")
        got = fdp.combine_shards(parts)
        err_sh = float((got - want).abs().max())
        mesh_m = compat.make_mesh((1,), ("model",))
        whole = drive("shard", lambda: fdp.flash_decode_shard(q, k, v, length, mesh=mesh_m,
                                                              axis="model", shard_offset=0))
        one = fdp.combine_shards([fdp.shard_partials(q, k, v, length, shard_offset=0)], q.dtype)
        if err_sh > K7_TOL or not torch.equal(bits(whole), bits(one)):
            raise AssertionError(f"flash_decode_shard: combine max|err| {err_sh}; NCCL at world "
                                 "1 differs from the collective-free combine of one shard")
        say(14, f"flash_decode_shard at B {B}, H {H}, KVH {KVH}, D {D}, {S} positions, bf16, "
                f"lengths {FLASH_LENGTHS}: {shards} shards of {s_sh} through K7 (the last past "
                f"every length: exactly (-1e30, 0, 0)), combined by combine_shards, "
                f"max|err| {err_sh:.2e} vs the plain attention (limit {K7_TOL}); the whole cache "
                f"as one shard on NCCL (all_reduce MAX/SUM) == combine_shards of it, bit for bit")
    finally:
        dist.destroy_process_group()

    # -- (f) a checkpoint of one decoder layer of the reduced tree, plus a bf16 leaf
    red_k, _ = car.reduce_stacked(g, car.init_error_state(abstract, WIRE_PODS, gc_k), gc_k)
    del g
    layer = {name: red_k["layers"][name][0].contiguous() for name in red_k["layers"]}
    del red_k
    gc.collect()
    torch.cuda.empty_cache()
    layer["wk_bf16"] = layer["wk"].to(torch.bfloat16)
    n_ck = sum(t.numel() for n, t in layer.items() if t.dtype == torch.float32)
    timers = {"encode": 0.0, "decode": 0.0, "plan": 0.0}
    ent = fz_mod.ent
    originals = {name: getattr(ent, name) for name in timers}

    def timed(name):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return originals[name](*a, **kw)
            finally:
                timers[name] += time.perf_counter() - t
        return run
    with tempfile.TemporaryDirectory() as root:
        for name in timers:
            setattr(ent, name, timed(name))
        try:
            d, save_s = synced(lambda: drive("checkpoint", lambda: ckpt.save(
                root, 1, layer, codec="fz")))
            enc_s = timers["encode"] + timers["plan"]
            (back, _), restore_s = synced(lambda: drive("checkpoint", lambda: ckpt.restore(
                root, layer)))
            dec_s = timers["decode"]
        finally:
            for name, fn in originals.items():
                setattr(ent, name, fn)
        rep = checkpoint.compression_report(root, 1)
        worst = 0.0
        for name, x in layer.items():
            y = back[name]
            if x.dtype == torch.bfloat16:
                if not torch.equal(bits(x), bits(y)):
                    raise AssertionError(f"bf16 leaf {name} does not come back exact")
                continue
            ebl = float(rt.resolve_eb(x.reshape(-1), checkpoint._FZ_CKPT))
            rng_ = float(x.max() - x.min())
            err = float((y - x).abs().max())
            if err > ebl * 1.01 + rng_ * 2e-7:
                raise AssertionError(f"checkpoint leaf {name}: max err {err} past eb {ebl}")
            worst = max(worst, err / ebl)
        # the wk leaf's bytes, against the CPU port's save of the same leaf
        wk = layer["wk"]
        with tempfile.TemporaryDirectory() as r2, tempfile.TemporaryDirectory() as r3:
            d_card = ckpt.save(r2, 1, {"wk": wk}, codec="fz")
            d_cpu = ckpt.save(r3, 1, {"wk": wk.cpu()}, codec="fz", device="cpu")
            card_b = open(os.path.join(d_card, "leaf_000000.bin"), "rb").read()
            if card_b != open(os.path.join(d_cpu, "leaf_000000.bin"), "rb").read():
                raise AssertionError("the wk leaf's file differs between the card and the CPU")
            in_layer = os.path.join(d, f"leaf_{sorted(layer).index('wk'):06d}.bin")
            if open(in_layer, "rb").read() != card_b:
                raise AssertionError("the wk leaf's file in the layer's checkpoint differs")
        say(14, f"{card} | checkpoint of {sorted(layer)} ({n_ck:,} float32 elements, "
                f"{4 * n_ck / 1e9:.3f} GB, codec fz, strict eb 1e-5 rel): save {save_s:.2f} s "
                f"(host entropy probe + encode {enc_s:.2f} s), restore {restore_s:.2f} s (host "
                f"entropy decode {dec_s:.2f} s); compression_report ratio {rep['ratio']:.4f} "
                f"({rep['raw_bytes']:,} -> {rep['stored_bytes']:,} bytes); max_err/eb "
                f"{worst:.4f}; bf16 leaf exact; the wk leaf's file == the CPU port's")
    del layer, back
    for path, counts in launches.items():
        say(14, f"launches on the {path} path: {counts}")
    need = {"reduce": ("fused_compress", "fused_decompress"),
            "bucketed": ("fused_compress", "fused_decompress"),
            "nccl": ("fused_compress", "fused_decompress"),
            "shard": ("flash_decode",),
            "checkpoint": ("fused_compress_strict", "fused_decompress")}
    for path, names in need.items():
        for name in names:
            if launches[path][name] <= 0:
                raise AssertionError(f"{name} was not launched on the {path} path")
    gc.collect()
    torch.cuda.empty_cache()
    say(14, f"wire and checkpoint phase done in {time.time() - t_phase:.1f} s")
    return launches


KERNEL_KINDS = (                  # (kind, substrings of the profiler's kernel names)
    ("K4 encode_tiles", ("encode_tiles",)),
    ("K6 decode_scan_rows/bin_residuals/scan_columns",
     ("decode_scan_rows", "bin_residuals", "scan_columns")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
    ("NCCL", ("nccl",)),
    ("sort (embedding backward)", ("RadixSort", "radix_sort", "embedding")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise_kernel",)),
    ("copies and fills", ("Memcpy", "Memset", "copy", "fill")),
)


def kernel_kind(name: str) -> str:
    for kind, keys in KERNEL_KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def hop_overlap(prof) -> tuple[float, float, float]:
    """From a profile's kernel intervals by CUDA stream: the main stream (the one
    with the most device time) against every other stream (the overlap form's
    side stream and NCCL's). Returns (hop ms: the union of the other streams'
    intervals, main ms: the union of the main stream's, and the ms of hop time
    that ran while the main stream was busy)."""
    per: dict = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            per.setdefault(e.device_resource_id, []).append((e.time_range.start,
                                                             e.time_range.end))
    if not per:
        return 0.0, 0.0, 0.0
    main = max(per, key=lambda sid: sum(t1 - t0 for t0, t1 in per[sid]))

    def union(spans):
        out = []
        for t0, t1 in sorted(spans):
            if out and t0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t1)
            else:
                out.append([t0, t1])
        return out
    m = union(per[main])
    h = union([s for sid, spans in per.items() if sid != main for s in spans])
    inter, i, j = 0.0, 0, 0
    while i < len(m) and j < len(h):
        lo, hi = max(m[i][0], h[j][0]), min(m[i][1], h[j][1])
        inter += max(0.0, hi - lo)
        if m[i][1] < h[j][1]:
            i += 1
        else:
            j += 1
    total = lambda spans: sum(t1 - t0 for t0, t1 in spans) / 1e3  # noqa: E731
    return total(h), total(m), inter / 1e3


def train_phase(card, dev) -> dict:
    """Phase 15: training (``repro_torch.train``) at Yi-6B's width through
    ``Trainer.run`` on a one-rank NCCL pod mesh, the compressed gradient mean
    on. Returns each path's launches. Raises on any failed check."""
    import dataclasses
    import gc
    import re
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    import repro_torch as rt
    from repro_torch import configs, kernels, pytree
    from repro_torch.ckpt import checkpoint
    from repro_torch.configs.base import SHAPES, ShapeConfig
    from repro_torch.data.tokens import TokenStream
    from repro_torch.dist import compressed_allreduce as car
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import zoo
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train import step as step_mod

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.time()
    launches = {path: dict.fromkeys(kernels.WRAPPERS, 0)
                for path in ("train", "plain", "overlap", "resume", "launcher")}

    def log(msg):
        say(15, f"{card} | {msg}")

    def drive(path, fn):
        kernels.reset_launch_counts()
        out = fn()
        counts = kernels.launch_counts()
        for name, count in counts.items():
            launches[path][name] += count
        return out, counts

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else (
            t.view(torch.int32) if t.dtype == torch.float32 else t)

    def same_tree(a, b, what):
        la, lb = pytree.leaves_with_keys(a), pytree.leaves_with_keys(b)
        if [k for k, _ in la] != [k for k, _ in lb]:
            raise AssertionError(f"{what}: the trees' leaves differ")
        for (k, x), (_, y) in zip(la, lb):
            same = (x.shape == y.shape and torch.equal(bits(x), bits(y))
                    if isinstance(x, torch.Tensor) else x == y)
            if not same:
                raise AssertionError(f"{what}: leaf {k} differs")

    def finite(hist, what):
        for m in hist:
            if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
                raise AssertionError(f"{what}: step {m['step']} loss {m['loss']} grad_norm "
                                     f"{m['grad_norm']}")

    full = configs.get("yi-6b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    model = zoo.build(cfg)
    shape = ShapeConfig(*TRAIN_SHAPE)
    stream = TokenStream(cfg.vocab, shape.seq_len, shape.global_batch, seed=0)
    gc_k = car.GradCompressionConfig(enabled=True)     # rel eb 1e-4, paper, capacity 1.0
    n_fz = sum(1 for t in pytree.leaves(model.abstract_params())
               if t.dtype.is_floating_point and t.numel() >= gc_k.min_leaf_size)

    def tcfg(gcc):
        return TrainConfig(grad_compress=gcc, total_steps=TRAIN_TOTAL, warmup_steps=1)
    fresh_group = not dist.is_initialized()       # the first step starts its communicator
    mesh = lmesh.make_mesh((1, 1, 1), ("pod", "data", "model"), device=dev)
    try:
        p0 = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        log(f"Yi-6B at its published width (d_model {cfg.d_model}, {cfg.n_heads} heads, "
            f"{cfg.n_kv_heads} KV heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}); cuts: depth "
            f"{full.n_layers} -> {cfg.n_layers} layers ({model.param_count():,} parameters), "
            f"global batch {SHAPES['train_4k'].global_batch} -> {shape.global_batch} at "
            f"train_4k's seq_len {shape.seq_len} ({shape}); {n_fz} leaves past min_leaf_size; "
            f"mesh make_mesh((1, 1, 1), ('pod', 'data', 'model')) = {lmesh.mesh_shape(mesh)} "
            f"on {dist.get_backend()} at world size {dist.get_world_size()} (make_local_mesh("
            f"pods=1) has no pod axis and never compresses); GradCompressionConfig(enabled="
            f"True): eb {gc_k.eb} {gc_k.eb_mode}, paper mode, capacity {gc_k.capacity_frac}, "
            f"min_leaf_size {gc_k.min_leaf_size}; TokenStream seed 0, weights from "
            f"torch.Generator seed 0")

        def trainer(gcc, state=None):
            t = Trainer(model, shape, mesh, tcfg(gcc), stream=stream,
                        init_params=p0 if state is None else state["params"], device=dev)
            if state is not None:
                t.opt, t.err, t.step = state["opt"], state["err"], int(state["step"])
            return t

        def state_of(t):
            return dict(t._state(), step=t.step)

        def run(t, path, n=1):
            hist = []
            for _ in range(n):
                (h,), counts = drive(path, lambda: t.run(1)[-1:])
                hist.append(h)
                if path != "plain":
                    if not (counts["fused_compress"] == counts["fused_decompress"] == n_fz):
                        raise AssertionError(f"step {h['step']} on the {path} path launched "
                                             f"{counts}, not K4 = K6 = {n_fz}")
                elif any(counts.values()):
                    raise AssertionError(f"the plain route launched kernels: {counts}")
            finite(hist, path)
            return hist

        noise = {path: {"cudaMalloc": [], "retries": [], "gc_ms": []}
                 for path in ("train", "overlap")}
        gc_ms, gc_t0 = [0.0], [0.0]

        def gc_clock(phase, info):
            if phase == "start":
                gc_t0[0] = time.perf_counter()
            else:
                gc_ms[0] += (time.perf_counter() - gc_t0[0]) * 1e3

        def timed(t, path):
            """One step: (metrics, ms by CUDA events with the host's share). Keeps
            what may stretch a step: the caching allocator's cudaMalloc calls and
            retries (a retry frees its cache and waits for the card), and the
            host's Python garbage collection."""
            s0, gc_ms[0] = torch.cuda.memory_stats(), 0.0
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            gc.callbacks.append(gc_clock)
            try:
                e0.record()
                (h,) = run(t, path)
                e1.record()
                torch.cuda.synchronize()
            finally:
                gc.callbacks.remove(gc_clock)
            s1 = torch.cuda.memory_stats()
            for key, stat in (("cudaMalloc", "num_device_alloc"),
                              ("retries", "num_alloc_retries")):
                noise[path][key].append(s1.get(stat, 0) - s0.get(stat, 0))
            noise[path]["gc_ms"].append(round(gc_ms[0], 1))
            return h, e0.elapsed_time(e1)

        def warm_up(t, path, form):
            """The first step of a form, reported on its own line and never in a rate."""
            libs, stats = set(build._loaded), torch.cuda.memory_stats()
            t0 = time.perf_counter()
            h, ms = timed(t, path)
            wall = time.perf_counter() - t0
            new_libs = sorted(set(build._loaded) - libs)
            after = torch.cuda.memory_stats()
            grow = (after["reserved_bytes.all.current"] - stats["reserved_bytes.all.current"])
            log(f"warm-up: the {form} form's first step (step {h['step']}) {ms:.1f} ms (CUDA "
                f"events), {wall * 1e3:.1f} ms host; it held: kernel libraries built or loaded "
                f"{new_libs or 'none (built earlier)'}"
                + ("; the NCCL communicator's start (the group's first collective)"
                   if form == "barrier" and fresh_group else "; no NCCL start")
                + f"; the caching allocator reserving {grow / 1e9:.2f} GB in "
                f"{after['num_device_alloc'] - stats['num_device_alloc']} cudaMalloc calls. "
                f"Not in any rate.")
            return h

        # -- (2) kernel route vs plain route: two steps each from the same start
        t_b = trainer(gc_k)
        hist_k = [warm_up(t_b, "train", "barrier")] + run(t_b, "train")
        s2 = state_of(t_b)
        t_p = trainer(dataclasses.replace(gc_k, use_kernels=False))
        hist_p = run(t_p, "plain", 2)
        same_tree(s2, state_of(t_p), "2 steps, kernel route vs plain route")
        if [m["loss"] for m in hist_k] != [m["loss"] for m in hist_p]:
            raise AssertionError("the plain route's losses differ from the kernel route's")
        del t_p
        gc.collect()
        log("kernel route (K4/K6) == plain route (use_kernels=False) after 2 steps from the "
            "same start: params, optimizer and error state bit for bit; loss "
            + ", ".join(f"{m['loss']:.6f}" for m in hist_k) + ", grad_norm "
            + ", ".join(f"{m['grad_norm']:.6f}" for m in hist_k))

        # -- (3, 4) overlap vs barrier from the same state, in turn; the overlap
        # form's first step is its warm-up, then TRAIN_TIMED timed steps of each
        t_o = trainer(dataclasses.replace(gc_k, overlap=True, bucket_bytes=TRAIN_BUCKET), s2)
        del s2
        n_buckets = t_o.info["plan"].n_buckets
        hist_o, hist_b = [warm_up(t_o, "overlap", "overlap")], []
        ms = {"barrier": [], "overlap": []}
        for i in range(TRAIN_TIMED):
            h, step_ms = timed(t_b, "train")
            hist_b.append(h)
            ms["barrier"].append(step_ms)
            if i == TRAIN_TIMED - 1:           # both forms TRAIN_TIMED steps past s2
                same_tree(state_of(t_b), state_of(t_o), f"{TRAIN_TIMED} steps, barrier vs "
                          "overlap")
                if [m["loss"] for m in hist_o] != [m["loss"] for m in hist_b]:
                    raise AssertionError("the overlap form's losses differ from the barrier's")
            h, step_ms = timed(t_o, "overlap")
            hist_o.append(h)
            ms["overlap"].append(step_ms)
        log(f"overlap form ({n_buckets} buckets of {TRAIN_BUCKET >> 20} MiB, each issued from "
            f"the backward on a side stream) == barrier form after {TRAIN_TIMED} steps each "
            f"from the same state: params, optimizer and error state bit for bit; loss "
            + ", ".join(f"{m['loss']:.6f}" for m in hist_b) + ", grad_norm "
            + ", ".join(f"{m['grad_norm']:.6f}" for m in hist_b))
        for form, path in (("barrier", "train"), ("overlap", "overlap")):
            mean, median = sum(ms[form]) / len(ms[form]), float(np.median(ms[form]))
            log(f"{form} form, {TRAIN_TIMED} steps in turn with the other form after its "
                f"warm-up (CUDA events, host included): " + ", ".join(
                    f"{x:.2f}" for x in ms[form]) + f" ms, mean {mean:.2f} ms = "
                f"{shape.tokens / mean * 1e3:.0f} tokens/s, median {median:.2f} ms = "
                f"{shape.tokens / median * 1e3:.0f} tokens/s ({shape.tokens} tokens a step); "
                f"per step, the warm-up first: {noise[path]}")
        log(f"overlap / barrier time {sum(ms['overlap']) / sum(ms['barrier']):.4f}")

        # -- the split of one barrier step: synchronised host timers around each part
        split = dict.fromkeys(("forward+backward", "reduce", "AdamW"), 0.0)
        patches = [(step_mod, "_loss_and_grads", "forward+backward"),
                   (car, "reduce_stacked", "reduce"), (step_mod, "adamw_update", "AdamW")]
        originals = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]

        def split_timer(key, fn):
            def call(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                split[key] += time.perf_counter() - t0
                return out
            return call
        for (mod, name, key), (_, _, fn) in zip(patches, originals):
            setattr(mod, name, split_timer(key, fn))
        try:
            (h_split,) = run(t_b, "train")
        finally:
            for mod, name, fn in originals:
                setattr(mod, name, fn)
        log(f"split of step {h_split['step']} of the barrier form (synchronised host timers): "
            + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in split.items())
            + f", rest {(h_split['seconds'] - sum(split.values())) * 1e3:.1f} ms of "
            f"{h_split['seconds'] * 1e3:.1f} ms")

        # -- one step of each form under torch.profiler
        for form, t, path in (("barrier", t_b, "train"), ("overlap", t_o, "overlap")):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                (h,) = run(t, path)
            wall_ms = h["seconds"] * 1e3
            busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
            hop_ms, main_ms, beside_ms = hop_overlap(prof)
            if form == "barrier":
                by_kind: dict[str, list] = {}
                for e in prof.key_averages():
                    if e.self_device_time_total > 0:
                        acc = by_kind.setdefault(kernel_kind(e.key), [0.0, 0])
                        acc[0] += e.self_device_time_total / 1e3
                        acc[1] += e.count
                log(f"one barrier step under torch.profiler: {wall_ms:.1f} ms host, "
                    f"{busy_ms:.1f} ms of device time, idle share "
                    f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; device ms by kind (launches): "
                    + "; ".join(f"{kind} {v:.2f} ({n})" for kind, (v, n) in
                                sorted(by_kind.items(), key=lambda kv: -kv[1][0])))
            else:
                log(f"one overlap step under torch.profiler: {wall_ms:.1f} ms host; the hops "
                    f"(side stream and NCCL) busy {hop_ms:.2f} ms, of which {beside_ms:.2f} ms "
                    f"ran while the main stream computed (share "
                    f"{beside_ms / max(hop_ms, 1e-9):.3f}); main stream busy {main_ms:.1f} ms. "
                    f"At world size 1 there is no wire to hide: nothing is gained and none "
                    f"is claimed")
        peak = torch.cuda.max_memory_allocated()
        log(f"peak {peak / 1e9:.2f} GB allocated (torch.cuda.max_memory_allocated; two "
            f"trainers' states on the card during the turns)")
        if peak > TRAIN_PEAK_LIMIT:
            raise AssertionError(f"peak {peak / 1e9:.2f} GB passes {TRAIN_PEAK_LIMIT / 1e9} GB: "
                                 "cut the batch")
        del t_b, t_o, p0
        gc.collect()
        torch.cuda.empty_cache()

        log(f"full-width part done in {time.time() - t_phase:.1f} s")
        t_resume = time.time()

        # -- (5) resume at Yi-6B SMOKE size on the same pod mesh
        scfg = configs.get("yi-6b", smoke=True)
        smodel = zoo.build(scfg)
        sshape = ShapeConfig("smoke", 128, 8, "train")
        sstream = TokenStream(scfg.vocab, sshape.seq_len, sshape.global_batch, seed=0)
        sp0 = smodel.init(torch.Generator(device=dev).manual_seed(0), device=dev)

        def strainer(root, codec="raw"):
            return Trainer(smodel, sshape, mesh, tcfg(gc_k), stream=sstream, init_params=sp0,
                           ckpt_dir=root, ckpt_every=100, ckpt_codec=codec, device=dev)
        with tempfile.TemporaryDirectory() as root:
            drive("resume", lambda: strainer(root).run(4))
            t2, _ = drive("resume", lambda: strainer(root))
            if t2.step != 4:
                raise AssertionError(f"the restarted trainer is at step {t2.step}, not 4")
            h2, _ = drive("resume", lambda: t2.run(2))
            h6, _ = drive("resume", lambda: strainer(None).run(6))
            if [m["loss"] for m in h2] != [m["loss"] for m in h6][4:]:
                raise AssertionError(f"resume: {[m['loss'] for m in h2]} != "
                                     f"{[m['loss'] for m in h6][4:]}")
        with tempfile.TemporaryDirectory() as root:
            t1 = strainer(root, "fz")
            drive("resume", lambda: t1.run(4))
            t2, _ = drive("resume", lambda: strainer(root, "fz"))
            # every FZ leaf equals the plain route's round trip of the same leaf
            # (the plain route's files are the reference's, byte for byte:
            # tests/test_torch_train_resume.py); then each is held to its bound
            plain = dataclasses.replace(checkpoint._FZ_CKPT, use_kernels=False)
            worst, n_within, past = 0.0, 0, []
            for (k, a), b in zip(pytree.leaves_with_keys(t2._state()),
                                 pytree.leaves(t1._state())):
                if a.dtype == torch.float32 and a.numel() >= checkpoint._MIN_FZ_SIZE:
                    x = b.reshape(-1)
                    want = rt.decompress(rt.compress(x, plain, device=dev), plain, device=dev)
                    if not torch.equal(bits(a.reshape(-1)), bits(want)):
                        raise AssertionError(f"fz restore: {k} differs from the plain route")
                    eb = 1e-5 * float(x.max() - x.min())
                    ratio = float((a.reshape(-1) - x).abs().max()) / eb
                    if ratio <= 1.01 + 2e-2:        # the reference test's slack: 1% + 2e-7 range
                        worst, n_within = max(worst, ratio), n_within + 1
                    else:
                        past.append(f"{k} {ratio:.3g} eb")
                elif not torch.equal(bits(a), bits(b)):
                    raise AssertionError(f"fz restore: raw leaf {k} differs")
            if any(not k.startswith("['err']") for k in past):
                raise AssertionError(f"fz restore: a leaf other than the error state past its "
                                     f"bound: {past}")
        for name in ("fused_compress", "fused_compress_strict", "fused_decompress"):
            if launches["resume"][name] <= 0:
                raise AssertionError(f"{name} was not launched on the resume path")
        log(f"resume at {scfg.arch_id} ({sshape}) on the same pod mesh: 4 steps + restart + "
            f"2 == 6 steps, losses bit for bit (raw codec); codec fz: every FZ leaf == the "
            f"plain route's round trip bit for bit, {n_within} within their bound (max_err/eb "
            f"{worst:.4f}), {len(past)} past it, as the reference's round trip of the same "
            f"tree is (strict mode's outlier channel overflows on the residuals' noise): "
            + ", ".join(past) + f"; the rest bit for bit; {time.time() - t_resume:.1f} s")
    finally:
        if fresh_group:
            dist.destroy_process_group()

    # -- (6) the launcher's entry point, twice on one directory: the second run
    # resumes at step 4 (in this process, so its launches are counted)
    import contextlib
    import io
    from repro_torch.launch import train as launch_train
    step_line = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) \((\d+\.\d\d)s\)$")
    t_launch = time.time()
    with tempfile.TemporaryDirectory() as root:
        outs = []
        for steps in (4, 6):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                drive("launcher", lambda: launch_train.main([
                    "--arch", "yi-6b", "--smoke", "--steps", str(steps), "--ckpt-codec", "fz",
                    "--ckpt-dir", root]))
            outs.append(buf.getvalue().splitlines())
    head = "yi-6b-smoke: 0.4M params, mesh={'data': 1, 'model': 1}, reduce=exact, resume_step="
    steps_seen = [[int(m[1]) for m in map(step_line.match, o[1:]) if m] for o in outs]
    if (outs[0][0] != head + "0" or outs[1][0] != head + "4"
            or steps_seen != [[0, 1, 2, 3], [4, 5]]
            or not all(step_line.match(line) for o in outs for line in o[1:])):
        raise AssertionError(f"the launcher printed {outs}")
    log(f"launcher (repro_torch.launch.train.main, the entry point of python -m "
        f"repro_torch.launch.train): --arch yi-6b --smoke --steps 4 --ckpt-codec fz --ckpt-dir "
        f"D, then --steps 6: " + " | ".join(o[0] for o in outs) + f"; the reference's line "
        f"format; {time.time() - t_launch:.1f} s")
    for path, counts in launches.items():
        log(f"launches on the {path} path: {counts}")
    for path, names in (("train", ("fused_compress", "fused_decompress")),
                        ("overlap", ("fused_compress", "fused_decompress")),
                        ("resume", ("fused_compress", "fused_compress_strict",
                                    "fused_decompress")),
                        ("launcher", ("fused_compress_strict", "fused_decompress"))):
        for name in names:
            if launches[path][name] <= 0:
                raise AssertionError(f"{name} was not launched on the {path} path")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"train phase done in {time.time() - t_phase:.1f} s")
    return launches


def launch_recorder(launches: dict):
    """(drive, plain): ``drive(path, fn)`` runs ``fn`` with the launch counts set
    to 0 just before and adds them to ``launches[path]`` just after;
    ``plain(fn, what)`` runs a plain-route ``fn``, in which no kernel may launch."""
    from repro_torch import kernels

    def drive(path, fn):
        kernels.reset_launch_counts()
        out = fn()
        for name, count in kernels.launch_counts().items():
            launches[path][name] += count
        return out

    def plain(fn, what):
        kernels.reset_launch_counts()
        out = fn()
        if any(kernels.launch_counts().values()):
            raise AssertionError(f"the plain route of {what} launched {kernels.launch_counts()}")
        return out
    return drive, plain


def same(a, b) -> bool:
    """Equal shape, type and bits (NaN included)."""
    import torch

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else (
            t.view(torch.int32) if t.dtype == torch.float32 else t)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def fresh():
    """Free what the last model left and restart the peak-memory count."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def zoo_phase(card, dev) -> dict:
    """Phase 16: the MoE and M-RoPE decoders at their published widths, each cut
    to ``ZOO_LAYERS`` layers, one model at a time. Returns each path's launches."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs, kernels, pytree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import fz
    from repro_torch.data.tokens import TokenStream
    from repro_torch.dist import compressed_allreduce as car
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import moe, zoo
    from repro_torch.serve import Engine, KVCompressionConfig, PoolConfig
    from repro_torch.serve.kvpool import tracegen
    from repro_torch.train import TrainConfig, Trainer

    t_phase = time.time()
    launches = {path: dict.fromkeys(kernels.WRAPPERS, 0)
                for path in (*ZOO_SERVED, ZOO_VLM, "moe-train")}
    drive, plain = launch_recorder(launches)

    def build(arch):
        full = configs.get(arch)
        cfg = dataclasses.replace(full, n_layers=ZOO_LAYERS)
        model = zoo.build(cfg)
        t0 = time.time()
        params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        nbytes = sum(t.numel() * t.element_size() for t in pytree.leaves(params))
        ffn = (f"{cfg.n_experts} experts top-{cfg.top_k}"
               + (" + a shared expert" if cfg.shared_expert else "")
               + f" of d_ff {cfg.d_ff}, capacity factor {cfg.capacity_factor}"
               if cfg.n_experts else f"d_ff {cfg.d_ff}, M-RoPE sections {cfg.mrope_sections}")
        say(16, f"{card} | {arch} at its published width (d_model {cfg.d_model}, "
                f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads (G "
                f"{cfg.n_heads // cfg.n_kv_heads}), head_dim {cfg.hd}, {ffn}, vocab "
                f"{cfg.vocab}); cut: depth {full.n_layers} -> {cfg.n_layers} layers: "
                f"{model.param_count():,} parameters ({model.active_param_count():,} active a "
                f"token), {nbytes / 1e9:.2f} GB, random from torch.Generator seed 0 on the card "
                f"in {time.time() - t0:.2f} s")
        return cfg, model, params

    # -- 16a, 16b: the MoE decoders through the paged pool, K7 and K4/K6 ------
    trace_cfg = tracegen.TraceGenConfig(**SERVE_TRACE)
    reqs = tracegen.generate(trace_cfg)
    groups = {"K7 flash_decode": ("flash_decode",),
              "K6 cold-page decode": ("decode_scan_rows", "bin_residuals", "scan_columns"),
              "other GEMMs (projections, unembed)": (
                  "gemm", "nvjet", "sm90", "cutlass", "xmma", "cublas", "Kernel2"),
              "copies (page gather, stacking)": ("copy", "Copy", "cat", "Cat", "stack")}
    for arch in ZOO_SERVED:
        fresh()
        t0 = time.time()
        cfg, model, params = build(arch)
        held = hold_served(16, card, dev, model, params, trace_cfg,
                           lambda fn, arch=arch: drive(arch, fn), launches[arch])
        pset = page_set(16, dev, model, params, reqs)
        eng_k, pool, pages, lanes, tokens = (pset[k] for k in (
            "eng_k", "pool", "pages", "lanes", "tokens"))

        def step():
            return eng_k.decode_step_paged(pool.gather_pages(lanes), tokens)

        step_ms = cuda_ms(step, iters=10)
        decode_ms = cuda_ms(lambda: eng_k.decode_step_paged(pages, tokens), iters=10)
        # one profiled step: the MoE's router and its experts each in a named range
        ranges = {"moe.route": moe.route, "moe.experts": moe.experts}

        def ranged(name, fn):
            def call(*a, **k):
                with torch.profiler.record_function(name):
                    return fn(*a, **k)
            return call
        step()
        torch.cuda.synchronize()
        for name, fn in ranges.items():
            setattr(moe, name.split(".")[1], ranged(name, fn))
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                step()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t) * 1e3
        finally:
            for name, fn in ranges.items():
                setattr(moe, name.split(".")[1], fn)
        with tempfile.TemporaryDirectory() as tmp:
            prof.export_chrome_trace(f"{tmp}/step.json")
            with open(f"{tmp}/step.json") as f:
                kern = kernels_by_range(json.load(f), ranges)
        split = dict.fromkeys(["expert einsums (moe.experts)", "router and dispatch (moe.route)",
                               *groups, "other"], 0.0)
        for name, us, where in kern:
            key = ("expert einsums (moe.experts)" if where == "moe.experts" else
                   "router and dispatch (moe.route)" if where == "moe.route" else
                   next((g for g, keys in groups.items() if any(k in name for k in keys)),
                        "other"))
            split[key] += us
        busy_ms = sum(split.values()) / 1e3
        experts_floor = ZOO_LAYERS * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff * 2 \
            / HBM_BYTES_PER_S * 1e3
        st = held["stats"]
        say(16, f"{card} | {arch}: {held['n_tok'] / held['wall_k']:.1f} tokens/s over the trace "
                f"({1e3 * held['wall_k'] / st.decode_steps:.1f} ms a decode step, prefills "
                f"included); one step on the page set ({SERVE_LANES} lanes, lengths "
                f"{pages['length'].tolist()}): gather + decode {step_ms:.3f} ms, decode alone "
                f"{decode_ms:.3f} ms")
        if busy_ms:
            say(16, f"{card} | {arch} device time of one gather + decode step under "
                    f"torch.profiler ({len(kern)} kernels): " + ", ".join(
                        f"{name} {us / 1e3:.3f} ms ({100 * us / 1e3 / busy_ms:.1f}%)"
                        for name, us in split.items())
                    + f"; busy {busy_ms:.3f} ms of {wall_ms:.3f} ms, idle share "
                      f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; the experts read all "
                      f"{cfg.n_experts} experts' weights of {ZOO_LAYERS} layers at capacity "
                      f"{max(1, int(SERVE_LANES * cfg.top_k * cfg.capacity_factor / cfg.n_experts))}"
                      f" a expert, {experts_floor:.3f} ms at the memory rate")
        else:
            say(16, "step split not measured (the profiler saw no device time)")
        say(16, f"{card} | {arch}: peak allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} "
                f"GB; launches {launches[arch]}; {arch} done in {time.time() - t0:.1f} s")
        del model, params, held, pset, eng_k, pool, pages, prof

    # -- 16c: qwen2-vl through the whole cache, parked by K4 and resumed by K6 -
    fresh()
    t0 = time.time()
    cfg, model, params = build(ZOO_VLM)
    try:
        Engine(model, params, pool=PoolConfig(**SERVE_POOL), device=dev).make_pool()
    except NotImplementedError as e:
        say(16, f"{ZOO_VLM}: make_pool refuses the paged pool, as the reference's: {e}")
    else:
        raise AssertionError(f"{ZOO_VLM}: make_pool built a paged pool for M-RoPE")
    B, S, n_new = VLM_GENERATE
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
             "positions": np.broadcast_to(np.arange(S, dtype=np.int32), (B, 3, S)).copy()}
    runs = {}
    for use_kernels in (True, False):
        eng = Engine(model, params, device=dev, kv_compress=KVCompressionConfig(
            enabled=True, eb=1e-4, use_kernels=use_kernels))
        seen, park = [], eng.park

        def rec_park(cache, park=park, seen=seen):
            parked = park(cache)
            seen.append((cache, parked))
            return parked
        eng.park = rec_park
        torch.cuda.synchronize()
        t = time.perf_counter()
        gen = lambda eng=eng: eng.generate(batch, n_new, park_between=True)   # noqa: E731
        toks, cache = drive(ZOO_VLM, gen) if use_kernels else plain(gen, ZOO_VLM)
        torch.cuda.synchronize()
        runs[use_kernels] = (toks, cache, seen, time.perf_counter() - t, eng)
    (toks_k, cache_k, seen_k, wall_k, eng_k), (toks_p, cache_p, seen_p, wall_p, _) = \
        runs[True], runs[False]
    if not (torch.equal(toks_k, toks_p) and all(same(cache_k[n], cache_p[n]) for n in cache_k)):
        raise AssertionError(f"{ZOO_VLM}: the kernel route's tokens or cache differ from the "
                             "plain route's")
    plain_fz = KVCompressionConfig(enabled=True, eb=1e-4, use_kernels=False).fz_config()
    worst, n_leaves = 0.0, 0
    for (raw, pk), (_, pp) in zip(seen_k, seen_p):
        for name, (codec, c, _, _) in pk.items():
            if codec != "fz":
                continue
            cp = pp[name][1]
            for f in c.FIELDS:
                if not same(getattr(c, f), getattr(cp, f)):
                    raise AssertionError(f"{ZOO_VLM}: parked {name} field {f} differs between "
                                         "the kernel and the plain route")
            x = raw[name].reshape(-1).float()
            err = float((x - fz.decompress(c, plain_fz)).abs().max())
            eb = float(c.eb_abs)
            if not err <= eb * (1 + 2**-20) + float(x.abs().max()) * 2**-22:
                raise AssertionError(f"{ZOO_VLM}: a parked {name} breaks the bound: {err} > {eb}")
            worst, n_leaves = max(worst, err / eb), n_leaves + 1
    if len(seen_k) != n_new - 1 or not n_leaves:
        raise AssertionError(f"{ZOO_VLM}: {len(seen_k)} parks of {n_leaves} FZ leaves")
    cache = cache_k
    park_ms = cuda_ms(lambda: eng_k.resume(eng_k.park(cache)), iters=5)
    say(16, f"{card} | {ZOO_VLM} Engine.generate(park_between=True), batch {B}, prompt {S}, "
            f"{n_new} tokens, positions 0..{S - 1} on t/h/w: kernel route {wall_k:.2f} s "
            f"({B * n_new / wall_k:.1f} tokens/s), plain route {wall_p:.2f} s; tokens, caches and "
            f"all {n_leaves} parked containers bit for bit equal between the routes; worst "
            f"max_err/eb {worst:.6f}; park + resume of the cache ({cache['k'].numel() * 2 / 1e6:.1f}"
            f" MB a leaf) {park_ms:.3f} ms; peak allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {launches[ZOO_VLM]}; "
            f"done in {time.time() - t0:.1f} s")
    del model, params, runs, seen_k, seen_p, cache, cache_k, cache_p, eng_k

    # -- 16d: two MoE training steps through the compressed reduce -------------
    fresh()
    t0 = time.time()
    scfg = configs.get("dbrx-132b", smoke=True)
    smodel = zoo.build(scfg)
    shape = ShapeConfig(*ZOO_TRAIN_SHAPE)
    gc_k = car.GradCompressionConfig(enabled=True)
    n_fz = sum(1 for t in pytree.leaves(smodel.abstract_params())
               if t.dtype.is_floating_point and t.numel() >= gc_k.min_leaf_size)
    fresh_group = not dist.is_initialized()
    mesh = lmesh.make_mesh((1, 1, 1), ("pod", "data", "model"), device=dev)
    backend = dist.get_backend()
    try:
        p0 = smodel.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        out = {}
        for use_kernels in (True, False):
            t = Trainer(smodel, shape, mesh, TrainConfig(
                grad_compress=dataclasses.replace(gc_k, use_kernels=use_kernels),
                warmup_steps=1), stream=TokenStream(scfg.vocab, shape.seq_len,
                                                   shape.global_batch, seed=0),
                init_params=p0, device=dev)
            fn = lambda t=t: t.run(ZOO_TRAIN_STEPS)    # noqa: E731
            hist = drive("moe-train", fn) if use_kernels else plain(fn, "moe-train")
            out[use_kernels] = (t.info["mode"], hist, t._state())
    finally:
        if fresh_group:
            dist.destroy_process_group()
    (mode, hist_k, state_k), (_, hist_p, state_p) = out[True], out[False]
    la, lb = pytree.leaves_with_keys(state_k), pytree.leaves_with_keys(state_p)
    if [k for k, _ in la] != [k for k, _ in lb] or not all(
            same(a, b) for (_, a), (_, b) in zip(la, lb)):
        raise AssertionError("dbrx training: the kernel route's state differs from the plain "
                             "route's")
    if [h["loss"] for h in hist_k] != [h["loss"] for h in hist_p] or not all(
            np.isfinite(h["loss"]) for h in hist_k):
        raise AssertionError(f"dbrx training losses: kernel {hist_k}, plain {hist_p}")
    tl = launches["moe-train"]
    if not tl["fused_compress"] == tl["fused_decompress"] == ZOO_TRAIN_STEPS * n_fz:
        raise AssertionError(f"dbrx training launched {tl}, not K4 = K6 = steps x {n_fz} leaves")
    say(16, f"{card} | {scfg.arch_id} training ({smodel.param_count():,} parameters, {shape}), "
            f"{ZOO_TRAIN_STEPS} Trainer steps on make_mesh((1, 1, 1), ('pod', 'data', 'model')) "
            f"({backend}, world size 1), mode {mode}, GradCompressionConfig(enabled=True): losses "
            f"{[round(h['loss'], 6) for h in hist_k]}, the kernel route's params, optimizer "
            f"and error state equal to the plain route's bit for bit; K4 = K6 = {n_fz} a step "
            f"(leaves past min_leaf_size); done in {time.time() - t0:.1f} s")
    fresh()
    say(16, f"MoE and M-RoPE phase done in {time.time() - t_phase:.1f} s")
    return launches


def profile_split(fn, ranges: dict) -> tuple[dict, float, float, int]:
    """One call of ``fn`` under torch.profiler, with each function of ``ranges``
    (range name -> (module, attribute)) wrapped in a named range. Returns the
    device time (us) by group (``RECURRENT_RANGES``' ranges, then
    ``KERNEL_KINDS``), the busy and wall ms and the kernel count."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile

    def ranged(name, f):
        def call(*a, **k):
            with torch.profiler.record_function(name):
                return f(*a, **k)
        return call
    fn()
    torch.cuda.synchronize()
    originals = {name: getattr(mod, attr) for name, (mod, attr) in ranges.items()}
    for name, (mod, attr) in ranges.items():
        setattr(mod, attr, ranged(name, originals[name]))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        for name, (mod, attr) in ranges.items():
            setattr(mod, attr, originals[name])
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        with open(f"{tmp}/trace.json") as f:
            kern = kernels_by_range(json.load(f), ranges)
    split = dict.fromkeys([*ranges, *(kind for kind, _ in KERNEL_KINDS), "other"], 0.0)
    for name, us, where in kern:
        split[where or kernel_kind(name)] += us
    return split, sum(split.values()) / 1e3, wall_ms, len(kern)


def recurrent_phase(card, dev) -> dict:
    """Phase 17: rwkv6-3b, zamba2-2.7b and whisper-tiny served whole at their
    published width and depth, each cache parked through K4 and resumed through
    K6 every step; rwkv6 and zamba2 trained, cut in depth, through the
    compressed reduce. Returns each path's launches."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import configs, kernels, pytree
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import fz
    from repro_torch.data.tokens import TokenStream
    from repro_torch.dist import compressed_allreduce as car
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import mamba2, rwkv6, zoo
    from repro_torch.serve import Engine, KVCompressionConfig, PoolConfig
    from repro_torch.train import TrainConfig, Trainer

    t_phase = time.time()
    train_paths = [f"{arch}-train" for arch, _ in RECURRENT_TRAIN]
    launches = {path: dict.fromkeys(kernels.WRAPPERS, 0)
                for path in (*RECURRENT_SERVED, *train_paths)}
    drive, plain = launch_recorder(launches)
    mods = {"rwkv6": rwkv6, "mamba2": mamba2}
    ranges = {f"{m}.{attr}": (mods[m], attr) for m, attr in RECURRENT_RANGES}

    def kcfg(use_kernels):
        return KVCompressionConfig(enabled=True, eb=RECURRENT_EB, use_kernels=use_kernels,
                                   kernel_mode="fused")

    def split_line(what, split, busy_ms, wall_ms, n):
        if not busy_ms:
            return f"{what}: device split not measured (the profiler saw no device time)"
        return (f"{what} under torch.profiler ({n} kernels): " + ", ".join(
            f"{name} {us / 1e3:.3f} ms ({100 * us / 1e3 / busy_ms:.1f}%)"
            for name, us in split.items() if us) + f"; busy {busy_ms:.3f} ms of {wall_ms:.3f} "
            f"ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")

    # -- 17a-c: served whole at published size, parked by K4, resumed by K6 -------
    B, S, n_new = RECURRENT_GENERATE
    for arch in RECURRENT_SERVED:
        fresh()
        t0 = time.time()
        cfg = configs.get(arch)
        model = zoo.build(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        nbytes = sum(t.numel() * t.element_size() for t in pytree.leaves(params))
        say(17, f"{card} | {arch} at its published width and depth ({cfg.n_layers} layers, "
                f"d_model {cfg.d_model}, family {cfg.family}): {model.param_count():,} "
                f"parameters, {nbytes / 1e9:.2f} GB, random from torch.Generator seed 0 on "
                f"the card in {time.time() - t0:.2f} s; nothing cut")
        try:
            Engine(model, params, pool=PoolConfig(**SERVE_POOL), device=dev).make_pool()
        except NotImplementedError as e:
            say(17, f"{arch}: make_pool refuses the paged pool, as the reference's: {e}")
        else:
            raise AssertionError(f"{arch}: make_pool built a paged pool")
        rng = np.random.default_rng(1)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S), dtype=np.int32))
                 .to(dev)}
        if cfg.family == "audio":           # the stubbed frontend, as the launcher feeds it
            batch["audio_embeds"] = torch.zeros((B, cfg.n_audio_ctx, cfg.d_model),
                                                dtype=torch.bfloat16, device=dev)
        runs = {}
        for use_kernels in (True, False):
            eng = Engine(model, params, device=dev, kv_compress=kcfg(use_kernels))
            seen, park = [], eng.park

            def rec_park(cache, park=park, seen=seen):
                parked = park(cache)
                seen.append((cache, parked))
                return parked
            eng.park = rec_park
            torch.cuda.synchronize()
            t = time.perf_counter()
            gen = lambda eng=eng: eng.generate(batch, n_new, park_between=True)   # noqa: E731
            toks, cache = drive(arch, gen) if use_kernels else plain(gen, arch)
            torch.cuda.synchronize()
            runs[use_kernels] = (toks, cache, seen, time.perf_counter() - t, eng)
        (toks_k, cache_k, seen_k, wall_k, eng_k), (toks_p, cache_p, seen_p, wall_p, _) = \
            runs[True], runs[False]
        if not (torch.equal(toks_k, toks_p) and sorted(cache_k) == sorted(cache_p)
                and all(same(cache_k[n], cache_p[n]) for n in cache_k)):
            raise AssertionError(f"{arch}: the kernel route's tokens or cache differ from the "
                                 "plain route's")
        plain_fz = kcfg(False).fz_config()
        worst, fz_names = 0.0, None
        for (raw, pk), (_, pp) in zip(seen_k, seen_p):
            names = [name for name, (codec, *_) in pk.items() if codec == "fz"]
            if fz_names not in (None, names):
                raise AssertionError(f"{arch}: parked leaves {names} after {fz_names}")
            fz_names = names
            for name in names:
                c, cp = pk[name][1], pp[name][1]
                for f in c.FIELDS:
                    if not same(getattr(c, f), getattr(cp, f)):
                        raise AssertionError(f"{arch}: parked {name} field {f} differs between "
                                             "the kernel and the plain route")
                x = raw[name].reshape(-1).float()
                err = float((x - fz.decompress(c, plain_fz)).abs().max())
                eb = float(c.eb_abs)
                if not err <= eb * (1 + 2**-20) + float(x.abs().max()) * 2**-22:
                    raise AssertionError(f"{arch}: a parked {name} breaks the bound: {err} > {eb}")
                worst = max(worst, err / eb)
        parks, lk = len(seen_k), launches[arch]
        want = parks * len(fz_names)
        if parks != n_new - 1 or not fz_names or not (
                lk["fused_compress"] == lk["fused_decompress"] == want) or \
                sum(lk.values()) != 2 * want:
            raise AssertionError(f"{arch}: {parks} parks of {fz_names} launched {lk}, not K4 = "
                                 f"K6 = {want}")
        last = seen_k[-1]
        leaves = ", ".join(
            f"{name} {tuple(last[0][name].shape)} {str(last[0][name].dtype).replace('torch.', '')}"
            f" CR {last[1][name][1].compression_ratio():.2f}" for name in fz_names)
        say(17, f"{card} | {arch} Engine.generate(park_between=True), batch {B}, prompt {S}, "
                f"{n_new} tokens, rel eb {RECURRENT_EB}: kernel route {wall_k:.2f} s "
                f"({B * n_new / wall_k:.1f} tokens/s, parking included), plain route "
                f"{wall_p:.2f} s; tokens, final caches and all {parks * len(fz_names)} parked "
                f"containers bit for bit equal between the routes; every parked leaf within "
                f"its bound (worst max_err/eb {worst:.6f}); K4 {lk['fused_compress']} = K6 "
                f"{lk['fused_decompress']} = {parks} parks x {len(fz_names)} leaves, the plain "
                f"route none; parked leaves (last park): {leaves}")
        # times: a decode step, a park and a resume of the final cache, a prefill
        cache, tok = cache_k, toks_k[:, -1]
        parked = eng_k.park(cache)
        decode_ms = cuda_ms(lambda: model.decode(params, cache, tok), iters=5, warmup=1)
        park_ms = cuda_ms(lambda: eng_k.park(cache), iters=5, warmup=1)
        resume_ms = cuda_ms(lambda: eng_k.resume(parked), iters=5, warmup=1)
        prefill_ms = cuda_ms(lambda: model.prefill(params, batch), iters=3, warmup=1)
        raw_mb = sum(t.numel() * t.element_size() for t in cache.values()) / 1e6
        say(17, f"{card} | {arch} times (CUDA events, host included): prefill {prefill_ms:.3f} "
                f"ms, decode step {decode_ms:.3f} ms ({B / decode_ms * 1e3:.1f} tokens/s "
                f"unparked), park {park_ms:.3f} ms, resume {resume_ms:.3f} ms of the "
                f"{raw_mb:.1f} MB cache")
        say(17, f"{card} | " + split_line(f"{arch} prefill", *profile_split(
            lambda: model.prefill(params, batch), ranges)))
        say(17, f"{card} | " + split_line(f"{arch} parked decode step (park, resume, decode)",
                                          *profile_split(lambda: model.decode(
                                              params, eng_k.resume(eng_k.park(cache)), tok),
                                              ranges)))
        # the recurrence at full size: prefill S, then one decode step, against
        # prefill S + 1 over the same tokens
        with torch.no_grad():
            l_pre, c_pre = model.prefill(params, batch)
            step_l, _ = model.decode(params, c_pre, toks_k[:, 0])
            longer = dict(batch, tokens=torch.cat([batch["tokens"], toks_k[:, :1]], dim=1))
            full_l, _ = model.prefill(params, longer)
        diff = float((step_l.float() - full_l.float()).abs().max())
        if not np.isfinite(diff):
            raise AssertionError(f"{arch}: prefill S + 1 or decode gave non-finite logits")
        say(17, f"{card} | {arch}: prefill {S} + one decode step against prefill {S + 1}: "
                f"largest logit difference {diff:.6f} (max |logit| "
                f"{float(full_l.float().abs().max()):.3f}); peak allocated "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches {lk}; done in "
                f"{time.time() - t0:.1f} s")
        del model, params, runs, seen_k, seen_p, cache, cache_k, cache_p, eng_k, eng, gen, \
            rec_park, park, parked, c_pre

    # -- 17d: training, cut in depth, through the compressed reduce -----------------
    fresh_group = not dist.is_initialized()
    mesh = lmesh.make_mesh((1, 1, 1), ("pod", "data", "model"), device=dev)
    backend = dist.get_backend()
    shape = ShapeConfig(*RECURRENT_TRAIN_SHAPE)
    gc_k = car.GradCompressionConfig(enabled=True, kernel_mode="fused")
    try:
        for (arch, layers), path in zip(RECURRENT_TRAIN, train_paths):
            fresh()
            t0 = time.time()
            full = configs.get(arch)
            cfg = dataclasses.replace(full, n_layers=layers)
            model = zoo.build(cfg)
            n_fz = sum(1 for t in pytree.leaves(model.abstract_params())
                       if t.dtype.is_floating_point and t.numel() >= gc_k.min_leaf_size)
            p0 = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
            out = {}
            for use_kernels in (True, False):
                t = Trainer(model, shape, mesh, TrainConfig(
                    grad_compress=dataclasses.replace(gc_k, use_kernels=use_kernels),
                    warmup_steps=1), stream=TokenStream(cfg.vocab, shape.seq_len,
                                                       shape.global_batch, seed=0),
                    init_params=p0, device=dev)
                fn = lambda t=t: t.run(RECURRENT_TRAIN_STEPS)    # noqa: E731
                hist = drive(path, fn) if use_kernels else plain(fn, path)
                out[use_kernels] = (t.info["mode"], hist, t._state())
                del t
            (mode, hist_k, state_k), (_, hist_p, state_p) = out[True], out[False]
            la, lb = pytree.leaves_with_keys(state_k), pytree.leaves_with_keys(state_p)
            if [k for k, _ in la] != [k for k, _ in lb] or not all(
                    same(a, b) for (_, a), (_, b) in zip(la, lb)):
                raise AssertionError(f"{arch} training: the kernel route's state differs from "
                                     "the plain route's")
            if [h["loss"] for h in hist_k] != [h["loss"] for h in hist_p] or not all(
                    np.isfinite(h["loss"]) for h in hist_k):
                raise AssertionError(f"{arch} training losses: kernel {hist_k}, plain {hist_p}")
            tl = launches[path]
            if not tl["fused_compress"] == tl["fused_decompress"] == RECURRENT_TRAIN_STEPS * n_fz:
                raise AssertionError(f"{arch} training launched {tl}, not K4 = K6 = steps x "
                                     f"{n_fz} leaves")
            say(17, f"{card} | {arch} training at its published width, depth {full.n_layers} -> "
                    f"{layers} layers ({model.param_count():,} parameters), {shape}, "
                    f"{RECURRENT_TRAIN_STEPS} Trainer steps on make_mesh((1, 1, 1), ('pod', "
                    f"'data', 'model')) ({backend}, world size 1), mode {mode}: losses "
                    f"{[round(h['loss'], 6) for h in hist_k]}, ms a step "
                    f"{[round(h['seconds'] * 1e3, 1) for h in hist_k]} (kernel route; plain "
                    f"{[round(h['seconds'] * 1e3, 1) for h in hist_p]}); params, optimizer and "
                    f"error state of the kernel route equal to the plain route's bit for bit; "
                    f"K4 {tl['fused_compress']} = K6 {tl['fused_decompress']} = "
                    f"{RECURRENT_TRAIN_STEPS} steps x {n_fz} leaves; peak allocated "
                    f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; done in "
                    f"{time.time() - t0:.1f} s")
            del model, p0, out, state_k, state_p, la, lb
    finally:
        if fresh_group:
            dist.destroy_process_group()
    fresh()
    say(17, f"recurrent and audio phase done in {time.time() - t_phase:.1f} s")
    return launches


def example_phase(card, dev) -> dict:
    """Phase 18a: the four examples (``repro_torch.examples``) in-process at
    their own sizes, each through its ``main`` with the launch counts set to 0
    just before and read just after. Gates: each example's own asserts; each
    kernel of its path (``EXAMPLE_PATHS``) launched; compress_field's CR column
    equal to the plain route's on the card digit for digit; the serving
    example's two routes with identical scheduling counts and tokens agreeing in
    ``TOKEN_AGREEMENT`` of them; train_lm's relaunch resumes at step 50.
    Returns each path's launches."""
    import contextlib
    import io
    import shutil
    import numpy as np
    import torch
    from repro_torch import kernels, obs
    from repro_torch.core import fz
    from repro_torch.data import make_field
    from repro_torch.examples import compress_field, quickstart, serve_compressed_kv, train_lm

    launches = {path: dict.fromkeys(kernels.WRAPPERS, 0) for path in EXAMPLE_PATHS}
    drive, _ = launch_recorder(launches)
    walls = {}
    t_phase = time.time()

    def run(path, main, argv, interrupted=()):
        """``main(argv)``; an ``interrupted`` exception is returned, not raised."""
        def call():
            try:
                return main(argv)
            except interrupted as e:
                return e
        obs.reset()
        obs.clear_events()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            got = drive(path, call)
        torch.cuda.synchronize()
        walls[path] = time.perf_counter() - t
        text = out.getvalue()
        for line in text.splitlines()[-4:]:
            say("18a", f"  {path}: {line}")
        must = EXAMPLE_PATHS[path]
        if not must and any(launches[path].values()):
            raise AssertionError(f"{path} (the plain route) launched {launches[path]}")
        missing = [k for k in must if launches[path][k] <= 0]
        if missing:
            raise AssertionError(f"{path} did not launch {missing}: {launches[path]}")
        say("18a", f"{card} | {path}: {walls[path]:.2f} s wall; launches "
                   f"{ {k: v for k, v in launches[path].items() if v} }")
        return got, text

    run("quickstart", quickstart.main, ["--device", str(dev)])
    for path, kind, shape in EXAMPLE_FIELDS:
        rows, _ = run(path, compress_field.main, ["--kind", kind, "--shape", *map(str, shape),
                                                  "--device", str(dev)])
        f = torch.from_numpy(make_field(kind, shape, seed=0)).to(dev)
        for eb, row in zip(compress_field.EBS, rows):
            _, c = fz.roundtrip(f, fz.FZConfig(eb=eb, use_kernels=False), device=dev)
            plain_cr = f"{c.compression_ratio():.2f}"
            if row.split(",")[1] != plain_cr:
                raise AssertionError(f"{path} eb={eb}: CR column {row.split(',')[1]} differs "
                                     f"from the plain route's {plain_cr}")
        say("18a", f"{path}: the CR column equals the plain route's at every bound "
                   f"({[r.split(',')[1] for r in rows]})")
        del f
    served = {}
    for path, argv in (("serve_compressed_kv --kernels", ["--kernels"]),
                       ("serve_compressed_kv", [])):
        served[path], _ = run(path, serve_compressed_kv.main, argv + ["--device", str(dev)])
    k, p = served["serve_compressed_kv --kernels"], served["serve_compressed_kv"]
    for name in SCHED_FIELDS:
        if getattr(k["stats"], name) != getattr(p["stats"], name):
            raise AssertionError(f"serve_compressed_kv: TraceStats.{name} differs across "
                                 f"routes: {getattr(k['stats'], name)} vs "
                                 f"{getattr(p['stats'], name)}")
    agree = float(np.mean([np.mean(k["outputs"][i] == p["outputs"][i]) for i in p["outputs"]]))
    say("18a", f"serve_compressed_kv: identical scheduling counts across routes; tokens of "
               f"the kernel route equal the plain route's in {agree:.4f} (bar "
               f"{TOKEN_AGREEMENT}); oracle agreement kernel {k['agreement']:.4f}, plain "
               f"{p['agreement']:.4f}")
    if agree < TOKEN_AGREEMENT:
        raise AssertionError(f"serve_compressed_kv: routes agree in {agree} of tokens")
    shutil.rmtree(TRAIN_LM_DIR, ignore_errors=True)
    first, relaunch = TRAIN_LM_STEPS
    args = [*TRAIN_LM_ARGS, "--ckpt-dir", str(TRAIN_LM_DIR), "--device", str(dev)]

    class Killed(Exception):
        pass

    class KilledAt(train_lm.Trainer):
        """The example's trainer, its data loader interrupted at TRAIN_LM_KILL."""
        def _batch(self, step):
            if step == TRAIN_LM_KILL:
                raise Killed(step)
            return super()._batch(step)

    real = train_lm.Trainer
    train_lm.Trainer = KilledAt
    try:
        got, _ = run("train_lm", train_lm.main, ["--steps", str(first), *args],
                     interrupted=Killed)
    finally:
        train_lm.Trainer = real
    if not isinstance(got, Killed):
        raise AssertionError("train_lm was not interrupted")
    hist, text = run("train_lm resumed", train_lm.main, ["--steps", str(relaunch), *args])
    if "resumed from checkpoint at step 50" not in text or hist[0]["step"] != 50:
        raise AssertionError(f"train_lm did not resume at step 50: {text[:300]}")
    if not all(np.isfinite(m["loss"]) for m in hist):
        raise AssertionError("train_lm: a loss is not finite")
    say("18a", f"{card} | train_lm: killed at step {TRAIN_LM_KILL} of {first}, relaunched: "
               f"resumed at step 50, to {relaunch}: loss {hist[0]['loss']:.4f} -> "
               f"{hist[-1]['loss']:.4f}, "
               f"{np.median([m['seconds'] for m in hist[2:]]) * 1e3:.1f} ms a step (median)")
    shutil.rmtree(TRAIN_LM_DIR, ignore_errors=True)     # 0.3 GB of checkpoints
    say("18a", f"{card} | example wall times (s): "
               f"{ {path: round(w, 2) for path, w in walls.items()} }; phase "
               f"{time.time() - t_phase:.1f} s")
    return launches


def sync_events(fn, events: list):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``, appending to
    ``events`` one entry a synchronizing call: the ``(file, qualname, line)``
    frames of ``repro_torch`` on the stack at that call, innermost first."""
    import inspect
    import warnings
    import torch
    src = ROOT / "src"
    root = str(src / "repro_torch")
    active = [False]              # only fn's syncs, not the mode switches around it

    def hook(message, category, filename, lineno, file=None, line=None):
        if not active[0] or "synchronizing" not in str(message):
            return
        frames, every, f = [], [], inspect.currentframe().f_back
        while f is not None:
            path = f.f_code.co_filename
            if path.startswith(root):
                frames.append((os.path.relpath(path, src), f.f_code.co_qualname, f.f_lineno))
            every.append((path, f.f_code.co_qualname, f.f_lineno))
            f = f.f_back
        # a sync outside the port (no repro_torch frame) keeps its whole stack
        events.append(frames or [("(outside repro_torch)", repr(every[:6]), 0)])

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        active[0] = True
        try:
            return fn()
        finally:
            active[0] = False
            torch.cuda.set_sync_debug_mode("default")


def static_sync_sites() -> set[tuple[str, str]]:
    """(file, qualname) of every function that the static ``host-sync`` pass
    finds a sync in, or that the baseline lists one in."""
    from repro_torch.analysis import jitlint
    return jitlint.sync_sites()


def sync_phase(card, dev) -> dict:
    """Phase 18c: the host-sync lint's runtime twin. Yi-6B serves phase 8's trace
    and pool on the kernel route, and fused compress / decompress run at
    ``SYNC_FIELD`` (strict and paper mode), under the sync debug mode. Gate: the
    innermost ``repro_torch`` frame of every synchronizing call is a function that
    the static ``host-sync`` findings or the baseline list. Prints the syncs a
    decode step. Returns the counts."""
    import collections
    import statistics
    import torch
    from repro_torch import configs
    from repro_torch.core import fz
    from repro_torch.data import make_field
    from repro_torch.models import zoo
    from repro_torch.serve import Engine, PoolConfig
    from repro_torch.serve.kvpool import ContinuousBatcher, tracegen

    t_phase = time.time()
    model = zoo.build(configs.get("yi-6b"))
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = Engine(model, params, pool=PoolConfig(**SERVE_POOL), device=dev)
    batcher = ContinuousBatcher(eng, eng.make_pool(), max_batch=SERVE_LANES)
    events, steps = [], []
    step = batcher.step

    def counted(i, outputs):
        n0, d0 = len(events), batcher.stats.decode_steps
        out = step(i, outputs)
        steps.append((batcher.stats.decode_steps > d0, len(events) - n0))
        return out
    batcher.step = counted
    sync_events(lambda: batcher.run(tracegen.generate(tracegen.TraceGenConfig(**SERVE_TRACE))),
                events)
    torch.cuda.synchronize()
    serve_events = list(events)
    per_decode = [n for decoded, n in steps if decoded]
    del eng, batcher, params, model
    fresh()

    x = torch.from_numpy(make_field("smooth", SYNC_FIELD, seed=0)).to(dev)
    calls = {}
    for mode, cfg in (("strict", fz.FZConfig(eb=1e-3)),
                      ("paper", fz.FZConfig(eb=1e-3, exact_outliers=False))):
        c = fz.compress(x, cfg, device=dev)           # warm: tuner, kernels built
        fz.decompress(c, cfg, device=dev)
        torch.cuda.synchronize()
        for op, fn in (("compress", lambda: fz.compress(x, cfg, device=dev)),
                       ("decompress", lambda: fz.decompress(c, cfg, device=dev))):
            n0 = len(events)
            sync_events(fn, events)
            calls[f"{op} {mode}"] = len(events) - n0
    torch.cuda.synchronize()
    del x

    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "sync_events.json").write_text(json.dumps(
        {"serve": serve_events, "fz": events[len(serve_events):], "calls": calls,
         "per_step": steps}, indent=0) + "\n")
    inner = collections.Counter(f"{e[0][0]}:{e[0][1]}" if e else "(no repro_torch frame)"
                                for e in events)
    say("18c", f"{card} | Yi-6B serving trace on the kernel route: {len(serve_events)} "
               f"synchronizing calls in {len(steps)} scheduler steps; a decode step "
               f"{statistics.median(per_decode)} (median), {min(per_decode)}-{max(per_decode)} "
               f"over {len(per_decode)} decode steps; fz calls at {SYNC_FIELD}: {calls}")
    say("18c", f"synchronizing calls by innermost repro_torch function: "
               f"{dict(inner.most_common())}")
    sites = static_sync_sites()
    unmapped = collections.Counter(f"{e[0][0]}:{e[0][1]} (line {e[0][2]}; from "
                                   f"{[f'{f[1]}:{f[2]}' for f in e[1:4]]})" if e else
                                   "(no repro_torch frame)"
                                   for e in events if not e or (e[0][0], e[0][1]) not in sites)
    if unmapped:
        raise AssertionError(f"synchronizing calls the static host-sync pass does not list: "
                             f"{dict(unmapped)}")
    say("18c", f"every synchronizing call maps to a host-sync finding or baseline entry "
               f"({len(sites)} functions listed); phase {time.time() - t_phase:.1f} s")
    return {"per_decode_step": per_decode, "calls": calls, "by_function": dict(inner)}


def analysis_phase(card) -> None:
    """Phase 18b: ``python -m repro_torch.analysis --check`` with all four passes
    on the checkout's tree, the resource pass with the card's ptxas figures and
    C-side shared bytes."""
    import contextlib
    import io
    from repro_torch.analysis import __main__ as analysis_cli
    from repro_torch.analysis import report, resources

    t0 = time.time()
    if resources.ptxas_info() is None:
        raise AssertionError("no ptxas log beside the built kernel libraries")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = analysis_cli.main(["--check"])
    for line in out.getvalue().splitlines()[-3:]:
        say("18b", f"  {line}")
    if rc != 0:
        raise AssertionError(f"python -m repro_torch.analysis --check failed: {out.getvalue()}")
    rep = report.run_all()
    unmeasured = [r["name"] for r in rep.rows if r["registers"] == resources.NOT_MEASURED
                  or r["dynamic_smem"] == resources.NOT_MEASURED]
    if unmeasured:
        raise AssertionError(f"the resource pass measured nothing for {unmeasured}")
    say("18b", f"{card} | analysis --check clean with passes {report.PASSES}: "
               f"{len(rep.findings)} finding(s), all baselined; registers and dynamic shared "
               f"bytes measured for {len(rep.rows)} launch rows ({time.time() - t0:.1f} s)")


def tune_phase(card, dev, serving, x) -> None:
    """Phase 13: the resource table and its gates, the tuner on the card's
    points and its gates, and "auto" / the engine on the tuned cache (phase
    8's model). Raises on any failed gate."""
    import dataclasses
    import numpy as np
    import torch
    import repro_torch as rt
    from repro_torch import kernels, obs, tune
    from repro_torch.analysis import report, resources, space
    from repro_torch.analysis.kernelspec import KernelSpec
    from repro_torch.kernels import ref
    from repro_torch.serve import Engine, PoolConfig
    from repro_torch.serve.kvpool import tracegen
    from repro_torch.tune import __main__ as tune_cli
    from repro_torch.tune import dispatch, impls, registry, tuner

    t_phase = time.time()
    model, params = serving["model"], serving["params"]

    def log(msg):
        say(13, msg)

    # -- the resource table ------------------------------------------------
    ptxas = resources.ptxas_info(build=True)
    if ptxas is None:
        raise AssertionError("no ptxas log beside the built kernel libraries")
    rep = report.run_all(ptxas=ptxas)
    (TUNE_DIR / "resources.json").write_text(json.dumps(rep.to_json(), indent=1) + "\n")
    for r in rep.rows:
        say(13, f"{card} | resources {r['name']} ({r['module']}: {r['symbol']}): "
                f"{r['registers']} registers, {r['spill_stores']} B spill stores, shared "
                f"{r['static_smem']} B static + {r['dynamic_smem']} B dynamic, "
                f"{r['threads']} threads, {r['ctas_per_sm']} CTAs an SM (by {r['limited_by']}; "
                f"launch bounds {r['min_ctas']}); {r['points']} point(s), first "
                f"{r['first_point']}")
    for f in rep.findings:
        say(13, f"finding {'NEW ' if f in rep.new else 'baselined '}{f.severity} {f.key}: "
                f"{f.message}")
    for key in rep.stale:
        say(13, f"baseline entry the card does not produce: {key}")
    refused = [f for f in rep.new if f.rule in tuner.BUDGET_RULES]
    if refused:
        raise AssertionError("launches the card refuses, not in the baseline: "
                             + "; ".join(f"{f.key}: {f.message}" for f in refused))
    specs = space.build_specs()
    unmeasured = sorted({s.name for s in specs if s.dynamic_smem is None})
    if unmeasured:
        raise AssertionError(f"no dynamic shared bytes from the C side for {unmeasured}")
    n_queries = len({s.c_query for s in specs if s.c_query is not None})
    say(13, f"dynamic shared bytes from {n_queries} C queries at {len(specs)} launch points; "
            f"{len(rep.findings)} finding(s), {len(rep.new)} new")

    # -- tuning --------------------------------------------------------------
    # the engine's own decode-attention point: its heads, head size, pages, lanes
    attn = Engine(model, params, pool=PoolConfig(**SERVE_POOL),
                  device=dev).attention_workload(batch=SERVE_LANES)
    timing = {"shape": TIMING_SHAPE, "mode": "paper"}
    workloads = list(tune_cli.SMOKE_WORKLOADS) + [
        ("fz.compress", TIMING_N, "float32", timing), ("fz.decompress", TIMING_N, "float32", timing),
        ("fz.compress", SERVE_PAGE_N, "bfloat16"), ("fz.decompress", SERVE_PAGE_N, "bfloat16"),
        attn]
    t0 = time.time()
    kernels.reset_launch_counts()
    first = tune.ensure_tuned(workloads, device=dev, log=log)
    say(13, f"tuned {first['misses']} points in {time.time() - t0:.1f} s "
            f"({first['measurements']} measurements), launches {kernels.launch_counts()}")

    def show(r, where=""):
        us = ", ".join(f"{i} {v:.1f}" for i, v in sorted(r["measured_us"].items()))
        say(13, f"{card} | tune{where} {r['op']} n={r['n']} (bucket "
                f"{tune.shape_bucket(r['n'])}) {r['dtype']} {r['geometry'] or ''}: "
                f"{r['impl']} wins; us: {us}; skipped {r['skipped'] or 'none'}; "
                f"rejected {r['rejected'] or 'none'}")

    for r in first["results"]:
        show(r)
        if r["rejected"] or r["skipped"] or r["impl"] in dispatch.PLAIN_IMPLS:
            raise AssertionError(f"{r['op']} n={r['n']} {r['dtype']}: the card's tuning "
                                 f"chose {r['impl']}, skipped {r['skipped']}, rejected "
                                 f"{r['rejected']}")
    # the key is the size bucket: the timing point's choice (the 3-D paper field)
    # also serves strict calls and 1-D streams of that bucket, so both are measured
    # (force: they share the key) into a cache of their own and must choose the same
    variants = tune.ensure_tuned(
        [(op, TIMING_N, "float32", g) for g in ({"shape": TIMING_SHAPE, "mode": "strict"},
                                                {"shape": (TIMING_N,), "mode": "paper"})
         for op in ("fz.compress", "fz.decompress")],
        cache=tune.TuneCache(TUNE_DIR / "variants.json"), force=True, device=dev, log=log)
    chosen = {r["op"]: r["impl"] for r in first["results"] if r["n"] == TIMING_N}
    for r in variants["results"]:
        show(r, " (variant)")
        if r["impl"] != chosen[r["op"]]:
            raise AssertionError(f"{r['op']} at {r['geometry']} chooses {r['impl']}, the "
                                 f"cached timing point {chosen[r['op']]}")
    second = tune.ensure_tuned(workloads, device=dev, log=log)
    if second["hits"] != len(workloads) or second["measurements"] != 0:
        raise AssertionError(f"the second ensure_tuned measured again: {second['hits']} hits, "
                             f"{second['measurements']} measurements")
    say(13, f"second ensure_tuned: {second['hits']} hits, 0 measurements "
            f"({second['cache_entries']} entries in {second['cache_path']})")

    # -- the gates' seeded candidates, into a cache of their own ----------------
    # on the card a rejected or skipped candidate is a fault: TuneError, no entry
    gates = tune.TuneCache(TUNE_DIR / "gates.json")
    try:
        with registry.scoped(impls.evil_candidate("fz.decompress")):
            tuner.tune_op("fz.decompress", n=1 << 20, dtype="float32", cache=gates,
                          device=dev, log=log)
        raise AssertionError("the zeroed decode was not rejected")
    except tuner.TuneError as err:
        if set(err.rejected) != {"evil"} or len(gates):
            raise AssertionError(f"the zeroed decode: {err}") from None
        say(13, f"evil candidate rejected, nothing cached: {err.rejected['evil']}")

    def budget_context(*, n, dtype, device):
        data = torch.from_numpy(np.cumsum(np.random.default_rng(n).standard_normal(n)
                                          .astype(np.float32))).to(device)
        return {"n": n, "dtype": dtype, "device": device, "data": data,
                "eb": torch.full((), 1e-3, dtype=torch.float32, device=device)}

    registry.register_op(registry.OpSpec(
        name="smoke.budget", reference="plain", make_context=budget_context,
        parity=lambda ctx, out, want: None if all(torch.equal(a, b) for a, b in zip(out, want))
        else "differs", gate="bit-identity"))
    try:
        registry.register(registry.Candidate(
            op="smoke.budget", impl="plain", make_runner=lambda ctx: lambda: ref.fused_compress_ref(
                ctx["data"], ctx["eb"], capacity=ctx["n"] // 8)))
        registry.register(registry.Candidate(
            op="smoke.budget", impl="huge", make_runner=lambda ctx: lambda: kernels.fused_compress(
                ctx["data"], ctx["eb"], capacity=ctx["n"] // 8),
            kernel_specs=lambda ctx: [KernelSpec(
                name="smoke.budget", module="fz_compress.cu", symbol="encode_tiles",
                grid=(ctx["n"] // 4096,), threads=256, dynamic_smem=EVIL_SMEM,
                point=f"{EVIL_SMEM} B seeded")]))
        before = kernels.launch_counts()
        try:
            tuner.tune_op("smoke.budget", n=1 << 20, dtype="float32", cache=gates,
                          device=dev, log=log)
            raise AssertionError("the 300 KiB candidate was not skipped")
        except tuner.TuneError as err:
            skipped = err.skipped
        after = kernels.launch_counts()
    finally:
        registry._OPS.pop("smoke.budget", None)
        registry._CANDS.pop("smoke.budget", None)
    if set(skipped) != {"huge"} or "smem-overflow" not in skipped["huge"] or after != before:
        raise AssertionError(f"the 300 KiB candidate was not skipped unlaunched: {skipped}, "
                             f"launches {before} -> {after}")
    say(13, f"budget candidate skipped, no launch: {skipped['huge']}")

    # -- auto on the tuned cache ------------------------------------------------
    arch = dispatch.arch(dev)

    def winner(op, n, dtype):
        return dispatch.active_cache().get(
            tune.cache_key(dispatch.backend(dev), op, n, dtype, arch))["impl"]

    c_route = winner("fz.compress", x.numel(), "float32")
    d_route = winner("fz.decompress", x.numel(), "float32")
    for exact in (True, False):
        auto = rt.FZConfig(eb=1e-3, exact_outliers=exact)
        c_cfg = dataclasses.replace(auto, kernel_mode=c_route)
        d_cfg = dataclasses.replace(auto, kernel_mode=d_route)
        snap = obs.snapshot()["counters"]
        c = rt.compress(x, auto)
        y = rt.decompress(c, auto)
        torch.cuda.synchronize()
        delta = {k: v - snap.get(k, 0) for k, v in obs.snapshot()["counters"].items()
                 if k.startswith("fz_dispatches") and v != snap.get(k, 0)}
        want = {f"fz_dispatches{{op=compress,path={c_route}}}": 1,
                f"fz_dispatches{{op=decompress,path={d_route}}}": 1}
        if delta != want:
            raise AssertionError(f"auto dispatched {delta}, the cache names {want}")
        ce = rt.compress(x, c_cfg)
        for f in c.FIELDS:
            if not torch.equal(getattr(c, f), getattr(ce, f)):
                raise AssertionError(f"auto's container differs from {c_route}'s in {f}")
        if not torch.equal(y.view(torch.int32), rt.decompress(c, d_cfg).view(torch.int32)):
            raise AssertionError(f"auto's reconstruction differs from {d_route}'s")
        say(13, f"auto {'strict' if exact else 'paper'} at {TIMING_SHAPE}: compress "
                f"{c_route}, decompress {d_route} (as the cache names them), bit-identical to "
                f"the explicit routes; dispatches {delta}")

    # -- the engine on the tuned cache ------------------------------------------
    eng = Engine(model, params, pool=PoolConfig(**SERVE_POOL), device=dev)
    reqs = tracegen.generate(tracegen.TraceGenConfig(**{
        **SERVE_TRACE, "n_requests": 2, "template_len": (64, 96), "suffix_len": (16, 32),
        "n_new": (4, 6)}))
    kernels.reset_launch_counts()
    _, stats, _ = eng.serve(reqs, max_batch=SERVE_LANES)
    torch.cuda.synchronize()
    k7 = kernels.launch_counts()["flash_decode"]
    want = model.cfg.n_layers * stats.decode_steps
    if eng.decode_attention != "kernel" or k7 != want or stats.completed != len(reqs):
        raise AssertionError(f"the engine chose {eng.decode_attention!r} and launched K7 {k7} "
                             f"times in {stats.decode_steps} decode steps (want {want}); "
                             f"{stats.completed} of {len(reqs)} completed")
    say(13, f"Engine decode attention on the tuned cache: {eng.decode_attention} "
            f"(decode_attention n={attn[1]} {attn[2]} {attn[3]}); {stats.decode_steps} decode steps "
            f"launched K7 {k7} times ({model.cfg.n_layers} layers)")
    say(13, f"tune phase done in {time.time() - t_phase:.1f} s")


def dryrun_phase(card) -> list[dict]:
    """Phase 19a: the dry-run's cells on fake meshes (see the module docstring).
    Returns the cells' JSON. Raises on any failed gate."""
    from repro_torch.launch import dryrun

    out_dir = ROOT / "chiprun_out" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    try:
        for arch, shape, mesh, compressed, opt in DRYRUN_CELLS:
            r = dryrun.run_cell(arch, shape, mesh, compressed_grads=compressed, opt=opt)
            tag = f"{arch}_{shape}_{mesh}" + ("_compressed" if compressed else "") + \
                (f"_{opt}" if opt != "none" else "")
            (out_dir / f"{tag}.json").write_text(json.dumps(r, indent=1))
            cm, rf, mem = r["cost_model"], r["roofline"], r["full"]["memory"]
            say(19, f"{card} | dry-run {arch} {shape} {mesh}"
                    f"{' --compressed-grads' if compressed else ''}"
                    f"{' --opt ' + opt if opt != 'none' else ''}: {r['devices']} devices, "
                    f"{r['param_count']:,} parameters; per device {cm['flops']:.4e} FLOPs, "
                    f"{cm['bytes']:.4e} bytes, {cm['collective_bytes']:.4e} collective "
                    f"bytes, {cm['cross_pod_bytes']:.4e} cross-pod bytes; peak "
                    f"{mem['peak_device_bytes'] / 1e9:.2f} GB of 80 GB "
                    f"({'fits' if r['fits'] else 'does not fit'}); bottleneck "
                    f"{rf['bottleneck']}, bound {rf['step_time_lower_bound_s']:.4f} s, "
                    f"useful_flops_ratio {rf['useful_flops_ratio']:.4f}; counted at depths "
                    f"{r['extrapolated_from']['depths']} -> {r['extrapolated_from']['full_depth']}"
                    f" {r['extrapolated_from']['unit']}; {r['elapsed_s']:.1f} s")
            top = sorted(cm["flops_by_site"].items(), key=lambda kv: -kv[1])[:3]
            say(19, f"dry-run {tag}: largest products "
                    + "; ".join(f"{k} {v / cm['flops']:.1%}" for k, v in top))
            if rf["useful_flops_ratio"] > DRYRUN_RATIO_LIMIT:
                raise AssertionError(f"dry-run {tag}: useful_flops_ratio "
                                     f"{rf['useful_flops_ratio']} > {DRYRUN_RATIO_LIMIT}: "
                                     "the cost model counts fewer FLOPs than the model does")
            if compressed:
                for check in r["bucket_check"]:
                    if not check or not check["ok"]:
                        raise AssertionError(f"dry-run {tag}: per-bucket cross-pod bytes "
                                             f"differ from expected_cross_pod_bytes: {check}")
                say(19, f"{card} | dry-run {tag}: cross-pod bytes of each of "
                        f"{r['bucket_check'][-1]['buckets']} buckets equal "
                        "expected_cross_pod_bytes at both depths")
            results.append(r)
    finally:
        dryrun.end_fake_group()
    return results


def calibration_phase(card, dev) -> dict:
    """Phase 19b: the cost model against the profiler on real tensors at Yi-6B's
    width (see the module docstring). Returns each path's launches. Raises on
    any failed gate."""
    import dataclasses
    import gc
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.checkpoint import set_checkpoint_early_stop
    from repro_torch import configs, kernels
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.compressed_allreduce import GradCompressionConfig
    from repro_torch.launch import hlo_analysis as ha
    from repro_torch.launch import hlo_cost
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import zoo
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainConfig, build_decode_step, build_prefill_step
    from repro_torch.train import build_train_step

    gc.collect()
    torch.cuda.empty_cache()
    full = configs.get("yi-6b")
    cfg = dataclasses.replace(full, n_layers=CALIB_LAYERS)
    model = zoo.build(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, device=dev)
    launches = {}
    fresh_group = not dist.is_initialized()

    def measure(what, shape, fn, args):
        kernels.reset_launch_counts()
        t0 = time.time()
        _, trace = hlo_cost.record(fn, *args, memory=False)      # also the warm-up
        torch.cuda.synchronize()
        launches[what] = kernels.launch_counts()
        t_trace = time.time() - t0
        # the profiler's run apart (under the trace's dispatch mode it sees each
        # product twice), with checkpoints recomputing whole as in the trace;
        # its FLOPs are the host-side operator events'
        with set_checkpoint_early_stop(False), profile(activities=[ProfilerActivity.CPU],
                                                       with_flops=True) as prof:
            fn(*args)
            torch.cuda.synchronize()
        t_prof = time.time() - t0 - t_trace
        # the profiler's formulas for the products the cost model counts (it
        # also gives aten::mul and aten::add one FLOP an element), read off its
        # raw events: building its Python event list takes over a minute here
        prof_flops = float(sum(e.flops() for e in prof.profiler.kineto_results.events()
                               if e.name() in CALIB_PRODUCTS))
        cost = hlo_cost.analyze(trace)
        terms = ha.roofline_terms(cost["flops"], cost["bytes"], cost["collective_bytes"])
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop)
        bound_ms = terms["step_time_lower_bound_s"] * 1e3
        rel = abs(cost["flops"] - prof_flops) / max(prof_flops, 1.0)
        say(19, f"{card} | calibration {what} ({shape}): cost model {cost['flops']:.6e} "
                f"FLOPs, profiler {prof_flops:.6e} ({100 * rel:.3f}% apart); "
                f"{cost['bytes']:.4e} dot bytes; device time {ms:.3f} ms, roofline bound "
                f"{bound_ms:.3f} ms by {terms['bottleneck']} (H100 SXM datasheet peaks), "
                f"achieved {100 * bound_ms / ms:.1f}% of the bound; launches "
                f"{ {k: v for k, v in launches[what].items() if v} }; host s: traced run "
                f"{t_trace:.1f}, profiled run {t_prof:.1f}, timed run "
                f"{time.time() - t0 - t_trace - t_prof:.1f}")
        if rel > CALIB_FLOP_TOL:
            raise AssertionError(f"calibration {what}: the cost model's FLOPs "
                                 f"{cost['flops']:.6e} are {100 * rel:.2f}% from the "
                                 f"profiler's {prof_flops:.6e}")
        if ms < bound_ms:
            raise AssertionError(f"calibration {what}: {ms:.3f} ms is under the roofline "
                                 f"bound {bound_ms:.3f} ms: the count is wrong")

    try:
        mesh2 = lmesh.make_mesh((1, 1), ("data", "model"), device=dev)
        say(19, f"{card} | calibration: Yi-6B at its published width, depth "
                f"{full.n_layers} -> {cfg.n_layers} layers ({model.param_count():,} "
                f"parameters), random bfloat16 weights from torch.Generator seed 0, mesh "
                f"{lmesh.mesh_shape(mesh2)}")
        with torch.no_grad():
            shape = ShapeConfig(*CALIB_PREFILL)
            step, info = build_prefill_step(model, shape, mesh2)
            batch = {"tokens": torch.randint(0, cfg.vocab, (shape.global_batch, shape.seq_len),
                                             generator=gen, device=dev, dtype=torch.int32)}
            measure("prefill", shape, step, (params, batch))
            del batch
            shape = ShapeConfig(*CALIB_DECODE)
            step, info = build_decode_step(model, shape, mesh2)
            cache = model.make_cache(shape.global_batch, shape.seq_len, device=dev)
            cache["length"].fill_(shape.seq_len)
            inputs = {"token": torch.randint(0, cfg.vocab, (shape.global_batch,),
                                             generator=gen, device=dev, dtype=torch.int32)}

            def decode(p, c, i):
                out = step(p, c, i)
                c["length"].fill_(shape.seq_len)     # the same step each call
                return out
            measure("decode", shape, decode, (params, cache, inputs))
            del cache
        gc.collect()
        torch.cuda.empty_cache()
        shape = ShapeConfig(*TRAIN_SHAPE)
        mesh3 = lmesh.make_mesh((1, 1, 1), ("pod", "data", "model"), device=dev)
        tcfg = TrainConfig(grad_compress=GradCompressionConfig(enabled=True),
                           total_steps=TRAIN_TOTAL, warmup_steps=1)
        step, info = build_train_step(model, shape, mesh3, tcfg, device=dev)
        opt = adamw_init(params)
        err = info["make_err_state"](model.abstract_params())
        tok = torch.randint(0, cfg.vocab, (shape.global_batch, shape.seq_len + 1),
                            generator=gen, device=dev, dtype=torch.int32)
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
        measure("train", shape, step, (params, opt, err, 1, batch))
        if not (launches["train"]["fused_compress"] and launches["train"]["fused_decompress"]):
            raise AssertionError(f"calibration train: K4/K6 did not launch: {launches['train']}")
        del opt, err, batch
    finally:
        if fresh_group and dist.is_initialized():
            dist.destroy_process_group()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


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
    from repro_torch.kernels.fused_compress import shuffle_encode_ctas
    from repro_torch.tune import cache as tune_cache
    from repro_torch.tune import dispatch as tune_dispatch

    # a fresh tuning cache for this run (phases 1-12 run untuned; phase 13
    # tunes into it), also for the launcher's subprocess of phase 12
    TUNE_DIR.mkdir(parents=True, exist_ok=True)
    fresh_cache = TUNE_DIR / "tune_cache.json"
    for stale in ("tune_cache.json", "variants.json", "gates.json"):
        (TUNE_DIR / stale).unlink(missing_ok=True)
    os.environ[tune_cache.ENV_VAR] = str(fresh_cache)
    tune_dispatch.configure(fresh_cache)

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
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or ("spill" in line and "0 bytes spill stores" not in line):
                say(1, f"  {src}: {entry}: {line.strip()}")

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
                    ocap = rt.FZConfig().outlier_capacity(x.numel())
                    hold("fused_compress_strict",
                         kernels.fused_compress_strict(x, eb, capacity=cap, outlier_capacity=ocap,
                                                       code_mode=code_mode),
                         ref.fused_compress_strict_ref(x, eb, capacity=cap,
                                                       outlier_capacity=ocap,
                                                       code_mode=code_mode), what)
                    if dtype == torch.float32:      # K5 on the codes of the strict route
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
    say(2, f"K1-K6 and strict K4 bit-identical to their plain versions in {cases} cases "
           f"({time.time() - t0:.1f} s); max |kernel - plain|: {max_err}")
    # strict K4 on the 1-D HACC-like field at bounds whose overflows fill part
    # of the channel (rel 1e-5, the checkpoint codec's) and pass it (rel 1e-6:
    # the first K kept)
    t0 = time.time()
    x = fields[MAIN_FIELDS[2][0]]
    overflowed = []
    for eb_rel in (1e-5, 1e-6):
        eb = rt.resolve_eb(x, rt.FZConfig(eb=eb_rel))
        ocap = rt.FZConfig().outlier_capacity(x.numel())
        cap = rt.FZConfig().payload_capacity(x.numel())
        for code_mode in ("sign_mag", "zigzag"):
            got = kernels.fused_compress_strict(x, eb, capacity=cap, outlier_capacity=ocap,
                                                code_mode=code_mode)
            hold("fused_compress_strict", got,
                 ref.fused_compress_strict_ref(x, eb, capacity=cap, outlier_capacity=ocap,
                                               code_mode=code_mode),
                 f"{MAIN_FIELDS[2][0]} rel eb {eb_rel} {code_mode}")
            overflowed.append((eb_rel, code_mode, int(got[5]), ocap))
    if not any(n_over > ocap for _, _, n_over, ocap in overflowed):
        raise AssertionError(f"no strict K4 case passed its outlier channel: {overflowed}")
    say(2, f"strict K4 bit-identical to its plain version on {MAIN_FIELDS[2][0]} "
           f"{tuple(x.shape)}: (rel eb, code mode, overflows, channel slots) {overflowed} "
           f"({time.time() - t0:.1f} s)")
    t0 = time.time()
    k6_cases = 0
    for shape in K6_EDGE_SHAPES:
        x = field("particle" if len(shape) == 1 else "turbulent", shape, seed=8)
        if shape == (2097152,):
            x = x.to(torch.bfloat16)
        eb = rt.resolve_eb(x, rt.FZConfig(eb=1e-4))
        n = x.numel()
        for code_mode in ("sign_mag", "zigzag"):
            for capf in (1.0, 0.25):
                cap = rt.FZConfig(capacity_frac=capf).payload_capacity(n)
                bf, pl, _ = kernels.fused_compress(x, eb, capacity=cap, code_mode=code_mode)
                for slots in (None, "few", "many", "one_tile"):
                    oidx, oval = outlier_slots(n, slots, n, dev) if slots else (None, None)
                    args = dict(shape=shape, code_mode=code_mode, outlier_idx=oidx,
                                outlier_val=oval)
                    hold("fused_decompress", kernels.fused_decompress(bf, pl, eb, **args),
                         ref.fused_decompress_ref(bf, pl, eb, **args),
                         f"edge {shape} {code_mode} capacity {capf} outlier slots {slots}")
                    k6_cases += 1
    torch.cuda.synchronize()
    say(2, f"K6 bit-identical to its plain version at its edge shapes {K6_EDGE_SHAPES} in "
           f"{k6_cases} cases (outlier slots none / few, repeated and at n / overflowing every "
           f"bin / all in one tile) ({time.time() - t0:.1f} s)")
    t0 = time.time()
    k4_cases = k1_cases = 0
    for shape in K4_EDGE_SHAPES + K1_WALK_SHAPES:
        x32 = field("particle" if len(shape) == 1 else "turbulent", shape, seed=9)
        for dtype in (torch.float32, torch.bfloat16):
            off = torch.empty(x32.numel() + 3, dtype=dtype, device=dev)[3:].view(shape)
            for where, x in (("own allocation", x32.to(dtype)), ("3 elements off 16 B",
                                                                 off.copy_(x32))):
                eb = rt.resolve_eb(x, rt.FZConfig(eb=1e-3))
                for code_mode in ("sign_mag", "zigzag"):
                    k1_plain = ref.lorenzo_quant_ref(x, eb, code_mode=code_mode)
                    hold("lorenzo_quant", kernels.lorenzo_quant(x, eb, code_mode=code_mode),
                         k1_plain, f"edge {shape} {dtype} {where} {code_mode}")
                    k1_cases += 1
                    if shape not in K4_EDGE_SHAPES:
                        continue
                    flat = shuffle.pad_to_tiles(k1_plain.reshape(-1))
                    for capf in (1.0, 0.25):
                        what = f"edge {shape} {dtype} {where} {code_mode} capacity {capf}"
                        cap = rt.FZConfig(capacity_frac=capf).payload_capacity(x.numel())
                        hold("fused_compress",
                             kernels.fused_compress(x, eb, capacity=cap, code_mode=code_mode),
                             ref.fused_compress_ref(x, eb, capacity=cap, code_mode=code_mode),
                             what)
                        hold("fused_shuffle_encode",
                             kernels.fused_shuffle_encode(flat, capacity=cap),
                             ref.fused_shuffle_encode_ref(flat, capacity=cap), what)
                        ocap = rt.FZConfig().outlier_capacity(x.numel())
                        tight = eb * 1e-3
                        hold("fused_compress_strict",
                             kernels.fused_compress_strict(x, tight, capacity=cap,
                                                           outlier_capacity=ocap,
                                                           code_mode=code_mode),
                             ref.fused_compress_strict_ref(x, tight, capacity=cap,
                                                           outlier_capacity=ocap,
                                                           code_mode=code_mode),
                             what + " rel eb 1e-6")
                        k4_cases += 1
    rng = np.random.default_rng(5)
    for n_tiles in K3_TILE_COUNTS:
        size = n_tiles * shuffle.TILE
        codes = rng.integers(0, 1 << 16, size=size) * (rng.random(size) < 0.5)
        tiles = torch.from_numpy(codes.astype(np.int32)).to(torch.uint16).reshape(
            n_tiles, shuffle.TILE).to(dev)
        k2 = kernels.bitshuffle_flag(tiles)
        hold("bitshuffle_flag", k2, ref.bitshuffle_flag_ref(tiles), f"{n_tiles} tiles")
        k3 = kernels.bitunshuffle_tiles(k2[0])
        hold("bitunshuffle_tiles", k3, ref.bitunshuffle_ref(k2[0]), f"{n_tiles} tiles")
        if not same(k3, tiles):
            raise AssertionError(f"K3 does not invert K2 at {n_tiles} tiles")
    # K5 at tile counts around one wave, each payload allocated right after a
    # same-sized block of 0xFFFF is freed, so a tail left unzeroed would show
    wave = shuffle_encode_ctas()
    k5_counts = [eval(t, {"wave": wave}) for t in K5_TILES]
    k5_cases = landed = 0
    for n_tiles in k5_counts:
        codes = torch.from_numpy((rng.geometric(0.15, n_tiles * shuffle.TILE) - 1).astype(
            np.int32)).to(torch.uint16).to(dev)
        codes.view(n_tiles, -1)[1::3, 1000:3000] = 0
        for capf in (1.0, 0.25):
            cap = rt.FZConfig(capacity_frac=capf).payload_capacity(codes.numel())
            want = ref.fused_shuffle_encode_ref(codes, capacity=cap)
            for off in (0, 3):
                flat = torch.empty(codes.numel() + off, dtype=torch.uint16, device=dev)[off:]
                flat.copy_(codes)
                poison = torch.full((cap, 8), -1, dtype=torch.int16, device=dev)
                ptr = poison.data_ptr()
                del poison
                got = kernels.fused_shuffle_encode(flat, capacity=cap)
                landed += got[1].data_ptr() == ptr
                hold("fused_shuffle_encode", got, want,
                     f"{n_tiles} tiles (wave {wave}) capacity {capf} {off} elements off 16 B")
                k5_cases += 1
    torch.cuda.synchronize()
    say(2, f"K5 bit-identical to its plain version, whole payload, at {k5_counts} tiles (one "
           f"wave: {wave} CTAs), capacity 1.0 and 0.25 (nnz past the capacity there), own "
           f"allocation and 3 elements off 16 bytes, in {k5_cases} cases; {landed} payloads "
           f"landed on a freed block of 0xFFFF")
    say(2, f"K4, strict K4 (rel eb 1e-6) and K5 bit-identical to their plain versions at "
           f"{K4_EDGE_SHAPES} in {k4_cases} "
           f"cases each (float32 and bfloat16, own allocation and 3 elements off 16 bytes, both "
           f"code modes, capacity 1.0 and 0.25); K1 there and at its walk's edge shapes "
           f"{K1_WALK_SHAPES} in {k1_cases} cases (the same dtypes, places and code modes); K2 "
           f"and K3 at {K3_TILE_COUNTS} tiles of random 16-bit codes ({time.time() - t0:.1f} s)")

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
    xn = torch.tensor(NONFINITE, dtype=torch.float32)
    for exact in (True, False):
        cfg = rt.FZConfig(eb_mode="abs", exact_outliers=exact)
        c = rt.compress_with_eb(xn.to(dev), 1e-3, cfg)
        c_cpu = rt.compress_with_eb(xn, 1e-3, cfg, device="cpu")
        for f in c.FIELDS:
            if not same(getattr(c_cpu, f), getattr(c, f)):
                raise AssertionError(f"card and CPU differ in container field {f} on "
                                     f"{NONFINITE} ({'strict' if exact else 'paper'})")
        y, y_cpu = rt.decompress(c, cfg), rt.decompress(c_cpu, cfg, device="cpu")
        if not same(y_cpu, y):
            raise AssertionError(f"card and CPU reconstructions differ on {NONFINITE}")
        say(4, f"card == CPU on {NONFINITE} at abs eb 1e-3, {'strict' if exact else 'paper'} "
               f"mode: every container field and the reconstruction {y.tolist()} bit for bit")

    # -- 5. launch counts ------------------------------------------------------
    for path, counts in path_launches.items():
        say(5, f"launches on the {path} path: {counts}")
    for name in kernels.WRAPPERS:
        if KERNEL_PATH[name] == "serving":
            continue                      # phase 8
        count = path_launches[KERNEL_PATH[name]][name]
        if name in OFF_PATH and count != 0:
            raise AssertionError(f"{name} was launched {count} times on the "
                                 f"{KERNEL_PATH[name]} path, which no longer runs it")
        if name not in OFF_PATH and count <= 0:
            raise AssertionError(f"{name} was not launched on the {KERNEL_PATH[name]} path")
    if path_launches["cold and batch"]["fused_decompress"] <= 0:
        raise AssertionError("decompress_bytes did not launch fused_decompress")

    # -- 6. times at (100, 500, 500) ------------------------------------------
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

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def cold_ms(fn, iters=20, warmup=3):
        """Device time per call with L2 cold: a 64 MB write before each call,
        each call between its own pair of events, all queued behind a sleep.
        Only for calls that never wait on the card."""
        for _ in range(warmup):
            fn()
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(iters + 1)]
        torch.cuda.synchronize()
        pairs[0][0].record()
        torch.cuda._sleep(200_000_000)
        pairs[0][1].record()
        t = time.perf_counter()
        for a, b in pairs[1:]:
            flush.fill_(1.0)
            a.record()
            fn()
            b.record()
        host_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        if host_ms >= pairs[0][0].elapsed_time(pairs[0][1]):
            raise RuntimeError(f"queueing {iters} calls took {host_ms:.1f} ms, longer "
                               "than the sleep ahead of them: device time not isolated")
        return sum(a.elapsed_time(b) for a, b in pairs[1:]) / iters

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
    # K4, strict K4 and K5 write their whole capacity-sized payload, zero past
    # nnz (the TPU kernels zero it in their body,
    # repro/kernels/fused_compress.py:306); K6 reads only the used part. Strict
    # K4 also writes its outlier channel (8 bytes a slot) and the overflow count
    payload_bytes = cap * 16
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
            n * 4 + flag_bytes + payload_bytes + 4),
        "fused_compress_strict": (
            lambda: kernels.fused_compress_strict(x, eb, capacity=cap, outlier_capacity=ocap),
            lambda: ref.fused_compress_strict_ref(x, eb, capacity=cap, outlier_capacity=ocap),
            n * 4 + flag_bytes + payload_bytes + 8 * ocap + 8),
        "fused_shuffle_encode": (
            lambda: kernels.fused_shuffle_encode(flat, capacity=cap),
            lambda: ref.fused_shuffle_encode_ref(flat, capacity=cap),
            flat.numel() * 2 + flag_bytes + payload_bytes + 4),
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
               "fused_compress_strict": ("fz_compress.cu", "ops.py:127"),
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
    # strict K4 at the HACC field's size (the particle proxy drawn on the card,
    # rel eb 1e-5, the default channel): the strict benchmark cell's kernel
    hacc_n = 280_953_867
    gen = torch.Generator(device=dev).manual_seed(0)
    xh = torch.log1p(torch.exp(2.0 * torch.randn(hacc_n, generator=gen, device=dev)))
    hcfg = rt.FZConfig(eb=1e-5)
    ebh = rt.resolve_eb(xh, hcfg)
    caph, ocaph = hcfg.payload_capacity(hacc_n), hcfg.outlier_capacity(hacc_n)
    k4s = lambda: kernels.fused_compress_strict(xh, ebh, capacity=caph,  # noqa: E731
                                                outlier_capacity=ocaph)
    n_over_h = int(k4s()[5])
    nbytes_h = (hacc_n * 4 + -(-hacc_n // shuffle.TILE) * 64 + caph * 16 + 8 * ocaph + 8)
    bound_h = nbytes_h / HBM_BYTES_PER_S * 1e3
    ms_h = device_ms(k4s)
    say(6, f"{card} | fused_compress_strict at the HACC field ({hacc_n} float32, particle "
           f"proxy, rel eb 1e-5): {ms_h:.4f} ms on the card, {n_over_h} overflows of "
           f"{ocaph} slots, bound {bound_h:.4f} ms by bytes ({nbytes_h / 1e6:.1f} MB), "
           f"{100 * bound_h / ms_h:.1f}% of bound")
    say(6, f"{card} | fused_compress_strict per call at the HACC field: {breakdown(k4s)}")
    del xh, k4s
    # K5 at its tail cases: a quarter capacity (short of nnz: no tail), one
    # tile, one wave plus a tile
    k5_tail = [(f"{TIMING_SHAPE} capacity 0.25", flat,
                rt.FZConfig(capacity_frac=0.25).payload_capacity(n))]
    for n_tiles in (1, wave + 1):
        part = flat[: n_tiles * shuffle.TILE]
        k5_tail.append((f"{n_tiles} tiles of {TIMING_SHAPE}'s codes, capacity 1.0", part,
                        cfg.payload_capacity(part.numel())))
    for what, part, cap5 in k5_tail:
        k5 = lambda: kernels.fused_shuffle_encode(part, capacity=cap5)   # noqa: E731
        nnz5 = int(k5()[2])
        nbytes5 = part.numel() * 2 + part.numel() // shuffle.TILE * 64 + cap5 * 16 + 4
        bound5 = nbytes5 / HBM_BYTES_PER_S * 1e3
        ms5 = device_ms(k5)
        say(6, f"{card} | fused_shuffle_encode at {what}: {ms5:.4f} ms on the card, nnz {nnz5} "
               f"of capacity {cap5}, bound {bound5:.4f} ms by bytes ({nbytes5 / 1e6:.2f} MB), "
               f"{100 * bound5 / ms5:.1f}% of bound")
    raw = n * 4
    routes = {"fused": {}, "staged": dict(kernel_mode="staged"), "plain": dict(use_kernels=False)}
    for exact in (True, False):
        for route, kw in routes.items():
            c_cfg = rt.FZConfig(eb=1e-3, exact_outliers=exact, **kw)
            c = rt.compress(x, c_cfg)
            c_ms = cuda_ms(lambda: rt.compress(x, c_cfg), iters=10)
            d_ms = cuda_ms(lambda: rt.decompress(c, c_cfg), iters=10)
            # card-only times where the route never waits on the card (the
            # staged route's compaction and its strict quantize call nonzero)
            card_c = (f" (card {device_ms(lambda: rt.compress(x, c_cfg), iters=10):.3f} ms)"
                      if route == "fused" else "")
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

    k7_row, k6_page, k4_page, serving = serving_phases(card, dev, drive, path_launches,
                                                       max_err, cuda_ms, device_ms, cold_ms)
    paper_comparison(card, dev, fields, cuda_ms, device_ms)
    telemetry_phase(card, dev, serving, fields["Hurricane-like smooth"])
    tune_phase(card, dev, serving, fields["Hurricane-like smooth"])
    del serving, fields, flush
    wire = wire_phase(card, dev)
    train = train_phase(card, dev)
    zoo_launches = zoo_phase(card, dev)
    recurrent_launches = recurrent_phase(card, dev)
    fresh()
    example_launches = example_phase(card, dev)
    analysis_phase(card)
    syncs = sync_phase(card, dev)
    t19 = time.time()
    dryrun_phase(card)
    say(19, f"dry-run cells took {time.time() - t19:.1f} s")
    calib_launches = calibration_phase(card, dev)
    say(19, f"phase 19 took {time.time() - t19:.1f} s")
    pages = {"fused_decompress": k6_page, "fused_compress": k4_page}
    for row in rows:                  # K4 and K6 carry both shapes; max_abs_err after phase 10
        row["max_abs_err"] = max_err[row["name"]]
        if row["name"] in pages:
            row["shapes"] = [{"shape": list(TIMING_SHAPE), "ms": row["ms"],
                              "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                              "bound_by": row["bound_by"]}, pages[row["name"]]]
    rows.append(k7_row)
    for row in rows:                  # phase 14's launches, all its paths; phase 15's
        row["wire_launches"] = sum(counts[row["name"]] for counts in wire.values())
        # every path of phase 15: the full-width steps and the smoke-size resume
        row["train_launches"] = sum(counts[row["name"]] for counts in train.values())
        # phase 16's main paths: dbrx and llama4 served, qwen2-vl parked, dbrx trained
        row["zoo_launches"] = {path: counts[row["name"]]
                               for path, counts in zoo_launches.items()}
        # phase 17's main paths: rwkv6, zamba2 and whisper parked, rwkv6 and zamba2 trained
        row["recurrent_launches"] = {path: counts[row["name"]]
                                     for path, counts in recurrent_launches.items()}
        # phase 18a: each example's own path
        row["example_launches"] = {path: counts[row["name"]]
                                   for path, counts in example_launches.items()}
        # phase 19b: the calibrated prefill, decode and compressed train steps
        row["calibration_launches"] = {path: counts[row["name"]]
                                       for path, counts in calib_launches.items()}
    say(18, f"{card} | host syncs a Yi-6B decode step (phase 18c): median "
            f"{statistics.median(syncs['per_decode_step'])}")
    say(10, f"total {time.time() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
