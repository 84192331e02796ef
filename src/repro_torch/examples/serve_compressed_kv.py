"""Prefix-shared continuous batching through the paged FZ KV pool (§2.4). The
port of ``examples/serve_compressed_kv.py``.

A seeded trace-driven load (tracegen): Poisson arrivals drawing from a
template pool, so most requests share a long prompt prefix — the production
shape the radix page table is built for. The pool completes a trace whose
raw demand exceeds the slab because (a) matched prefixes are *mapped*, not
re-prefilled (one physical page serves every reader; writes copy-on-write),
(b) cold pages tier down to entropy-coded FZ byte containers
(``PoolConfig.cold_entropy``, docs/CONTAINER_FORMAT.md), freeing their
slots, and (c) preempted sequences are compress-parked instead of
recomputed.
Every request's tokens are checked against the never-parked whole-cache
oracle (``Engine.generate``).

    python -m repro_torch.examples.serve_compressed_kv            # full
    python -m repro_torch.examples.serve_compressed_kv --smoke    # tiny model,
                                     # 3-page pool, 4-request trace
    python -m repro_torch.examples.serve_compressed_kv --kernels  # decode through
                                     # K7 over the page view, cold pages
                                     # through K4 (park) and K6 (read)
    python -m repro_torch.examples.serve_compressed_kv --smoke --device cpu

Without ``--kernels`` the pool takes the plain route (``use_kernels=False``),
as the reference's does. Deliberate difference: the 0.9 bar on the oracle
agreement holds the teacher-forced agreement (the oracle's greedy token on the
pooled run's own prefix, at every step); the reference's free-running agreement
is printed beside it. A free-running stream that flips at one near tie of the
bfloat16 logits (random weights have many) diverges for the rest of its
request: the reference's own example passes its free-running bar at 2 of 5
weight seeds on the CPU, and the port's eager bfloat16 ops round at every op.
Weights are random, drawn from a ``torch.Generator`` seeded 0 on the device.
The telemetry checks read the process-wide ``obs``
registry: in a process that ran other work, reset it first
(``obs.reset()``, ``obs.clear_events()``). ``main`` returns the outputs, the
``TraceStats`` and the oracle agreement.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs, obs
from repro_torch.models import zoo
from repro_torch.obs import cli as obs_cli
from repro_torch.serve import Engine, PoolConfig
from repro_torch.serve.kvpool import TraceGenConfig, generate, latency_summary


def build(smoke: bool, kernels: bool = False):
    if smoke:
        cfg = configs.get("glm4-9b", smoke=True)
        pool = PoolConfig(num_pages=3, page_size=8, seq_capacity=32,
                          cold_after=1, eb=1e-4, use_kernels=kernels,
                          cold_entropy=True)
        tg = TraceGenConfig(seed=1, n_requests=4, vocab=cfg.vocab,
                            arrival_rate=2.0, n_templates=1,
                            template_len=(12, 12), template_reuse=0.9,
                            suffix_len=(2, 4), n_new=(4, 6),
                            priorities=(0, 1), ttft_slo=6, itl_slo=4)
        max_batch = 2
    else:
        cfg = dataclasses.replace(
            configs.get("glm4-9b"),
            arch_id="glm4-mini", n_layers=4, d_model=256, n_heads=8,
            n_kv_heads=2, d_ff=704, vocab=4096, head_dim=32)
        # 4 slots against ~37 pages of raw demand: tight enough that running
        # tails protect most of the slab, so admission pressure has to
        # compress-park victims, not just tier cold pages
        pool = PoolConfig(num_pages=4, page_size=16, seq_capacity=128,
                          cold_after=2, eb=1e-4, use_kernels=kernels,
                          max_cached_pages=6, cold_entropy=True)
        tg = TraceGenConfig(seed=4, n_requests=8, vocab=cfg.vocab,
                            arrival_rate=1.0, n_templates=2,
                            template_len=(32, 48), template_reuse=0.75,
                            suffix_len=(4, 8), n_new=(8, 12),
                            priorities=(0, 1), ttft_slo=10, itl_slo=6)
        max_batch = 3
    return cfg, pool, tg, max_batch


def teacher_forced(eng: Engine, prompt, tokens) -> float:
    """Fraction of a pooled run's tokens that the never-parked whole-cache oracle
    picks greedily when fed the pooled run's own prefix (prompt + earlier tokens)."""
    logits, cache = eng.prefill({"tokens": torch.as_tensor(prompt)[None].to(eng.device)})
    hits = []
    for i, tok in enumerate(tokens):
        hits.append(int(torch.argmax(logits[0])) == int(tok))
        if i + 1 < len(tokens):
            logits, cache = eng.model.decode(
                eng.params, cache, torch.tensor([int(tok)], dtype=torch.int32).to(eng.device))
    return float(np.mean(hits))


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model, 3-page pool, 4-request trace")
    ap.add_argument("--kernels", action="store_true",
                    help="decode through K7 over the page view and park cold "
                         "pages through K4/K6 (each wrapper's plain version "
                         "on the CPU)")
    ap.add_argument("--device", default="cuda")
    obs_cli.add_args(ap)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    obs_cli.start(args, device=dev)

    cfg, pool_cfg, tg, max_batch = build(args.smoke, args.kernels)
    model = zoo.build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    mode = "K7 paged decode (CUDA kernels)" if args.kernels else "reference decode"
    print(f"decode path: {mode}")
    print(f"serving {cfg.arch_id}: {model.param_count() / 1e6:.1f}M params, "
          f"pool {pool_cfg.num_pages} pages x {pool_cfg.page_size} tokens, "
          f"prefix_mode={pool_cfg.prefix_mode}")

    reqs = generate(tg)
    pages_demanded = sum(-(-len(r.tokens) // pool_cfg.page_size) +
                         -(-r.n_new // pool_cfg.page_size) for r in reqs)
    prompt_tokens = sum(len(r.tokens) for r in reqs)
    print(f"trace: {len(reqs)} requests / {prompt_tokens} prompt tokens from "
          f"{tg.n_templates} template(s) at {tg.template_reuse:.0%} reuse, "
          f"Poisson rate {tg.arrival_rate}/step; demands ~{pages_demanded} "
          f"pages raw vs a {pool_cfg.num_pages}-slot slab")

    eng = Engine(model, params, pool=pool_cfg, device=dev)
    outputs, stats, pool = eng.serve(reqs, max_batch=max_batch)
    assert len(outputs) == len(reqs), "trace did not complete"
    assert stats.preemptions >= 1, "trace never exercised compress-parking"
    assert stats.prefix_hits >= 2, "trace never exercised prefix sharing"
    assert stats.cow_promotions >= 1, "trace never exercised copy-on-write"

    slab = pool_cfg.num_pages * pool.slot_bytes
    print(f"\ncompleted {stats.completed} requests in {stats.decode_steps} "
          f"decode steps: {stats.admissions} admissions, "
          f"{stats.preemptions} preemptions (compress-park), "
          f"{stats.resumes} resumes, {stats.tiered_pages} pages tiered cold")
    print(f"prefix sharing: {stats.prefix_hits}/{stats.admissions} admissions "
          f"hit the radix cache; {stats.prefill_tokens} prompt tokens "
          f"prefilled, {stats.prefill_tokens_saved} served from shared pages; "
          f"{stats.cow_promotions} copy-on-write forks, "
          f"{stats.shared_cold_reads_deduped} shared cold reads deduped "
          f"({stats.pool_decompressions} decompressions in "
          f"{stats.decompress_dispatches} batched dispatches)")
    lat = latency_summary(stats, tg)
    print(f"latency (steps): ttft p50/p99 {lat['ttft_p50']:.0f}/"
          f"{lat['ttft_p99']:.1f}, itl p50/p99 {lat['itl_p50']:.0f}/"
          f"{lat['itl_p99']:.1f}; SLO attainment ttft "
          f"{lat['ttft_slo_attained']:.0%}, itl {lat['itl_slo_attained']:.0%}")
    print(f"pool memory high-water: {stats.high_water_used_bytes / 1e3:.1f} KB "
          f"(raw slab in use + compressed payloads) vs "
          f"{stats.high_water_logical_bytes / 1e3:.1f} KB had every reader "
          f"held private raw pages "
          f"({stats.high_water_logical_bytes / max(stats.high_water_used_bytes, 1):.2f}x)"
          f"; preallocated slab {slab / 1e3:.1f} KB")

    # parity vs. the never-parked whole-cache oracle: free-running (the
    # reference's number) and teacher-forced (the bar)
    agrees, forced = [], []
    for r in reqs:
        oracle, _ = eng.generate({"tokens": torch.as_tensor(r.tokens)[None]}, r.n_new)
        agrees.append(float((oracle[0].cpu().numpy() == outputs[r.req_id]).mean()))
        forced.append(teacher_forced(eng, r.tokens, outputs[r.req_id]))
    mean_agree, mean_forced = float(np.mean(agrees)), float(np.mean(forced))
    print(f"decode-token agreement, pooled (shared + parked) vs never-parked "
          f"oracle at eb={pool_cfg.eb:g}: {mean_agree * 100:.1f}% "
          f"(per request: {[f'{a:.2f}' for a in agrees]}); teacher-forced "
          f"{mean_forced * 100:.1f}% (per request: {[f'{a:.2f}' for a in forced]})")
    print("sample continuation (pooled):", outputs[reqs[0].req_id][:10])
    assert mean_forced >= 0.9, f"shared decode diverged from oracle: {forced}"

    # telemetry cross-checks: the registry's FZ dispatch counts must agree
    # exactly with the pool's own accounting, and the run must finish with
    # zero error-bound sentinel violations
    snap = obs.snapshot()
    fz_decomp = sum(v for k, v in snap["counters"].items()
                    if k.startswith("fz_dispatches{op=decompress,"))
    assert fz_decomp == stats.decompress_dispatches, (
        f"fz decompress dispatches {fz_decomp} != pool "
        f"{stats.decompress_dispatches}")
    assert not obs.violations(), f"sentinel violations: {obs.violations()}"
    # entropy cold tier: parked pages were serialized through to_bytes with
    # the probe-gated entropy stage — the counters prove the tier ran, and
    # the zero-violations assert above covered its bit-exact decode path
    ent_ops = {k: v for k, v in snap["counters"].items()
               if k.startswith("entropy_stage{")}
    assert any("tier=kv_cold_entropy" in k for k in ent_ops), \
        f"entropy cold tier never exercised: {sorted(ent_ops)}"
    n_sel = sum(v for k, v in ent_ops.items()
                if "op=encode" in k and "selected=true" in k)
    n_skip = sum(v for k, v in ent_ops.items()
                 if "op=encode" in k and "selected=false" in k)
    print(f"telemetry: {fz_decomp} fz decompress dispatches == pool "
          f"accounting; entropy stage on {n_sel} parked containers "
          f"({n_skip} probe-skipped); 0 sentinel violations")
    if args.kernels:
        # tuned dispatch: with use_kernels on, the pool's kernel_mode="auto"
        # FZ entries and the engine's decode-attention choice must have
        # resolved through the repro_torch.tune registry (cached winner or
        # the static fallback) — never a hardcoded path
        tuned = {k: v for k, v in snap["counters"].items()
                 if k.startswith(("tune_cache{", "tune_selected{"))
                 and "site=dispatch" in k}
        assert tuned, "kernels run never dispatched through repro_torch.tune"
        assert any(k.startswith("tune_selected{") and "op=decode_attention" in k
                   for k in tuned), \
            "decode attention never resolved through repro_torch.tune"
        assert any(k.startswith("tune_selected{") and "op=fz." in k
                   for k in tuned), \
            "FZ kernel_mode=auto never resolved through repro_torch.tune"
        print(f"tuned dispatch: {sum(tuned.values())} repro_torch.tune "
              f"resolutions across {len(tuned)} counter keys")
    obs_cli.finish(args, metadata={"arch": cfg.arch_id,
                                   "mode": "serve-prefix-shared"})
    return {"outputs": outputs, "stats": stats, "agreement": mean_agree,
            "teacher_forced": mean_forced}


if __name__ == "__main__":
    main()
