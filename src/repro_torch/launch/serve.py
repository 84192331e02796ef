"""Serving launcher: batched prefill + greedy decode, optional FZ KV parking, or
the paged FZ KV pool with continuous batching. The port of ``repro/launch/serve.py``.

    python -m repro_torch.launch.serve --arch yi-6b --paged
    python -m repro_torch.launch.serve --arch yi-6b --smoke --paged --device cpu
    python -m repro_torch.launch.serve --arch glm4-9b --smoke --kv-compress --device cpu
    python -m repro_torch.launch.serve --arch dbrx-132b --smoke --paged --device cpu
    python -m repro_torch.launch.serve --arch qwen2-vl-72b --smoke --kv-compress --device cpu

Weights are random, drawn from a ``torch.Generator`` seeded 0 on the device.
``--paged`` decodes through K7 and compresses cold pages through K4/K6;
``--no-kernels`` takes the plain route. M-RoPE archs (qwen2-vl-72b) serve
through the whole cache only, with position ids 0..S-1 on all three axes (the
vision frontend is stubbed). Runs on the CUDA card unless
``--device cpu`` is given. Telemetry (``repro_torch.obs.cli``):
``--trace-out PATH`` writes the spans as a Chrome trace, ``--metrics-out
PATH`` the metric registry and sentinel violations as JSON, and
``--profile-dir DIR`` a ``torch.profiler`` trace of the run (the card's
kernels too, when it runs on the card).
"""
from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--prompt-len", type=int, default=128)
    p.add_argument("--tokens", type=int, default=16)
    p.add_argument("--kv-compress", action="store_true")
    p.add_argument("--kv-eb", type=float, default=1e-4)
    p.add_argument("--paged", action="store_true",
                   help="serve through the paged KV pool (repro_torch.serve.kvpool)")
    p.add_argument("--pool-pages", type=int, default=8)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--cold-after", type=int, default=2)
    p.add_argument("--no-kernels", action="store_true",
                   help="the plain PyTorch route instead of the CUDA kernels")
    p.add_argument("--device", default="cuda")
    from ..obs import cli as obs_cli
    obs_cli.add_args(p)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from .. import configs
    from ..device import resolve_device
    from ..models import zoo
    from ..serve import Engine, KVCompressionConfig, PoolConfig, Request
    from ..serve.engine import cache_bytes, compressed_cache_bytes

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch, smoke=args.smoke)
    model = zoo.build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    use_kernels = not args.no_kernels
    obs_cli.start(args, device=dev)

    if args.paged:
        cap = args.page_size * -(-(args.prompt_len + args.tokens + 1) // args.page_size)
        pool_cfg = PoolConfig(num_pages=args.pool_pages, page_size=args.page_size,
                              seq_capacity=cap, cold_after=args.cold_after, eb=args.kv_eb,
                              use_kernels=use_kernels)
        eng = Engine(model, params, pool=pool_cfg, device=dev)
        reqs = [Request(req_id=i,
                        tokens=rng.integers(0, cfg.vocab, (args.prompt_len,), dtype=np.int32),
                        n_new=args.tokens, priority=i % 2)
                for i in range(args.batch)]
        outputs, stats, pool = eng.serve(reqs, max_batch=min(args.batch, 4))
        print(f"{cfg.arch_id}: {stats.completed} requests in {stats.decode_steps} decode "
              f"steps ({stats.preemptions} preempt / {stats.resumes} resume / "
              f"{stats.tiered_pages} tiered) on {dev}")
        print(f"pool high-water {stats.high_water_used_bytes / 1e6:.2f} MB vs "
              f"{stats.high_water_demand_bytes / 1e6:.2f} MB raw demand")
        print("first sequence:", outputs[0])
        obs_cli.finish(args, metadata={"arch": cfg.arch_id, "mode": "serve-paged",
                                       "device": str(dev)})
        return {"outputs": outputs, "stats": stats}

    batch = {"tokens": rng.integers(0, cfg.vocab, (args.batch, args.prompt_len),
                                    dtype=np.int32)}
    if cfg.mrope_sections is not None:
        batch["positions"] = np.broadcast_to(np.arange(args.prompt_len, dtype=np.int32),
                                             (args.batch, 3, args.prompt_len)).copy()
    eng = Engine(model, params, kv_compress=KVCompressionConfig(
        enabled=args.kv_compress, eb=args.kv_eb, use_kernels=use_kernels), device=dev)
    toks, cache = eng.generate(batch, args.tokens, park_between=args.kv_compress)
    print(f"{cfg.arch_id}: generated {tuple(toks.shape)} tokens on {dev}")
    print("first sequence:", toks[0].cpu().numpy())
    out = {"tokens": toks}
    if args.kv_compress:
        parked = eng.park(cache)
        print(f"KV parked: {cache_bytes(cache) / 1e6:.1f} MB -> "
              f"{compressed_cache_bytes(parked) / 1e6:.1f} MB")
        out["parked_bytes"] = compressed_cache_bytes(parked)
    obs_cli.finish(args, metadata={"arch": cfg.arch_id, "mode": "serve", "device": str(dev)})
    return out


if __name__ == "__main__":
    main()
