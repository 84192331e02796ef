"""Training launcher: the port of ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch yi-6b --smoke --steps 20 --ckpt-dir /tmp/run1
    python -m repro_torch.launch.train --arch yi-6b --smoke --steps 4 --device cpu

Runs on the CUDA card unless ``--device cpu`` is given. The mesh is
``launch.mesh.make_local_mesh`` over the running process group (a one-rank
group when the process was started alone; ``--pods N`` needs N ranks).
Re-running with the same ``--ckpt-dir`` resumes from its newest checkpoint.

``--compressed-grads`` turns on the FZ-compressed cross-pod gradient mean;
``--overlap-reduce`` implies it and routes the step through the bucketed
reduce (``dist/bucketed_reduce.py``). Both act only on a mesh with a ``pod``
axis, which ``make_local_mesh`` builds only for ``--pods`` above 1: on one
rank the step runs the exact reduce while the printed line still says
``reduce=barrier`` (or ``bucketed-overlap``), as the reference's does.
Telemetry: ``--trace-out``, ``--metrics-out``, ``--profile-dir``
(``repro_torch.obs.cli``).
"""
from __future__ import annotations

import argparse

# The reference exports these latency-hiding-scheduler flags into
# LIBTPU_INIT_ARGS for --overlap-reduce, so that XLA can split each bucket's
# async all-gather around the remaining backward compute. Eager PyTorch has no
# such scheduler: the overlap form issues its buckets itself (train/step.py).
OVERLAP_XLA_FLAGS = (
    "--xla_tpu_enable_async_collective_fusion=true "
    "--xla_tpu_enable_async_collective_fusion_fuse_all_gather=true "
    "--xla_enable_async_all_gather=true"
)


def enable_overlap_scheduler_flags() -> None:
    """A no-op kept under the reference's name: the flags configure XLA on a
    TPU, and nothing here reads them."""


def main(argv: list[str] | None = None) -> list[dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", default=None, help="assigned shape name (defaults to a local shape)")
    p.add_argument("--smoke", action="store_true", help="reduced config")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--model-parallel", type=int, default=1)
    p.add_argument("--pods", type=int, default=1)
    p.add_argument("--compressed-grads", action="store_true")
    p.add_argument("--overlap-reduce", action="store_true",
                   help="bucketed compressed reduce (implies --compressed-grads)")
    p.add_argument("--bucket-bytes", type=int, default=4 << 20,
                   help="wire-byte target per reduce bucket (--overlap-reduce)")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-codec", choices=["raw", "fz"], default="raw")
    p.add_argument("--device", default="cuda")
    from ..obs import cli as obs_cli
    obs_cli.add_args(p)
    args = p.parse_args(argv)

    if args.overlap_reduce:
        enable_overlap_scheduler_flags()

    import torch.distributed as dist

    from .. import configs
    from ..configs.base import SHAPES, ShapeConfig
    from ..data.tokens import TokenStream
    from ..device import resolve_device
    from ..dist.compressed_allreduce import GradCompressionConfig
    from ..models import zoo
    from ..train import TrainConfig, Trainer
    from .mesh import make_local_mesh, mesh_shape

    dev = resolve_device(args.device)
    cfg = configs.get(args.arch, smoke=args.smoke)
    model = zoo.build(cfg)
    shape = SHAPES[args.shape] if args.shape else ShapeConfig("local", args.seq, args.batch,
                                                              "train")
    owns_group = not dist.is_initialized()
    mesh = make_local_mesh(model_parallel=args.model_parallel, pods=args.pods, device=dev)
    try:
        tcfg = TrainConfig(
            microbatches=args.microbatches, total_steps=args.steps,
            warmup_steps=max(args.steps // 10, 1),
            grad_compress=GradCompressionConfig(
                enabled=args.compressed_grads or args.overlap_reduce,
                overlap=args.overlap_reduce, bucket_bytes=args.bucket_bytes))
        stream = TokenStream(vocab_size=cfg.vocab, seq_len=shape.seq_len,
                             global_batch=shape.global_batch, seed=0)
        trainer = Trainer(model, shape, mesh, tcfg, stream=stream, ckpt_dir=args.ckpt_dir,
                          ckpt_codec=args.ckpt_codec, device=dev)
        reduce_mode = ("bucketed-overlap" if args.overlap_reduce else
                       "barrier" if tcfg.grad_compress.enabled else "exact")
        print(f"{cfg.arch_id}: {model.param_count()/1e6:.1f}M params, "
              f"mesh={mesh_shape(mesh)}, reduce={reduce_mode}, "
              f"resume_step={trainer.step}")
        obs_cli.start(args, device=dev)
        hist = trainer.run(args.steps - trainer.step)
        for m in hist[:: max(len(hist) // 10, 1)]:
            print(f"step {m['step']:5d} loss {m['loss']:.4f} ({m['seconds']:.2f}s)")
        obs_cli.finish(args, metadata={"arch": cfg.arch_id, "mode": "train",
                                       "reduce": reduce_mode})
    finally:
        if owns_group:
            dist.destroy_process_group()
    return hist


if __name__ == "__main__":
    main()
