"""End-to-end driver: train a ~100M-param LM for a few hundred steps. The port
of ``examples/train_lm.py``.

Exercises the full production path at laptop scale: the training step on a
one-rank mesh (``make_local_mesh``: any (pod, data, model) layout on more
ranks), AdamW + warmup-cosine, checkpoint/restart (kill it mid-run and
re-launch: it resumes), straggler watchdog, and FZ-compressed checkpoints
(float32 leaves through K5 on save and K6 on restore, on the card).

    python -m repro_torch.examples.train_lm --steps 300
    python -m repro_torch.examples.train_lm --steps 2 --batch 2 --seq 16 --device cpu

Runs on the CUDA card unless ``--device cpu`` is given; the weights are drawn
from a ``torch.Generator`` seeded 0. ``--ckpt-dir`` defaults to a directory
under the system's temporary directory. ``main`` returns the step history.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import zoo
from repro_torch.train import TrainConfig, Trainer


def main(argv: list[str] | None = None) -> list[dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "fztorch_train_lm"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    # ~100M params: yi-6b family scaled down (keeps GQA + SwiGLU structure)
    cfg = dataclasses.replace(
        configs.get("yi-6b"),
        arch_id="yi-100m", n_layers=10, d_model=640, n_heads=10, n_kv_heads=2,
        d_ff=1792, vocab=16_384, head_dim=64)
    model = zoo.build(cfg)
    print(f"arch={cfg.arch_id}  params={model.param_count() / 1e6:.1f}M")

    owns_group = not dist.is_initialized()
    mesh = make_local_mesh(device=args.device)
    try:
        shape = ShapeConfig("train_local", args.seq, args.batch, "train")
        stream = TokenStream(vocab_size=cfg.vocab, seq_len=args.seq,
                             global_batch=args.batch, seed=0)
        trainer = Trainer(model, shape, mesh,
                          TrainConfig(peak_lr=3e-4, warmup_steps=30, total_steps=args.steps),
                          stream=stream, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                          ckpt_codec="fz", device=args.device)
        if trainer.step:
            print(f"resumed from checkpoint at step {trainer.step}")

        hist = trainer.run(args.steps - trainer.step)
        for m in hist[:: max(len(hist) // 12, 1)]:
            print(f"step {m['step']:4d}  loss {m['loss']:.4f}  lr {m['lr']:.2e}  "
                  f"{m['seconds']:.2f}s" + ("  [straggler]" if m["straggler"] else ""))
        print(f"final loss: {hist[-1]['loss']:.4f} (from {hist[0]['loss']:.4f})")
        if trainer.watchdog.events:
            print("straggler events:",
                  [(e.step, round(e.seconds, 2)) for e in trainer.watchdog.events])
    finally:
        if owns_group:
            dist.destroy_process_group()
    return hist


if __name__ == "__main__":
    main()
