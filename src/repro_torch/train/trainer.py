"""Trainer loop: data -> step -> metrics, with checkpoint/restart and a
straggler watchdog. The port of ``repro/train/trainer.py``.

  * restart: on construction the trainer restores the newest checkpoint
    under ``ckpt_dir`` (params, optimizer, error-feedback state, step) and
    the loss sequence continues bit for bit;
  * periodic and final checkpoints, atomic, keep-last-k (``repro_torch.ckpt``;
    ``ckpt_codec="fz"`` compresses float32 leaves with strict K4 and restores them
    with K6 on the card);
  * straggler watchdog: each step's wall time against an EWMA; a step slower
    than ``factor`` times the EWMA is logged with a mitigation decision.

Telemetry as in the reference: each step runs under ``obs.span("train.step")``,
sets the gauge ``train_tokens_per_s``, counts ``train_steps`` and calls
``sentinels.assert_healthy()``.

Differences from the reference: ``init_params=`` starts from a given parameter
tree (in the port's layout, e.g. the reference's weights carried over by
``interop.params_from_reference``) instead of ``model.init(seed)``; ``device=``
as every entry point of the port. With a ``DeviceMesh`` pod axis (one pod a
rank) the error state is gathered to the stacked ``(n_pods, ...)`` layout the
reference saves, rank 0 writes the checkpoint, and each rank restores its own
pod's slice. On a mesh with in-pod axes larger than 1 the parameters and the
optimizer state are DTensors laid out by the step's ``info`` (a step returns
them so); a save gathers every leaf whole (a collective on every rank) before
rank 0 writes, and a restore lays the full leaves out again.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch
import torch.distributed as dist

from .. import obs, pytree
from ..ckpt import checkpoint as ckpt
from ..data.tokens import TokenStream
from ..device import resolve_device
from ..dist import compressed_allreduce as car
from ..dist import sharding as shd
from ..models import zoo
from ..obs import sentinels
from ..optim import adamw_init
from .step import TrainConfig, build_train_step


@dataclasses.dataclass
class WatchdogEvent:
    step: int
    seconds: float
    ewma: float
    action: str


class StragglerWatchdog:
    def __init__(self, factor: float = 3.0, alpha: float = 0.2, warmup: int = 2):
        self.factor = factor
        self.alpha = alpha
        self.warmup = warmup          # ignore the first steps (warm-up, first builds)
        self.seen = 0
        self.ewma: float | None = None
        self.events: list[WatchdogEvent] = []

    def observe(self, step: int, seconds: float) -> WatchdogEvent | None:
        self.seen += 1
        if self.seen <= self.warmup:
            return None
        if self.ewma is None:
            self.ewma = seconds
            return None
        flagged = seconds > self.factor * self.ewma
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        if flagged:
            ev = WatchdogEvent(step, seconds, self.ewma,
                               "flag: candidate for elastic reshard / hot spare swap")
            self.events.append(ev)
            return ev
        return None


class Trainer:
    def __init__(self, model: zoo.Model, shape, mesh, tcfg: TrainConfig, *,
                 stream: TokenStream, ckpt_dir: str | None = None,
                 ckpt_every: int = 50, seed: int = 0,
                 ckpt_codec: str = "raw", keep_last: int = 3,
                 init_params: dict | None = None, device="cuda"):
        self.model, self.shape, self.mesh, self.tcfg = model, shape, mesh, tcfg
        self.device = resolve_device(device)
        self.stream = stream
        self.ckpt_dir, self.ckpt_every = ckpt_dir, ckpt_every
        self.ckpt_codec, self.keep_last = ckpt_codec, keep_last
        self.watchdog = StragglerWatchdog()
        self.step_fn, self.info = build_train_step(model, shape, mesh, tcfg,
                                                   device=self.device)
        if init_params is None:
            init_params = model.init(torch.Generator(device=self.device).manual_seed(seed),
                                     device=self.device)
        self.params = pytree.tree_map(lambda t: t.to(self.device), init_params)
        if self.info["sharded"]:
            self.params = shd.distribute_like(self.params, self.info["params"])
        self.opt = adamw_init(self.params)
        self.err = self.info["make_err_state"](model.abstract_params())
        self.step = 0
        self.history: list[dict] = []
        if ckpt_dir is not None and ckpt.latest_step(ckpt_dir) is not None:
            self._restore()

    # ------------------------------------------------------------------
    def _state(self, err=None):
        return {"params": self.params, "opt": self.opt,
                "err": self.err if err is None else err}

    def _full_state(self, err=None):
        """``_state`` with every DTensor leaf gathered whole (a collective)."""
        return shd.gather_tree(self._state(err))

    def _stacked_err(self):
        """The error state in the reference's stacked ``(n_pods, ...)`` layout:
        with a pod group, every rank's slice gathered (a collective)."""
        group = self.info["group"]
        if group is None:
            return self.err
        return pytree.tree_map(
            lambda e: e if e.numel() == 0 else car.gather_bytes(e[0], group, None), self.err)

    def _restore(self):
        state, meta = ckpt.restore(self.ckpt_dir, self._state(), device=self.device)
        self.params, self.opt = state["params"], state["opt"]
        if self.info["sharded"]:
            self.params = shd.distribute_like(self.params, self.info["params"])
            self.opt = {k: (v if k == "count" else shd.distribute_like(v, self.info["params"]))
                        for k, v in self.opt.items()}
        pod = self.info["pod"]
        self.err = state["err"] if pod is None else pytree.tree_map(
            lambda e: e[pod:pod + 1].contiguous(), state["err"])
        self.step = int(meta["step"])

    def save(self):
        if self.ckpt_dir is None:
            return
        err = self._stacked_err()
        state = self._full_state(err)
        ranks = dist.is_initialized() and dist.get_world_size() > 1
        if not ranks or dist.get_rank() == 0:
            ckpt.save(self.ckpt_dir, self.step, state,
                      meta={"data_seed": self.stream.seed},
                      codec=self.ckpt_codec, keep_last=self.keep_last, device=self.device)
        if ranks:
            dist.barrier()                     # the step is on disk before any rank reads it

    # ------------------------------------------------------------------
    def _batch(self, step: int) -> dict:
        arr = torch.from_numpy(self.stream.shard_batch(step, shard=0, num_shards=1))
        return {"tokens": arr[:, :-1].to(self.device), "labels": arr[:, 1:].to(self.device)}

    def run(self, n_steps: int, *, delay_injector: Callable[[int], float] | None = None):
        tokens_per_batch = None
        for _ in range(n_steps):
            t0 = time.perf_counter()
            with obs.span("train.step", step=self.step):
                batch = self._batch(self.step)
                self.params, self.opt, self.err, metrics = self.step_fn(
                    self.params, self.opt, self.err, self.step, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
            if delay_injector is not None:
                time.sleep(delay_injector(self.step))
            dt = time.perf_counter() - t0
            if tokens_per_batch is None:
                tokens_per_batch = int(batch["tokens"].numel())
            obs.gauge("train_tokens_per_s").set(tokens_per_batch / max(dt, 1e-9))
            obs.counter("train_steps").inc()
            sentinels.assert_healthy()
            ev = self.watchdog.observe(self.step, dt)
            metrics.update(step=self.step, seconds=dt, straggler=bool(ev))
            self.history.append(metrics)
            self.step += 1
            if self.ckpt_dir is not None and self.step % self.ckpt_every == 0:
                self.save()
        if self.ckpt_dir is not None:
            self.save()
        return self.history
