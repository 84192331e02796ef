"""The training step: the port of ``repro/train/step.py`` (``build_train_step``).

``build_train_step`` assembles the step the reference compiles: microbatch
gradient accumulation -> the optional FZ-compressed cross-pod gradient mean
with error feedback -> global-norm clip -> AdamW on float32 masters.

    step(params, opt_state, err_state, step_idx, batch)
      -> (params, opt_state, err_state, metrics)     # metrics: loss, lr, grad_norm

Three forms, as in the reference:

* **Exact**: no ``pod`` axis, or compression off. One loss and backward over
  the whole batch, then AdamW. The step never reads the error state
  (``make_err_state`` returns ``{}``). On several ranks every rank computes
  the same step.
* **Barrier**: a ``pod`` axis with ``grad_compress.enabled``. Each pod's loss
  and gradients come from its contiguous rows of the batch (the reference
  reshapes the batch to ``(n_pods, B / n_pods)`` and vmaps); the gradients,
  stacked ``(pods, ...)``, go through ``dist.compressed_allreduce.
  reduce_stacked`` (K4 compresses, K6 decompresses every leaf past
  ``min_leaf_size``); the loss is the pod mean, as XLA computes
  ``jnp.mean`` (``pod_mean``).
* **Overlap**: ``grad_compress.overlap`` too. The plan (``assign_buckets``) is
  built once. For each forward a ``dist.bucketed_reduce.BucketReducer`` is
  installed as ``nn.grad_tap`` (and removed after it: every other forward
  runs with no tap, as in the reference). The model's
  gradient boundaries (unembed, final norm, the layer stack, embed) hand it
  their gradients from the backward, and it issues each bucket's hop once the
  bucket's last leaf is final, on a side stream on the card. The per-leaf math
  is the barrier form's, so the two are bit-identical.

The mesh says where the pods run. A ``DeviceMesh`` (``launch.mesh``) runs one
pod a rank: each rank computes its pod's rows of the global batch, passes its
``(1, ...)`` gradient slice and its own residual to the reduce, and gathers
the pods' losses for the mean. Anything else with ``axis_names`` and
``shape`` (a stand-in) runs every pod in this process, one after another,
stacked as the reference's vmap stacks them (``reduce_stacked(mesh=None)``).
Axes ``data`` and ``model`` larger than 1 (in-pod FSDP and tensor
parallelism) raise ``NotImplementedError``; for the same reason no activation
sharder is installed (``nn.shard_act`` stays the identity), where the
reference installs ``with_sharding_constraint``.

Microbatches (``TrainConfig.microbatches``): with one, the gradients stay in
the parameters' type; with more, they are summed in float32, in microbatch
order, and scaled by ``1 / n``. The reduce sees that type.

``info`` carries the reference's keys (``params``, ``opt`` and ``batch``:
``dist.sharding.NamedSharding`` trees resolved from the logical specs;
``input_structs``; ``make_err_state``; ``err_shardings``) and the port's own:
``n_pods``, ``pod`` (this rank's pod; None when every pod runs here),
``group`` (the pod process group or None), ``plan`` (the overlap form's
buckets) and ``mode`` (``"exact"``, ``"barrier"`` or ``"overlap"``).

``build_prefill_step`` / ``build_decode_step`` belong to the dry-run tooling
and are not ported yet (ROADMAP, queue 1 item 8).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import pytree
from ..device import resolve_device
from ..dist import bucketed_reduce as bkt
from ..dist import compat
from ..dist import compressed_allreduce as car
from ..dist import sharding as shd
from ..models import nn, zoo
from ..optim import AdamWConfig, adamw_update, global_norm, warmup_cosine


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    microbatches: int = 1              # gradient-accumulation steps
    adamw: AdamWConfig = AdamWConfig()
    grad_compress: car.GradCompressionConfig = car.GradCompressionConfig(enabled=False)


def _value_and_grad(model: zoo.Model, params, batch, reducer=None):
    """(loss, gradients in the parameters' types) of one batch. With a
    ``BucketReducer``, its tap is armed for the forward, so the backward hands
    it each parameter group's gradients, and it is settled after."""
    flat = [p.detach().requires_grad_(True) for p in pytree.leaves(params)]
    nn.set_grad_tap(reducer.tap if reducer is not None else None)
    try:
        loss, _ = model.train_loss(pytree.unflatten(params, flat), batch)
    finally:
        nn.set_grad_tap(None)
    # an unused parameter (Mamba2's dt_bias) gets zeros, as under jax.grad
    grads = pytree.unflatten(params, list(torch.autograd.grad(loss, flat,
                                                              materialize_grads=True)))
    if reducer is not None:
        reducer.settle(grads)
    return loss.detach(), grads


def _loss_and_grads(model: zoo.Model, params, batch, n_micro: int, reducer=None):
    """Gradient accumulation over ``n_micro`` microbatches, in order. With a
    reducer, the reducer accumulates and the gradients returned are None."""
    if n_micro == 1:
        loss, grads = _value_and_grad(model, params, batch, reducer)
        return loss, (None if reducer is not None else grads)
    b = batch["tokens"].shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    per = b // n_micro
    loss_acc = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
    g_acc = None
    if reducer is None:
        g_acc = pytree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                      device=p.device), params)
    for i in range(n_micro):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        loss, g = _value_and_grad(model, params, mb, reducer)
        if g_acc is not None:
            g_acc = pytree.tree_map(lambda a, gi: a + gi.to(torch.float32), g_acc, g)
        loss_acc = loss_acc + loss
    inv = 1.0 / n_micro
    return loss_acc * inv, (None if g_acc is None else
                            pytree.tree_map(lambda g: g * inv, g_acc))


def _pod_loss_mean(losses: list[torch.Tensor], group) -> torch.Tensor:
    """The pods' mean loss as XLA computes ``jnp.mean(losses)``: a sum in pod
    order times ``float32(1 / n)``. With a group, ``losses`` is this rank's own
    and the pods' are gathered first (not counted as gradient traffic)."""
    if group is not None:
        losses = list(car.gather_bytes(losses[0], group, None))
    return car.pod_mean(losses)


def build_train_step(model: zoo.Model, shape, mesh, tcfg: TrainConfig, *, device="cuda"):
    """Returns ``(step_fn, info)`` (see the module docstring)."""
    dev = resolve_device(device)
    names = compat.axis_names(mesh)
    in_pod = {a: compat.axis_size(mesh, a) for a in ("data", "model") if a in names}
    if any(size > 1 for size in in_pod.values()):
        raise NotImplementedError(
            f"mesh axes {in_pod}: in-pod data and model parallelism are not ported yet "
            "(ROADMAP, queue 1 item 9)")
    abstract = model.abstract_params()
    param_sh = shd.tree_shardings(model.param_specs(), abstract, mesh)
    opt_sh = {"m": param_sh, "v": param_sh, "master": param_sh,
              "count": shd.NamedSharding(mesh, ())}
    in_structs, in_logical = model.input_specs(shape)
    batch_sh = {k: shd.NamedSharding(mesh, shd.resolve_spec(in_logical[k], v.shape, mesh))
                for k, v in in_structs.items()}

    use_pod_compress = tcfg.grad_compress.enabled and "pod" in names
    overlap = use_pod_compress and tcfg.grad_compress.overlap
    n_pods = compat.axis_size(mesh, "pod") if "pod" in names else 1
    distributed = use_pod_compress and hasattr(mesh, "get_group")      # a DeviceMesh
    group = car.pod_group(mesh) if distributed else None
    pod = mesh.get_local_rank("pod") if distributed else None
    if shape.global_batch % n_pods:
        raise ValueError(f"global batch {shape.global_batch} does not split over {n_pods} pods")
    plan = bkt.assign_buckets(abstract, tcfg.grad_compress) if overlap else None

    def finish(loss, grads, params, opt_state, step_idx):
        lr = warmup_cosine(torch.as_tensor(step_idx, dtype=torch.int32, device=dev),
                           peak_lr=tcfg.peak_lr, warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)
        new_params, new_opt = adamw_update(grads, opt_state, lr, tcfg.adamw, params)
        metrics = {"loss": loss, "lr": lr, "grad_norm": global_norm(grads)}
        return new_params, new_opt, metrics

    if use_pod_compress:
        per = shape.global_batch // n_pods
        pods_here = [pod] if distributed else list(range(n_pods))
        stream = torch.cuda.Stream(dev) if overlap and dev.type == "cuda" else None

        def pod_rows(batch, p):
            return {k: v[p * per:(p + 1) * per] for k, v in batch.items()}

        def step(params, opt_state, err_state, step_idx, batch):
            losses = []
            if overlap:
                # each bucket's hop starts in the backward, once its gradients are final
                r = bkt.BucketReducer(err_state, tcfg.grad_compress, plan, group,
                                      n_slots=len(pods_here), n_micro=tcfg.microbatches,
                                      stream=stream)
                for slot, p in enumerate(pods_here):
                    r.start_pod(slot)
                    losses.append(_loss_and_grads(model, params, pod_rows(batch, p),
                                                  tcfg.microbatches, r)[0])
                grads, err_state = r.finish(params)
                del r
            else:
                grads = []
                for p in pods_here:
                    loss, g = _loss_and_grads(model, params, pod_rows(batch, p),
                                              tcfg.microbatches)
                    losses.append(loss)
                    grads.append(g)
                grads_stacked = pytree.tree_map(
                    lambda *gs: torch.stack(gs) if len(gs) > 1 else gs[0][None], *grads)
                del grads
                grads, err_state = car.reduce_stacked(grads_stacked, err_state,
                                                      tcfg.grad_compress,
                                                      mesh if distributed else None)
                del grads_stacked
            p, o, m = finish(_pod_loss_mean(losses, group), grads, params, opt_state,
                             step_idx)
            return p, o, err_state, m

        def err_shardings(grads_abstract):
            return car.error_state_shardings(grads_abstract, tcfg.grad_compress, mesh)
    else:
        def step(params, opt_state, err_state, step_idx, batch):
            loss, grads = _loss_and_grads(model, params, batch, tcfg.microbatches)
            p, o, m = finish(loss, grads, params, opt_state, step_idx)
            return p, o, err_state, m

        err_shardings = None

    def make_err_state(grads_abstract):
        if not use_pod_compress:            # no pod axis: the step never reads it
            return {}
        return car.init_error_state(grads_abstract, 1 if distributed else n_pods,
                                    tcfg.grad_compress, device=dev)

    return step, dict(params=param_sh, opt=opt_sh, batch=batch_sh,
                      input_structs=in_structs, make_err_state=make_err_state,
                      err_shardings=err_shardings, n_pods=n_pods, pod=pod, group=group,
                      plan=plan, mode=("overlap" if overlap else "barrier"
                                       if use_pod_compress else "exact"))
