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
pod a rank group: each pod computes its rows of the global batch, passes its
``(1, ...)`` gradient slice and its own residual to the reduce, and gathers
the pods' losses for the mean. Anything else with ``axis_names`` and
``shape`` (a stand-in) runs every pod in this process, one after another,
stacked as the reference's vmap stacks them (``reduce_stacked(mesh=None)``).

In-pod FSDP and tensor parallelism (``data`` and ``model`` axes larger than
1 on a ``DeviceMesh``) run on DTensors, where the reference runs GSPMD:
parameters, masters and moments are laid out by ``info["params"]`` /
``info["opt"]`` (``dist.sharding.distribute_like``; a step takes full
tensors or DTensors and returns DTensors), the batch by ``info["batch"]``,
and the activation sharder (``_install_act_sharder``) redistributes each
``nn.shard_act`` site to its resolved placements, as the reference's
``with_sharding_constraint``. The forward and backward run under
``dist.sharding.sharded_ops``; gradients are laid out as their parameters
(a reduce-scatter) before AdamW, whose ``global_norm`` reduces whole
tensors. With the compressed pod hop, each pod's forward runs on its
``(data, model)`` sub-mesh; each gradient leaf is gathered whole within the
pod, so K4 compresses the pod's whole leaf with ``eb`` from the whole
leaf's range, as the reference's ``shard_map`` (manual over ``pod`` only)
does; the hop and K6 run as with ``data == model == 1``, and the mean is
laid back out as the parameter. The error state stays each pod's whole
``(1, ...)`` residual on every rank of the pod: the local block of
``err_shardings``' layout (pod on the leading dimension, replicated in the
pod). Meshes with ``data == model == 1`` keep the plain tensors of the
paths above.

Microbatches (``TrainConfig.microbatches``): with one, the gradients stay in
the parameters' type; with more, they are summed in float32, in microbatch
order, and scaled by ``1 / n``. The reduce sees that type.

``info`` carries the reference's keys (``params``, ``opt`` and ``batch``:
``dist.sharding.NamedSharding`` trees resolved from the logical specs;
``input_structs``; ``make_err_state``; ``err_shardings``) and the port's own:
``n_pods``, ``pod`` (this rank's pod; None when every pod runs here),
``group`` (the pod process group or None), ``plan`` (the overlap form's
buckets) and ``mode`` (``"exact"``, ``"barrier"`` or ``"overlap"``).

``build_prefill_step`` / ``build_decode_step`` are the serving steps that the
dry-run shares: ``(fn, info)`` with the reference's keys (``params``,
``batch``, ``cache``: shardings; ``input_structs``, ``cache_structs``: meta
tensors). On a sharded mesh the parameters, inputs and caches become
DTensors by those shardings. The reference's decode donates its cache; the
port's decode step writes the new cache into the one it was given, in place,
and returns it.
"""
from __future__ import annotations

import contextlib
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


def _install_act_sharder(mesh) -> None:
    """Route ``nn.shard_act`` to DTensor: a DTensor activation is redistributed
    to its logical spec resolved against its own mesh (``mesh``, or a pod's
    sub-mesh of it); a plain tensor passes unchanged. Process-wide, as the
    reference's trace-time global."""

    def sharder(x, logical):
        if not shd.is_dtensor(x):
            return x
        m = x.device_mesh
        return x.redistribute(m, shd.placements(shd.resolve_spec(tuple(logical), x.shape, m), m))

    nn.set_act_sharder(sharder)


def _in_pod_sharded(mesh) -> bool:
    """A ``DeviceMesh`` whose ``data`` and ``model`` axes hold more than one rank."""
    if not hasattr(mesh, "get_group"):
        return False
    names = compat.axis_names(mesh)
    n = 1
    for a in ("data", "model"):
        if a in names:
            n *= compat.axis_size(mesh, a)
    return n > 1


def _mesh_sharded(mesh) -> bool:
    """A ``DeviceMesh`` of more than one rank (the serving steps shard over all)."""
    return hasattr(mesh, "get_group") and mesh.size() > 1


def _relaid(x, sharding):
    """``x`` (a DTensor, or a full tensor every rank holds) laid out by ``sharding``."""
    if shd.is_dtensor(x):
        return x.redistribute(sharding.mesh, sharding.placements)
    return shd.distribute(x, sharding)


def _laid_out(tree, shardings):
    """A tree laid out by a tree of shardings (:func:`_relaid` a leaf)."""
    return pytree.tree_map(_relaid, tree, shardings)


def _batch_on(batch: dict, logical: dict, mesh) -> dict:
    """A batch (or a microbatch, or a pod's rows) laid out on ``mesh`` by its
    logical specs resolved at its own shape."""
    return {k: shd.distribute(v, shd.NamedSharding(mesh, shd.resolve_spec(logical[k], v.shape,
                                                                          mesh)))
            for k, v in batch.items()}


def _value_and_grad(model: zoo.Model, params, batch, reducer=None, lay=None):
    """(loss, gradients in the parameters' types) of one batch. With a
    ``BucketReducer``, its tap is armed for the forward, so the backward hands
    it each parameter group's gradients, and it is settled after. ``lay``
    lays the batch out (the sharded forms); DTensor gradients come back laid
    out as their parameters and the loss as a full tensor."""
    flat = [p.detach().requires_grad_(True) for p in pytree.leaves(params)]
    if lay is not None:
        batch = lay(batch)
    nn.set_grad_tap(reducer.tap if reducer is not None else None)
    try:
        loss, _ = model.train_loss(pytree.unflatten(params, flat), batch)
        loss = shd.gather(loss)
    finally:
        nn.set_grad_tap(None)
    # an unused parameter (Mamba2's dt_bias) gets zeros, as under jax.grad
    gs = list(torch.autograd.grad(loss, flat, materialize_grads=True))
    gs = [g.redistribute(p.device_mesh, p.placements) if shd.is_dtensor(g) else g
          for g, p in zip(gs, flat)]
    grads = pytree.unflatten(params, gs)
    if reducer is not None:
        reducer.settle(grads)
    return loss.detach(), grads


def _loss_and_grads(model: zoo.Model, params, batch, n_micro: int, reducer=None,
                    lay=None):
    """Gradient accumulation over ``n_micro`` microbatches, in order. With a
    reducer, the reducer accumulates and the gradients returned are None."""
    if n_micro == 1:
        loss, grads = _value_and_grad(model, params, batch, reducer, lay)
        return loss, (None if reducer is not None else grads)
    b = batch["tokens"].shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    per = b // n_micro
    loss_acc = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
    g_acc = None
    if reducer is None:
        g_acc = pytree.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    for i in range(n_micro):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        loss, g = _value_and_grad(model, params, mb, reducer, lay)
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
    dev = resolve_device(device, allow_meta=True)     # meta: the dry-run's shapes
    _install_act_sharder(mesh)
    names = compat.axis_names(mesh)
    sharded = _in_pod_sharded(mesh)
    if not sharded and any(compat.axis_size(mesh, a) > 1 for a in ("data", "model")
                           if a in names):
        raise ValueError("data or model axes larger than 1 need a DeviceMesh "
                         "(launch.mesh), on which the step runs on DTensors")
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
    # where each forward runs: the whole mesh, or the pod's (data, model) sub-mesh
    fwd_mesh = None
    if sharded:
        fwd_mesh = mesh[tuple(a for a in names if a != "pod")] if use_pod_compress else mesh
    extra = {"lay": lambda b: _batch_on(b, in_logical, fwd_mesh)} if sharded else {}

    def on_fwd_mesh(params):
        """The parameters as DTensors on the forward's mesh (a pod's sub-mesh:
        the same local blocks, the pod dimension dropped)."""
        if not sharded or fwd_mesh is mesh:
            return params
        from torch.distributed.tensor import DTensor
        keep = [i for i, a in enumerate(names) if a != "pod"]
        return pytree.tree_map(lambda x: DTensor.from_local(
            x.to_local(), fwd_mesh, [x.placements[i] for i in keep], run_check=False,
            shape=x.shape, stride=x.stride()), params)

    def finish(loss, grads, params, opt_state, step_idx):
        lr = warmup_cosine(torch.as_tensor(step_idx, dtype=torch.int32, device=dev),
                           peak_lr=tcfg.peak_lr, warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.total_steps)
        new_params, new_opt = adamw_update(grads, opt_state, lr, tcfg.adamw, params)
        metrics = {"loss": loss, "lr": lr, "grad_norm": shd.gather(global_norm(grads))}
        return new_params, new_opt, metrics

    def sharded_step(body):
        """A step whose state is laid out by ``info`` and whose forward runs
        under ``sharded_ops`` (the plain step where the mesh is not sharded)."""
        if not sharded:
            return body

        def step(params, opt_state, err_state, step_idx, batch):
            with shd.sharded_ops():
                params = _laid_out(params, param_sh)
                opt_state = {k: (_laid_out(v, param_sh) if k != "count" else v)
                             for k, v in opt_state.items()}
                return body(params, opt_state, err_state, step_idx, batch)
        return step

    if use_pod_compress:
        per = shape.global_batch // n_pods
        pods_here = [pod] if distributed else list(range(n_pods))
        stream = torch.cuda.Stream(dev) if overlap and dev.type == "cuda" else None

        def pod_rows(batch, p):
            return {k: v[p * per:(p + 1) * per] for k, v in batch.items()}

        def body(params, opt_state, err_state, step_idx, batch):
            fwd_params = on_fwd_mesh(params)
            losses = []
            if overlap:
                # each bucket's hop starts in the backward, once its gradients are final
                r = bkt.BucketReducer(err_state, tcfg.grad_compress, plan, group,
                                      n_slots=len(pods_here), n_micro=tcfg.microbatches,
                                      stream=stream)
                for slot, p in enumerate(pods_here):
                    r.start_pod(slot)
                    losses.append(_loss_and_grads(model, fwd_params, pod_rows(batch, p),
                                                  tcfg.microbatches, r, **extra)[0])
                grads, err_state = r.finish(params)
                del r
            else:
                grads = []
                for p in pods_here:
                    loss, g = _loss_and_grads(model, fwd_params, pod_rows(batch, p),
                                              tcfg.microbatches, **extra)
                    losses.append(loss)
                    grads.append(shd.gather_tree(g))      # each pod's whole leaves
                grads_stacked = pytree.tree_map(
                    lambda *gs: torch.stack(gs) if len(gs) > 1 else gs[0][None], *grads)
                del grads
                grads, err_state = car.reduce_stacked(grads_stacked, err_state,
                                                      tcfg.grad_compress,
                                                      mesh if distributed else None)
                del grads_stacked
            if sharded:
                grads = shd.distribute_like(grads, param_sh)
            p, o, m = finish(_pod_loss_mean(losses, group), grads, params, opt_state,
                             step_idx)
            return p, o, err_state, m

        def err_shardings(grads_abstract):
            return car.error_state_shardings(grads_abstract, tcfg.grad_compress, mesh)
    else:
        def body(params, opt_state, err_state, step_idx, batch):
            loss, grads = _loss_and_grads(model, params, batch, tcfg.microbatches, **extra)
            p, o, m = finish(loss, grads, params, opt_state, step_idx)
            return p, o, err_state, m

        err_shardings = None

    def make_err_state(grads_abstract):
        if not use_pod_compress:            # no pod axis: the step never reads it
            return {}
        return car.init_error_state(grads_abstract, 1 if distributed else n_pods,
                                    tcfg.grad_compress, device=dev)

    return sharded_step(body), dict(
        params=param_sh, opt=opt_sh, batch=batch_sh, input_structs=in_structs,
        make_err_state=make_err_state, err_shardings=err_shardings, n_pods=n_pods, pod=pod,
        group=group, plan=plan, sharded=sharded,
        mode=("overlap" if overlap else "barrier" if use_pod_compress else "exact"))


def _serving_info(model: zoo.Model, shape, mesh):
    _install_act_sharder(mesh)
    param_sh = shd.tree_shardings(model.param_specs(), model.abstract_params(), mesh)
    in_structs, in_logical = model.input_specs(shape)
    batch_sh = {k: shd.NamedSharding(mesh, shd.resolve_spec(in_logical[k], v.shape, mesh))
                for k, v in in_structs.items()}
    cache_abs, cache_logical = model.cache_specs(shape)
    cache_sh = {k: shd.NamedSharding(mesh, shd.resolve_spec(cache_logical[k], v.shape, mesh))
                for k, v in cache_abs.items()}
    return dict(params=param_sh, batch=batch_sh, cache=cache_sh,
                input_structs=in_structs, cache_structs=cache_abs)


def build_prefill_step(model: zoo.Model, shape, mesh):
    """``prefill(params, batch) -> (logits, cache)`` and its ``info``; the cache
    is laid out by ``info["cache"]`` on a sharded mesh."""
    info = _serving_info(model, shape, mesh)
    if not _mesh_sharded(mesh):
        return model.prefill, info

    def prefill(params, batch):
        with shd.sharded_ops():
            logits, cache = model.prefill(_laid_out(params, info["params"]),
                                          _laid_out(batch, info["batch"]))
            return logits, {k: _relaid(v, info["cache"][k]) for k, v in cache.items()}
    return prefill, info


def build_decode_step(model: zoo.Model, shape, mesh):
    """``decode(params, cache, inputs) -> (logits, cache)`` and its ``info``:
    one token a row (``inputs["token"]``, M-RoPE ``inputs["positions"]``); the
    cache given is updated in place and returned."""
    info = _serving_info(model, shape, mesh)
    sharded = _mesh_sharded(mesh)

    def decode(params, cache, inputs):
        with shd.sharded_ops() if sharded else contextlib.nullcontext():
            if sharded:
                params = _laid_out(params, info["params"])
                cache = _laid_out(cache, info["cache"])
                inputs = _laid_out(inputs, info["batch"])
            logits, new = model.decode(params, cache, inputs["token"], inputs.get("positions"))
            for k, v in new.items():
                if sharded:
                    v = _relaid(v, info["cache"][k])
                if v.dtype == cache[k].dtype and v.shape == cache[k].shape:
                    cache[k].copy_(v)
                else:                        # a leaf that changes type (zamba2's conv)
                    cache[k] = v
        return logits, cache
    return decode, info
