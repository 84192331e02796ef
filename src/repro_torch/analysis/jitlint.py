"""Host-sync linter: the syncs of the port's hot paths, before merge. The port of
``repro/analysis/jitlint.py``.

The reference lints JAX trace discipline: Python work inside a traced body
runs once at trace time, on tracers. The port has no tracing; what costs the
card there is a *host sync*: a Python decision or a host copy that waits for
the card to finish all queued work, so the host stops queueing. The hot paths
that run once a decode step, a train step or a compress / decompress call are
host-bound on the card (``PERF.md`` §5), so each sync there is paid once a
step. This pass moves the count of ``torch.cuda.set_sync_debug_mode`` to an
AST check over ``src/repro_torch``, so a new sync on a hot path fails
``--check`` before it runs.

Hot contexts are declared, not found: :data:`HOT` lists ``(module,
qualname)`` of the functions each step or call runs, and every ``def``
nested in one of them is hot too. Tensor values are inferred inside a hot
function: parameters annotated ``torch.Tensor``, names and ``self``
attributes assigned from ``torch`` calls or tensor methods, attributes a class
of the module annotates ``torch.Tensor``, calls of the module's functions
annotated ``-> torch.Tensor``, and operators, subscripts and methods of those.
Within a hot context:

  * ``host-sync`` -- ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``torch.cuda.synchronize`` (and ``.synchronize()``), ``float()`` /
    ``int()`` / ``bool()`` / ``np.asarray()`` of a tensor expression,
    ``torch.equal`` / ``allclose`` (a host bool), the ops whose output size
    depends on the data (``nonzero``, ``argwhere``, ``masked_select``,
    ``unique``, ``unique_consecutive``, one-argument ``torch.where``,
    ``repeat_interleave`` without ``output_size``, indexing by a boolean
    mask), and host-to-device copies (``torch.tensor`` / ``torch.as_tensor``
    of host data with ``device=``, ``.to(<device>)`` of a tensor made from
    host data, ``.cuda()``): a pageable copy waits for the stream;
  * ``tensor-branch`` -- an ``if`` / ``while`` / conditional expression on a
    tensor value: the reference's ``traced-branch``, an implicit
    ``bool()`` here.

A finding's key names the function and the sync's kind with its ordinal in
that function (``repro_torch/serve/engine.py:Engine.step:.item()#1``), not
its line, so edits elsewhere keep the baseline stable while a new sync of a
kind in a function adds a key. ``chip_smoke.py`` phase 18c is the runtime
twin: every sync the card reports in a Yi-6B serving trace and in fused
compress / decompress maps to a function that a finding or the baseline
names (:func:`sync_sites`).

Not applicable here: ``unknown-static-arg`` and ``unhashable-static-arg``
(the port has no ``jax.jit`` and no static arguments); ``eager-obs-in-trace``
(the reference flags ``obs`` counters in a traced body because they count
once a compilation instead of once a dispatch; the port runs eagerly, so a
counter in a hot context counts once a call, which is what the reference's
eager wrapper counts, and its bookkeeping is queued on the host without a
sync; during a CUDA graph capture the fz entry points count nothing); the
reference's ``host-call`` of numpy (numpy runs on the host either way: only
the conversion of a card tensor syncs, which ``host-sync`` names).

A style pass (``unused-import``, F401-equivalent, honoring ``# noqa``) rides
along over ``src/repro_torch``, as the reference's does over ``src/repro``.
"""
from __future__ import annotations

import ast
import pathlib

from .report import Finding, load_baseline

SRC_ROOT = pathlib.Path(__file__).resolve().parents[2]   # .../src

# (module, qualname) of every function a decode step, a scheduler step, a
# train step or an fz entry point runs once or more a call; defs nested in
# them are hot too
HOT: tuple[tuple[str, str], ...] = (
    # serving: the engine's decode and the model's layers a step
    ("repro_torch/serve/engine.py", "Engine.decode_step_paged"),
    ("repro_torch/serve/engine.py", "Engine.decode_step"),
    ("repro_torch/serve/engine.py", "Engine.prefill"),
    ("repro_torch/serve/engine.py", "Engine.prefill_suffix"),
    ("repro_torch/serve/engine.py", "compressed_cache_bytes"),
    ("repro_torch/models/zoo.py", "Model.prefill"),
    ("repro_torch/models/zoo.py", "Model.decode"),
    ("repro_torch/models/zoo.py", "Model.decode_paged"),
    ("repro_torch/models/zoo.py", "Model.prefill_suffix"),
    ("repro_torch/models/transformer.py", "_layer"),
    ("repro_torch/models/transformer.py", "_ffn"),
    ("repro_torch/models/transformer.py", "_qkv"),
    ("repro_torch/models/transformer.py", "_logits_at"),
    ("repro_torch/models/transformer.py", "_positions"),
    ("repro_torch/models/transformer.py", "forward_prefill"),
    ("repro_torch/models/transformer.py", "forward_prefill_suffix"),
    ("repro_torch/models/transformer.py", "forward_decode"),
    ("repro_torch/models/transformer.py", "forward_decode_paged"),
    ("repro_torch/models/nn.py", "rms_norm"),
    ("repro_torch/models/nn.py", "dense"),
    ("repro_torch/models/nn.py", "silu"),
    ("repro_torch/models/nn.py", "swiglu"),
    ("repro_torch/models/nn.py", "embed_lookup"),
    ("repro_torch/models/attention.py", "rope_freqs"),
    ("repro_torch/models/attention.py", "apply_rope"),
    ("repro_torch/models/attention.py", "flash_attention"),
    ("repro_torch/models/attention.py", "prefix_attention"),
    ("repro_torch/models/attention.py", "decode_attention"),
    ("repro_torch/serve/kvpool/attention.py", "_combine"),
    ("repro_torch/serve/kvpool/attention.py", "paged_decode_attention"),
    ("repro_torch/kernels/flash_decode.py", "flash_decode_partials"),
    ("repro_torch/kernels/flash_decode.py", "prep_q"),
    ("repro_torch/kernels/flash_decode.py", "length_eff"),
    ("repro_torch/kernels/flash_decode.py", "decode_partials_pages"),
    ("repro_torch/kernels/flash_decode.py", "combine_partials"),
    # the scheduler's step and the pool's work in it (gather, append, tiering)
    ("repro_torch/serve/kvpool/scheduler.py", "ContinuousBatcher.step"),
    ("repro_torch/serve/kvpool/scheduler.py", "ContinuousBatcher._step"),
    ("repro_torch/serve/kvpool/scheduler.py", "ContinuousBatcher._tensor"),
    ("repro_torch/serve/kvpool/scheduler.py", "ContinuousBatcher._admit"),
    ("repro_torch/serve/kvpool/scheduler.py", "ContinuousBatcher._admit_suffix"),
    ("repro_torch/serve/kvpool/scheduler.py", "ContinuousBatcher._start_running"),
    ("repro_torch/serve/kvpool/scheduler.py", "ContinuousBatcher._try_resume"),
    ("repro_torch/serve/kvpool/scheduler.py", "ContinuousBatcher._secure_tails"),
    ("repro_torch/serve/kvpool/scheduler.py", "ContinuousBatcher._preempt_for"),
    ("repro_torch/serve/kvpool/scheduler.py", "ContinuousBatcher._park"),
    ("repro_torch/serve/kvpool/scheduler.py", "ContinuousBatcher._emit"),
    ("repro_torch/serve/kvpool/scheduler.py", "ContinuousBatcher._finish"),
    ("repro_torch/serve/kvpool/policy.py", "TieredPolicy.tier"),
    ("repro_torch/serve/kvpool/policy.py", "TieredPolicy.reclaim"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool.gather"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool.gather_pages"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool._lane_pages"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool._decompress"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool._decompress_many"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool._container"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool.append_token"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool.alloc_page"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool._cow_page"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool.promote_page"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool.compress_pages"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool._park_store"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool._sentinel_check"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool._ensure_eb"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool.write_prefill"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool.write_suffix"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool._paginate"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool.note_high_water"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool.used_bytes"),
    ("repro_torch/serve/kvpool/pool.py", "PagePool.compressed_used_bytes"),
    # the fz entry points, their routes and the kernel wrappers
    ("repro_torch/core/fz.py", "compress"),
    ("repro_torch/core/fz.py", "compress_with_eb"),
    ("repro_torch/core/fz.py", "decompress"),
    ("repro_torch/core/fz.py", "compress_batch_with_eb"),
    ("repro_torch/core/fz.py", "decompress_batch"),
    ("repro_torch/core/fz.py", "roundtrip"),
    ("repro_torch/core/fz.py", "resolve_eb"),
    ("repro_torch/core/fz.py", "_as_input"),
    ("repro_torch/core/fz.py", "_eb_tensor"),
    ("repro_torch/core/fz.py", "_compress_core"),
    ("repro_torch/core/fz.py", "_decompress"),
    ("repro_torch/core/fz.py", "FZCompressed.to"),
    ("repro_torch/core/fz.py", "FZCompressed.used_bytes"),
    ("repro_torch/core/fz.py", "FZCompressed.compression_ratio"),
    ("repro_torch/kernels/ops.py", "relative_eb"),
    ("repro_torch/kernels/ops.py", "fused_compress_stages"),
    ("repro_torch/kernels/ops.py", "fused_decompress"),
    ("repro_torch/kernels/ops.py", "lorenzo_quantize"),
    ("repro_torch/kernels/ops.py", "bitshuffle_flag_encode"),
    ("repro_torch/kernels/ops.py", "bitunshuffle"),
    ("repro_torch/kernels/fused_compress.py", "fused_compress"),
    ("repro_torch/kernels/fused_compress.py", "fused_compress_strict"),
    ("repro_torch/kernels/fused_compress.py", "_check_data"),
    ("repro_torch/kernels/fused_compress.py", "fused_shuffle_encode"),
    ("repro_torch/kernels/fused_compress.py", "_outputs"),
    ("repro_torch/kernels/fused_compress.py", "range_eb"),
    ("repro_torch/kernels/fused_decode.py", "fused_decompress"),
    ("repro_torch/kernels/lorenzo_quant.py", "lorenzo_quant"),
    ("repro_torch/kernels/bitshuffle_flag.py", "bitshuffle_flag"),
    ("repro_torch/kernels/bitshuffle_flag.py", "bitunshuffle_tiles"),
    ("repro_torch/core/quant.py", "lorenzo_delta"),
    ("repro_torch/core/quant.py", "lorenzo_inverse"),
    ("repro_torch/core/quant.py", "to_codes"),
    ("repro_torch/core/quant.py", "from_codes"),
    ("repro_torch/core/quant.py", "prequantize"),
    ("repro_torch/core/quant.py", "dual_quantize"),
    ("repro_torch/core/quant.py", "dual_dequantize"),
    ("repro_torch/core/shuffle.py", "pad_to_tiles"),
    ("repro_torch/core/encode.py", "compact_blocks"),
    ("repro_torch/core/encode.py", "decode"),
    # the train step and the trainer's loop around it
    ("repro_torch/train/step.py", "_value_and_grad"),
    ("repro_torch/train/step.py", "_loss_and_grads"),
    ("repro_torch/train/step.py", "_pod_loss_mean"),
    ("repro_torch/train/step.py", "build_train_step.<locals>.finish"),
    ("repro_torch/train/step.py", "build_train_step.<locals>.body"),
    ("repro_torch/train/step.py", "build_train_step.<locals>.sharded_step"),
    ("repro_torch/train/step.py", "build_train_step.<locals>.pod_rows"),
    ("repro_torch/train/trainer.py", "Trainer.run"),
    ("repro_torch/train/trainer.py", "Trainer._batch"),
)

SIZE_OPS = {"nonzero", "argwhere", "masked_select", "unique", "unique_consecutive"}
BOOL_OPS = {"equal", "allclose"}
CASTS = {"float", "int", "bool"}
# torch calls that do not return a tensor
TORCH_NON_TENSOR = {"device", "Size", "is_tensor", "is_floating_point", "is_complex", "numel",
                    "Generator", "finfo", "iinfo", "get_default_dtype", "promote_types",
                    "result_type", "no_grad", "inference_mode", "enable_grad", "equal",
                    "allclose", "manual_seed", "dtype", "Stream", "Event"}
# tensor methods that do not return a tensor
NON_TENSOR_METHODS = {"item", "tolist", "size", "dim", "numel", "nelement", "data_ptr",
                      "element_size", "is_contiguous", "stride", "storage_offset",
                      "get_device", "is_floating_point", "is_complex", "equal",
                      "untyped_storage", "numpy", "__len__", "register_hook"}
TENSOR_ATTRS = {"T", "mT", "H", "mH", "real", "imag", "data", "grad"}


def _dotted(node: ast.expr) -> str:
    """'a.b.c' for Name/Attribute chains, '' otherwise."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_tensor_annotation(ann: ast.expr | None) -> bool:
    return ann is not None and "Tensor" in ast.unparse(ann)


class _Index:
    """What the package tells about tensor values: attributes its classes
    annotate or assign as tensors, and its functions annotated
    ``-> torch.Tensor`` (by name, across the modules given)."""

    def __init__(self, trees: list[ast.Module]):
        self.tensor_attrs: set[str] = set()
        self.tensor_fns: set[str] = set()
        for tree in trees:
            for node in ast.walk(tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and _is_tensor_annotation(node.returns) \
                        and not ast.unparse(node.returns).startswith(("tuple", "list", "dict")):
                    self.tensor_fns.add(node.name)
                elif isinstance(node, ast.ClassDef):
                    for stmt in node.body:
                        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name) \
                                and _is_tensor_annotation(stmt.annotation) \
                                and "None" not in ast.unparse(stmt.annotation):
                            self.tensor_attrs.add(stmt.target.id)


class _Types:
    """Tensor inference inside one function."""

    def __init__(self, fn: ast.FunctionDef, mod: _Index, outer: "_Types | None"):
        self.mod = mod
        self.names: set[str] = set(outer.names) if outer else set()
        self.host: set[str] = set(outer.host) if outer else set()   # host data, host tensors
        self.bools: set[str] = set(outer.bools) if outer else set()
        args = fn.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            self.names.discard(a.arg)
            if _is_tensor_annotation(a.annotation) and "None" not in ast.unparse(a.annotation):
                self.names.add(a.arg)
        for _ in range(2):                  # assignments can feed each other
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    self._assign(node.targets, node.value)
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    self._assign([node.target], node.value)

    def _assign(self, targets, value):
        for t in targets:
            if isinstance(t, ast.Name) and _host_data(value):
                self.host.add(t.id)
            elif isinstance(t, ast.Name) and self.tensor(value):
                self.names.add(t.id)
                if self.from_host(value):
                    self.host.add(t.id)
                if self.boolean(value):
                    self.bools.add(t.id)
            elif isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
                    and t.value.id == "self" and self.tensor(value):
                self.mod.tensor_attrs.add(t.attr)

    def from_host(self, node: ast.expr) -> bool:
        """Host data, or a tensor made from it without a device: ``torch.tensor``
        and ``from_numpy``, and ``torch.as_tensor`` of host data, without
        ``device=``."""
        if isinstance(node, ast.Name):
            return node.id in self.host
        if _host_data(node):
            return True
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name in ("torch.tensor", "torch.from_numpy"):
                return not any(k.arg == "device" for k in node.keywords)
            if name == "torch.as_tensor":
                return (not any(k.arg == "device" for k in node.keywords)
                        and bool(node.args) and self.from_host(node.args[0]))
            if isinstance(node.func, ast.Attribute) and node.func.attr not in ("to", "cuda"):
                return self.from_host(node.func.value)
        return False

    def boolean(self, node: ast.expr) -> bool:
        """A boolean tensor: a comparison of tensors, ``isfinite`` and kin, or a name of one."""
        if isinstance(node, ast.Name):
            return node.id in self.bools
        if isinstance(node, ast.Compare):
            return self.tensor(node)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.boolean(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitAnd, ast.BitOr)):
            return self.boolean(node.left) or self.boolean(node.right)
        if isinstance(node, ast.Call):
            name = node.func.attr if isinstance(node.func, ast.Attribute) else ""
            return name in {"isfinite", "isnan", "isinf", "logical_and", "logical_or",
                            "logical_not", "eq", "ne", "lt", "le", "gt", "ge"} \
                and self.tensor(node)
        return False

    def tensor(self, node: ast.expr | None) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if node.attr in TENSOR_ATTRS:
                return self.tensor(node.value)
            return node.attr in self.mod.tensor_attrs and not isinstance(node.value, ast.Call)
        if isinstance(node, ast.Subscript):
            return self.tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.tensor(node.left) or self.tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.tensor(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.tensor(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in node.ops):
                return False
            return self.tensor(node.left) or any(self.tensor(c) for c in node.comparators)
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            root = name.split(".")[0]
            if root in ("torch", "F") and not name.startswith(("torch.cuda.", "torch.backends.",
                                                               "torch.distributed.")):
                return name.split(".")[-1] not in TORCH_NON_TENSOR
            if isinstance(node.func, ast.Name):
                return node.func.id in self.mod.tensor_fns
            if isinstance(node.func, ast.Attribute):
                if self.tensor(node.func.value):
                    return node.func.attr not in NON_TENSOR_METHODS
                # a module's function: ``fz.resolve_eb(...)``
                return (isinstance(node.func.value, ast.Name)
                        and node.func.attr in self.mod.tensor_fns)
        return False


def _host_data(node: ast.expr) -> bool:
    """A literal, a list / tuple / comprehension or a numpy call: host data."""
    if isinstance(node, (ast.Constant, ast.List, ast.Tuple, ast.ListComp, ast.GeneratorExp)):
        return True
    return isinstance(node, ast.Call) and _dotted(node.func).split(".")[0] in ("np", "numpy")


def _qualnames(tree: ast.Module):
    """(qualname, FunctionDef, enclosing FunctionDef or None) of every def, in
    Python's ``__qualname__`` form."""
    out = []

    def visit(node, prefix, outer_fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                out.append((q, child, outer_fn))
                visit(child, f"{q}.<locals>.", child)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.", outer_fn)
            else:
                visit(child, prefix, outer_fn)
    visit(tree, "", None)
    return out


class _HotLinter:
    def __init__(self, rel: str):
        self.rel = rel
        self.findings: list[Finding] = []
        self._count: dict[tuple[str, str], int] = {}

    def emit(self, rule: str, qual: str, kind: str, msg: str, node: ast.AST):
        k = self._count[(qual, kind)] = self._count.get((qual, kind), 0) + 1
        self.findings.append(Finding(
            "jitlint", rule, f"{self.rel}:{qual}:{kind}#{k}", msg,
            location=f"{self.rel}:{node.lineno}"))

    def lint(self, qual: str, fn: ast.FunctionDef, types: _Types):
        """One hot function's own statements (nested defs are linted on their own)."""
        sync = "host-sync"
        for node in _own_nodes(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)) and types.tensor(node.test):
                kind = {ast.If: "if", ast.While: "while", ast.IfExp: "if-expression"}[type(node)]
                self.emit("tensor-branch", qual, kind,
                          f"Python {kind} on a tensor value ({ast.unparse(node.test)[:60]}): "
                          f"an implicit bool(), a host sync", node)
            elif isinstance(node, ast.Subscript) and types.boolean(node.slice) \
                    and types.tensor(node.value):
                self.emit(sync, qual, "mask-index",
                          f"indexing by a boolean mask ({ast.unparse(node)[:60]}): the "
                          f"output size needs the mask's count on the host", node)
            elif isinstance(node, ast.Call):
                self._call(qual, node, types)

    def _call(self, qual: str, node: ast.Call, types: _Types):
        sync = "host-sync"
        name = _dotted(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else ""
        recv = node.func.value if isinstance(node.func, ast.Attribute) else None
        if attr == "synchronize":
            kind = "torch.cuda.synchronize()" if name == "torch.cuda.synchronize" \
                else ".synchronize()"
            self.emit(sync, qual, kind, f"{name or attr}() waits for the card", node)
        elif attr in ("item", "tolist", "cpu") or (attr == "numpy" and types.tensor(recv)):
            self.emit(sync, qual, f".{attr}()",
                      f".{attr}() copies a card value to the host and waits for it", node)
        elif attr == "cuda" and types.tensor(recv):
            self.emit(sync, qual, ".cuda()", "a host-to-device copy waits for the stream", node)
        elif isinstance(node.func, ast.Name) and node.func.id in CASTS and node.args \
                and types.tensor(node.args[0]):
            self.emit(sync, qual, f"{node.func.id}()",
                      f"{node.func.id}() of a tensor ({ast.unparse(node.args[0])[:60]}) reads "
                      f"it on the host", node)
        elif name in ("np.asarray", "np.array", "numpy.asarray") and node.args \
                and types.tensor(node.args[0]):
            self.emit(sync, qual, f"{name}()", f"{name}() of a tensor reads it on the host",
                      node)
        elif attr in BOOL_OPS and (name.startswith("torch.") or types.tensor(recv)):
            self.emit(sync, qual, f"{attr}()",
                      f"{attr}() returns a host bool of card values", node)
        elif attr in SIZE_OPS and (name.startswith("torch.") or types.tensor(recv)):
            self.emit(sync, qual, f"{attr}()",
                      f"{attr}() sizes its output by the data: the count is read on "
                      f"the host", node)
        elif name == "torch.where" and len(node.args) == 1 and not node.keywords:
            self.emit(sync, qual, "torch.where()",
                      "one-argument torch.where() is nonzero(): a host sync", node)
        elif attr == "repeat_interleave" and not any(k.arg == "output_size"
                                                     for k in node.keywords) and (
                _tensor_repeats(node, name, types)):
            self.emit(sync, qual, "repeat_interleave()",
                      "repeat_interleave() with tensor repeats and no output_size reads "
                      "the total on the host", node)
        elif name in ("torch.tensor", "torch.as_tensor") and any(
                k.arg == "device" for k in node.keywords) and not (
                node.args and types.tensor(node.args[0]) and not types.from_host(node.args[0])):
            self.emit(sync, qual, f"{name}(device=)",
                      f"{name}() of host data on a device: a pageable host-to-device copy "
                      f"waits for the stream", node)
        elif attr == "to" and recv is not None and types.from_host(recv) and _device_arg(node):
            self.emit(sync, qual, ".to(device)",
                      "a tensor of host data moved to a device: a pageable host-to-device "
                      "copy waits for the stream", node)


def _tensor_repeats(node: ast.Call, name: str, types: _Types) -> bool:
    """``repeat_interleave`` whose repeats are a tensor (its output size is their sum)."""
    args = node.args[1:] if name.startswith("torch.") else node.args
    rep = args[0] if args else next((k.value for k in node.keywords if k.arg == "repeats"),
                                    None)
    if rep is None:                   # repeat_interleave(repeats): the tensor is the repeats
        return True
    return types.tensor(rep)


def _device_arg(node: ast.Call) -> bool:
    """``.to(...)`` with a device: a ``device=`` keyword, or a positional that is
    not a dtype (``torch.<dtype>``, ``*.dtype``, a name holding ``dtype``)."""
    if any(k.arg == "device" for k in node.keywords):
        return True
    if not node.args:
        return False
    a = node.args[0]
    text = ast.unparse(a)
    return not (text.startswith("torch.") and text.split(".")[-1][:1].islower()
                and text not in ("torch.device",)) and "dtype" not in text


def _own_nodes(fn: ast.FunctionDef) -> list[ast.AST]:
    """The nodes of ``fn`` outside its nested defs and classes, in source order."""
    out, stack = [], list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return sorted((n for n in out if hasattr(n, "lineno")),
                  key=lambda n: (n.lineno, n.col_offset))


def hot_qualnames(rel: str) -> set[str]:
    return {q for m, q in HOT if m == rel}


# --------------------------------------------------------------------------
# Style pass: unused imports (F401-equivalent), honoring `# noqa`
# --------------------------------------------------------------------------

def _unused_imports(tree: ast.Module, source: str, rel: str) -> list[Finding]:
    lines = source.splitlines()
    imported: list[tuple[str, str, int]] = []    # (bound name, shown, lineno)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for al in node.names:
                bound = al.asname or al.name.split(".")[0]
                imported.append((bound, al.name, node.lineno))
        elif isinstance(node, ast.ImportFrom):
            if node.module == "__future__":
                continue
            for al in node.names:
                if al.name == "*":
                    continue
                bound = al.asname or al.name
                imported.append((bound, al.name, node.lineno))
    used: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            root = node
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name):
                used.add(root.id)
    # names re-exported via __all__ count as used
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "__all__"
                        for t in node.targets)):
            for el in ast.walk(node.value):
                if isinstance(el, ast.Constant) and isinstance(el.value, str):
                    used.add(el.value)
    out = []
    for bound, shown, lineno in imported:
        if bound in used or bound == "_":
            continue
        line = lines[lineno - 1] if lineno - 1 < len(lines) else ""
        if "noqa" in line:
            continue
        out.append(Finding(
            "style", "unused-import", f"{rel}:{lineno}:{bound}",
            f"{shown!r} imported but unused", location=f"{rel}:{lineno}"))
    return out


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------

def lint_source(source: str, rel: str = "<string>", *, hot: set[str] | None = None,
                style: bool = False, discipline: bool = True,
                index: _Index | None = None) -> list[Finding]:
    """Lint one module's source text (the unit the tests fixture against).
    ``hot``: the qualnames of its hot functions (default: :data:`HOT`'s);
    ``index``: the package's tensor attributes and functions (default: this
    module's own)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("jitlint", "syntax-error", rel, str(e),
                        location=f"{rel}:{e.lineno}")]
    out: list[Finding] = []
    if discipline:
        hot = hot_qualnames(rel) if hot is None else hot
        index = index or _Index([tree])
        linter = _HotLinter(rel)
        types: dict[str, _Types] = {}
        for qual, fn, _ in _qualnames(tree):
            parent = qual.rsplit(".<locals>.", 1)[0] if ".<locals>." in qual else None
            if qual in hot or (parent is not None and parent in types):
                types[qual] = _Types(fn, index, types.get(parent))
                linter.lint(qual, fn, types[qual])
        out += linter.findings
    if style:
        out += _unused_imports(tree, source, rel)
    return out


def analyze(root: pathlib.Path | None = None, *, style: bool = True,
            discipline: bool = True) -> list[Finding]:
    root = root or (SRC_ROOT / "repro_torch")
    paths = sorted(root.rglob("*.py"))
    sources = {p: p.read_text() for p in paths}
    index = _Index([ast.parse(src) for src in sources.values()])
    out: list[Finding] = []
    for path, src in sources.items():
        rel = str(path.relative_to(root.parent))
        out += lint_source(src, rel, style=style, discipline=discipline, index=index)
    if discipline:
        out += [Finding("jitlint", "unknown-hot-context", f"{rel}:{qual}",
                        f"HOT names {qual!r} in {rel}, which defines no such function",
                        location=rel)
                for rel, qual in missing_hot(root.parent)]
    return out


def missing_hot(root: pathlib.Path | None = None) -> list[tuple[str, str]]:
    """Entries of :data:`HOT` that name no function of the tree (a rename)."""
    root = root or SRC_ROOT
    out = []
    for rel in sorted({m for m, _ in HOT}):
        path = root / rel
        quals = {q for q, _, _ in _qualnames(ast.parse(path.read_text()))} \
            if path.exists() else set()
        out += [(rel, q) for m, q in HOT if m == rel and q not in quals]
    return out


def sync_sites(findings: list[Finding] | None = None,
               baseline: dict[str, str] | None = None) -> set[tuple[str, str]]:
    """(file, qualname) of every function with a ``host-sync`` or
    ``tensor-branch`` finding of the tree or entry of the baseline."""
    findings = analyze(style=False) if findings is None else findings
    keys = [f.key for f in findings if f.pass_name == "jitlint"]
    keys += [k for k in (load_baseline() if baseline is None else baseline)
             if k.startswith("jitlint:")]
    out = set()
    for key in keys:
        _, rule, obj = key.split(":", 2)
        if rule in ("host-sync", "tensor-branch"):
            rel, qual, _ = obj.split(":", 2)
            out.add((rel, qual))
    return out
