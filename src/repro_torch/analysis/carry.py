"""Grid-carry contract for CUDA: a cross-CTA carry needs a ticket and zeroed
scratch, statically. The port of ``repro/analysis/carry.py``.

The reference checks that a Pallas kernel whose grid steps carry state (a
running payload offset, a row carry) declares its grid sequential
(``dimension_semantics`` "arbitrary"). A CUDA grid has no sequential form: its
CTAs run in any order and only some of them at once. The sound form of a carry
across CTAs is the one K4, K5 and K6's row pass use, the decoupled look-back
of ``csrc/fz_common.cuh``:

  * the tile index comes from ``take_ticket`` (an atomic counter), not from
    ``blockIdx``: tiles are then handed out in the order the CTAs start, so a
    CTA spins only on tiles that an already running CTA holds. Indexed by
    ``blockIdx``, a CTA can spin on a tile whose CTA is not resident yet and
    never will be while the spinning CTAs hold the card: a deadlock;
  * the look-back status words and the ticket are zeroed before every launch:
    a status word left by an earlier launch reads as already published.

Classification is by reading the sources, not by trusting the declaration: a
``__global__`` body *carries* if it reaches, through the device functions it
calls (in its ``.cu`` and the ``.cuh`` headers that includes), either
``lookback_exclusive`` or a spin on a published flag (a loop in a function
that reads through a ``volatile`` pointer, cast or parameter). The spec's
wrapper (the module that registers its builder) is read by AST for the
scratch it hands to the C entry points that launch the kernel.

Rules:

  * ``carry-without-ticket`` -- a body that carries takes its tile index from
    ``blockIdx``, or takes no ticket;
  * ``carry-scratch-not-zeroed`` -- a wrapper of a carrying kernel allocates
    its look-back or ticket scratch (an argument ``<name>.data_ptr()`` whose
    name holds ``scratch``, ``ticket`` or ``lookback``) with ``torch.empty``,
    ``empty_like`` or ``new_empty``, or reuses a tensor it did not allocate,
    without zeroing it (``zero_()``, ``fill_(0)``) before the launch;
  * ``carry-undeclared`` -- a body that carries, whose spec's ``carry`` is None;
  * ``declared-carry-unused`` (warn) -- a spec that declares a carry whose body
    does not carry.

Not applicable: the reference's ``carry-under-parallel`` and
``carry-default-semantics`` (a CUDA grid has no per-axis semantics to declare:
``carry-without-ticket`` is their counterpart), and ``missing-semantics`` (no
grid axis of a CUDA launch has semantics to declare, so none can be omitted).
"""
from __future__ import annotations

import ast
import dataclasses
import importlib.util
import pathlib
import re

from .kernelspec import KernelSpec, spec_builders
from .report import Finding

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
LOOKBACK = "lookback_exclusive"
TICKET = "take_ticket"
SCRATCH_NAME = re.compile(r"scratch|ticket|lookback")
ZEROED_ALLOC = {"zeros", "zeros_like", "new_zeros"}
EMPTY_ALLOC = {"empty", "empty_like", "new_empty", "empty_strided"}
ZEROING = {"zero_": None, "fill_": 0}

_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_STRING = re.compile(r'"(?:\\.|[^"\\\n])*"')
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)
_DIRECTIVE = re.compile(r"^[ \t]*#(?!\s*define)[^\n]*", re.M)
_NAME_CALL = re.compile(r"\b([A-Za-z_]\w*)\s*\(")
_CALLEE = re.compile(r"\b([A-Za-z_]\w*)\s*(?:<[^;(){}]*>)?\s*(?:\(|<<<)")
_VOLATILE_READ = re.compile(r"volatile\s+(?:const\s+)?[\w:]+(?:\s+[\w:]+)*\s*\*")
_LOOP = re.compile(r"\b(?:while|for)\s*\(|\bdo\s*\{")
_EXTERN_C = re.compile(r'extern\s+"C"\s*\{')
_NOT_FUNCTIONS = {"if", "for", "while", "switch", "return", "sizeof", "catch", "defined",
                  "__launch_bounds__", "__align__", "alignas", "decltype", "static_assert"}


@dataclasses.dataclass
class CudaFunction:
    """One function definition of a CUDA source (overloads merged)."""
    name: str
    bodies: list[str]                  # each definition's parameters and body
    is_global: bool = False
    is_c_entry: bool = False
    line: int = 0


def _blank(m: re.Match) -> str:
    return re.sub(r"[^\n]", " ", m.group(0))


def _match(text: str, i: int, open_: str, close: str) -> int:
    """Index just past the bracket matching ``text[i] == open_``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_:
            depth += 1
        elif text[j] == close:
            depth -= 1
            if depth == 0:
                return j + 1
    return len(text)


def cuda_functions(source: str) -> dict[str, CudaFunction]:
    """name -> :class:`CudaFunction` of every function defined at any level
    outside another function's body (namespace, ``extern "C"`` and struct
    members included)."""
    text = _COMMENT.sub(_blank, source)
    externs = [(m.end() - 1, _match(text, m.end() - 1, "{", "}"))
               for m in _EXTERN_C.finditer(text)]
    text = _DIRECTIVE.sub(_blank, _STRING.sub(_blank, text))
    out: dict[str, CudaFunction] = {}
    i = 0
    while (m := _NAME_CALL.search(text, i)) is not None:
        name = m.group(1)
        close = _match(text, m.end() - 1, "(", ")")
        j = close
        while True:                       # trailing qualifiers before the body
            while j < len(text) and text[j].isspace():
                j += 1
            q = re.match(r"(?:const|noexcept|override|final)\b", text[j:])
            if not q:
                break
            j += q.end()
        if name in _NOT_FUNCTIONS or j >= len(text) or text[j] != "{":
            i = m.end()
            continue
        end = _match(text, j, "{", "}")
        head = text[max(text.rfind(";", 0, m.start()), text.rfind("}", 0, m.start()),
                        text.rfind("{", 0, m.start())) + 1:m.start()]
        fn = out.setdefault(name, CudaFunction(name, [], line=text.count("\n", 0, m.start()) + 1))
        fn.bodies.append(text[m.end() - 1:end])
        fn.is_global |= "__global__" in head
        fn.is_c_entry |= any(a < m.start() < b for a, b in externs)
        i = end
    return out


def load_unit(module: str, csrc: pathlib.Path = CSRC,
              sources: dict[str, str] | None = None) -> dict[str, CudaFunction]:
    """The functions of ``module`` and of the ``.cuh`` headers it includes, by
    name. ``sources``: file name -> text, read instead of ``csrc`` (fixtures)."""
    def read(name):
        if sources is not None and name in sources:
            return sources[name]
        path = csrc / name
        return path.read_text() if path.exists() else None

    unit: dict[str, CudaFunction] = {}
    todo, seen = [module], set()
    while todo:
        name = todo.pop()
        if name in seen or (src := read(name)) is None:
            continue
        seen.add(name)
        todo += _INCLUDE.findall(src)
        for fn in cuda_functions(src).values():
            cur = unit.setdefault(fn.name, CudaFunction(fn.name, [], line=fn.line))
            cur.bodies += fn.bodies
            cur.is_global |= fn.is_global
            cur.is_c_entry |= fn.is_c_entry
    return unit


def closure(unit: dict[str, CudaFunction], name: str) -> set[str]:
    """``name`` and every function of the unit it calls or launches, transitively."""
    out, todo = set(), [name]
    while todo:
        n = todo.pop()
        if n in out or n not in unit:
            continue
        out.add(n)
        for body in unit[n].bodies:
            todo += [c for c in _CALLEE.findall(body) if c in unit]
    return out


def _spins(body: str) -> bool:
    return bool(_VOLATILE_READ.search(body) and _LOOP.search(body))


def classify(unit: dict[str, CudaFunction], symbol: str) -> dict:
    """What a ``__global__`` body does across CTAs: ``carries`` (reaches the
    look-back or a spin on a published flag), ``ticket`` (takes its tile from
    ``take_ticket``), ``block_idx`` (reads ``blockIdx``)."""
    names = closure(unit, symbol)
    bodies = [b for n in names for b in unit[n].bodies]
    return {"carries": LOOKBACK in names or any(_spins(b) for b in bodies),
            "ticket": TICKET in names,
            "block_idx": any(re.search(r"\bblockIdx\b", b) for b in bodies)}


def launchers(unit: dict[str, CudaFunction], symbol: str) -> set[str]:
    """The ``extern "C"`` entry points whose calls reach a launch of ``symbol``."""
    return {n for n, fn in unit.items() if fn.is_c_entry and symbol in closure(unit, n)}


# --------------------------------------------------------------------------
# The wrapper side (Python AST)
# --------------------------------------------------------------------------

def _call_name(node: ast.AST) -> str:
    """The called attribute or name of a call, '' otherwise."""
    if isinstance(node, ast.Call):
        f = node.func
        return f.attr if isinstance(f, ast.Attribute) else f.id if isinstance(f, ast.Name) else ""
    return ""


def _assigned(fn: ast.FunctionDef, name: str) -> list[tuple[ast.AST, int]]:
    """(value, position in the target tuple or -1) of each assignment to ``name``."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    out.append((node.value, -1))
                elif isinstance(t, ast.Tuple):
                    for k, e in enumerate(t.elts):
                        if isinstance(e, ast.Name) and e.id == name:
                            out.append((node.value, k))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name) \
                and node.target.id == name and node.value is not None:
            out.append((node.value, -1))
    return out


def _zeroed_in(fn: ast.FunctionDef, name: str, before: int) -> bool:
    """``name.zero_()`` or ``name.fill_(0)`` in ``fn`` before line ``before``."""
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name) and node.func.value.id == name
                and node.func.attr in ZEROING and node.lineno < before):
            want = ZEROING[node.func.attr]
            if want is None or (node.args and isinstance(node.args[0], ast.Constant)
                                and node.args[0].value == want):
                return True
    return False


def _scratch_state(fns: dict[str, ast.FunctionDef], fn: ast.FunctionDef, name: str,
                   before: int, depth: int = 0) -> str:
    """"zeroed", "empty" or "reused" for the tensor ``name`` at line ``before``."""
    if _zeroed_in(fn, name, before):
        return "zeroed"
    states = []
    for value, pos in _assigned(fn, name):
        kind = _call_name(value)
        if kind in ZEROED_ALLOC:
            states.append("zeroed")
        elif kind in EMPTY_ALLOC or (isinstance(value, ast.IfExp)
                                     and {_call_name(value.body), _call_name(value.orelse)}
                                     & EMPTY_ALLOC):
            states.append("empty")
        elif kind in fns and depth < 3:        # a helper of the module: its own return
            helper = fns[kind]
            rets = [r.value for r in ast.walk(helper) if isinstance(r, ast.Return) and r.value]
            inner = None
            for r in rets:
                if pos >= 0 and isinstance(r, ast.Tuple) and pos < len(r.elts) \
                        and isinstance(r.elts[pos], ast.Name):
                    inner = r.elts[pos].id
                elif pos < 0 and isinstance(r, ast.Name):
                    inner = r.id
            states.append(_scratch_state(fns, helper, inner, 10**9, depth + 1)
                          if inner else "reused")
        else:
            states.append("reused")
    if not states:
        return "reused"                        # a parameter, a global, an attribute
    return "zeroed" if all(s == "zeroed" for s in states) else (
        "empty" if "empty" in states else "reused")


def wrapper_findings(source: str, rel: str, entries: set[str], spec_name: str) -> list[Finding]:
    """``carry-scratch-not-zeroed`` over the calls of ``entries`` in a wrapper."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("carry", "syntax-error", rel, str(e), location=f"{rel}:{e.lineno}")]
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    out = []
    for fn in fns.values():
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in entries):
                continue
            for arg in node.args:
                if not (isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute)
                        and arg.func.attr == "data_ptr"
                        and isinstance(arg.func.value, ast.Name)
                        and SCRATCH_NAME.search(arg.func.value.id)):
                    continue
                name = arg.func.value.id
                state = _scratch_state(fns, fn, name, node.lineno)
                if state != "zeroed":
                    how = ("allocated without zeroing (torch.empty)" if state == "empty"
                           else "not allocated here, and not zeroed before the launch")
                    out.append(Finding(
                        "carry", "carry-scratch-not-zeroed", spec_name,
                        f"{fn.name} hands {node.func.attr} look-back scratch {name!r} "
                        f"{how}: a status word of an earlier launch reads as published",
                        location=f"{rel}:{node.lineno}"))
    return out


def _wrapper_of(spec: KernelSpec) -> tuple[str, str] | None:
    """(source, path relative to src) of the module registering the spec's builder."""
    builder = spec_builders().get(spec.name)
    if builder is None:
        return None
    found = importlib.util.find_spec(builder.__module__)
    if found is None or not found.origin:
        return None
    path = pathlib.Path(found.origin)
    return path.read_text(), str(path.relative_to(CSRC.parents[1]))


def analyze_spec(spec: KernelSpec, csrc: pathlib.Path = CSRC, *,
                 sources: dict[str, str] | None = None,
                 wrapper: tuple[str, str] | None = None) -> list[Finding]:
    """The carry rules on one launch site. ``sources`` / ``wrapper`` replace the
    files on disk (fixtures)."""
    unit = load_unit(spec.module, csrc, sources)
    if spec.symbol not in unit:
        return [Finding("carry", "missing-body", spec.name,
                        f"no __global__ {spec.symbol} in {spec.module} or its headers",
                        location=spec.module)]
    c = classify(unit, spec.symbol)
    where = f"{spec.module}:{unit[spec.symbol].line}"
    out = []
    if c["carries"] and (c["block_idx"] or not c["ticket"]):
        how = "reads blockIdx" if c["block_idx"] else "takes no ticket"
        out.append(Finding(
            "carry", "carry-without-ticket", spec.name,
            f"{spec.symbol} spins on state other CTAs publish but {how}: a CTA can wait "
            f"on a tile whose CTA is not resident (take the tile from {TICKET})",
            location=where))
    if c["carries"] and spec.carry is None:
        out.append(Finding(
            "carry", "carry-undeclared", spec.name,
            f"{spec.symbol} carries across CTAs (look-back) but its spec declares "
            f"carry=None", location=where))
    if spec.carry is not None and not c["carries"]:
        out.append(Finding(
            "carry", "declared-carry-unused", spec.name,
            f"the spec declares carry={spec.carry!r} but {spec.symbol} reads no state "
            f"other CTAs publish", severity="warn", location=where))
    if c["carries"]:
        wrapper = wrapper or _wrapper_of(spec)
        if wrapper is not None:
            out += wrapper_findings(*wrapper, launchers(unit, spec.symbol), spec.name)
    return out


def analyze(specs: list[KernelSpec]) -> list[Finding]:
    # one spec per launch site is enough (the body and wrapper do not change
    # across geometry points): dedup by site name
    seen: set[str] = set()
    out = []
    for spec in specs:
        if spec.name in seen:
            continue
        seen.add(spec.name)
        out += analyze_spec(spec)
    return out
