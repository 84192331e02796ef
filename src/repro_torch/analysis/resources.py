"""Kernel resource analyzer: Hopper's per-CTA and per-SM limits. The port of
``repro/analysis/resources.py``, whose TPU tile model (VMEM/SMEM footprints,
lane and sublane padding) is replaced by the H100's limits (NVIDIA's Hopper
tuning guide and occupancy calculator, compute capability 9.0):

  * shared memory: 232,448 bytes (227 KiB) a CTA with opt-in, 233,472 a
    multiprocessor (SM), allocated in 128-byte units plus 1 KiB the system
    reserves a CTA;
  * registers: 65,536 an SM, 255 a thread, allocated 256 a warp;
  * threads: 1,024 a CTA, 2,048 an SM; 32 CTAs an SM.

A launch's dynamic shared bytes come from its :class:`~.kernelspec.KernelSpec`,
which asks them of the C side's plan on the card (``c_query``); registers,
static shared bytes and spill stores from ptxas (``nvcc -Xptxas -v``, whose
output ``kernels/build.py`` keeps beside each library). Without a card (the
CPU) none of these is known: the checks report "not measured" for them, and
only the shared bytes a spec states outright (a seeded spec, a launch that
sets none) are checked.

Checks per spec, evaluated over every point :mod:`.space` ships:

  * ``smem-overflow`` -- static + dynamic shared bytes above the opt-in limit:
    the launch is refused;
  * ``reg-overflow``  -- registers x threads a CTA above 65,536: the launch
    cannot start;
  * ``spill`` (warn)  -- ptxas reports spill stores;
  * ``occupancy-below-bounds`` (warn) -- fewer resident CTAs an SM than the
    kernel's ``__launch_bounds__`` minimum, which sized its registers for
    more.

The counterpart of the reference's ``check_band_helpers``: the dynamic
shared bytes are the C side's own plan at every point of :mod:`.space`, so
``smem-overflow`` there holds the plan the launches follow to the limit.
"""
from __future__ import annotations

import re

from .kernelspec import KernelSpec
from .report import Finding

MAX_SMEM_CTA = 232_448              # bytes a CTA can opt into
SMEM_SM = 233_472                   # bytes an SM
SMEM_RESERVED = 1_024               # the system's share of each CTA
SMEM_UNIT = 128
REGS_SM = 65_536
REGS_THREAD = 255
REG_UNIT = 256                      # registers are allocated per warp in these
THREADS_CTA = 1_024
THREADS_SM = 2_048
CTAS_SM = 32
NOT_MEASURED = "not measured"

# ptxas -v lines (CUDA 12)
_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def symbol_of(mangled: str) -> str:
    """The function name of an Itanium-mangled ``__global__`` (``_ZN2fz12encode_
    tilesI...`` -> ``encode_tiles``); an unmangled name as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    i, name = 2, mangled
    nested = mangled[i:i + 1] == "N"
    i += nested
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        size = int(mangled[i:j])
        name, i = mangled[j:j + size], j + size
        if not nested:
            break
    return name


def parse_ptxas(log: str) -> dict[str, dict]:
    """mangled entry -> {registers, static_smem, spill_stores, spill_loads} from
    nvcc's ``-Xptxas -v`` output."""
    out: dict[str, dict] = {}
    entry = props = None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            entry = m.group(1)
            out.setdefault(entry, {"registers": 0, "static_smem": 0,
                                   "spill_stores": 0, "spill_loads": 0})
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif (m := _SPILL.search(line)) and props in out:
            out[props]["spill_stores"] = int(m.group(2))
            out[props]["spill_loads"] = int(m.group(3))
        elif (m := _USED.search(line)) and entry is not None:
            out[entry]["registers"] = int(m.group(1))
            if s := _SMEM.search(line):
                out[entry]["static_smem"] = int(s.group(1))
    return out


def ptxas_info(build: bool = False) -> dict[tuple[str, str], dict] | None:
    """(source, symbol) -> the worst figures over the symbol's instantiations,
    from the logs of the built libraries; None where no library is built.
    ``build``: compile the missing libraries first (needs nvcc)."""
    from ..kernels import build as _build
    if build:
        _build.build()
    info: dict[tuple[str, str], dict] = {}
    found = False
    for source in _build.SOURCES:
        log = _build.ptxas_log(source)
        if log is None:
            continue
        found = True
        for mangled, fig in parse_ptxas(log).items():
            cur = info.setdefault((source, symbol_of(mangled)),
                                  dict.fromkeys(fig, 0) | {"instances": 0})
            for k, v in fig.items():
                cur[k] = max(cur[k], v)
            cur["instances"] += 1
    return info if found else None


def _figures(spec: KernelSpec, ptxas) -> dict | None:
    if ptxas is None:
        return None
    return ptxas.get((spec.module, spec.symbol))


def _shown(value):
    return NOT_MEASURED if value is None else value


def occupancy(spec: KernelSpec, fig: dict | None) -> tuple[int, str]:
    """(resident CTAs an SM, what limits them). What is not measured (the
    registers without ptxas figures, the shared bytes without the C query) is
    left out, the static shared bytes taken as 0: an upper bound."""
    warps = -(-spec.threads // 32)
    limits = {"ctas": CTAS_SM, "threads": min(THREADS_SM // spec.threads, 64 // warps)}
    static = fig["static_smem"] if fig else 0
    if spec.dynamic_smem is not None:
        smem = -(-(static + spec.dynamic_smem) // SMEM_UNIT) * SMEM_UNIT + SMEM_RESERVED
        limits["shared memory"] = SMEM_SM // smem
    if fig:
        per_warp = -(-fig["registers"] * 32 // REG_UNIT) * REG_UNIT
        limits["registers"] = REGS_SM // (per_warp * warps) if per_warp else CTAS_SM
    by = min(limits, key=limits.get)
    return limits[by], by


def analyze_spec(spec: KernelSpec, ptxas=None) -> list[Finding]:
    fig = _figures(spec, ptxas)
    where = f"at {spec.point}" if spec.point else ""
    out = []
    static = fig["static_smem"] if fig else None
    total = (static or 0) + (spec.dynamic_smem or 0)
    if total > MAX_SMEM_CTA:
        out.append(Finding(
            "resources", "smem-overflow", spec.name,
            f"{spec.symbol}: shared memory {total} B (static {_shown(static)}, dynamic "
            f"{_shown(spec.dynamic_smem)}) > {MAX_SMEM_CTA} B a CTA {where}",
            location=spec.module))
    if fig:
        warps = -(-spec.threads // 32)
        regs = -(-fig["registers"] * 32 // REG_UNIT) * REG_UNIT * warps
        if regs > REGS_SM or fig["registers"] > REGS_THREAD:
            out.append(Finding(
                "resources", "reg-overflow", spec.name,
                f"{spec.symbol}: {fig['registers']} registers x {spec.threads} threads "
                f"({regs} allocated) > {REGS_SM} an SM {where}", location=spec.module))
        if fig["spill_stores"]:
            out.append(Finding(
                "resources", "spill", spec.name,
                f"{spec.symbol}: ptxas spills {fig['spill_stores']} B "
                f"({fig['registers']} registers)", severity="warn", location=spec.module))
    if spec.min_ctas:
        ctas, by = occupancy(spec, fig)
        if ctas < spec.min_ctas:
            regs = fig["registers"] if fig else NOT_MEASURED
            out.append(Finding(
                "resources", "occupancy-below-bounds", spec.name,
                f"{spec.symbol}: {ctas} CTAs an SM (limited by {by}; registers {regs}, "
                f"dynamic shared {_shown(spec.dynamic_smem)} B) < __launch_bounds__ minimum "
                f"{spec.min_ctas} {where}", severity="warn", location=spec.module))
    return out


def analyze(specs: list[KernelSpec], ptxas=None) -> list[Finding]:
    out = []
    for spec in specs:
        out += analyze_spec(spec, ptxas)
    return out


def table(specs: list[KernelSpec], ptxas=None) -> list[dict]:
    """One row per launch site and distinct (threads, dynamic shared bytes):
    registers, spill stores, static and dynamic shared bytes, threads, the
    CTAs an SM and what limits them, and how many points share the row."""
    rows: dict[tuple, dict] = {}
    for spec in specs:
        key = (spec.name, spec.threads, spec.dynamic_smem)
        if key in rows:
            rows[key]["points"] += 1
            continue
        fig = _figures(spec, ptxas)
        ctas, by = occupancy(spec, fig)
        rows[key] = {
            "name": spec.name, "module": spec.module, "symbol": spec.symbol,
            "threads": spec.threads, "dynamic_smem": _shown(spec.dynamic_smem),
            "static_smem": fig["static_smem"] if fig else NOT_MEASURED,
            "registers": fig["registers"] if fig else NOT_MEASURED,
            "spill_stores": fig["spill_stores"] if fig else NOT_MEASURED,
            "ctas_per_sm": ctas if fig and spec.dynamic_smem is not None else f"<= {ctas}",
            "limited_by": by,
            "min_ctas": spec.min_ctas, "points": 1, "first_point": spec.point,
        }
    return list(rows.values())
