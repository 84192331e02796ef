"""KernelSpec: the declarative contract between the CUDA launch sites and the
resource analyzer. The port of ``repro/analysis/kernelspec.py``.

The reference's spec describes a Pallas TPU launch (BlockSpecs, VMEM/SMEM
scratch); the port's describes one CUDA launch: the ``.cu`` source, the
``__global__`` symbol, the grid, threads per CTA, the dynamic shared bytes the
launch sets, and the minimum CTAs an SM of the kernel's ``__launch_bounds__``
where it declares one. Registers, static shared bytes and spill stores are
not declared: ptxas reports them (:mod:`.resources` reads its log).

Every launch site of a kernel wrapper (``repro_torch/kernels/*.py``) registers
a *spec builder* next to the launch (``@register_spec(name)``), computed by the
same plan helpers the wrapper's launch follows (``split_count``, K6's column
passes), so a spec cannot drift from its launch silently. Where the C side
computes a launch's dynamic shared bytes, the spec names the ``extern "C"``
query that returns them (``c_query``) and takes its answer on the card
(``kernels.build.query``): the C plan is the only plan. Without a card the
bytes are None, "not measured", as the registers are.

This module is import-light on purpose: the kernel wrappers import it to
register their builders, and the analysis passes import the wrappers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One CUDA launch at one geometry point.

    ``point`` is a short description of the geometry the spec was built at; it
    feeds finding messages, never finding keys, so the committed baseline stays
    stable as the evaluated space grows. ``c_query`` is ``(source, function,
    args)``: the ``extern "C"`` function of ``source`` that returns the dynamic
    shared bytes this launch sets, or None where the launch sets none.
    ``dynamic_smem`` is None where the query could not be asked (no card).
    ``carry`` is ``"lookback"`` for a launch whose CTAs read state other CTAs of
    the same launch publish (the decoupled look-back of ``csrc/fz_common.cuh``),
    None otherwise: the counterpart of the reference's ``dimension_semantics``,
    held to the kernel's body by :mod:`.carry`.
    """
    name: str                          # launch-site name (the registry key)
    module: str                        # the .cu source under csrc/
    symbol: str                        # the __global__ function
    grid: tuple[int, ...]              # CTAs (x, y, z)
    threads: int                       # threads per CTA
    dynamic_smem: int | None = 0       # bytes the launch sets; None: not measured
    min_ctas: int | None = None        # __launch_bounds__ minimum CTAs an SM
    point: str = ""
    c_query: tuple[str, str, tuple] | None = None
    carry: str | None = None           # "lookback": CTAs read each other's published state


# --------------------------------------------------------------------------
# Builder registry
# --------------------------------------------------------------------------

_BUILDERS: dict[str, Callable] = {}


def register_spec(name: str):
    """Decorator: register ``fn(**point) -> KernelSpec`` under ``name``.

    One registration per launch site; re-registering a name overwrites
    (module reload safety), never accumulates.
    """
    def deco(fn):
        _BUILDERS[name] = fn
        return fn
    return deco


def spec_builders() -> dict[str, Callable]:
    """name -> builder for every registered launch site.

    Importing :mod:`repro_torch.kernels` is what populates the registry;
    callers (the analysis passes, the tuner) do that import themselves.
    """
    return dict(_BUILDERS)
