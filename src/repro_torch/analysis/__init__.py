"""repro_torch.analysis -- static kernel-resource, carry and host-sync analyzer.
The port of ``repro.analysis``.

  * :mod:`.kernelspec` -- the :class:`KernelSpec` every launch site of the
    kernel wrappers registers a builder for (``@register_spec``), with its
    ``carry`` declaration;
  * :mod:`.resources` -- Hopper's per-CTA and per-SM limits over every spec:
    shared memory (static from ptxas + dynamic from the plan), registers and
    spills from ptxas, resident CTAs an SM against ``__launch_bounds__``; on
    the card, each plan's dynamic shared bytes against the C side's;
  * :mod:`.carry` -- the contract of a carry across CTAs (K4, K5 and K6's
    decoupled look-back): a tile index from the ticket, look-back scratch
    zeroed before every launch, the spec's ``carry`` true to its body;
  * :mod:`.jitlint` -- host syncs (``.item()``, host copies, data-sized ops,
    branches on tensors) in the functions a decode step, a train step or an fz
    call runs, and a style pass (unused imports);
  * :mod:`.space` -- the shipped geometry points;
  * :mod:`.report` -- findings, the committed allowlist ``baseline.json``,
    ``run_all``.

``python -m repro_torch.analysis`` renders the findings as text or JSON;
``--check`` fails on any finding not in the baseline. Rules of the reference
with no CUDA or eager meaning (``missing-semantics``, ``unknown-static-arg``,
``unhashable-static-arg``, ``eager-obs-in-trace``) are recorded as not
applicable in :mod:`.carry` and :mod:`.jitlint`.

This package imports nothing heavy at package level: the kernel wrappers
import :mod:`.kernelspec` to declare their specs, so the passes live in
submodules and are imported lazily.
"""
from .kernelspec import KernelSpec, register_spec, spec_builders  # noqa: F401
