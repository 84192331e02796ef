"""repro_torch.analysis -- the static kernel-resource pass. The port of the
resource half of ``repro.analysis``.

  * :mod:`.kernelspec` -- the :class:`KernelSpec` every launch site of the
    kernel wrappers registers a builder for (``@register_spec``);
  * :mod:`.resources` -- Hopper's per-CTA and per-SM limits over every spec:
    shared memory (static from ptxas + dynamic from the plan), registers and
    spills from ptxas, resident CTAs an SM against ``__launch_bounds__``; on
    the card, each plan's dynamic shared bytes against the C side's;
  * :mod:`.space` -- the shipped geometry points;
  * :mod:`.report` -- findings, the committed allowlist ``baseline.json``,
    ``run_all``.

``python -m repro_torch.analysis`` renders the findings as text or JSON;
``--check`` fails on any finding not in the baseline. The reference's
``carry`` and ``jitlint`` passes (Pallas grid carries, JAX traced branches)
are not ported (ROADMAP, queue 1).

This package imports nothing heavy at package level: the kernel wrappers
import :mod:`.kernelspec` to declare their specs, so the passes live in
submodules and are imported lazily.
"""
from .kernelspec import KernelSpec, register_spec, spec_builders  # noqa: F401
