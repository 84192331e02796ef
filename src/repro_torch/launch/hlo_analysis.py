"""Roofline terms and the memory summary: the port of ``repro/launch/hlo_analysis.py``.

The inputs come from ``launch/hlo_cost.py`` (per-device FLOPs, dot-adjacent
bytes and ring-model collective bytes with pod attribution, from a dispatch
trace) and from the dry-run's memory tally, which stands in for XLA's
``memory_analysis()``.

Hardware model: NVIDIA H100 SXM5 80GB, 700 W, datasheet figures, in place of
the reference's TPU figures. The counts are per device, so the terms are
per-device seconds:

    compute    = flops_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = in_pod_bytes / LINK_BW + cross_pod_bytes / DCN_BW
"""
from __future__ import annotations

PEAK_FLOPS = 989e12      # NVIDIA H100 SXM5 80GB, 700 W, datasheet: dense bf16 FLOP/s
HBM_BW = 3.35e12         # NVIDIA H100 SXM5 80GB, 700 W, datasheet: HBM3 bytes/s
LINK_BW = 450e9          # NVIDIA H100 SXM5 80GB, 700 W, datasheet: NVLink 4, bytes/s a direction
DCN_BW = 50e9            # NVIDIA H100 SXM5 80GB, 700 W, datasheet: one 400 Gb/s NDR port a GPU
HBM_BYTES = 80e9         # NVIDIA H100 SXM5 80GB, 700 W, datasheet: device memory


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   cross_pod_bytes: float = 0.0) -> dict:
    compute = flops / PEAK_FLOPS
    memory = bytes_accessed / HBM_BW
    collective = coll_bytes / LINK_BW + cross_pod_bytes / DCN_BW
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": collective,
             "cross_pod_s": cross_pod_bytes / DCN_BW}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["bottleneck"] = dom.replace("_s", "")
    terms["step_time_lower_bound_s"] = bound
    # fraction of roofline achieved if the dominant term were the only cost
    terms["roofline_fraction_compute"] = compute / bound if bound > 0 else 0.0
    return terms


def model_flops(n_params_active: int, tokens: int, kind: str) -> float:
    """6ND for training, 2ND for forward-only (prefill/decode)."""
    if kind == "train":
        return 6.0 * n_params_active * tokens
    return 2.0 * n_params_active * tokens


def memory_summary(mem: dict) -> dict:
    """The reference's keys from the dry-run's tally (``argument_bytes``,
    ``output_bytes``, ``temp_bytes``, ``alias_bytes``)."""
    return {
        "argument_bytes": mem["argument_bytes"],
        "output_bytes": mem["output_bytes"],
        "temp_bytes": mem["temp_bytes"],
        "alias_bytes": mem["alias_bytes"],
        "peak_device_bytes": (mem["argument_bytes"] + mem["output_bytes"]
                              + mem["temp_bytes"] - mem["alias_bytes"]),
    }
