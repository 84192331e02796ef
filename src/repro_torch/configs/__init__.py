"""Architecture registry: ``--arch <id>`` resolves here.

The reference's whole registry: the dense decoders (glm4-9b, internlm2-20b,
yi-6b, mistral-large-123b), the MoE decoders (dbrx-132b, llama4-scout-17b-a16e),
the M-RoPE VLM backbone (qwen2-vl-72b), the recurrent RWKV-6 (rwkv6-3b), the
Mamba2 hybrid (zamba2-2.7b) and the audio encoder-decoder (whisper-tiny).

``SHAPES`` and ``ShapeConfig`` are the reference's assigned shapes, and
``cells_for`` the dry-run's shapes for an arch (``launch.dryrun``).
"""
from importlib import import_module

from .base import SHAPES, ArchConfig, ShapeConfig, cells_for  # noqa: F401

ARCH_IDS = (
    "qwen2-vl-72b", "glm4-9b", "internlm2-20b", "yi-6b", "mistral-large-123b",
    "whisper-tiny", "dbrx-132b", "llama4-scout-17b-a16e", "zamba2-2.7b", "rwkv6-3b",
)

_MODULES = {
    "glm4-9b": "glm4_9b",
    "internlm2-20b": "internlm2_20b",
    "yi-6b": "yi_6b",
    "mistral-large-123b": "mistral_large_123b",
    "dbrx-132b": "dbrx_132b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "whisper-tiny": "whisper_tiny",
    "zamba2-2.7b": "zamba2_2p7b",
    "rwkv6-3b": "rwkv6_3b",
}


def get(arch_id: str, smoke: bool = False) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {', '.join(ARCH_IDS)}")
    mod = import_module(f"{__name__}.{_MODULES[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG
