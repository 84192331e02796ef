"""Architecture registry: ``--arch <id>`` resolves here.

The port serves the reference's ``transformer`` family: the dense decoders
(glm4-9b, internlm2-20b, yi-6b, mistral-large-123b), the MoE decoders
(dbrx-132b, llama4-scout-17b-a16e) and the M-RoPE VLM backbone (qwen2-vl-72b).
The recurrent and audio architectures of the reference registry (rwkv6-3b,
zamba2-2.7b, whisper-tiny) are known by id and raise ``NotImplementedError``
until their family is ported (ROADMAP, queue 1 item 5).
"""
from importlib import import_module

from .base import ArchConfig  # noqa: F401

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
}


def get(arch_id: str, smoke: bool = False) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {', '.join(ARCH_IDS)}")
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"{arch_id} is not a transformer decoder; its family is not ported yet "
            "(ROADMAP, queue 1 item 5)")
    mod = import_module(f"{__name__}.{_MODULES[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG
