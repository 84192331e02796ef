"""Architecture registry: ``--arch <id>`` resolves here.

The port serves the dense family. The other architectures of the reference
registry are known by id and raise ``NotImplementedError`` until their family
is ported (ROADMAP, queue 1 item 14).
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
}


def get(arch_id: str, smoke: bool = False) -> ArchConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {', '.join(ARCH_IDS)}")
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"{arch_id} is not a dense decoder; its family is not ported yet "
            "(ROADMAP, queue 1 item 14)")
    mod = import_module(f"{__name__}.{_MODULES[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG
