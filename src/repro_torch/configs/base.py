"""Architecture config schema: the port's copy of ``repro/configs/base.py``.

Every architecture the port serves has one module in this package exporting
``CONFIG`` (the published dims) and ``SMOKE`` (a reduced same-family config for
CPU tests). ``repro_torch.configs.get(arch_id)`` resolves either.
``ShapeConfig`` and ``SHAPES`` are the reference's input-shape suite.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    shared_expert: bool = False
    # VLM (qwen2-vl M-RoPE; the vision frontend is stubbed, as in the reference)
    mrope_sections: tuple[int, int, int] | None = None
    # audio (whisper; the conv frontend is stubbed, as in the reference)
    n_audio_ctx: int = 0
    n_enc_layers: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    shared_attn_every: int = 0       # zamba2: the shared attention block's cadence
    # RWKV
    rwkv_head_dim: int = 64
    remat: bool = True               # recompute each layer in the backward pass

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic archs."""
        return self.family in ("ssm", "hybrid")

    def reduced(self, **overrides) -> "ArchConfig":
        """Same-family tiny config for CPU tests (the reference's shrink)."""
        base = dict(
            arch_id=self.arch_id + "-smoke",
            n_layers=min(self.n_layers, 4 if (self.shared_attn_every or self.n_enc_layers) else 2),
            d_model=128, n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=256, vocab=512, head_dim=32,
            n_experts=min(self.n_experts, 4), top_k=min(self.top_k, 2),
            n_audio_ctx=min(self.n_audio_ctx, 64),
            n_enc_layers=min(self.n_enc_layers, 2),
            ssm_state=min(self.ssm_state, 16), ssm_head_dim=32 if self.ssm_state else 64,
            shared_attn_every=2 if self.shared_attn_every else 0,
            rwkv_head_dim=32 if self.family == "ssm" else 64,
        )
        if self.mrope_sections:
            base["mrope_sections"] = (4, 6, 6)  # sums to head_dim/2 = 16
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cells_for(cfg: ArchConfig) -> list[str]:
    """The dry-run's shapes for this arch: long_500k only where the arch is
    sub-quadratic (``supports_long_context``), as in the reference."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        names.append("long_500k")
    return names
