"""Qwen2-VL-72B backbone [arXiv:2409.12191; hf] — M-RoPE, vision stub."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, head_dim=128, rope_theta=1e6,
    mrope_sections=(16, 24, 24),
)
SMOKE = CONFIG.reduced()
