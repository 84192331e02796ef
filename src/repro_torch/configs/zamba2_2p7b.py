"""Zamba2-2.7B [arXiv:2411.15242; hf] -- Mamba2 backbone + a shared attention block."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, head_dim=80, rope_theta=1e4,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, conv_width=4,
    shared_attn_every=6,
)
SMOKE = CONFIG.reduced()
