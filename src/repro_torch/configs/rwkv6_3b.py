"""RWKV6-3B "Finch" [arXiv:2404.05892; hf] -- attention-free, data-dependent decay."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=8960,
    vocab=65536, head_dim=64,
    rwkv_head_dim=64,
)
SMOKE = CONFIG.reduced()
