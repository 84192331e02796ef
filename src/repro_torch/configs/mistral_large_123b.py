"""Mistral-Large-123B [hf:mistralai/Mistral-Large-Instruct-2407] -- dense GQA."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=28672,
    vocab=32768, head_dim=128, rope_theta=1e6,
)
SMOKE = CONFIG.reduced()
