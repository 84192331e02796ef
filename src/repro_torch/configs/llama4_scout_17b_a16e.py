"""Llama4-Scout-17B-16E [hf:meta-llama] — MoE 16e top-1 + shared expert,
early-fusion vision stubbed (text backbone, as in the reference)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, head_dim=128, rope_theta=5e5,
    n_experts=16, top_k=1, shared_expert=True,
)
SMOKE = CONFIG.reduced()
