"""DBRX-132B [hf:databricks/dbrx-base] — fine-grained MoE 16e top-4."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100352, head_dim=128, rope_theta=5e5,
    n_experts=16, top_k=4,
)
SMOKE = CONFIG.reduced()
