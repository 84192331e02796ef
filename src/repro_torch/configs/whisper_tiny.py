"""Whisper-tiny [arXiv:2212.04356] -- encoder-decoder, the conv frontend stubbed."""
from .base import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab=51865, head_dim=64,
    n_audio_ctx=1500, n_enc_layers=4,
)
SMOKE = CONFIG.reduced()
