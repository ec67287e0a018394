"""yi-34b [dense]: 60L d7168 56H (GQA kv=8) d_ff 20480 vocab 64000.

Llama-architecture GQA, SwiGLU, untied embeddings. [arXiv:2403.04652; hf]
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense", n_layers=60, d_model=7168, n_heads=56,
    n_kv_heads=8, d_ff=20480, vocab=64000, head_dim=128, act="silu",
    attn_pattern="g", tie_embeddings=False, rope_theta=5_000_000.0,
)

SMOKE = ModelConfig(
    name="yi-34b-smoke", family="dense", n_layers=3, d_model=48, n_heads=6,
    n_kv_heads=2, d_ff=96, vocab=128, head_dim=8, act="silu",
    attn_pattern="g", tie_embeddings=False, dtype=torch.float32, remat="none",
)
