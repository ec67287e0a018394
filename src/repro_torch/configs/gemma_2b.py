"""gemma-2b [dense]: 18L d2048 8H (MQA kv=1) d_ff 16384 vocab 256000.

GeGLU, head_dim 256, tied embeddings scaled by sqrt(d). [arXiv:2403.08295; hf]
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense", n_layers=18, d_model=2048, n_heads=8,
    n_kv_heads=1, d_ff=16384, vocab=256000, head_dim=256, act="gelu",
    attn_pattern="g", tie_embeddings=True, embed_scale=True,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="gemma-2b-smoke", family="dense", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=1, d_ff=128, vocab=128, head_dim=16, act="gelu",
    attn_pattern="g", tie_embeddings=True, embed_scale=True,
    dtype=torch.float32, remat="none",
)
