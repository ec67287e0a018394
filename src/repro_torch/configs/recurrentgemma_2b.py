"""recurrentgemma-2b [hybrid]: 26L d2560 10H (MQA kv=1) d_ff 7680 vocab 256000.

Griffin: RG-LRU + local attention (window 2048), 2:1 recurrent:attention,
lru_width 2560, GeGLU, tied + scaled embeddings. [arXiv:2402.19427; hf]
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab=256000, head_dim=256,
    act="gelu", window=2048, lru_width=2560, conv1d_size=4,
    tie_embeddings=True, embed_scale=True, subquadratic=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid", n_layers=8, d_model=32,
    n_heads=4, n_kv_heads=1, d_ff=64, vocab=128, head_dim=8, act="gelu",
    window=8, lru_width=32, conv1d_size=4, tie_embeddings=True,
    embed_scale=True, dtype=torch.float32, remat="none", subquadratic=True,
)
