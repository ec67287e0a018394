"""internvl2-2b [vlm]: 24L d2048 16H (GQA kv=8) d_ff 8192 vocab 92553.

InternViT frontend STUBBED (the batch provides projected patch embeddings,
256 visual tokens) + InternLM2 backbone. [arXiv:2404.16821; hf]
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=8, d_ff=8192, vocab=92553, head_dim=128, act="silu",
    tie_embeddings=False, n_vis_tokens=256, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="internvl2-smoke", family="vlm", n_layers=2, d_model=32, n_heads=4,
    n_kv_heads=2, d_ff=64, vocab=128, head_dim=8, act="silu",
    tie_embeddings=False, n_vis_tokens=8, dtype=torch.float32, remat="none",
)
