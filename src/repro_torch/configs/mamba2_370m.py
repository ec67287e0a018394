"""mamba2-370m [ssm]: 48L d1024 attn-free, ssm_state=128, vocab 50280.

SSD (state-space duality), expand 2, head_dim 64. [arXiv:2405.21060; unverified]
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm", n_layers=48, d_model=1024, n_heads=1,
    n_kv_heads=1, d_ff=0, vocab=50280, ssm_state=128, ssm_expand=2,
    ssm_head_dim=64, ssm_chunk=256, tie_embeddings=True, subquadratic=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm", n_layers=3, d_model=32, n_heads=1,
    n_kv_heads=1, d_ff=0, vocab=128, ssm_state=16, ssm_expand=2,
    ssm_head_dim=8, ssm_chunk=8, dtype=torch.float32, remat="none",
    subquadratic=True,
)
