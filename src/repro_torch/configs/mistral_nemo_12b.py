"""mistral-nemo-12b [dense]: 40L d5120 32H (GQA kv=8) d_ff 14336 vocab 131072.

128k-context llama-family model, SwiGLU, head_dim 128, untied.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=131072, head_dim=128,
    act="silu", attn_pattern="g", tie_embeddings=False, rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="mistral-nemo-12b-smoke", family="dense", n_layers=3, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16, act="silu",
    attn_pattern="g", tie_embeddings=False, dtype=torch.float32, remat="none",
)
