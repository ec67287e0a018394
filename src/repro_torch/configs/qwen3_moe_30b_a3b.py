"""qwen3-moe-30b-a3b [moe]: 48L d2048 32H (GQA kv=4) expert d_ff 768,
vocab 151936, 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

Note: Qwen3's qk-norm is not modeled (structural nicety orthogonal to the
paper's technique); noted in the reference's DESIGN.md.
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, d_ff=768, vocab=151936, head_dim=128,
    act="silu", n_experts=128, top_k=8, tie_embeddings=False,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe", n_layers=2, d_model=32, n_heads=4,
    n_kv_heads=2, d_ff=64, vocab=128, head_dim=8, act="silu",
    n_experts=8, top_k=2, tie_embeddings=False, dtype=torch.float32, remat="none",
)
