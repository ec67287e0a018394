"""grok-1-314b [moe]: 64L d6144 48H (GQA kv=8) expert d_ff 32768,
vocab 131072, 8 experts top-2, attention logit softcap 30.
[hf:xai-org/grok-1; unverified]

The reference places the 8 experts with SPLIT=2 on a 16-wide model axis;
the port places them the same way on any model axis (one device: all 8
whole; four ranks: 2 a rank, SPLIT=1), see models/moe.py. ``launch.steps`` keeps the optimizer state in bf16 for any
config over 1e11 parameters, as the reference does.
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=32768, vocab=131072, head_dim=128, act="gelu",
    n_experts=8, top_k=2, attn_softcap=30.0, final_softcap=30.0,
    tie_embeddings=True, embed_scale=True,
)

SMOKE = ModelConfig(
    name="grok-1-smoke", family="moe", n_layers=2, d_model=32, n_heads=4,
    n_kv_heads=2, d_ff=64, vocab=128, head_dim=8, act="gelu",
    n_experts=2, top_k=2, attn_softcap=30.0, final_softcap=30.0,
    tie_embeddings=True, embed_scale=True, dtype=torch.float32, remat="none",
)
