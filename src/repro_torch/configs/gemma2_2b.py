"""gemma2-2b [dense]: 26L d2304 8H (GQA kv=4) d_ff 9216 vocab 256000.

Alternating local(4096)/global attention, attn/final logit softcaps (50/30),
post-norms, GeGLU, head_dim 256, tied + scaled embeddings. [arXiv:2408.00118; hf]
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense", n_layers=26, d_model=2304, n_heads=8,
    n_kv_heads=4, d_ff=9216, vocab=256000, head_dim=256, act="gelu",
    attn_pattern="lg", window=4096, attn_softcap=50.0, final_softcap=30.0,
    post_norms=True, tie_embeddings=True, embed_scale=True,
    rope_theta=10000.0, subquadratic=True,  # local layers keep long_500k viable
)

SMOKE = ModelConfig(
    name="gemma2-2b-smoke", family="dense", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=128, head_dim=16, act="gelu",
    attn_pattern="lg", window=8, attn_softcap=50.0, final_softcap=30.0,
    post_norms=True, tie_embeddings=True, embed_scale=True,
    dtype=torch.float32, remat="none",
)
