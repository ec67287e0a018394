"""whisper-large-v3 [audio]: 32+32L d1280 20H (MHA kv=20) d_ff 5120 vocab 51866.

Encoder-decoder; conv frontend STUBBED (the batch provides precomputed
frame embeddings, enc context 1500). [arXiv:2212.04356; unverified]
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec", n_layers=32, n_enc_layers=32,
    d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120, vocab=51866,
    head_dim=64, act="gelu", enc_positions=1500, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec", n_layers=2, n_enc_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=128, head_dim=16,
    act="gelu", enc_positions=24, tie_embeddings=True,
    dtype=torch.float32, remat="none",
)
