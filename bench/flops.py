"""The frozen yardstick: model FLOPs of a train step and the H100's peaks.

PaLM's count (Chowdhery et al. 2022, appendix B): a step over ``tokens``
tokens of context ``seq_len`` costs 6 N tokens + 12 L H hd seq_len tokens,
where N counts the parameters a token's forward touches as matmul weights:
every non-embedding parameter (for a MoE, the router and top_k of the
experts; the norms too) plus the unembedding. The embedding lookup is not
counted, and attention's context term counts the whole S x S score matrix,
as PaLM does, causal or not. Nothing recomputed (remat) and nothing padded
(a MoE's capacity slots) is counted.
"""
from __future__ import annotations

from bench.reference.dims import Dims

# NVIDIA H100 SXM5 data sheet, dense rates, at the 700 W limit
BF16_PEAK_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12


def active_params(dm: Dims) -> int:
    """N: the non-embedding parameters a token touches, plus the unembedding."""
    D, H, K, hd, F = dm.d, dm.heads, dm.kv_heads, dm.hd, dm.ff
    attn = D * H * hd + 2 * D * K * hd + H * hd * D
    if dm.family == "moe":
        ffn = D * dm.experts + dm.top_k * 3 * D * F
    else:
        ffn = 3 * D * F
    return dm.layers * (attn + ffn + 2 * D) + D + dm.vocab * D


def train_step_flops(dm: Dims, seq_len: int, batch: int) -> float:
    tokens = seq_len * batch
    return 6.0 * active_params(dm) * tokens + 12.0 * dm.layers * dm.heads * dm.hd * seq_len * tokens
