"""The frozen token generator: each step's batch, uniform over the
vocabulary, drawn from the seed on the device the batch is used on."""
from __future__ import annotations

import torch

from bench.reference.seeds import sub_seed


def batch(seed: int, step: int, rows: int, seq_len: int, vocab: int, device) -> torch.Tensor:
    """Step ``step``'s (rows, seq_len + 1) int32 token ids: inputs and the
    next-token labels. The same arguments give the same ids."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "tokens", step))
    return torch.randint(0, vocab, (rows, seq_len + 1), generator=gen, device=device,
                         dtype=torch.int32)
