"""Sub-seeds derived from the run's ``--seed`` (any whole number)."""
from __future__ import annotations

import hashlib


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for ``torch.Generator.manual_seed`` from ``seed`` and tags."""
    key = "/".join(str(t) for t in (int(seed), *tags)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") & ((1 << 63) - 1)
