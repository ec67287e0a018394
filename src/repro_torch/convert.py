"""Carry state across from the reference package.

Plans and digests made by ``repro`` become the port's own objects here, so
one plan can drive both engines and their digests compare as equals; a
reference pytree of numpy arrays becomes the port's state dict and back.
All of it is duck-typed — ``.h``/``.length`` for a digest, the
``ChunkPlan``/``Chunk`` fields for a plan, nested dicts and lists for a
tree — and imports nothing of ``repro``. The other half of the shared state
is on disk: the chunk journal and the checkpoint layout, which the two
packages write byte for byte alike.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import _flatten, _unflatten, dtype_name, tensor_bytes
from repro_torch.core.chunker import Chunk, ChunkPlan
from repro_torch.core.integrity import Digest


def digest_from_reference(d) -> Digest:
    """The port's ``Digest`` for a reference digest (any object with
    ``h``, a sequence of four residues, and ``length``)."""
    return Digest(tuple(int(v) for v in d.h), int(d.length))


def plan_from_reference(p) -> ChunkPlan:
    """The port's ``ChunkPlan`` for a reference plan (same fields)."""
    return ChunkPlan(
        total_bytes=int(p.total_bytes),
        chunk_bytes=int(p.chunk_bytes),
        movers=int(p.movers),
        pipeline_depth=int(p.pipeline_depth),
        chunks=tuple(Chunk(int(c.index), int(c.offset), int(c.length), int(c.mover))
                     for c in p.chunks),
    )


def state_from_reference(tree: Any) -> dict[str, torch.Tensor]:
    """The port's state dict of a reference pytree of numpy arrays: one CPU
    tensor a leaf, keyed by the leaf's "/"-joined path (the checkpoint's
    keys), with the same dtype and bytes (bfloat16 included)."""
    return _flatten(tree)


def state_to_reference(state: Any) -> dict:
    """A reference pytree (nested dicts of numpy arrays, split on "/") of
    the port's state. The numpy dtype is looked up by the MANIFEST name, so
    a bfloat16 leaf needs numpy's bfloat16, which ``ml_dtypes`` registers
    (the reference imports it)."""
    leaves = {}
    for key, t in _flatten(state).items():
        dt = np.dtype(dtype_name(t.dtype))
        leaves[key] = tensor_bytes(t).copy().view(dt).reshape(tuple(t.shape))
    return _unflatten(leaves)
