"""Carry state across from the reference package.

Plans and digests made by ``repro`` become the port's own objects here, so
one plan can drive both engines and their digests compare as equals; a
reference pytree of numpy arrays becomes the port's state dict and back,
and a reference model's params tree the port's (``params_from_reference``)
and back. ``gather_params`` makes the whole tree of a run's blocks over a
``model`` axis, so it compares with the reference's.
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
from repro_torch.core.dataplane import resolve_device
from repro_torch.core.chunker import Chunk, ChunkPlan
from repro_torch.core.integrity import Digest
from repro_torch.distributed.mesh import gather


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


def params_from_reference(tree: Any, device="cuda") -> dict:
    """The port's params tree (nested dicts of tensors on ``device``) of a
    reference model's params: nested dicts of numpy arrays, as
    ``np.asarray`` makes them of ``init_params``. A bfloat16 leaf may come as
    numpy's bfloat16 (``ml_dtypes``) or as its ``uint16`` view, since a
    params tree holds no uint16 leaf of its own; either becomes a bfloat16
    tensor with the same bits."""
    dev = resolve_device(device)

    def bf16_bits(node):
        if isinstance(node, dict):
            return {k: bf16_bits(v) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype == np.uint16:
            return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(
                torch.bfloat16)
        return node

    leaves = state_from_reference(bf16_bits(tree))
    return _unflatten({key: t.to(dev) for key, t in leaves.items()})


def params_to_reference(state: Any) -> dict:
    """A reference params tree (nested dicts of host numpy arrays) of the
    port's: each leaf with its dtype and bytes, a bfloat16 leaf as its
    ``uint16`` view (``.view(jnp.bfloat16)`` on the reference's side), so
    no ``ml_dtypes`` is needed here."""
    leaves = {}
    for key, t in _flatten(state).items():
        raw = tensor_bytes(t).copy()
        dt = np.uint16 if t.dtype == torch.bfloat16 else np.dtype(dtype_name(t.dtype))
        leaves[key] = raw.view(dt).reshape(tuple(t.shape))
    return _unflatten(leaves)


def gather_params(tree: Any, mesh, specs: Any) -> dict:
    """The whole params tree of this rank's blocks ``tree`` under the
    PartitionSpecs ``specs`` (``param_specs(mesh)``): each leaf cut over
    ``model`` gathered over the model group, leaf by leaf. Every rank of
    the group calls it."""
    if isinstance(tree, dict):
        return {k: gather_params(v, mesh, specs[k]) for k, v in tree.items()}
    return gather(mesh, tree, specs)
