"""Cross-pod gradient synchronisation.

Twin of ``repro.distributed.fsdp``. Two gradient-sync paths, mirroring the
paper's baseline-vs-chunked pair (``launch.steps.build_train_step``):

  * **auto** (the un-chunked baseline): one monolithic all-reduce a
    gradient leaf over the whole (pod x data) world — what GSPMD emits in
    the reference. Globus moving a large file as a single stream.
  * **chunked** (the paper's contribution): the data axis is meaned by the
    monolithic all-reduce (GSPMD's part in the reference), then
    ``cross_pod_mean`` synchronises the pods with a bandwidth-optimal
    reduce-scatter + all-gather ring whose messages are cut into
    planner-sized chunks, pipelining the slow, WAN-like cross-pod hop.

The per-leaf chunk count follows ``core.chunker``'s rule transposed to the
interconnect: >= ~1 MiB per message, at most ``n_chunks`` chunks.

The reference's ``manual_pod`` (``shard_map`` manual over the pod axis)
has no counterpart: every rank already runs its own pod's step.
"""
from __future__ import annotations

from typing import Any

import torch.distributed as dist

from repro_torch.distributed import chunked as C
from repro_torch.optim.adamw import tree_map


def cross_pod_mean(tree: Any, group, *, n_chunks: int = 4) -> Any:
    """Chunked mean-all-reduce of a gradient tree over the pod axis's
    ``group``. Each leaf's ring runs in the leaf's own dtype (bf16 gradients
    add in bf16, as the reference's do), then the sum is divided by the
    number of pods. Chunk counts are clamped per leaf, so small tensors ship
    whole (the paper: chunking only pays for large files). A world of one
    pod (``group`` None or of size 1) returns ``tree`` unchanged."""
    n_pods = 1 if group is None else dist.get_world_size(group)
    if n_pods == 1:
        return tree

    def leaf(g):
        nc = min(n_chunks, C.default_n_chunks(g.numel() * g.element_size()))
        return C.chunked_all_reduce(g, group, n_chunks=nc) / n_pods

    return tree_map(leaf, tree)
