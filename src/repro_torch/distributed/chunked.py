"""Chunked collectives: client-driven chunking applied to the interconnect.

Twin of ``repro.distributed.chunked``. The paper's mechanism moved onto a
mesh axis: a large tensor crossing the axis is cut into chunks that travel
as separate ring messages, so (a) every link carries fine-grained messages
that overlap with compute, and (b) a consumer (a matmul) can start on
chunk k-1 while chunk k is in flight.

The reference's functions are manual-SPMD under ``shard_map``; these are
rank-local, multi-controller functions (one process a device, as in
PyTorch's idiom). Each takes the axis's ``ProcessGroup`` where the
reference takes ``(axis_name, axis_size)``: the axis size is the group's
size and the index is ``dist.get_rank(group)``. Each ``ppermute`` is a
ring hop: one ``dist.batch_isend_irecv`` carries every chunk's send to the
next rank and receive from the previous one, so ``n_chunks`` messages are
in flight on each link, as in the reference's interleaving of the chunk
rings. Peers are global ranks and each chunk has its own tag (gloo matches
messages on (peer, tag); NCCL matches them in the order they are posted).

The monolithic baselines are ``dist.all_gather_into_tensor``,
``dist.reduce_scatter_tensor`` and ``dist.all_reduce``. The block products
of ``ag_matmul`` and ``matmul_rs`` are plain ``torch.mm``, as the
reference's are plain ``@``. Where the reference asserts, these raise
``ValueError``. The legacy-JAX shims (``_AXIS_INDEX_OVERRIDE``,
``_PSUM_FALLBACK_AXES``) have no counterpart.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _axis(group) -> tuple[int, int]:
    """(axis size, this rank's index on the axis) of ``group``."""
    return dist.get_world_size(group), dist.get_rank(group)


def _ring_perm(axis_size: int, reverse: bool = False):
    if reverse:
        return [((i + 1) % axis_size, i) for i in range(axis_size)]
    return [(i, (i + 1) % axis_size) for i in range(axis_size)]


def _hop(send: list, recv: list, perm, idx: int, group) -> list:
    """Post one ring step of ``perm`` (``(source, dest)`` group indices) for
    the rank at ``idx``: chunk c of ``send`` to its dest and chunk c of
    ``recv`` from its source, all in one batch. Returns the works to wait."""
    to = next(d for s, d in perm if s == idx)
    frm = next(s for s, d in perm if d == idx)
    dst, src = dist.get_global_rank(group, to), dist.get_global_rank(group, frm)
    ops = [dist.P2POp(dist.isend, t, dst, group, tag=c) for c, t in enumerate(send)]
    ops += [dist.P2POp(dist.irecv, t, src, group, tag=c) for c, t in enumerate(recv)]
    return dist.batch_isend_irecv(ops)


def _wait(works: list) -> None:
    for w in works:
        w.wait()


def default_n_chunks(nbytes: int, *, pipeline_depth: int = 4, min_chunk_bytes: int = 1 << 20) -> int:
    """Paper §3.1 heuristic at interconnect scale: depth chunks, >= 1 MiB messages."""
    if nbytes <= min_chunk_bytes:
        return 1
    return max(1, min(pipeline_depth, nbytes // min_chunk_bytes))


# ---------------------------------------------------------------------------
# all-gather
# ---------------------------------------------------------------------------
def chunked_all_gather(x: torch.Tensor, group, *, n_chunks: int = 4) -> torch.Tensor:
    """Ring all-gather of the local shard, moved in ``n_chunks`` sub-messages.

    x: (s, ...) local shard -> (axis_size * s, ...), equal to
    ``dist.all_gather_into_tensor`` over ``group`` (the monolithic baseline).
    Each received chunk lands in its place in the output and is forwarded
    from there on the next step.
    """
    A, idx = _axis(group)
    x = x.contiguous()
    s = x.shape[0]
    if n_chunks > 1 and s % n_chunks != 0:
        n_chunks = 1  # fall back rather than mis-chunk
    cs = s // n_chunks
    out = x.new_empty((A * s,) + tuple(x.shape[1:]))
    out[idx * s:(idx + 1) * s] = x

    def chunks(owner: int) -> list:
        return [out[owner * s + c * cs: owner * s + (c + 1) * cs] for c in range(n_chunks)]

    perm = _ring_perm(A)
    bufs = chunks(idx)
    for step in range(1, A):
        recv = chunks((idx - step) % A)
        _wait(_hop(bufs, recv, perm, idx, group))
        bufs = recv
    return out


# ---------------------------------------------------------------------------
# reduce-scatter
# ---------------------------------------------------------------------------
def chunked_reduce_scatter(x: torch.Tensor, group, *, n_chunks: int = 4) -> torch.Tensor:
    """Ring reduce-scatter: x (A*s, ...) on every rank -> (s, ...) summed shard.

    Equal to ``dist.reduce_scatter_tensor`` over ``group`` up to the order of
    the additions, which is the reference's: at step t rank r receives the
    running partial for block (r-1-t) mod A and adds its own contribution to
    it (received + own); after A-1 steps rank r holds block r, summed over
    every rank.
    """
    A, idx = _axis(group)
    rows = x.shape[0]
    if rows % A != 0:
        raise ValueError(f"{rows} rows do not split over an axis of {A}")
    x = x.contiguous()
    s = rows // A
    if n_chunks > 1 and s % n_chunks != 0:
        n_chunks = 1
    cs = s // n_chunks

    def block(owner: int, c: int) -> torch.Tensor:
        return x[owner * s + c * cs: owner * s + (c + 1) * cs]

    perm = _ring_perm(A)
    acc = [block((idx - 1) % A, c) for c in range(n_chunks)]
    for step in range(1, A):
        own = (idx - 1 - step) % A
        recv = [torch.empty_like(a) for a in acc]
        _wait(_hop(acc, recv, perm, idx, group))
        acc = [recv[c] + block(own, c) for c in range(n_chunks)]
    return torch.cat(acc, dim=0) if n_chunks > 1 else acc[0]


def chunked_all_reduce(x: torch.Tensor, group, *, n_chunks: int = 4) -> torch.Tensor:
    """Bandwidth-optimal all-reduce = chunked reduce-scatter + chunked all-gather.

    Equal to ``dist.all_reduce`` (sum) over ``group`` up to the order of the
    additions. This is the pod-axis gradient synchronisation path: the
    cross-pod hop is the slow link where the paper's chunking pays most.
    The flattened tensor is zero-padded to a multiple of A * n_chunks.
    """
    A, _ = _axis(group)
    shape = x.shape
    flat = x.reshape(-1)
    groups = A * n_chunks
    pad = (-flat.numel()) % groups
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    mat = flat.reshape(groups, -1)                      # (A*n_chunks, m)
    shard = chunked_reduce_scatter(mat, group, n_chunks=n_chunks)
    full = chunked_all_gather(shard, group, n_chunks=n_chunks)
    return full.reshape(-1)[: x.numel()].reshape(shape)


# ---------------------------------------------------------------------------
# overlapped all-gather matmul (collective matmul)
# ---------------------------------------------------------------------------
def ag_matmul(x: torch.Tensor, w_shard: torch.Tensor, group) -> torch.Tensor:
    """y = x @ all_gather(w_shard) with transfer/compute overlap.

    x: (B, K) replicated on the axis; w_shard: (K/A, N) local rows of W.
    Each step posts the ring hop that pulls the next weight block from the
    right, multiplies the block already resident, and only then waits for
    the hop: the product of block k-1 runs while block k moves (the
    reference leaves this overlap to XLA's scheduler). The weight blocks
    are the chunks; their size is fixed by the shard.
    """
    A, idx = _axis(group)
    B, K = x.shape
    kA, N = w_shard.shape
    if kA * A != K:
        raise ValueError(f"x {tuple(x.shape)} and w_shard {tuple(w_shard.shape)} "
                         f"do not fit an axis of {A}")

    def x_block(owner: int) -> torch.Tensor:
        return x[:, owner * kA:(owner + 1) * kA]

    perm = _ring_perm(A, reverse=True)  # pull blocks from the right
    buf = w_shard.contiguous()
    acc = None
    for step in range(A):
        works, nxt = [], None
        if step + 1 < A:
            nxt = torch.empty_like(buf)
            works = _hop([buf], [nxt], perm, idx, group)
        part = torch.mm(x_block((idx + step) % A), buf)
        acc = part if acc is None else acc + part
        _wait(works)
        buf = nxt
    return acc


def matmul_rs(x: torch.Tensor, w: torch.Tensor, group, *, n_chunks: int = 1) -> torch.Tensor:
    """y_shard = reduce_scatter(x_partial @ w_partial), the row-parallel pair.

    x: (B, K/A) local columns; w: (K/A, N) local rows; output (B/A, N).
    The partial products are reduce-scattered chunk-wise.
    """
    A, _ = _axis(group)
    if x.shape[0] % A != 0:
        raise ValueError(f"{x.shape[0]} rows do not split over an axis of {A}")
    part = torch.mm(x, w)                             # (B, N) partial sum
    return chunked_reduce_scatter(part, group, n_chunks=n_chunks)
