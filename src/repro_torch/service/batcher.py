"""Request batching — Balsam-style coalescing of small files into one task.

Balsam's Globus plugin batches up to ``transfer_batch_size`` staged files into
a single Globus transfer task so that task-submission overhead (and the
service's per-task bookkeeping) is amortized over many files. Terabyte-scale
files go the other way: each becomes its *own* task so the chunked movers and
the marginal-benefit allocator can spread a whole mover share across it.

The Batcher is pure policy (no threads): ``split`` batches one request's
items; ``add``/``flush`` support streaming accumulation per tenant.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from repro_torch.core.chunker import MiB
from repro_torch.service.task import TransferItem


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    direct_bytes: int = 512 * MiB    # >= this: route straight to a chunked task
    batch_files: int = 64            # max small files coalesced into one task
    batch_bytes: int = 4_000 * MiB   # max total bytes of one coalesced task


class Batcher:
    """Coalesce small items into batched tasks; route big items directly."""

    def __init__(self, config: BatchConfig | None = None):
        self.config = config or BatchConfig()
        self._staged: dict[str, list[TransferItem]] = {}

    # -- one-shot: batch the items of a single request ---------------------
    def split(self, items: Sequence[TransferItem]) -> list[list[TransferItem]]:
        """Group one request's items into task-sized groups.

        Large items become singleton groups (dedicated chunked-mover tasks);
        the rest are coalesced FIFO under the file-count and byte caps.
        """
        cfg = self.config
        groups: list[list[TransferItem]] = []
        batch: list[TransferItem] = []
        batch_bytes = 0
        for it in items:
            if it.nbytes >= cfg.direct_bytes:
                groups.append([it])
                continue
            if batch and (
                len(batch) >= cfg.batch_files
                or batch_bytes + it.nbytes > cfg.batch_bytes
            ):
                groups.append(batch)
                batch, batch_bytes = [], 0
            batch.append(it)
            batch_bytes += it.nbytes
        if batch:
            groups.append(batch)
        return groups

    # -- streaming: accumulate across requests, cut when a batch fills -----
    def add(self, tenant: str, items: Iterable[TransferItem]) -> list[list[TransferItem]]:
        """Stage items; return any groups that became ready (full batches and
        all direct-routed large items)."""
        cfg = self.config
        ready: list[list[TransferItem]] = []
        staged = self._staged.setdefault(tenant, [])
        for it in items:
            if it.nbytes >= cfg.direct_bytes:
                ready.append([it])
                continue
            staged.append(it)
            if (
                len(staged) >= cfg.batch_files
                or sum(s.nbytes for s in staged) >= cfg.batch_bytes
            ):
                ready.append(staged[:])
                staged.clear()
        return ready

    def flush(self, tenant: str | None = None) -> list[list[TransferItem]]:
        """Cut all partially-filled batches (for one tenant, or all)."""
        tenants = [tenant] if tenant is not None else list(self._staged)
        out = []
        for t in tenants:
            staged = self._staged.get(t) or []
            if staged:
                out.append(staged[:])
                staged.clear()
        return out

    def staged_count(self, tenant: str) -> int:
        return len(self._staged.get(tenant, ()))
