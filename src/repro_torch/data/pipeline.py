"""Deterministic synthetic token pipeline.

Twin of ``repro.data.pipeline``. Host-side batches are made per step by
``_batch_at`` — the reference's, byte for byte (numpy
``SeedSequence([seed, step])``, a zipf base) — double-buffered on a
background thread, and placed on the device. Determinism is (seed,
step)-keyed, so a restart resumes the exact data order from the
checkpointed step (data and model state restart together). On a mesh of
more than one rank the batch dimension is sharded over (pod, data), the
reference's layout: rank (p, d) takes block ``p * dp + d`` of the global
batch. Every rank draws the same global batch and keeps its block, so
sharding needs no communication.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.dataplane import resolve_device
from repro_torch.distributed.mesh import DATA, POD, axis_size


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # learnable structure: token t+1 = (a * t + noise) % vocab on a zipf base
    structured: bool = True


def _batch_at(cfg: DataConfig, step: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    B, S, V = cfg.global_batch, cfg.seq_len + 1, cfg.vocab
    if not cfg.structured:
        return rng.integers(0, V, (B, S), dtype=np.int32)
    base = rng.zipf(1.3, size=(B, 1)).astype(np.int64) % V
    mult = rng.integers(1, 17, (B, 1))
    pos = np.arange(S, dtype=np.int64)[None, :]
    noise = rng.integers(0, 3, (B, S))
    return ((base + mult * pos + noise) % V).astype(np.int32)


class TokenPipeline:
    """Iterator of ``{'tokens': (B, S+1) int32}`` batches on ``device`` (the
    card unless the caller asks for "cpu"; a request for the card without
    one raises); on a mesh of several ranks, this rank's rows of them."""

    def __init__(self, cfg: DataConfig, mesh=None, start_step: int = 0,
                 prefetch: int = 2, device="cuda"):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self.rows = self._rows(cfg.global_batch, mesh)
        self.step = start_step
        self._next_produce = start_step
        self._q: "queue.Queue[tuple[int, np.ndarray]]" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    @staticmethod
    def _rows(batch: int, mesh) -> slice:
        """This rank's rows of a global batch: block ``p * dp + d`` of
        ``n_pods * dp``, all of it on a mesh of one device."""
        if mesh is None or mesh.size == 1:
            return slice(0, batch)
        pods, dp = axis_size(mesh, POD), axis_size(mesh, DATA)
        if batch % (pods * dp):
            raise ValueError(f"global batch {batch} does not shard over {pods} x {dp}")
        n = batch // (pods * dp)
        block = (mesh.rank(POD) if pods > 1 else 0) * dp + (mesh.rank(DATA) if dp > 1 else 0)
        return slice(block * n, (block + 1) * n)

    def _producer(self) -> None:
        while not self._stop.is_set():
            s = self._next_produce
            batch = _batch_at(self.cfg, s)[self.rows]
            try:
                self._q.put((s, batch), timeout=0.5)
            except queue.Full:
                continue
            if s == self._next_produce:
                self._next_produce = s + 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        batch = None
        for _ in range(self._q.maxsize + 1):   # drop stale prefetches after a seek
            try:
                s, b = self._q.get_nowait()
            except queue.Empty:
                break
            if s == self.step:
                batch = b
                break
        if batch is None:                      # cold start / post-seek miss
            batch = _batch_at(self.cfg, self.step)[self.rows]
        self.step += 1
        return {"tokens": torch.from_numpy(batch).to(self.device)}

    def seek(self, step: int) -> None:
        self.step = step
        self._next_produce = step
        while not self._q.empty():
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def close(self) -> None:
        """Stop the producer and wait for it (it wakes at least every 0.5 s),
        so no thread of the pipeline outlives it."""
        self._stop.set()
        self._thread.join(timeout=5.0)
