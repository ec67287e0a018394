"""Checkpoint writes of torch state as transfer-service tasks.

``repro_torch.ckpt.save_checkpoint`` drives its own movers synchronously.
This bridge instead *submits* the checkpoint's leaves to a TransferService —
the write becomes one async task competing (fairly) with every other
tenant's traffic, scheduled under the global mover budget, journaled, and
integrity-fingerprinted by the service's movers. The resulting directory is
byte- and manifest-compatible with ``repro_torch.ckpt.restore_checkpoint``
and with the reference's ``restore_checkpoint``.

The leaves' byte images are in-memory (ephemeral) sources: if the service
dies before the task completes, recovery marks the task FAILED, the ``.tmp``
directory keeps its journaled chunks, and a re-submission after restart
skips every chunk that already landed (the destination files and service
journals are both keyed by the same deterministic chunk plan).

Delta checkpoints (``delta=True``): successive saves of a training state
differ by a few percent, yet every save re-moves every byte. The previous
save's MANIFEST.json already catalogs each leaf's chunks with their
merge-law digests — it IS a content index of that directory. Seeding the
service's chunk index from it and submitting with ``dedup="on"`` turns the
save into a delta: unchanged chunks are satisfied by a local copy from the
previous save's files, only changed chunks ride the wire, and the landed
directory stays byte- and manifest-compatible with a full save (restore
cannot tell the difference).

This is the port's copy of ``repro.service.ckpt_bridge``, for a state dict
of torch tensors (flattened and named as ``repro_torch.ckpt`` does). Where
it differs: a leaf on the card is copied off the card at submit time, and
its digest is taken there in the same step (``digest_of``, the
``checksum_words`` kernel) — the caller keeps training after submit, so a
digest taken later would see other weights. ``wait()`` raises
``IntegrityError`` if that digest differs from the digest of the bytes the
service landed, as ``save_checkpoint`` does for its own card leaves.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np

from repro_torch.cas import seed_index_from_manifest
from repro_torch.ckpt.checkpoint import SaveReport, _flatten, dtype_name, tensor_bytes
from repro_torch.core.integrity import Digest
from repro_torch.core.transfer import IntegrityError
from repro_torch.kernels import digest_of
from repro_torch.obs.clock import mono_s, wall_s
from repro_torch.service.task import SUCCEEDED, TaskStatus


@dataclasses.dataclass
class CheckpointSubmission:
    """Handle for an in-flight checkpoint-save task."""

    service: Any
    task_id: str
    step: int
    tmp_dir: str
    final_dir: str
    leaf_meta: list[tuple[str, tuple[int, ...], str]]   # (key, shape, dtype)
    submitted_s: float          # wall-clock timestamp (display only)
    t0_mono: float = 0.0        # monotonic mark: elapsed-time math only —
    #                             wall clock steps (NTP slew) must not be
    #                             able to produce a negative save duration
    card_digests: dict[str, Digest] = dataclasses.field(default_factory=dict)
    #                             digest of each card leaf, taken at submit

    def status(self) -> TaskStatus:
        return self.service.status(self.task_id)

    def wait(self, timeout: float | None = None) -> SaveReport:
        """Block until the save task finishes; finalize MANIFEST + rename."""
        st = self.service.wait(self.task_id, timeout)
        if st.state != SUCCEEDED:
            raise RuntimeError(
                f"checkpoint task {self.task_id} ended {st.state}: {st.error}"
            )
        manifest: dict[str, Any] = {"step": self.step, "process": 0, "leaves": {}}
        total = 0
        for (key, shape, dtype), rep in zip(self.leaf_meta, st.item_reports):
            on_card = self.card_digests.get(key)
            if on_card is not None and on_card.hexdigest() != rep.digest_hex:
                raise IntegrityError(
                    f"leaf {key!r}: digest on the card at submit "
                    f"{on_card.hexdigest()} != digest of the bytes landed "
                    f"{rep.digest_hex}")
            manifest["leaves"][key] = {
                "shape": list(shape),
                "dtype": dtype,
                "nbytes": rep.nbytes,
                "file": os.path.basename(rep.dst),
                "digest": rep.digest_hex,
                "chunk_bytes": rep.chunk_bytes,
                "chunks": [dict(c) for c in rep.chunks],
            }
            total += rep.nbytes
        with open(os.path.join(self.tmp_dir, "MANIFEST.json"), "w") as fh:
            json.dump(manifest, fh, indent=1, sort_keys=True)
        if os.path.exists(self.final_dir):
            import shutil

            shutil.rmtree(self.final_dir)
        os.replace(self.tmp_dir, self.final_dir)
        return SaveReport(
            step=self.step,
            path=self.final_dir,
            total_bytes=total,
            seconds=mono_s() - self.t0_mono,
            n_leaves=len(self.leaf_meta),
            resumed_chunks=st.resumed_chunks,
        )


def _previous_save(root: str, step: int) -> tuple[str, dict] | None:
    """The newest completed save below ``step``: (dir, manifest) or None."""
    best: tuple[int, str] | None = None
    try:
        names = os.listdir(root)
    except OSError:
        return None
    for name in names:
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        try:
            s = int(name[len("step_"):])
        except ValueError:
            continue
        if s < step and (best is None or s > best[0]):
            best = (s, os.path.join(root, name))
    if best is None:
        return None
    try:
        with open(os.path.join(best[1], "MANIFEST.json")) as fh:
            return best[1], json.load(fh)
    except (OSError, ValueError):
        return None


def submit_checkpoint(
    service,
    root: str | os.PathLike,
    step: int,
    tree: Any,
    *,
    tenant: str = "ckpt",
    chunk_bytes: int | None = None,
    delta: bool = False,
) -> CheckpointSubmission:
    """Submit one checkpoint save as a single service task; returns a handle.

    The caller keeps training while the service's movers drain the task; call
    ``.wait()`` (or poll ``.status()``) before relying on the checkpoint.
    Leaves on the card are copied to host memory (and digested on the card)
    before this returns, so later updates to them do not reach the save.

    ``delta=True`` fingerprints this save against the newest previous save
    under ``root``: the previous MANIFEST seeds the service's chunk index and
    the task submits with ``dedup="on"``, so only changed chunks are moved
    (unchanged ones are locally copied from the previous save's files). The
    chunk size is pinned to the previous save's unless the caller overrides
    it — dedup matches whole chunks, so boundaries must line up. With no
    previous save, delta degrades to a normal full save.
    """
    final = os.path.join(str(root), f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    dedup: str | None = None
    if delta:
        prev = _previous_save(str(root), step)
        if prev is not None:
            prev_dir, manifest = prev
            seed_index_from_manifest(service.cas_index(), manifest, prev_dir)
            dedup = "on"
            if chunk_bytes is None:
                # Leaves smaller than the plan's chunk size record a clamped
                # per-leaf chunk_bytes (== nbytes), so the true plan size is
                # the one multi-chunk leaves agree on; fall back to the max
                # when every leaf fit in a single chunk.
                leaves_meta = manifest.get("leaves", {}).values()
                sizes = {int(lv["chunk_bytes"]) for lv in leaves_meta
                         if lv.get("chunk_bytes") and len(lv.get("chunks", ())) > 1}
                if not sizes:
                    sizes = {int(lv["chunk_bytes"]) for lv in leaves_meta
                             if lv.get("chunk_bytes")}
                if sizes:
                    chunk_bytes = max(sizes)

    leaves = _flatten(tree)
    buffers: list[tuple[np.ndarray, str]] = []
    leaf_meta: list[tuple[str, tuple[int, ...], str]] = []
    card_digests: dict[str, Digest] = {}
    for key, t in leaves.items():
        safe = key.replace("/", "__")
        if t.device.type == "cuda" and t.numel():
            # the digest and the host copy are of the same bytes: both are
            # taken before submit returns and the caller updates the leaf
            card_digests[key] = digest_of(t)
        buffers.append((tensor_bytes(t), os.path.join(tmp, f"{safe}.bin")))
        leaf_meta.append((key, tuple(t.shape), dtype_name(t.dtype)))

    task_id = service.submit_buffers(
        buffers, tenant=tenant, label=f"ckpt-step{step}", chunk_bytes=chunk_bytes,
        dedup=dedup,
    )
    return CheckpointSubmission(
        service=service,
        task_id=task_id,
        step=step,
        tmp_dir=tmp,
        final_dir=final,
        leaf_meta=leaf_meta,
        submitted_s=wall_s(),
        t0_mono=mono_s(),
        card_digests=card_digests,
    )
