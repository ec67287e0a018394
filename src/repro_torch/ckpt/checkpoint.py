"""Chunked, integrity-checked, restartable checkpointing of torch state.

Twin of ``repro.ckpt.checkpoint`` for a nested dict or list of torch tensors
(a state dict). Each leaf is cut into chunks by the planner
(``core.chunker``), moved by the chunked transfer engine (``core.transfer``)
with per-chunk fingerprints computed in the same pass as the write,
journaled for partial restart, and verified chunk by chunk on restore — a
corrupted chunk is reported *by chunk*, so repair means re-fetching chunk
ranges rather than whole multi-GB files.

The on-disk layout is the reference's, byte for byte: the same MANIFEST.json
(dtype strings are numpy's names, "bfloat16" included), the same leaf files
and journals, so either package restores what the other saved.

    <root>/step_000123/            (renamed from .tmp on completion)
        MANIFEST.json              tree structure + per-leaf digests/plans
        <leaf-key>.bin             raw little-endian bytes
        <leaf-key>.journal         chunk-completion journal (kept for audit)

Where the port differs: ``device``. Every digest runs there. Save hands
it to ``ChunkedTransfer``, whose movers digest each chunk and its read-back
on ``device``, and a leaf that lies on the card is also digested there
(``digest_of``, the ``checksum_words`` kernel) and held against the digest
of the bytes written, so a fault between the card and the file is caught at
save. Restore copies each leaf file to ``device`` once, checks its chunks
there (``fingerprint_ranges_on_device``) and returns that copy as the
tensor. A request for the card without one raises. ``materialize`` lets a
sharded run hand over its blocks and gather each leaf whole just before it
is written: leaves are materialized on the calling thread, in tree order,
with at most ``io_workers`` of them in flight.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import shutil
import threading
import time
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.chunker import plan_chunks
from repro_torch.core.dataplane import (
    fingerprint_on_device,
    fingerprint_ranges_on_device,
    resolve_device,
)
from repro_torch.core.integrity import Digest
from repro_torch.core.journal import ChunkJournal
from repro_torch.core.transfer import BufferSource, ChunkedTransfer, FileDest, IntegrityError
from repro_torch.kernels import digest_of

# MANIFEST dtype strings (numpy's names, as the reference writes them)
DTYPES = {
    "float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int32": torch.int32, "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "uint32": torch.uint32, "float64": torch.float64, "int64": torch.int64,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


class CorruptionError(RuntimeError):
    def __init__(self, leaf: str, bad_chunks: list[int]):
        super().__init__(f"leaf {leaf!r}: corrupted chunks {bad_chunks}")
        self.leaf = leaf
        self.bad_chunks = bad_chunks


# ---------------------------------------------------------------------------
# tensors <-> bytes, state dict <-> flat leaves
# ---------------------------------------------------------------------------
def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype, as the MANIFEST records it."""
    try:
        return _NAMES[dtype]
    except KeyError:
        raise TypeError(f"no checkpoint dtype for {dtype}") from None


def as_tensor(leaf: Any) -> torch.Tensor:
    """A tensor as it is; anything else through ``np.asarray``, as the
    reference flattens it, and carried over by its bytes (so numpy's
    bfloat16 needs no import here). A dtype without a MANIFEST name raises."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name not in DTYPES:
        raise TypeError(f"no checkpoint dtype for {arr.dtype}")
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8).copy()
    return tensor_from_bytes(raw, arr.dtype.name, arr.shape)


def tensor_bytes(t: torch.Tensor) -> np.ndarray:
    """The little-endian byte image of a tensor as a host uint8 array."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()


def tensor_from_bytes(raw: np.ndarray, name: str, shape, device="cpu") -> torch.Tensor:
    """A tensor of MANIFEST dtype ``name`` and ``shape`` over uint8 ``raw``."""
    if raw.size == 0:             # torch cannot reinterpret an empty buffer
        return torch.empty(list(shape), dtype=DTYPES[name], device=device)
    flat = torch.from_numpy(raw).view(DTYPES[name])
    return flat.reshape(list(shape)).to(device)


def _flatten(tree: Any) -> dict[str, torch.Tensor]:
    """Leaves keyed by their "/"-joined path, as the reference keys them
    (dict keys and list indices; None is an empty subtree)."""
    leaves: dict[str, torch.Tensor] = {}

    def walk(node: Any, path: tuple[str, ...]) -> None:
        if node is None:
            return
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            leaves["/".join(path)] = as_tensor(node)

    walk(tree, ())
    return leaves


def _unflatten(leaves: dict[str, Any]) -> dict:
    root: dict = {}
    for key, val in leaves.items():
        parts = key.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return root


def _process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SaveReport:
    step: int
    path: str
    total_bytes: int
    seconds: float
    n_leaves: int
    resumed_chunks: int


def save_checkpoint(
    root: str | os.PathLike,
    step: int,
    tree: Any,
    *,
    movers: int = 8,
    io_workers: int = 4,
    chunk_bytes: int | None = None,
    process_index: int | None = None,
    device="cuda",
    materialize: Callable[[str, torch.Tensor], torch.Tensor] | None = None,
) -> SaveReport:
    """Write one checkpoint; safe to re-invoke after a crash (partial restart).
    ``materialize(key, leaf)``, when given, makes the tensor written for
    each leaf (called on this thread, in tree order)."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    proc = _process_index() if process_index is None else process_index
    final = os.path.join(str(root), f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    leaves = _flatten(tree)
    manifest: dict[str, Any] = {"step": step, "process": proc, "leaves": {}}
    total = 0
    resumed = 0
    lock = threading.Lock()

    def save_leaf(item):
        nonlocal total, resumed
        key, t = item
        safe = key.replace("/", "__")
        data = tensor_bytes(t)
        plan = plan_chunks(
            data.nbytes, movers,
            chunk_bytes=chunk_bytes, min_chunk=4 * 1024 * 1024,
            max_chunk=256 * 1024 * 1024, alignment=max(1, t.element_size()),
        ) if data.nbytes else plan_chunks(0, movers)
        bin_path = os.path.join(tmp, f"{safe}.bin")
        journal = ChunkJournal(os.path.join(tmp, f"{safe}.journal"))
        dest = FileDest(bin_path, data.nbytes)
        if data.nbytes:
            report = ChunkedTransfer(
                BufferSource(data), dest, plan, integrity=True, journal=journal,
                device=dev,
            ).run()
            digest = report.file_digest
            skipped = report.skipped_chunks
        else:
            digest = fingerprint_on_device(b"", dev)
            skipped = 0
        journal.close()
        dest.close()
        if t.device.type == "cuda" and data.nbytes:
            on_card = digest_of(t)
            if on_card != digest:
                raise IntegrityError(
                    f"leaf {key!r}: digest on the card {on_card.hexdigest()} != digest "
                    f"of the bytes written {digest.hexdigest()}")
        entry = {
            "shape": list(t.shape),
            "dtype": dtype_name(t.dtype),
            "nbytes": int(data.nbytes),
            "file": f"{safe}.bin",
            "digest": digest.hexdigest(),
            "chunk_bytes": plan.chunk_bytes,
            "chunks": [
                {"index": c.index, "offset": c.offset, "length": c.length,
                 "digest": journal.records[c.index].digest_hex
                 if c.index in journal.records else None}
                for c in plan.chunks
            ],
        }
        with lock:
            manifest["leaves"][key] = entry
            total += data.nbytes
            resumed += skipped

    with ThreadPoolExecutor(max_workers=io_workers) as ex:
        pending: collections.deque = collections.deque()
        for key, t in leaves.items():
            if len(pending) >= io_workers:
                pending.popleft().result()
            pending.append(ex.submit(save_leaf, (key, materialize(key, t) if materialize else t)))
        for fut in pending:
            fut.result()

    with open(os.path.join(tmp, "MANIFEST.json"), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return SaveReport(step, final, total, time.perf_counter() - t0, len(leaves), resumed)


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------
def restore_checkpoint(
    path: str | os.PathLike,
    *,
    verify_chunks: bool = True,
    movers: int = 8,
    device="cuda",
    keep: Callable[[str, torch.Tensor], torch.Tensor] | None = None,
) -> tuple[dict, int]:
    """Read + verify a checkpoint directory -> (nested dict of tensors on
    ``device``, step). ``keep(key, leaf)``, when given, makes the tensor
    kept for each whole leaf once it is verified (called in MANIFEST
    order, one leaf at a time: a rank's block of it, so the whole leaf is
    freed before the next is read); the counterpart of
    ``save_checkpoint``'s ``materialize``.

    Verification is per chunk, on ``device``: each leaf file is copied there
    once, its chunks are digested in place (tile-aligned runs in one
    ``checksum_many_words`` launch) and the same copy becomes the tensor.
    All bad chunks of a leaf are collected before raising CorruptionError
    (so an operator knows the exact byte ranges to re-replicate).
    ``movers`` is kept for the reference's signature.
    """
    dev = resolve_device(device)
    path = str(path)
    with open(os.path.join(path, "MANIFEST.json")) as fh:
        manifest = json.load(fh)
    leaves: dict[str, torch.Tensor] = {}

    def load_leaf(item):
        key, entry = item
        raw = np.fromfile(os.path.join(path, entry["file"]), dtype=np.uint8)
        if raw.nbytes != entry["nbytes"]:
            raise CorruptionError(key, [-1])  # truncated file
        if not (verify_chunks and entry["nbytes"]):
            leaves[key] = tensor_from_bytes(raw, entry["dtype"], entry["shape"], dev)
            return
        flat = torch.from_numpy(raw).to(dev)
        chunks = entry["chunks"]
        got = fingerprint_ranges_on_device(
            flat, [(c["offset"], c["length"]) for c in chunks])
        bad = sorted(c["index"] for c, d in zip(chunks, got)
                     if c["digest"] is None or d.hexdigest() != c["digest"])
        if bad:
            raise CorruptionError(key, bad)
        whole = Digest.from_bytes(bytes.fromhex(entry["digest"]))
        if whole.length != entry["nbytes"]:
            raise CorruptionError(key, [-1])
        leaves[key] = flat.view(DTYPES[entry["dtype"]]).reshape(list(entry["shape"]))

    for item in manifest["leaves"].items():
        load_leaf(item)
        if keep is not None:
            leaves[item[0]] = keep(item[0], leaves[item[0]])
    return _unflatten(leaves), int(manifest["step"])


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------
class CheckpointManager:
    """Retention, latest-step discovery, and restore-or-init."""

    def __init__(self, root: str | os.PathLike, *, keep: int = 3, movers: int = 8,
                 device="cuda"):
        self.root = str(root)
        self.keep = keep
        self.movers = movers
        self.device = device
        os.makedirs(self.root, exist_ok=True)

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree: Any, **kw) -> SaveReport:
        kw.setdefault("device", self.device)
        rep = save_checkpoint(self.root, step, tree, movers=self.movers, **kw)
        self._gc()
        return rep

    def restore(self, step: int | None = None, **kw) -> tuple[dict, int]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        kw.setdefault("device", self.device)
        return restore_checkpoint(
            os.path.join(self.root, f"step_{step:08d}"), movers=self.movers, **kw
        )

    def restore_or_init(self, init_fn: Callable[[], Any]) -> tuple[Any, int]:
        if self.latest_step() is None:
            return init_fn(), 0
        tree, step = self.restore()
        return tree, step

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"), ignore_errors=True)
