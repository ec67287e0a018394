"""Background scrubber: re-verify landed regions, repair bit-rot from CAS.

Integrity checking so far ends at the landing: a chunk is read-back
verified, journaled, and never looked at again. Storage rots — the
Petascale DTN work found silent corruption *after* transfers had
"succeeded" — so the scrubber walks landed regions on a budgeted cadence,
re-fingerprints each against its journaled custody digest, and when a
region has rotted, repairs it in place from any verified replica the CAS
chunk index knows about. No donor means quarantine: the region is reported
(and the caller surfaces a FAULT event) rather than silently rewritten.

Budgeting: a pass reads at most ``budget_bytes`` (scrub I/O competes with
transfers for the same spindles); the cursor persists across passes so
successive budgeted passes cycle round-robin through the whole target set
instead of re-reading the head of the list forever.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Sequence

from repro_torch.core.dataplane import fingerprint_on_device, resolve_device
from repro_torch.core.integrity import Digest, verify
from repro_torch.obs import metrics as obsmetrics

_M_SCANNED = obsmetrics.REGISTRY.counter(
    "resil_scrub_scanned_total", "Regions re-verified by the scrubber", ())
_M_ROT = obsmetrics.REGISTRY.counter(
    "resil_scrub_rot_total", "Landed regions found rotted", ())
_M_REPAIRED = obsmetrics.REGISTRY.counter(
    "resil_scrub_repaired_total", "Rotted regions repaired from a replica", ())
_M_QUARANTINED = obsmetrics.REGISTRY.counter(
    "resil_scrub_quarantined_total", "Rotted regions with no healthy donor", ())


@dataclasses.dataclass(frozen=True)
class ScrubTarget:
    """One landed region and the custody digest it must still match."""

    path: str
    offset: int
    length: int
    digest_hex: str
    task_id: str = ""
    item: int = 0
    chunk: int = 0


@dataclasses.dataclass
class ScrubReport:
    """Outcome of one scrub pass."""

    scanned: int = 0
    scanned_bytes: int = 0
    clean: int = 0
    rot_detected: int = 0
    repaired: int = 0
    quarantined: int = 0
    remaining: int = 0           # targets the byte budget pushed to next pass
    quarantines: list[ScrubTarget] = dataclasses.field(default_factory=list)
    repairs: list[ScrubTarget] = dataclasses.field(default_factory=list)


class Scrubber:
    """Re-verifies landed regions and repairs rot via the CAS index.

    ``index`` is the donor directory: a rotted region's custody digest is
    looked up for other landed locations of the same content; each candidate
    is itself read-back verified (``verify_entry``) before its bytes are
    trusted, and a candidate that *is* the rotted region is skipped — the
    corpse cannot donate to itself. ``device`` is where landed regions are
    digested (``"cuda"``, the default, raises here where there is no card;
    ``"cpu"`` runs the kernels' plain versions) — the reference digests on
    the host.
    """

    def __init__(
        self,
        *,
        index=None,                                  # cas.index.ChunkIndex
        budget_bytes: int | None = None,             # per-pass read budget
        on_quarantine: Callable[[ScrubTarget], None] | None = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.index = index
        self.budget_bytes = budget_bytes
        self.on_quarantine = on_quarantine
        self._cursor = 0            # round-robin position across passes

    # -- verification --------------------------------------------------------
    @staticmethod
    def _read(target: ScrubTarget) -> bytes | None:
        try:
            with open(target.path, "rb") as fh:
                data = os.pread(fh.fileno(), target.length, target.offset)
        except OSError:
            return None
        return data if len(data) == target.length else None

    def _matches(self, target: ScrubTarget, data: bytes) -> bool:
        expected = Digest.from_bytes(bytes.fromhex(target.digest_hex))
        return verify(expected, fingerprint_on_device(data, self.device))

    def _donor_bytes(self, target: ScrubTarget) -> bytes | None:
        if self.index is None:
            return None
        for entry in self.index.lookup(target.digest_hex, target.length):
            if (os.path.abspath(entry.path) == os.path.abspath(target.path)
                    and entry.offset == target.offset):
                continue            # that IS the rotted region
            data = self.index.verify_entry(entry)
            if data is not None:
                return data
        return None

    def _repair(self, target: ScrubTarget, data: bytes) -> bool:
        with open(target.path, "r+b") as fh:
            os.pwrite(fh.fileno(), data, target.offset)
        back = self._read(target)
        return back is not None and self._matches(target, back)

    # -- the pass ------------------------------------------------------------
    def scrub(self, targets: Sequence[ScrubTarget], *,
              repair: bool = True) -> ScrubReport:
        """One budgeted pass over ``targets`` starting at the rolling cursor.

        The target list is the caller's truth (typically rebuilt from task
        journals each pass); the cursor only remembers *where* in it the
        last pass stopped, so a stable list scans round-robin.
        """
        report = ScrubReport()
        n = len(targets)
        if n == 0:
            return report
        start = self._cursor % n
        budget = self.budget_bytes
        for k in range(n):
            target = targets[(start + k) % n]
            if budget is not None and report.scanned_bytes + target.length > budget \
                    and report.scanned > 0:
                report.remaining = n - k
                self._cursor = (start + k) % n
                return report
            report.scanned += 1
            report.scanned_bytes += target.length
            _M_SCANNED.inc(1)
            data = self._read(target)
            if data is not None and self._matches(target, data):
                report.clean += 1
                continue
            report.rot_detected += 1
            _M_ROT.inc(1)
            donor = self._donor_bytes(target) if repair else None
            if donor is not None and self._repair(target, donor):
                report.repaired += 1
                report.repairs.append(target)
                _M_REPAIRED.inc(1)
            else:
                report.quarantined += 1
                report.quarantines.append(target)
                _M_QUARANTINED.inc(1)
                if self.on_quarantine is not None:
                    self.on_quarantine(target)
        self._cursor = start        # full cycle: next pass starts where this did
        return report
