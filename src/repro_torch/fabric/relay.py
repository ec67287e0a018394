"""Multi-hop store-and-forward relay transfers with per-hop chunk custody.

A relay moves one payload along a fabric ``Route`` (origin -> intermediate
DTNs -> destination). The chunk plan is computed ONCE and shared by every
hop, so a chunk is the unit of *custody*: hop ``h`` journals chunk ``c`` the
moment it has landed (and been read-back verified) at stage ``h+1``, in a
per-hop ``core.journal.ChunkJournal``. That gives the fabric the paper's
partial-restart guarantee at every hop:

  * a chunk that reached an intermediate DTN is NEVER re-pulled from the
    origin after a crash — the restarted relay replays each hop's journal
    and resumes exactly the chunks still missing at that hop;
  * hops are pipelined chunk-wise: chunk ``c`` starts crossing hop ``h+1``
    as soon as hop ``h`` lands it, so relay makespan approaches the slowest
    hop, not the sum of hops;
  * integrity composes along the chain: each hop fingerprints what it read,
    verifies it against the upstream hop's journaled custody digest (staging
    bit-rot detection), write-verifies by destination read-back (in-flight
    corruption detection + re-fetch healing), and the final replica's
    merge-law digest must equal the origin digest.

Chaos hooks mirror the service: per-hop source/dest wrappers let
``repro_torch.faults`` campaigns corrupt, outage, stall, or kill each hop's data
path independently; ``realize_hop_campaigns`` maps the scenario DSL's fabric
faults (``link_outage_at_50pct``, ``degrade_hop``) onto seeded victim hops.

This is the port's copy of ``repro.fabric.relay``. Every digest a hop takes
— of the data it read, of its read-back, of each tuned granule — runs on
``RelayTransfer(device=...)`` (``"cuda"``, the default, raises in the
constructor where there is no card; ``"cpu"`` runs the kernels' plain
versions) through ``core.dataplane.fingerprint_on_device``; the reference
takes them on the host.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import random
import threading
from typing import Callable

from repro_torch.core.backoff import Backoff
from repro_torch.core.chunker import Chunk, ChunkPlan, plan_chunks
from repro_torch.core.dataplane import fingerprint_on_device, resolve_device
from repro_torch.core.integrity import (
    Digest,
    combine_at_offsets,
    merge_all,
    verify,
)
from repro_torch.core.journal import ChunkJournal, JournalRecord
from repro_torch.core.transfer import (
    ByteDest,
    ByteSource,
    EndpointOutage,
    FileDest,
    FileSource,
    IntegrityError,
    MoverCrash,
)
from repro_torch.faults.injectors import FaultCampaign, _seed_int
from repro_torch.faults.scenarios import Scenario
from repro_torch.fabric.topology import NoRouteError, Route
from repro_torch.obs.clock import mono_s
from repro_torch.obs.trace import NULL as _NULL_TRACER
from repro_torch.tune.controller import ChunkController
from repro_torch.tune.probe import ChunkSample


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class HopReport:
    """Per-hop outcome of one relay incarnation."""

    hop: int
    src: str
    dst: str
    moved_chunks: int = 0        # chunks this incarnation landed at this hop
    resumed_chunks: int = 0      # custody restored from the hop journal
    moved_bytes: int = 0         # custody bytes moved by this incarnation
    retries: int = 0
    refetches: int = 0           # corrupt landings healed by hop-local re-read
    outage_retries: int = 0
    mover_deaths: int = 0
    # per-hop autotuning: the transfer granule this hop settled on (chunks
    # stay the custody unit; a degraded hop only shrinks its own I/O units)
    granule_bytes: int = 0
    granule_replans: int = 0


@dataclasses.dataclass
class RelayReport:
    route: Route
    total_bytes: int
    n_chunks: int
    hops: list[HopReport]
    seconds: float
    file_digest: Digest          # merge-law combine of the final hop's custody
    # -- resilience: route failovers this incarnation performed
    retired_hops: list[HopReport] = dataclasses.field(default_factory=list)
    failovers: int = 0
    re_moved_journaled: int = 0  # invariant: stays 0 (custody handoff works)
    failover_events: list[dict] = dataclasses.field(default_factory=list)

    @property
    def wire_bytes(self) -> int:
        """Custody bytes moved across all hops by THIS incarnation."""
        return sum(h.moved_bytes for h in self.hops + self.retired_hops)

    @property
    def resumed_chunks(self) -> int:
        return sum(h.resumed_chunks for h in self.hops)

    @property
    def mover_deaths(self) -> int:
        return sum(h.mover_deaths for h in self.hops + self.retired_hops)

    @property
    def refetches(self) -> int:
        return sum(h.refetches for h in self.hops + self.retired_hops)


# ---------------------------------------------------------------------------
# relay engine
# ---------------------------------------------------------------------------
class _Hop:
    """Mutable per-hop execution state."""

    __slots__ = ("idx", "u", "v", "source", "dest", "journal", "ready",
                 "done", "digests", "report", "workers", "granule",
                 "controller", "dead", "inflight", "upstream")

    def __init__(self, idx: int, u: str, v: str, source: ByteSource,
                 dest: ByteDest, journal: ChunkJournal,
                 upstream: "_Hop | None" = None):
        self.idx, self.u, self.v = idx, u, v
        self.source, self.dest, self.journal = source, dest, journal
        self.ready: "queue.Queue[Chunk | None]" = queue.Queue()
        self.done: set[int] = set(journal.records)
        self.digests: dict[int, Digest] = {
            i: rec.digest() for i, rec in journal.records.items()
        }
        self.report = HopReport(idx, u, v, resumed_chunks=len(self.done))
        self.workers = 0
        self.granule = 0                  # 0 = whole-chunk moves (untuned)
        self.controller: ChunkController | None = None
        self.dead = False                 # retired by a route failover
        self.inflight: set[int] = set()   # chunks claimed by a mover
        self.upstream = upstream          # None = reads the origin source


class _FailoverSignal(Exception):
    """Internal: a hop wants the remaining route re-planned around its
    sick link (never escapes ``RelayTransfer``)."""


class RelayTransfer:
    """Executes one route-pipelined, custody-journaled relay transfer.

    ``workdir`` holds the per-hop journals and intermediate staging files;
    re-running with the same workdir resumes: every hop skips its journaled
    chunks, so a crash costs only the chunks in flight at crash time — at
    the hop they were crossing, never upstream.
    """

    def __init__(
        self,
        route: Route,
        source: ByteSource,
        dest: ByteDest,
        *,
        workdir: str | os.PathLike,
        chunk_bytes: int | None = None,
        plan: ChunkPlan | None = None,
        movers: int = 4,
        integrity: bool = True,
        max_retries: int = 3,
        max_refetches: int = 3,
        outage_retries: int = 64,
        outage_backoff_s: float = 0.002,
        max_mover_deaths: int = 16,
        retry_backoff_s: float = 0.002,
        source_wrapper: Callable[[int, ByteSource], ByteSource] | None = None,
        dest_wrapper: Callable[[int, ByteDest], ByteDest] | None = None,
        fault_injector: Callable[[int, Chunk, int], None] | None = None,
        tuning: bool = False,              # per-hop transfer-granule control
        granule_min: int = 64 * 1024,
        tune_epoch_chunks: int = 3,
        tune_hops: "set[int] | frozenset[int] | None" = None,  # None = all hops
        tracer=None,                       # obs.trace.Tracer; spans carry hop=
        task: str = "",
        backoff_seed: int = 0,             # de-correlates mover retry instants
        planner=None,                      # fabric.topology.RoutePlanner
        failover: bool = False,            # re-plan around dead links mid-flight
        failover_outage_threshold: int = 8,
        health=None,                       # resil.health.HealthTracker (shared)
        link_source_wrapper: Callable[[str, str, ByteSource], ByteSource] | None = None,
        link_dest_wrapper: Callable[[str, str, ByteDest], ByteDest] | None = None,
        device="cuda",                     # where every hop digest runs
    ):
        # resolved once, here: a missing card fails before the workdir exists
        self.device = resolve_device(device)
        if movers < 1:
            raise ValueError("movers must be >= 1")
        if failover and planner is None:
            raise ValueError("failover requires a planner to re-plan routes")
        if failover_outage_threshold < 1:
            raise ValueError("failover_outage_threshold must be >= 1")
        self.tracer = tracer if tracer is not None else _NULL_TRACER
        self.task = task or f"relay:{'-'.join(route.nodes)}"
        self.route = route
        self.workdir = str(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        self.total_bytes = source.nbytes
        self.plan = plan or plan_chunks(
            self.total_bytes, movers, chunk_bytes=chunk_bytes,
            min_chunk=1, max_chunk=1 << 62, alignment=1,
        )
        if self.plan.total_bytes != self.total_bytes:
            raise ValueError("chunk plan does not cover the source")
        self.movers = movers
        self.integrity = integrity
        self.max_retries = max_retries
        self.max_refetches = max_refetches
        self.outage_retries = outage_retries
        self.outage_backoff_s = outage_backoff_s
        self.max_mover_deaths = max_mover_deaths
        self.retry_backoff_s = retry_backoff_s
        self.backoff_seed = backoff_seed
        self._fault_injector = fault_injector
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._errors: list[BaseException] = []
        self._mover_deaths = 0
        self._threads: list[threading.Thread] = []

        # ---- resilience plane state
        self.planner = planner
        self.failover = failover
        self.failover_outage_threshold = failover_outage_threshold
        self.health = health
        self.failover_events: list[dict] = []
        self._fo_gen = 0
        self._re_moved = 0
        self._retired: list[_Hop] = []
        self._banned_links: set[tuple[str, str]] = set()
        self._banned_nodes: set[str] = set()
        # per-NODE custody: every chunk journaled as landed at that node.
        # Failover pre-populates replacement hops from this map, which is
        # what makes "re-move zero journaled chunks" structural rather than
        # best-effort.
        self._custody: dict[str, dict[int, Digest]] = {}

        # ---- per-hop endpoints: origin -> staging files -> final dest
        self._wrap_s = source_wrapper or (lambda _h, s: s)
        self._wrap_d = dest_wrapper or (lambda _h, d: d)
        self._link_wrap_s = link_source_wrapper
        self._link_wrap_d = link_dest_wrapper
        self._orig_source = source
        self._orig_dest = dest
        self._origin_node = route.nodes[0]
        self._final_node = route.nodes[-1]
        self.hops: list[_Hop] = []
        for h, (u, v) in enumerate(route.hops):
            self.hops.append(self._make_hop(
                h, u, v, self._journal_path(h, u, v),
                self.hops[h - 1] if h > 0 else None))
        for hop in self.hops:
            if hop.digests:
                self._custody.setdefault(hop.v, {}).update(hop.digests)
        # per-hop granule controllers: each hop adapts its own I/O unit
        # within [granule_min, chunk_bytes] — custody chunks are untouched,
        # so a degraded middle hop shrinks its own granule without forcing
        # the rest of the path (or the journals) to change
        nominal = self.plan.chunk_bytes
        if tuning and nominal > 0:
            lo = min(granule_min, nominal)
            for hop in self.hops:
                if tune_hops is not None and hop.idx not in tune_hops:
                    continue       # operator scoped tuning to specific hops
                hop.granule = nominal
                # noise-hardened thresholds: hop rates are wall-clock local
                # measurements, so only a halving reads as degradation and
                # probes need a 25% win to stick
                hop.controller = ChunkController(
                    chunk_bytes=nominal, min_chunk=lo, max_chunk=nominal,
                    epoch_chunks=tune_epoch_chunks,
                    degrade_threshold=0.5, hysteresis=0.25,
                    fast_md_streak=3,
                )
                hop.report.granule_bytes = nominal

    # -- paths ---------------------------------------------------------------
    def _stage(self, node: str) -> str:
        path = os.path.join(self.workdir, f"stage-{node}.bin")
        if not os.path.exists(path):
            # staging area preallocation (FileDest keeps a partial file, so a
            # crashed relay's journaled chunks stay on the intermediate DTN)
            with open(path, "wb") as fh:
                if self.total_bytes:
                    fh.truncate(self.total_bytes)
        return path

    def _journal_path(self, h: int, u: str, v: str) -> str:
        return os.path.join(self.workdir, f"hop{h:02d}-{u}--{v}.journal")

    @staticmethod
    def journal_paths(workdir: str | os.PathLike, route: Route) -> list[str]:
        """The custody journal path of every hop (for probes/tests)."""
        return [
            os.path.join(str(workdir), f"hop{h:02d}-{u}--{v}.journal")
            for h, (u, v) in enumerate(route.hops)
        ]

    # -- hop construction (shared by __init__ and failover re-plans) ---------
    def _make_hop(self, idx: int, u: str, v: str, journal_path: str,
                  upstream: "_Hop | None") -> _Hop:
        hop_src: ByteSource = (
            self._orig_source if u == self._origin_node
            else FileSource(self._stage(u)))
        hop_dst: ByteDest = (
            self._orig_dest if v == self._final_node
            else FileDest(self._stage(v), self.total_bytes))
        # node-keyed wrappers survive failover (a fault lives at an endpoint
        # or link, not at a position in whatever route happens to cross it)
        if self._link_wrap_s is not None:
            hop_src = self._link_wrap_s(u, v, hop_src)
        else:
            hop_src = self._wrap_s(idx, hop_src)
        if self._link_wrap_d is not None:
            hop_dst = self._link_wrap_d(u, v, hop_dst)
        else:
            hop_dst = self._wrap_d(idx, hop_dst)
        return _Hop(idx, u, v, hop_src, hop_dst,
                    ChunkJournal(journal_path), upstream)

    # -- worker wakeups (lock held by caller) --------------------------------
    def _wake_hop_locked(self, hop: _Hop) -> None:
        for _ in range(max(1, hop.workers)):
            hop.ready.put(None)

    def _wake_all_locked(self) -> None:
        for hop in self.hops:
            self._wake_hop_locked(hop)

    def _fail_locked(self, e: BaseException) -> None:
        self._errors.append(e)
        self._wake_all_locked()
        self._cond.notify_all()

    def _spawn_workers_locked(self, hop: _Hop) -> None:
        for m in range(self.movers):
            th = threading.Thread(
                target=self._worker, args=(hop,),
                name=f"relay-h{hop.idx}g{self._fo_gen}-m{m}", daemon=True,
            )
            hop.workers += 1
            th.start()
            self._threads.append(th)

    # -- execution -----------------------------------------------------------
    def run(self) -> RelayReport:
        t0 = mono_s()
        n = self.plan.n_chunks
        try:
            # seed each hop's ready queue: upstream custody present, own absent
            with self._lock:
                for hop in self.hops:
                    upstream = (
                        set(range(n)) if hop.upstream is None
                        else hop.upstream.done
                    )
                    for c in self.plan.chunks:
                        if c.index in upstream and c.index not in hop.done:
                            hop.ready.put(c)
                for hop in self.hops:
                    self._spawn_workers_locked(hop)
            with self._cond:
                while not self._finished_locked() and not self._errors:
                    self._cond.wait(0.05)
                self._wake_all_locked()
            # failover spawns replacement workers mid-run: join until the
            # thread list is quiescent, not just the initial snapshot
            while True:
                with self._lock:
                    threads = list(self._threads)
                for th in threads:
                    th.join()
                with self._lock:
                    if len(self._threads) == len(threads):
                        break
            if self._errors:
                raise self._errors[0]
            last = self.hops[-1]
            parts = [(self.plan.chunks[i].offset, d) for i, d in last.digests.items()]
            file_digest = combine_at_offsets(parts, self.total_bytes)
            origin = self.hops[0]
            origin_digest = combine_at_offsets(
                [(self.plan.chunks[i].offset, d) for i, d in origin.digests.items()],
                self.total_bytes,
            )
            if not verify(origin_digest, file_digest):
                raise IntegrityError(
                    f"relay end-to-end digest mismatch along {self.route.nodes}: "
                    f"origin {origin_digest.hexdigest()} != replica "
                    f"{file_digest.hexdigest()}"
                )
            return RelayReport(
                route=self.route, total_bytes=self.total_bytes, n_chunks=n,
                hops=[h.report for h in self.hops],
                seconds=mono_s() - t0, file_digest=file_digest,
                retired_hops=[h.report for h in self._retired],
                failovers=self._fo_gen,
                re_moved_journaled=self._re_moved,
                failover_events=list(self.failover_events),
            )
        finally:
            for hop in self.hops + self._retired:
                hop.journal.close()
            # root span covers the relay makespan even on a faulted exit, so
            # post-mortem attribution still sees the full window
            self.tracer.add(
                "relay", "task", t0, mono_s(), task=self.task,
                route="-".join(self.route.nodes), bytes=self.total_bytes,
                hops=self.route.n_hops,
            )

    def _finished_locked(self) -> bool:
        n = self.plan.n_chunks
        return all(len(h.done) >= n for h in self.hops)

    def _worker(self, hop: _Hop) -> None:
        try:
            while True:
                with self._lock:
                    if (self._errors or hop.dead
                            or len(hop.done) >= self.plan.n_chunks):
                        return
                # blocking get: the queue carries chunks and None sentinels
                # (error, hop completion, failover retirement) — no spin
                chunk = hop.ready.get()
                if chunk is None:
                    continue             # wakeup: re-check the exit conditions
                with self._lock:
                    if (hop.dead or chunk.index in hop.done
                            or chunk.index in hop.inflight):
                        continue
                    hop.inflight.add(chunk.index)
                try:
                    digest = self._move_chunk(hop, chunk)
                except _FailoverSignal:
                    with self._lock:
                        hop.inflight.discard(chunk.index)
                    self._failover(hop)
                    continue             # loop top sees hop.dead and exits
                except MoverCrash:
                    # the mover dies mid-write; the chunk survives it. The
                    # pool respawns in place (this thread carries on as the
                    # replacement) unless the relay-wide death budget is out.
                    with self._lock:
                        hop.inflight.discard(chunk.index)
                        self._mover_deaths += 1
                        hop.report.mover_deaths += 1
                        if self._mover_deaths > self.max_mover_deaths:
                            self._fail_locked(RuntimeError(
                                f"relay mover-death budget exhausted "
                                f"({self._mover_deaths} > {self.max_mover_deaths})"
                            ))
                            return
                    hop.ready.put(chunk)
                    continue
                except BaseException as e:  # noqa: BLE001 — fatal for the relay
                    with self._lock:
                        hop.inflight.discard(chunk.index)
                        if hop.dead:
                            continue     # retired mid-move: its faults are moot
                        self._fail_locked(e)
                    return
                with self._lock:
                    if hop.dead:         # retired while the move was in flight
                        hop.inflight.discard(chunk.index)
                        continue
                try:
                    t_j = mono_s()
                    hop.journal.append(JournalRecord(
                        chunk.index, chunk.offset, chunk.length, digest.hexdigest()
                    ))
                    self.tracer.add(
                        "custody_commit", "journal", t_j, mono_s(),
                        task=self.task, lane=f"hop{hop.idx}:journal",
                        offset=chunk.offset, index=chunk.index, hop=hop.idx,
                    )
                except Exception as e:  # noqa: BLE001 — dead journal: fail fast
                    with self._lock:
                        self._fail_locked(RuntimeError(
                            f"hop {hop.idx} journal append failed for chunk "
                            f"{chunk.index}: {e}"
                        ))
                    return
                nxt = None
                with self._lock:
                    hop.inflight.discard(chunk.index)
                    if hop.dead:
                        # retired while journaling: the replacement path was
                        # seeded without this landing, so it owns the chunk
                        # now — a dead hop's landing must not count as
                        # custody (or the replacement's move would read as a
                        # re-move of a journaled chunk)
                        continue
                    if chunk.index in self._custody.get(hop.v, ()):
                        # a journaled chunk crossed the wire again — the
                        # custody-handoff invariant the failover gate checks
                        self._re_moved += 1
                    self._custody.setdefault(hop.v, {})[chunk.index] = digest
                    hop.done.add(chunk.index)
                    hop.digests[chunk.index] = digest
                    hop.report.moved_chunks += 1
                    hop.report.moved_bytes += chunk.length
                    if len(hop.done) >= self.plan.n_chunks:
                        self._wake_hop_locked(hop)
                    if self._finished_locked():
                        self._cond.notify_all()
                    # hand custody downstream (store-and-forward pipelining);
                    # the CURRENT next hop — failover may have replaced it
                    if hop.idx + 1 < len(self.hops):
                        cand = self.hops[hop.idx + 1]
                        if chunk.index not in cand.done:
                            nxt = cand
                if nxt is not None:
                    nxt.ready.put(chunk)
        finally:
            with self._cond:
                hop.workers -= 1
                self._cond.notify_all()

    def _move_chunk(self, hop: _Hop, chunk: Chunk) -> Digest:
        """One chunk across one hop, with per-failure-class recovery budgets
        (the same taxonomy as the engine/service):

        * digest mismatch -> hop-local re-fetch (the staged upstream copy is
          intact, vouched for by the upstream custody digest), up to
          ``max_refetches``;
        * endpoint outage -> wait out the window on its own larger budget;
        * mover crash -> propagates; the worker re-queues the chunk;
        * anything else -> bounded in-place retries with backoff.
        """
        attempts = generic = refetches = outages = 0
        signal_s = 0.0   # fault-excluded work time: generic retries count
        # (congestion), corruption re-fetches and outage waits do not
        lane = f"hop{hop.idx}:{threading.current_thread().name}"
        while True:
            attempts += 1
            t_att = mono_s()
            try:
                if self._fault_injector is not None:
                    self._fault_injector(hop.idx, chunk, attempts)
                with self._lock:
                    granule = hop.granule
                if granule <= 0 or granule >= chunk.length:
                    # whole-chunk move (the untuned path, byte-identical)
                    data = hop.source.read(chunk.offset, chunk.length)
                    if len(data) != chunk.length:
                        raise IOError(
                            f"short read at {chunk.offset}: {len(data)}/{chunk.length}")
                    digest = fingerprint_on_device(data, self.device)
                    if hop.upstream is not None:
                        upstream = hop.upstream.digests.get(chunk.index)
                        if upstream is not None and not verify(upstream, digest):
                            raise IntegrityError(
                                f"hop {hop.idx} staging read of chunk {chunk.index} "
                                f"does not match upstream custody digest"
                            )
                    hop.dest.write(chunk.offset, data)
                    if self.integrity:
                        back = hop.dest.read_back(chunk.offset, chunk.length)
                        if not verify(digest,
                                      fingerprint_on_device(back, self.device)):
                            raise IntegrityError(
                                f"hop {hop.idx} read-back digest mismatch "
                                f"({hop.u}->{hop.v} @ {chunk.offset})"
                            )
                else:
                    # granular move: the custody chunk crosses this hop in
                    # sub-moves of the hop's tuned granule. Sub-digests fold
                    # into the chunk digest by the merge law, so custody
                    # verification is unchanged — the granule is purely this
                    # hop's I/O unit, invisible to its neighbours. Generic
                    # I/O failures retry the GRANULE in place (that is the
                    # point of shrinking it on a lossy hop: a lost granule
                    # costs one granule, not the whole chunk); corruption,
                    # outages and mover crashes keep chunk-level semantics.
                    parts: list[Digest] = []
                    pos = chunk.offset
                    while pos < chunk.end:
                        take = min(granule, chunk.end - pos)
                        sub_generic = 0
                        while True:
                            try:
                                data = hop.source.read(pos, take)
                                if len(data) != take:
                                    raise IOError(
                                        f"short read at {pos}: {len(data)}/{take}")
                                break
                            except (MoverCrash, EndpointOutage, IntegrityError):
                                raise
                            except Exception:
                                sub_generic += 1
                                if sub_generic > self.max_retries:
                                    raise
                                with self._lock:
                                    hop.report.retries += 1
                                Backoff(self.retry_backoff_s,
                                        seed=self.backoff_seed,
                                        lane=f"{lane}:g{pos}",
                                        ).sleep(sub_generic)
                        hop.dest.write(pos, data)
                        if self.integrity:
                            # batched digest path: the granule and its
                            # read-back are fingerprinted in ONE device
                            # launch (equal tile-aligned lengths stack) —
                            # the small-granule regime a degraded hop
                            # shrinks into is exactly where per-call
                            # overhead bites
                            back = hop.dest.read_back(pos, take)
                            if len(back) != take:
                                # diagnose the short read-back HERE: fed to
                                # the batched digest it would surface as a
                                # baffling length-mismatch (or worse, a
                                # digest mismatch) far from the cause
                                raise IOError(
                                    f"hop {hop.idx} short read-back at {pos}: "
                                    f"{len(back)}/{take} bytes"
                                )
                            d, d_back = fingerprint_on_device(
                                [data, back], self.device)
                            if not verify(d, d_back):
                                raise IntegrityError(
                                    f"hop {hop.idx} read-back digest mismatch "
                                    f"({hop.u}->{hop.v} @ {pos})"
                                )
                        else:
                            d = fingerprint_on_device(data, self.device)
                        parts.append(d)
                        pos += take
                    digest = merge_all(parts)
                    if hop.upstream is not None:
                        upstream = hop.upstream.digests.get(chunk.index)
                        if upstream is not None and not verify(upstream, digest):
                            raise IntegrityError(
                                f"hop {hop.idx} staging read of chunk {chunk.index} "
                                f"does not match upstream custody digest"
                            )
                now = mono_s()
                # custody span: this chunk crossing this hop (the attempt
                # that landed it) — checksum work is inline with the move on
                # a relay hop, so the whole attempt is wire custody time
                self.tracer.add(
                    "hop_move", "wire", t_att, now, task=self.task, lane=lane,
                    offset=chunk.offset, index=chunk.index, hop=hop.idx,
                    attempt=attempts,
                )
                if hop.controller is not None:
                    self._observe_hop(
                        hop, chunk, signal_s + (now - t_att),
                        attempts, refetches)
                self._note_health(hop, ok=True)
                return digest
            except MoverCrash:
                raise
            except IntegrityError:
                refetches += 1
                self.tracer.add(
                    "refetch", "stall", t_att, mono_s(), task=self.task,
                    lane=lane, offset=chunk.offset, hop=hop.idx, kind="corruption",
                )
                with self._lock:
                    hop.report.retries += 1
                    hop.report.refetches += 1
                if refetches > self.max_refetches:
                    raise
            except EndpointOutage:
                outages += 1
                with self._lock:
                    hop.report.outage_retries += 1
                self._note_health(hop, ok=False)
                if self._should_failover(hop, outages):
                    self.tracer.add(
                        "outage_wait", "stall", t_att, mono_s(), task=self.task,
                        lane=lane, offset=chunk.offset, hop=hop.idx, kind="outage",
                    )
                    raise _FailoverSignal()
                if outages > self.outage_retries:
                    self.tracer.add(
                        "outage_wait", "stall", t_att, mono_s(), task=self.task,
                        lane=lane, offset=chunk.offset, hop=hop.idx, kind="outage",
                    )
                    raise
                Backoff(self.outage_backoff_s, mode="linear",
                        seed=self.backoff_seed,
                        lane=f"{lane}:c{chunk.index}").sleep(outages)
                # stall span covers the rejected attempt AND the backoff wait
                self.tracer.add(
                    "outage_wait", "stall", t_att, mono_s(), task=self.task,
                    lane=lane, offset=chunk.offset, hop=hop.idx, kind="outage",
                )
            except Exception:
                generic += 1
                signal_s += mono_s() - t_att   # congestion-like
                self.tracer.add(
                    "move_retry", "wire", t_att, mono_s(), task=self.task,
                    lane=lane, offset=chunk.offset, hop=hop.idx, kind="generic",
                )
                if generic > self.max_retries:
                    raise
                with self._lock:
                    hop.report.retries += 1
                Backoff(self.retry_backoff_s, seed=self.backoff_seed,
                        lane=f"{lane}:c{chunk.index}").sleep(generic)


    # -- resilience plane ----------------------------------------------------
    def _note_health(self, hop: _Hop, ok: bool) -> None:
        """Feed the shared tracker: a hop verdict scores its link AND the
        endpoint it was writing toward."""
        if self.health is None:
            return
        self.health.record(f"link:{hop.u}->{hop.v}", ok)
        self.health.record(f"ep:{hop.v}", ok)

    def _should_failover(self, hop: _Hop, outages: int) -> bool:
        if not self.failover or self.planner is None or hop.dead:
            return False
        if outages >= self.failover_outage_threshold:
            return True
        h = self.health
        return h is not None and (
            not h.healthy(f"ep:{hop.v}")
            or not h.healthy(f"link:{hop.u}->{hop.v}"))

    def _failover(self, sick: _Hop) -> None:
        """Re-plan the remaining path around the sick hop's link and hand
        custody forward.

        The sick link's tail node ``u`` is the last healthy custody holder
        on the dead segment, so it becomes the new source; every replacement
        hop is pre-populated with the chunks its own node already journaled
        (including the final destination's), so a failover re-moves ZERO
        journaled chunks — only custody that died with the banned node
        crosses a wire again. The live upstream pipeline keeps feeding ``u``
        untouched; upstream nodes are excluded from the re-plan so the new
        path cannot loop back through it.
        """
        t0 = mono_s()
        with self._lock:
            if sick.dead or self._errors:
                return                       # someone already handled it
            if len(sick.done) >= self.plan.n_chunks:
                return                       # raced with its own completion
            gen = self._fo_gen = self._fo_gen + 1
            u, v = sick.u, sick.v
            self._banned_links.add((u, v))
            if v != self._final_node:
                self._banned_nodes.add(v)
            base = sick.idx
            plan_banned_nodes = set(self._banned_nodes)
            for h in self.hops[:base]:       # no looping back through the
                plan_banned_nodes.add(h.u)   # live upstream pipeline
                plan_banned_nodes.add(h.v)
            plan_banned_nodes.discard(u)
            try:
                route = self.planner.shortest_from_set(
                    [u], self._final_node, self.total_bytes,
                    banned_links=frozenset(self._banned_links),
                    banned_nodes=frozenset(plan_banned_nodes),
                )
            except NoRouteError as e:
                self._fail_locked(RuntimeError(
                    f"failover {gen}: no surviving route {u} -> "
                    f"{self._final_node} (banned links "
                    f"{sorted(self._banned_links)}, nodes "
                    f"{sorted(self._banned_nodes)}): {e}"))
                return
            # retire the dead tail: the sick hop and everything past it
            for hop in self.hops[base:]:
                hop.dead = True
                self._retired.append(hop)
                self._wake_hop_locked(hop)
            new_hops: list[_Hop] = []
            for j, (a, b) in enumerate(route.hops):
                jp = os.path.join(
                    self.workdir,
                    f"fo{gen:02d}-hop{base + j:02d}-{a}--{b}.journal")
                upstream = (new_hops[-1] if new_hops
                            else (self.hops[base - 1] if base > 0 else None))
                hop = self._make_hop(base + j, a, b, jp, upstream)
                # custody handoff: chunks already journaled at this node
                # survived the failure — restore them, never re-move them
                for idx, digest in self._custody.get(b, {}).items():
                    if idx in hop.done:
                        continue
                    c = self.plan.chunks[idx]
                    hop.journal.append(JournalRecord(
                        idx, c.offset, c.length, digest.hexdigest()))
                    hop.done.add(idx)
                    hop.digests[idx] = digest
                    hop.report.resumed_chunks += 1
                new_hops.append(hop)
            self.hops = self.hops[:base] + new_hops
            # seed replacement hops with upstream custody they still miss,
            # then staff them — the relay carries on without a restart
            for hop in new_hops:
                upstream_done = (
                    set(range(self.plan.n_chunks)) if hop.upstream is None
                    else hop.upstream.done)
                for c in self.plan.chunks:
                    if c.index in upstream_done and c.index not in hop.done:
                        hop.ready.put(c)
                self._spawn_workers_locked(hop)
            self.failover_events.append({
                "gen": gen,
                "sick_link": (u, v),
                "banned_nodes": sorted(self._banned_nodes),
                "new_path": list(route.nodes),
                "resumed_chunks": sum(
                    h.report.resumed_chunks for h in new_hops),
            })
            self._cond.notify_all()
        self.tracer.add(
            "failover", "failover", t0, mono_s(), task=self.task,
            lane=f"fo{gen}", hop=sick.idx, sick=f"{u}->{v}",
            path="-".join(route.nodes),
        )

    def _observe_hop(self, hop: _Hop, chunk: Chunk, attempt_seconds: float,
                     attempts: int, refetches: int) -> None:
        """Feed one landed chunk's telemetry to the hop's granule controller
        (the per-hop closed loop; other hops never see this decision)."""
        with self._lock:
            new = hop.controller.observe(ChunkSample(
                offset=chunk.offset, length=chunk.length,
                seconds=attempt_seconds, attempt_seconds=attempt_seconds,
                attempts=attempts, refetches=refetches, mover=hop.idx,
            ))
            if new is not None and new != hop.granule:
                hop.granule = new
                hop.report.granule_replans += 1
                hop.report.granule_bytes = new


def run_relay(
    route: Route,
    source: ByteSource,
    dest: ByteDest,
    *,
    workdir: str | os.PathLike,
    **kw,
) -> RelayReport:
    """One-shot helper mirroring ``core.transfer.transfer_verified``."""
    return RelayTransfer(route, source, dest, workdir=workdir, **kw).run()


# ---------------------------------------------------------------------------
# scenario DSL -> per-hop fault campaigns
# ---------------------------------------------------------------------------
def realize_hop_campaigns(
    scenario: Scenario,
    route: Route,
    *,
    total_bytes: int,
    seed: int = 0,
    movers: int = 4,
) -> tuple[dict[int, FaultCampaign], dict[str, int]]:
    """Bind a (possibly fabric-flavoured) Scenario to a relay route.

    Returns ``(campaigns, victims)``: one ``FaultCampaign`` per hop index,
    plus the seeded victim assignment. Mapping of the scenario DSL onto the
    multi-hop shape:

    * base faults (``bytes_per_error`` corruption) strike EVERY hop's write
      path — any WAN link can flip bits; base endpoint outages and mover
      kills strike hop 0 (the origin pull, matching single-pipe semantics);
    * ``link_outage_at_*`` picks one seeded victim hop whose endpoints
      reject the next ``link_outage_ops`` operations once that hop has moved
      ``link_outage_at_frac`` of its bytes;
    * ``degrade_hop`` picks ``degrade_hops`` seeded victim *intermediate*
      hops (the last hop when the route has no intermediates) whose writes
      all stall — persistently slow DTNs rather than dead ones.
    """
    rng = random.Random(_seed_int(seed, "fabric", route.nodes, scenario.name))
    n_hops = route.n_hops
    victims: dict = {}
    if scenario.link_outage_at_frac is not None:
        victims["link_outage"] = rng.randrange(n_hops)
    if scenario.degrade_hops > 0:
        inner = list(range(1, n_hops)) or [n_hops - 1]
        count = min(scenario.degrade_hops, len(inner))
        victims["degrade"] = tuple(sorted(rng.sample(inner, count)))
    # resilience-plane faults pick one seeded victim hop each (drawn after
    # the legacy victims so old scenarios keep their exact realisations)
    if scenario.down_at_frac is not None:
        victims["down"] = rng.randrange(n_hops)
    if scenario.link_flaps > 0:
        victims["flap"] = rng.randrange(n_hops)
    if scenario.brownout_events > 0:
        victims["brownout"] = rng.randrange(n_hops)

    campaigns: dict[int, FaultCampaign] = {}
    for h in range(n_hops):
        per_hop = Scenario(
            name=f"{scenario.name}@hop{h}",
            bytes_per_error=scenario.bytes_per_error,
            kill_movers=scenario.kill_movers if h == 0 else 0,
            kill_at_frac=scenario.kill_at_frac,
            outage_at_frac=scenario.outage_at_frac if h == 0 else None,
            outage_ops=scenario.outage_ops,
            stall_movers=scenario.stall_movers if h == 0 else 0,
            stall_s=scenario.stall_s,
        )
        if victims.get("link_outage") == h:
            per_hop = per_hop.replace(
                outage_at_frac=scenario.link_outage_at_frac,
                outage_ops=scenario.link_outage_ops,
            )
        if victims.get("down") == h:
            per_hop = per_hop.replace(down_at_frac=scenario.down_at_frac,
                                      down_ops=scenario.down_ops)
        if victims.get("flap") == h:
            per_hop = per_hop.replace(link_flaps=scenario.link_flaps,
                                      flap_ops=scenario.flap_ops)
        if victims.get("brownout") == h:
            per_hop = per_hop.replace(
                brownout_events=scenario.brownout_events)
        if h in victims.get("degrade", ()):
            # a degraded DTN stalls every write (bounded by the chunk count)
            per_hop = per_hop.replace(stall_movers=1 << 16, stall_s=0.001)
        campaigns[h] = FaultCampaign(
            per_hop, total_bytes=total_bytes, seed=_seed_int(seed, h), movers=movers,
        )
    return campaigns, victims
