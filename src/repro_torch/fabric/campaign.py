"""Fan-out 1 -> N replication campaigns over the fabric.

The climate-replication case study (7.3 PB to multiple sites) is the shape
this module executes: one dataset, many destinations, heterogeneous links.
Two pieces:

  * ``build_distribution_tree`` — grows a Steiner-ish distribution tree over
    the topology with cheapest-attachment: each destination is grafted onto
    the existing tree at its cheapest attachment point (multi-source
    Dijkstra, tree nodes are free sources), so shared first hops are paid
    for ONCE. Every chunk crosses a shared trunk link exactly once and
    branches at the split point — that is the wire-byte win over naive
    per-destination transfers, which pay the trunk N times.

  * ``CampaignRunner`` — executes a campaign against a REAL
    ``TransferService`` by decomposing the tree into one service task per
    tree edge, submitted event-driven as custody becomes available at each
    node (an edge's task is submitted the moment its parent edge SUCCEEDED).
    Because edges are ordinary service tasks, tenant quotas, mover
    allocation, the event stream, pause/resume/cancel and crash recovery
    all apply unchanged. Integrity is verified at every replica with the
    merge-law digests: each edge task's item digest (the commutative combine
    of its chunk fingerprints) must equal its parent edge's — the chain
    anchors at the origin read, so a matching leaf digest proves the replica
    is byte-identical to the origin without re-hashing anything.

Virtual-time execution of the same trees lives in ``fabric.virtual``.

This is the port's copy of ``repro.fabric.campaign``. A ``CampaignRunner``
takes its device from the ``TransferService`` it drives: the local verify
of an edge satisfied from a replica's chunk index digests the source and
the landing there (``core.dataplane.fingerprint_on_device``); the reference
digests them on the host.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Sequence

from repro_torch.cas import ChunkIndex
from repro_torch.core.dataplane import fingerprint_on_device
from repro_torch.core.integrity import combine_at_offsets, verify
from repro_torch.fabric.topology import NoRouteError, RoutePlanner, Topology
from repro_torch.obs.clock import mono_s
from repro_torch.service import events as ev
from repro_torch.service import task as tk
from repro_torch.service.service import TransferService
from repro_torch.service.task import TaskStatus, TransferItem

# edge_states value for a tree edge satisfied from the replica's chunk index
# (no service task was submitted; custody came from verified local bytes)
DEDUPED = "DEDUPED"


# ---------------------------------------------------------------------------
# distribution trees
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DistributionTree:
    """A replication tree: edges in topological (parent-before-child) order."""

    source: str
    dests: tuple[str, ...]
    edges: tuple[tuple[str, str], ...]

    def __post_init__(self):
        seen = {self.source}
        for u, v in self.edges:
            if u not in seen:
                raise ValueError(f"edge {u}->{v} precedes custody at {u}")
            if v in seen:
                raise ValueError(f"node {v} grafted twice (not a tree)")
            seen.add(v)
        missing = set(self.dests) - seen
        if missing:
            raise ValueError(f"destinations unreachable in tree: {sorted(missing)}")

    @property
    def nodes(self) -> tuple[str, ...]:
        out = [self.source]
        out += [v for _u, v in self.edges]
        return tuple(out)

    @property
    def wire_hops(self) -> int:
        """Links a byte crosses in total — each edge carries the payload once."""
        return len(self.edges)

    def parent(self, v: str) -> str:
        for u, w in self.edges:
            if w == v:
                return u
        raise KeyError(f"{v!r} has no parent (root or unknown)")

    def children(self, u: str) -> tuple[str, ...]:
        return tuple(w for p, w in self.edges if p == u)

    def path(self, dest: str) -> tuple[str, ...]:
        """Source -> dest node path inside the tree."""
        nodes = [dest]
        while nodes[-1] != self.source:
            nodes.append(self.parent(nodes[-1]))
        nodes.reverse()
        return tuple(nodes)

    def wire_bytes(self, nbytes: int) -> int:
        return nbytes * self.wire_hops


def build_distribution_tree(
    planner: RoutePlanner,
    source: str,
    dests: Sequence[str],
    nbytes: int,
    *,
    now: float = 0.0,
) -> DistributionTree:
    """Cheapest-attachment tree construction (shared first hops dedup'd).

    Destinations are attached nearest-first (deterministic: ties broken by
    name); each attachment is a multi-source Dijkstra from every node already
    holding custody, so an added route pays only for links the tree does not
    already cross.
    """
    dests = list(dict.fromkeys(dests))           # dedupe, keep order
    if not dests:
        raise ValueError("campaign needs at least one destination")
    if source in dests:
        raise ValueError("source endpoint cannot also be a destination")
    order = sorted(
        dests,
        key=lambda d: (planner.best_route(source, d, nbytes, now=now).seconds, d),
    )
    tree_nodes: list[str] = [source]
    edges: list[tuple[str, str]] = []
    for dest in order:
        if dest in tree_nodes:
            continue                             # already grafted en route
        # only relay-capable tree nodes (and the origin) may forward custody:
        # a relay=False destination holds a replica but never re-serves it
        grafts = [
            n for n in tree_nodes
            if n == source or planner.topo.endpoint(n).relay
        ]
        route = planner.shortest_from_set(grafts, dest, nbytes, now=now)
        for u, v in route.hops:
            if v not in tree_nodes:
                edges.append((u, v))
                tree_nodes.append(v)
    return DistributionTree(source=source, dests=tuple(dests), edges=tuple(edges))


def naive_wire_hops(
    planner: RoutePlanner, source: str, dests: Sequence[str], nbytes: int, *,
    now: float = 0.0,
) -> int:
    """Total link crossings for N independent per-destination transfers."""
    return sum(
        planner.best_route(source, d, nbytes, now=now).n_hops for d in dests
    )


# ---------------------------------------------------------------------------
# real-service campaign execution
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CampaignReport:
    """Outcome of one replication campaign run."""

    tree: DistributionTree
    relpath: str
    total_bytes: int
    state: str                               # SUCCEEDED | FAILED | CANCELED
    edge_tasks: dict[tuple[str, str], str]   # tree edge -> service task id
    edge_states: dict[tuple[str, str], str]
    replica_digests: dict[str, str]          # endpoint -> merge-law digest hex
    origin_digest: str
    replicas_verified: int
    integrity_escapes: int
    wire_bytes: int                          # custody bytes over tree edges
    naive_wire_bytes: int                    # what N independent routes cost
    resumed_chunks: int
    seconds: float
    # replica-aware dedup: edges whose destination replica already held the
    # content (per-replica chunk index) and were satisfied without a task
    edges_deduped: int = 0
    dedup_wire_bytes_saved: int = 0
    # resilience plane: orphaned subtrees re-parented onto surviving replicas
    # after an edge task failed (the effective edge set diverges from the
    # planned tree; verification still chains every replica to the origin)
    failovers: int = 0
    failover_events: list[dict] = dataclasses.field(default_factory=list)
    error: str | None = None

    @property
    def wire_reduction(self) -> float:
        return self.naive_wire_bytes / self.wire_bytes if self.wire_bytes else 1.0


class CampaignError(RuntimeError):
    pass


class CampaignRunner:
    """Decomposes distribution trees into service tasks, edge by edge.

    ``endpoint_dirs`` maps every fabric endpoint to its staging directory
    (the DTN's filesystem); edge ``(u, v)`` becomes one service task moving
    ``<dir(u)>/<relpath>`` to ``<dir(v)>/<relpath>``.
    """

    def __init__(
        self,
        service: TransferService,
        topo: Topology,
        endpoint_dirs: dict[str, str | os.PathLike],
        *,
        planner: RoutePlanner | None = None,
        indexes: dict[str, ChunkIndex] | None = None,
    ):
        self.service = service
        self.device = service.device
        self.topo = topo
        self.planner = planner or RoutePlanner(topo)
        self.dirs = {name: str(p) for name, p in endpoint_dirs.items()}
        for name in self.dirs:
            topo.endpoint(name)              # validate against the registry
        # per-replica chunk indexes: an edge whose destination endpoint has
        # one is probed before submission — if the replica already holds every
        # chunk, the edge is satisfied by verified local copies (no task)
        self.indexes: dict[str, ChunkIndex] = dict(indexes or {})
        for name in self.indexes:
            topo.endpoint(name)

    def _path(self, endpoint: str, relpath: str) -> str:
        try:
            return os.path.join(self.dirs[endpoint], relpath)
        except KeyError:
            raise CampaignError(
                f"endpoint {endpoint!r} has no staging directory") from None

    def _dedup_edge(
        self, u: str, v: str, relpath: str, nbytes: int,
        chunk_bytes: int | None,
    ) -> str | None:
        """Try to satisfy edge ``(u, v)`` entirely from ``v``'s chunk index.

        Probes each chunk of the custody file at ``u`` against the replica's
        index; a hit is satisfied by a verified local copy at ``v`` (or pure
        verification when the index already points at the destination path).
        All-or-nothing: any miss, stale entry, or verify failure demotes the
        whole edge to an ordinary wire task. Returns the merge-law whole-file
        digest hex on success (folded from the freshly fingerprinted source
        bytes, so the campaign's custody chain still anchors at the origin),
        or None to demote.
        """
        index = self.indexes.get(v)
        if index is None or nbytes == 0:
            return None
        cb = chunk_bytes or self.service.config.chunk_bytes
        src_path = self._path(u, relpath)
        dst_path = os.path.abspath(self._path(v, relpath))
        parts: list[tuple[int, Any]] = []
        pending_puts: list[tuple[str, int, int]] = []
        out = None
        try:
            with open(src_path, "rb") as fh:
                offset = 0
                while offset < nbytes:
                    length = min(cb, nbytes - offset)
                    data = fh.read(length)
                    if len(data) != length:
                        return None
                    want = fingerprint_on_device(data, self.device)
                    satisfied = False
                    for e in index.lookup(want.hexdigest(), length):
                        aliased = (os.path.abspath(e.path) == dst_path
                                   and e.offset == offset)
                        backing = index.verify_entry(e)
                        if backing is None:
                            # stale entry: the bytes behind it changed — drop
                            # it so no later probe trusts it again
                            index.discard(e.digest_hex, e.length, e.path, e.offset)
                            index.note_stale()
                            continue
                        if not aliased:
                            if out is None:
                                mode = "r+b" if os.path.exists(dst_path) else "w+b"
                                os.makedirs(os.path.dirname(dst_path) or ".",
                                            exist_ok=True)
                                out = open(dst_path, mode)
                            out.seek(offset)
                            out.write(backing)
                            out.flush()
                        with open(dst_path, "rb") as back_fh:
                            back_fh.seek(offset)
                            back = back_fh.read(length)
                        if len(back) == length and verify(
                                want, fingerprint_on_device(back, self.device)):
                            satisfied = True
                            if not aliased:
                                pending_puts.append(
                                    (want.hexdigest(), length, offset))
                            break
                    if not satisfied:
                        return None
                    parts.append((offset, want))
                    offset += length
        except OSError:
            return None
        finally:
            if out is not None:
                out.close()
        for hexd, length, off in pending_puts:
            try:
                index.put(hexd, length, dst_path, off)
            except Exception:
                pass
        return combine_at_offsets(parts, nbytes).hexdigest()

    def _index_landed(self, v: str, relpath: str, st: TaskStatus) -> None:
        """Register a succeeded edge's verified chunks in ``v``'s index."""
        index = self.indexes.get(v)
        if index is None or not st.item_reports:
            return
        dst_path = os.path.abspath(self._path(v, relpath))
        for c in st.item_reports[0].chunks:
            if not c.get("digest"):
                continue
            try:
                index.put(c["digest"], int(c["length"]), dst_path,
                          int(c["offset"]))
            except Exception:
                pass

    def _replan_edge(
        self,
        tree: DistributionTree,
        edge: tuple[str, str],
        nbytes: int,
        *,
        custody: set[str],
        banned_links: set[tuple[str, str]],
        occupied: set[str],
    ):
        """Re-parent the orphaned subtree below ``edge[1]`` onto a replica.

        The failed link is banned (bans accumulate across failovers, so the
        same link is never retried and the re-plan loop terminates); the new
        route may start at ANY custody-holding relay (a surviving replica is
        as good a parent as the origin) but may not pass through nodes that
        already hold or are already promised custody, nor through endpoints
        without staging directories. Returns the re-planned route or raises
        NoRouteError.
        """
        u, v = edge
        banned_links.add((u, v))
        sources = [
            n for n in custody
            if (n == tree.source or self.topo.endpoint(n).relay)
            and n in self.dirs
        ]
        no_dir = {n for n in self.topo.endpoints if n not in self.dirs}
        banned_nodes = (occupied | no_dir) - set(sources) - {v}
        return self.planner.shortest_from_set(
            sources, v, nbytes,
            banned_links=frozenset(banned_links),
            banned_nodes=frozenset(banned_nodes),
        )

    def replicate(
        self,
        relpath: str,
        source: str,
        dests: Sequence[str],
        *,
        tenant: str = "default",
        label: str = "campaign",
        chunk_bytes: int | None = None,
        tree: DistributionTree | None = None,
        timeout: float | None = 300.0,
        failover: str | None = None,
    ) -> CampaignReport:
        """Replicate ``<dir(source)>/<relpath>`` to every destination.

        Synchronous: drives the schedule to a terminal state. Submission is
        event-driven — an edge's task is submitted the moment its parent
        edge SUCCEEDED, so a fast subtree never waits for a slow sibling;
        the wait itself is event-driven too (the service event stream wakes
        the scheduler — no status polling). ``timeout`` is per-edge-task.

        ``failover="auto"`` re-parents instead of failing: when an edge task
        fails (or times out and is canceled), the orphaned subtree is grafted
        onto a surviving replica via a fresh route that bans the failed link,
        and the replacement hops run as ordinary edge tasks. Bans accumulate,
        so a genuinely partitioned destination still fails the campaign
        (NoRouteError) after every alternative is exhausted. ``failover=None``
        defers to ``ServiceConfig.failover``; ``"off"`` pins the tree — a
        failed edge fails the campaign and its downstream edges are never
        submitted, while unrelated subtrees still finish in flight.
        """
        t0 = mono_s()
        fo = failover if failover is not None else self.service.config.failover
        if fo not in ("off", "auto"):
            raise ValueError(f"failover must be 'off' or 'auto', got {fo!r}")
        src_path = self._path(source, relpath)
        nbytes = os.path.getsize(src_path)
        if tree is None:
            tree = build_distribution_tree(self.planner, source, list(dests), nbytes)
        naive = naive_wire_hops(self.planner, source, tree.dests, nbytes)

        edge_tasks: dict[tuple[str, str], str] = {}
        statuses: dict[tuple[str, str], TaskStatus] = {}
        dedup_digests: dict[tuple[str, str], str] = {}
        final_edges = list(tree.edges)       # effective set; failover splices
        ready = [e for e in tree.edges if e[0] == source]
        blocked = [e for e in tree.edges if e[0] != source]
        inflight: dict[tuple[str, str], tuple[str, float | None]] = {}
        custody: set[str] = {source}
        banned_links: set[tuple[str, str]] = set()
        failover_events: list[dict] = []
        failed: str | None = None

        # the scheduler sleeps on this and the event stream wakes it: any
        # terminal task event may be one of ours. The subscription is live
        # BEFORE the first submit, so a fast task cannot finish unseen.
        wake = threading.Event()
        _TERMINAL_KINDS = (ev.SUCCEEDED, ev.FAILED, ev.CANCELED)
        unsubscribe = self.service.subscribe(
            lambda e: wake.set() if e.kind in _TERMINAL_KINDS else None)

        def fail_edge(edge: tuple[str, str], tid: str, reason: str) -> None:
            """Re-parent the orphan (failover=auto) or fail the campaign."""
            nonlocal failed
            u, v = edge
            if fo == "auto":
                occupied = set(custody)
                for coll in (ready, blocked, inflight):
                    occupied.update(e[1] for e in coll)
                try:
                    route = self._replan_edge(
                        tree, edge, nbytes, custody=custody,
                        banned_links=banned_links, occupied=occupied)
                except NoRouteError as exc:
                    if v not in tree.dests:
                        # the orphan is a pure relay with no surviving route
                        # to it — nothing is *delivered* there, so drop it
                        # and re-parent each child subtree directly (they may
                        # reach their nodes through paths that bypass v)
                        if edge in final_edges:
                            final_edges.remove(edge)
                        children = [e for e in blocked if e[0] == v]
                        for child in children:
                            blocked.remove(child)
                        for child in children:
                            fail_edge(child, tid,
                                      f"{reason}; relay {v} unreachable")
                        return
                    if failed is None:
                        failed = (f"edge {u}->{v}: {reason}; no surviving "
                                  f"re-parent route: {exc}")
                    return
                final_edges.remove(edge)
                final_edges.extend(route.hops)
                # first replacement hop leaves a custody holder: runs now;
                # the rest chain behind it through the normal unlock path
                ready.append(route.hops[0])
                blocked.extend(route.hops[1:])
                evd = {
                    "edge": f"{u}->{v}", "reason": reason,
                    "new_parent": route.src, "new_path": list(route.nodes),
                    "banned_links": sorted(f"{a}->{b}" for a, b in banned_links),
                }
                failover_events.append(evd)
                self.service.record_failover(
                    tid, sick_link=f"{u}->{v}", new_path=list(route.nodes),
                    resumed_chunks=0, reason=reason)
            elif failed is None:
                failed = f"edge {u}->{v} task {tid} {reason}"

        try:
            while ready or inflight:
                for u, v in ready:
                    # replica-aware dedup: probe v's chunk index before
                    # paying for the wire — a full hit grants custody
                    # immediately and unlocks the subtree below v in the
                    # same scheduling pass
                    digest_hex = self._dedup_edge(u, v, relpath, nbytes,
                                                  chunk_bytes)
                    if digest_hex is not None:
                        dedup_digests[(u, v)] = digest_hex
                        custody.add(v)
                        unlocked = [e for e in blocked if e[0] == v]
                        blocked = [e for e in blocked if e[0] != v]
                        ready.extend(unlocked)
                        continue
                    item = TransferItem(
                        self._path(u, relpath), self._path(v, relpath), nbytes)
                    [tid] = self.service.submit(
                        [item], tenant=tenant, chunk_bytes=chunk_bytes,
                        label=f"{label}/{u}->{v}", batch=False, failover=fo,
                    )
                    edge_tasks[(u, v)] = tid
                    deadline = None if timeout is None else mono_s() + timeout
                    inflight[(u, v)] = (tid, deadline)
                ready = []
                if not inflight:
                    continue
                wake.clear()     # before the scan: a terminal event landing
                #                  mid-scan re-sets it and the wait falls through
                for edge, (tid, deadline) in list(inflight.items()):
                    st = self.service.status(tid)
                    if st.state in tk.TERMINAL:
                        inflight.pop(edge)
                        statuses[edge] = st
                        if st.state == tk.SUCCEEDED:
                            custody.add(edge[1])
                            self._index_landed(edge[1], relpath, st)
                            unlocked = [e for e in blocked if e[0] == edge[1]]
                            blocked = [e for e in blocked if e[0] != edge[1]]
                            ready.extend(unlocked)
                        elif st.state == tk.FAILED:
                            fail_edge(edge, tid, f"FAILED: {st.error}")
                        elif failed is None:
                            failed = (f"edge {edge[0]}->{edge[1]} task {tid} "
                                      f"{st.state}: {st.error}")
                    elif deadline is not None and mono_s() > deadline:
                        # don't leave a hung task writing into the staging
                        # dirs after the edge has been given up on
                        inflight.pop(edge)
                        self.service.cancel(tid)
                        try:
                            # drain before re-parenting: the dying task must
                            # stop writing into v's staging file before a
                            # replacement edge starts writing the same file
                            self.service.wait(tid, timeout=30.0)
                        except TimeoutError:
                            pass
                        fail_edge(edge, tid,
                                  f"timed out after {timeout}s (canceled)")
                if ready or not inflight:
                    continue
                # sleep until a terminal event or the nearest deadline; the
                # 0.5 s cap is a lost-wakeup backstop, not a poll interval
                rem = None
                for _tid, dl in inflight.values():
                    if dl is not None:
                        r = dl - mono_s()
                        rem = r if rem is None else min(rem, r)
                wake.wait(0.5 if rem is None else max(0.0, min(rem, 0.5)))
        finally:
            unsubscribe()

        # ---- merge-law verification chain: child digest == parent digest.
        # Failover makes the effective edge list non-topological (replacement
        # hops append at the tail), so the chain resolves to a fixpoint:
        # an edge is checked once its parent's digest is known.
        edge_digest: dict[tuple[str, str], str] = {}
        for e in final_edges:
            if e in dedup_digests:
                edge_digest[e] = dedup_digests[e]
            else:
                st = statuses.get(e)
                if st is not None and st.state == tk.SUCCEEDED and st.item_reports:
                    edge_digest[e] = st.item_reports[0].digest_hex
        origin_digest = ""
        replica_digests: dict[str, str] = {}
        escapes = 0
        verified = 0
        pending = [e for e in final_edges if e in edge_digest]
        progress = True
        while pending and progress:
            progress = False
            for e in list(pending):
                u, v = e
                digest = edge_digest[e]
                if u == tree.source:
                    if not origin_digest:
                        origin_digest = digest
                    parent_digest = origin_digest
                else:
                    parent_digest = replica_digests.get(u, "")
                    if not parent_digest:
                        continue        # parent unresolved: try next round
                pending.remove(e)
                progress = True
                replica_digests[v] = digest
                if digest == parent_digest:
                    if v in tree.dests:
                        verified += 1
                else:
                    escapes += 1
        state = tk.SUCCEEDED
        if failed or blocked or pending or verified < len(tree.dests):
            state = tk.FAILED
        if escapes:
            state = tk.FAILED
        edge_states = {e: s.state for e, s in statuses.items()}
        edge_states.update({e: DEDUPED for e in dedup_digests})
        wire_edges = sum(1 for e in final_edges
                         if e in statuses and statuses[e].state == tk.SUCCEEDED)
        return CampaignReport(
            tree=tree,
            relpath=relpath,
            total_bytes=nbytes,
            state=state,
            edge_tasks=edge_tasks,
            edge_states=edge_states,
            replica_digests=replica_digests,
            origin_digest=origin_digest,
            replicas_verified=verified,
            integrity_escapes=escapes,
            wire_bytes=nbytes * wire_edges,
            naive_wire_bytes=nbytes * naive,
            resumed_chunks=sum(s.resumed_chunks for s in statuses.values()),
            seconds=mono_s() - t0,
            edges_deduped=len(dedup_digests),
            dedup_wire_bytes_saved=nbytes * len(dedup_digests),
            failovers=len(failover_events),
            failover_events=failover_events,
            error=failed,
        )
