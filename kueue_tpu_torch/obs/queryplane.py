"""Snapshot-backed query plane: the read side of millions of users.

The reference ships a visibility apiserver (pkg/visibility) whose every
request walks the queue manager's LIVE heaps under the manager lock —
at storm read QPS that contends with the very admission cycle the
north-star metric measures. This module makes the read path a
first-class scaled surface:

- **Sealed views, not live state.** At every admission-cycle seal the
  scheduler publishes an immutable ``SealedView``: the cycle id and
  route, the cache's structural generation token, the cycle's nominate
  order (the admission-sorted entry ranks the scheduler already built —
  the decision-only column, amortized over all readers), and — for sync
  cycles — the cycle's own copy-on-write snapshot handout, whose
  ownership TRANSFERS from the scheduler to the plane instead of being
  released (``cache/SNAPSHOTS.md``: handout consumers now include
  readers; the handout stays counted in ``live_handouts`` until the
  plane rotates it out). Readers borrow the current view under a
  refcount and serve everything from it: one snapshot, one token, no
  live-heap walks per request.

- **Lazy per-CQ position tables.** A view's per-CQ (and per-LQ)
  pending-position table is materialized at most ONCE per view — the
  first reader of a CQ in a generation pays one ordered copy of that
  CQ's pending set (taken from the queue manager per CQ, outside the
  manager-wide lock); every subsequent reader of that CQ at storm QPS
  hits the immutable cached table. The old per-request cost (ordered
  walk + manager lock) becomes a per-cycle-per-CQ cost. Freshness
  contract, stated precisely: a table FREEZES the CQ's pending order
  at its first read within the view — at or after the seal, never
  before — and stays immutable for the view's lifetime, so all
  readers of one view agree. The stamped generation token is a
  staleness FLOOR (the rows are never older than the seal), not a
  row-freshness ceiling: readers of the CURRENT view see tables at
  most one seal ahead of the stamp, while a borrow deliberately held
  across later seals may first-materialize a table from
  correspondingly newer state (holding a retired view trades bounded
  coordinates for a stable object — the stamp still names the seal
  the nominate-rank column and snapshot belong to).

- **Explicit, observable staleness.** Every response is stamped with
  the generation token the view sealed under, the cycle id, and the
  view's age; ``token_lag()`` prices the view against the live cache
  (``Cache.generation_lag``). A plane that has never sealed a cycle is
  WARMING — the HTTP server answers 503 + Retry-After instead of
  blocking or lying.

Thread contract: ``publish`` is called by the scheduler thread at cycle
seal; ``acquire``/``release`` run on any number of reader threads. The
plane lock guards only the view swap, refcounts, and the once-per-view
table fills — never a queue walk or a snapshot build.

The port's copy of kueue_tpu/obs/queryplane.py.
"""

from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass
from typing import Optional

from kueue_tpu_torch.core import priority as prioritypkg
from kueue_tpu_torch.core import workload as wlpkg


@dataclass(frozen=True)
class PendingPosition:
    """One pending workload's position row (the visibility payload plus
    the query-plane columns)."""
    name: str
    namespace: str
    local_queue_name: str
    priority: int
    position_in_cluster_queue: int
    position_in_local_queue: int
    # This workload's rank in the sealed cycle's nominate (admission)
    # order, when it was among the cycle's heads; None otherwise. The
    # "decision-only column": readers see where the scheduler actually
    # ranked the head, not just heap order.
    nominate_rank: Optional[int] = None


class _CQTable:
    """Immutable ordered pending table for one ClusterQueue, built once
    per SealedView. ``rows`` is CQ queue order; ``by_lq`` projects LQ
    order (row indexes); ``by_key`` resolves point queries."""

    __slots__ = ("rows", "by_lq", "by_key")

    def __init__(self, rows: list):
        self.rows = tuple(rows)
        self.by_lq: dict = {}
        self.by_key: dict = {}
        for i, row in enumerate(self.rows):
            lqk = f"{row.namespace}/{row.local_queue_name}"
            self.by_lq.setdefault(lqk, []).append(i)
            self.by_key[f"{row.namespace}/{row.name}"] = i


class _SnapRef:
    """A snapshot handout shared by consecutive SealedViews (pipelined
    cycles publish without a fresh full snapshot): released back to the
    cache exactly once, when the last referencing view retires."""

    __slots__ = ("snapshot", "refs")

    def __init__(self, snapshot):
        self.snapshot = snapshot
        self.refs = 1


class SealedView:
    """One cycle's immutable read view. Built by ``QueryPlane.publish``;
    reader threads must only touch it between a paired
    ``acquire()``/``release()``."""

    __slots__ = ("cycle_id", "route", "generation", "journal_seq",
                 "sealed_wall", "sealed_mono", "_order", "_head_ranks",
                 "_order_chain", "_chain_len", "_since_keys", "snapref",
                 "_tables", "_snap_index", "_lq_index", "borrows",
                 "retired")

    def __init__(self, cycle_id: int, route: str, generation: tuple,
                 journal_seq: int, order: tuple,
                 snapref: Optional[_SnapRef]):
        self.cycle_id = cycle_id
        self.route = route
        self.generation = generation
        self.journal_seq = journal_seq
        self.sealed_wall = _time.time()
        self.sealed_mono = _time.perf_counter()
        self._order = order
        self._head_ranks: Optional[dict] = None
        self.snapref = snapref
        self._tables: dict = {}   # cq name -> _CQTable (plane-lock filled)
        self._snap_index: Optional[dict] = None  # key -> cq name (lazy)
        self._lq_index: Optional[dict] = None    # key -> cq name (lazy)
        # Nominate orders of every cycle sealed since this view's
        # snapshot was taken (append-only list shared with the plane;
        # _chain_len freezes this view's prefix). A pipelined stretch
        # reuses one snapshot for many seals — a key nominated in ANY
        # of those cycles is known to the view even though the stale
        # snapshot cannot place it (the "transitioning" witness).
        self._order_chain: list = []
        self._chain_len = 0
        self._since_keys: Optional[set] = None
        self.borrows = 0
        self.retired = False

    @property
    def head_ranks(self) -> dict:
        """key -> rank in the sealed cycle's nominate order. Built
        LAZILY on the first reader that needs it — the seal itself
        (the admission thread) only stores the order list, so the
        per-cycle publish cost stays O(1) regardless of head count.
        The racy double-build is benign: both results are equal and
        the slot assignment is atomic."""
        hr = self._head_ranks
        if hr is None:
            hr = {key: rank for rank, key in enumerate(self._order)}
            self._head_ranks = hr
        return hr

    @property
    def since_keys(self) -> set:
        """Keys nominated by any cycle sealed since this view's
        snapshot (the view's own cycle included). Built lazily on a
        reader thread (benign-race pattern); the chain entries are
        immutable tuples, so the frozen prefix is stable."""
        sk = self._since_keys
        if sk is None:
            sk = set()
            for order in self._order_chain[:self._chain_len]:
                sk.update(order)
            self._since_keys = sk
        return sk

    @property
    def snap_index(self) -> Optional[dict]:
        """key -> CQ name over the view snapshot's admitted/reserving
        workloads, built lazily on the first point query that needs it
        (same benign-race pattern as head_ranks) — point status lookups
        cost one dict probe instead of an O(CQs) snapshot scan."""
        idx = self._snap_index
        if idx is None:
            snap = self.snapshot
            if snap is None:
                return None
            idx = {key: cq.name
                   for cq in snap.cluster_queues.values()
                   for key in cq.workloads}
            self._snap_index = idx
        return idx

    @property
    def snapshot(self):
        return self.snapref.snapshot if self.snapref is not None else None

    def age_s(self) -> float:
        return max(0.0, _time.perf_counter() - self.sealed_mono)

    def stamp(self) -> dict:
        """The staleness stamp every response carries."""
        return {"generation": list(self.generation),
                "cycle": self.cycle_id,
                "sealed_at": self.sealed_wall,
                "age_s": round(self.age_s(), 6)}


class QueryPlane:
    def __init__(self, cache, queues, metrics=None):
        self._cache = cache
        self._queues = queues
        self._metrics = metrics
        self._lock = threading.Lock()
        self._view: Optional[SealedView] = None
        # Nominate orders sealed since the last full-snapshot publish
        # (reset when a fresh snapshot arrives; old views keep the old
        # list object, so their frozen prefixes stay valid).
        self._order_chain: list = []
        # Engagement counters (status surface / tests).
        self.cycles_published = 0
        self.tables_built = 0
        self.views_borrowed = 0

    # -- producer side (the scheduler thread, at cycle seal) -----------

    def publish(self, cycle_id: int, route: str, order,
                snapshot=None) -> None:
        """Seal a new view atomically. ``order`` is the cycle's nominate
        order (workload keys, admission-sorted — the scheduler already
        built it); ``snapshot`` is the cycle's full copy-on-write
        handout, whose ownership transfers to the plane (the plane
        releases it through ``cache.release_snapshot`` when the view
        rotates out and its last borrow returns). ``snapshot=None``
        (pipelined/light cycles) re-uses the previous view's handout.
        Cost on the admission thread: one token read + the view swap —
        the nominate-rank index and every position table materialize
        lazily on reader threads."""
        generation = self._cache.generation_token()
        order_t = tuple(order or ())
        with self._lock:
            old = self._view
            if snapshot is not None:
                snapref = _SnapRef(snapshot)
                self._order_chain = [order_t]
            else:
                snapref = old.snapref if old is not None else None
                if snapref is not None:
                    snapref.refs += 1
                self._order_chain.append(order_t)
                if len(self._order_chain) > 256:
                    # A very long snapshot-less (pipelined) stretch:
                    # keep only the newest 64 orders, in a FRESH list —
                    # existing views keep the old list object, so their
                    # frozen prefixes stay valid. An O(64)-ref slice,
                    # never a key merge, so the publish stays O(1)-ish
                    # on the admission thread even at seal 257 of a
                    # stretch. Witnesses older than ~256 seals expire
                    # to the pre-feature "unknown" answer until the
                    # next full-snapshot seal — bounded memory beats
                    # unbounded retention for a days-long all-fit
                    # stretch.
                    self._order_chain = list(self._order_chain[-64:])
            view = SealedView(cycle_id, route, generation,
                              getattr(snapshot, "journal_seq",
                                      old.journal_seq if old else 0),
                              order_t, snapref)
            view._order_chain = self._order_chain
            view._chain_len = len(self._order_chain)
            self._view = view
            self.cycles_published += 1
            if old is not None:
                old.retired = True
                self._maybe_release_locked(old)
        if self._metrics is not None:
            self._metrics.set_visibility_snapshot_age(0.0)

    # -- consumer side (reader threads) --------------------------------

    def acquire(self) -> Optional[SealedView]:
        """Borrow the current sealed view (None while warming — no
        cycle has sealed yet). Callers MUST pair with ``release`` on
        every path, including error paths (try/finally)."""
        with self._lock:
            view = self._view
            if view is None:
                return None
            view.borrows += 1
            self.views_borrowed += 1
            return view

    def release(self, view: Optional[SealedView]) -> None:
        if view is None:
            return
        with self._lock:
            view.borrows -= 1
            self._maybe_release_locked(view)

    def _maybe_release_locked(self, view: SealedView) -> None:
        """Release a retired view's snapshot ref once the last borrow
        returned; the underlying handout goes back to the cache (and
        its ``live_handouts`` accounting) when its last view retires."""
        if not view.retired or view.borrows > 0:
            return
        snapref, view.snapref = view.snapref, None
        if snapref is None:
            return
        snapref.refs -= 1
        if snapref.refs == 0 and snapref.snapshot is not None:
            self._cache.release_snapshot(snapref.snapshot)

    def close(self) -> None:
        """Shut the plane: retire the current view and release its
        handout (borrowed views release on their own return). After
        close the plane warms again from the next publish."""
        with self._lock:
            old, self._view = self._view, None
            if old is not None:
                old.retired = True
                self._maybe_release_locked(old)

    # -- the read API (serve from a borrowed view) ----------------------

    def cq_table(self, view: SealedView, cq_name: str) -> _CQTable:
        """The view's position table for one ClusterQueue, materialized
        on first access (one ordered copy of that CQ's pending set) and
        immutable thereafter — the per-cycle-per-CQ amortization."""
        table = view._tables.get(cq_name)
        if table is not None:
            return table
        # Build OUTSIDE the plane lock (the sort may be large); insert
        # under it. Two racing first-readers may both build — the first
        # insert wins and both results are equivalent (same heap copy
        # semantics the live API had per request).
        rows = []
        head_ranks = view.head_ranks
        lq_pos: dict = {}
        for idx, info in enumerate(self._queues.pending_order(cq_name)):
            obj = info.obj
            lq_key = wlpkg.queue_key(obj)
            pos = lq_pos.get(lq_key, 0)
            lq_pos[lq_key] = pos + 1
            rows.append(PendingPosition(
                name=obj.metadata.name,
                namespace=obj.metadata.namespace,
                local_queue_name=obj.spec.queue_name,
                priority=prioritypkg.priority(obj),
                position_in_cluster_queue=idx,
                position_in_local_queue=pos,
                nominate_rank=head_ranks.get(info.key)))
        built = _CQTable(rows)
        with self._lock:
            table = view._tables.setdefault(cq_name, built)
            if table is built:
                self.tables_built += 1
        return table

    def pending_cq(self, view: SealedView, cq_name: str,
                   limit: int, offset: int) -> list:
        rows = self.cq_table(view, cq_name).rows
        return list(rows[offset:offset + limit])

    def pending_lq(self, view: SealedView, namespace: str, lq_name: str,
                   limit: int, offset: int) -> list:
        lq_key = f"{namespace}/{lq_name}"
        lq = self._queues.local_queues.get(lq_key)
        if lq is None:
            return []
        table = self.cq_table(view, lq.cluster_queue)
        idxs = table.by_lq.get(lq_key, [])
        return [table.rows[i] for i in idxs[offset:offset + limit]]

    def workload_status(self, view: SealedView, namespace: str,
                        name: str) -> dict:
        """Point query: one workload's admission status + queue
        positions, answered from the borrowed view. Resolution order
        keeps answers consistent WITH THE VIEW while keeping the common
        case cheap: (1) the live LQ index names the owning CQ (O(LQs)
        dict probes, never a heap walk) and that ONE table is probed;
        (2) a miss falls back to the view's already-materialized tables
        — a workload this view lists as pending answers pending even
        if it admitted (and left the live index) after the seal; (3)
        the view snapshot's lazily-indexed admitted/reserving
        membership (one dict probe, not an O(CQs) scan); (4) a key the
        sealed cycle NOMINATED (the order column — accumulated across
        every seal since the view's snapshot, so a pipelined stretch's
        admissions stay witnessable) or that the live index still
        knows, but that none of the view's data can place, is reported
        ``transitioning`` — it changed state around this view's seal
        and a later full-snapshot view resolves it. Only a key unknown
        everywhere answers ``unknown``."""
        key = f"{namespace}/{name}"
        cq_name = self._lq_index(view).get(key)
        if cq_name is not None:
            table = self.cq_table(view, cq_name)
            i = table.by_key.get(key)
            if i is not None:
                return self._pending_payload(table, i, cq_name)
        for tbl_cq, table in list(view._tables.items()):
            i = table.by_key.get(key)
            if i is not None:
                return self._pending_payload(table, i, tbl_cq)
        idx = view.snap_index
        snap = view.snapshot
        if idx is not None and snap is not None:
            snap_cq = idx.get(key)
            if snap_cq is not None:
                cq = snap.cluster_queues.get(snap_cq)
                info = cq.workloads.get(key) if cq is not None else None
                if info is not None:
                    admitted = wlpkg.is_admitted(info.obj)
                    return {"found": True,
                            "status": "admitted" if admitted
                            else "reserving",
                            "cluster_queue": snap_cq,
                            "position_in_cluster_queue": None,
                            "position_in_local_queue": None,
                            "nominate_rank":
                                view.head_ranks.get(key)}
        rank = view.head_ranks.get(key)
        nominated = rank is not None or key in view.since_keys
        if cq_name is not None or nominated:
            # The live index or the sealed cycle's own nominate order
            # knows this key, but none of the view's data can place it
            # — it changed state around the seal (e.g. nominated and
            # admitted in the sealed cycle: the seal-time snapshot
            # predates the apply, and admission removed it from the
            # pending set). Distinguishable from a nonexistent name;
            # the next sealed view resolves it.
            return {"found": True, "status": "transitioning",
                    "cluster_queue": cq_name,
                    "position_in_cluster_queue": None,
                    "position_in_local_queue": None,
                    "nominate_rank": rank}
        return {"found": False, "status": "unknown",
                "cluster_queue": None}

    def _lq_index(self, view: SealedView) -> dict:
        """key -> owning CQ over the live LQ membership, built at most
        ONCE per view (benign-race pattern, reader threads): point
        queries cost one dict probe instead of an O(LQs) scan per
        request. Same freshness contract as the lazy tables: frozen at
        first use within the view. Unlike head_ranks/snap_index (whose
        inputs are immutable, so a double-build race is benign), this
        builds from LIVE queue state — two racing first builds can
        differ, so the FIRST insert wins under the plane lock (the
        cq_table pattern), keeping every reader of one view on one
        index."""
        idx = view._lq_index
        if idx is None:
            built = {}
            # list() first: the reconcilers mutate the LQ dict
            # concurrently and a live .values() iteration can see a
            # resize mid-walk; the items dicts are read via list(keys).
            for lq in list(self._queues.local_queues.values()):
                cq = lq.cluster_queue
                for key in list(lq.items):
                    built[key] = cq
            with self._lock:
                if view._lq_index is None:
                    view._lq_index = built
                idx = view._lq_index
        return idx

    @staticmethod
    def _pending_payload(table: _CQTable, i: int, cq_name: str) -> dict:
        row = table.rows[i]
        return {"found": True, "status": "pending",
                "cluster_queue": cq_name,
                "position_in_cluster_queue": row.position_in_cluster_queue,
                "position_in_local_queue": row.position_in_local_queue,
                "nominate_rank": row.nominate_rank}

    # -- observability ---------------------------------------------------

    def token_lag(self) -> Optional[int]:
        """Structural generations the current view lags the live cache
        (0 = the view's token IS the live token); None while warming."""
        view = self._view
        if view is None:
            return None
        return self._cache.generation_lag(view.generation)

    @property
    def warming(self) -> bool:
        return self._view is None

    def status(self) -> dict:
        """The /debug/queryplane producer (one producer per subsystem —
        obs/status.py convention)."""
        with self._lock:
            view = self._view
            holds_snapshot = view is not None and view.snapref is not None
            borrows = view.borrows if view is not None else 0
            tables = len(view._tables) if view is not None else 0
        out = {
            "warming": view is None,
            "cycles_published": self.cycles_published,
            "views_borrowed": self.views_borrowed,
            "tables_built": self.tables_built,
            "borrows_inflight": borrows,
            "tables_cached": tables,
            "holds_snapshot_handout": holds_snapshot,
        }
        if view is not None:
            out.update(view.stamp())
            out["route"] = view.route
            out["token_lag"] = self._cache.generation_lag(view.generation)
        return out
