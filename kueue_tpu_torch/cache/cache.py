"""The Cache: authoritative in-memory mirror of admitted usage.

Equivalent of the reference's pkg/cache/cache.go:89-595: tracks
ClusterQueues/cohorts/flavors/checks/local-queues plus assumed workloads
(optimistic admission before the API write), and produces Snapshots for
lock-free scheduling cycles. The port of kueue_tpu/cache/cache.py.

Full snapshots go through the incremental maintainer
(cache/incremental.py, on by default as in the JAX package): one
persistent snapshot advanced by replaying the usage journal, handed
out as copy-on-write shells; `Cache(incremental_snapshots=False)`
deep-clones every CQ each cycle instead. `snapshot(light=True)` shares
the live trees (read-only consumers). The usage journal has two
consumers, each with its own cursor: the solver's device-resident
state ("solver") and the maintainer ("snapshot"). Each snapshot carries
the MultiKueue remote-cluster capacity columns of
`remote_capacity_source` when one is set (`_stamp_remote`).
"""

from __future__ import annotations

import threading
import time as _time
from dataclasses import dataclass
from typing import Optional

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.meta import is_condition_true
from kueue_tpu_torch.cache.clusterqueue import (
    ACTIVE,
    TERMINATING,
    ClusterQueueCache,
    CohortCache,
    LocalQueueUsage,
    build_quotas,
    update_cohort_resource_node,
)
from kueue_tpu_torch.cache.snapshot import ClusterQueueSnapshot, CohortSnapshot, Snapshot
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.core.hierarchy import Manager as HierarchyManager


# Journal-consumer names (see the usage-journal block in Cache.__init__).
SNAPSHOT_CONSUMER = "snapshot"
SOLVER_CONSUMER = "solver"
SOLVER_CONSUMER = "solver"


@dataclass
class AdmissionCheckEntry:
    controller_name: str = ""
    active: bool = False
    single_instance_in_cluster_queue: bool = False


class Cache:
    def __init__(self, pods_ready_tracking: bool = False,
                 excluded_resource_prefixes: Optional[list] = None,
                 incremental_snapshots: bool = True):
        self._lock = threading.RLock()
        self._pods_ready_cond = threading.Condition(self._lock)
        self.hm: HierarchyManager = HierarchyManager(cohort_factory=self._new_cohort)
        self.resource_flavors: dict = {}  # name -> ResourceFlavor
        self.admission_checks: dict = {}  # name -> AdmissionCheckEntry
        self.assumed_workloads: dict = {}  # wl key -> cq name
        self.pods_ready_tracking = pods_ready_tracking
        self.excluded_resource_prefixes = excluded_resource_prefixes or []
        # Bumped on cohort-object changes (re-parent, cohort quotas):
        # structural edits invisible to per-CQ generations.
        self.cohort_epoch = 0
        # Monotonic capacity version: bumped on ANY capacity-affecting
        # change (CQ/cohort/flavor edits, workload removal). Snapshot
        # cohorts carry it as their allocatable generation so stored
        # flavor-resume state is invalidated by a simple `>` check — a
        # per-tree sum would shrink when a tree loses members and stall
        # invalidation forever.
        self._capacity_version = 0
        # Bumped on ResourceFlavor spec changes (taints / node labels):
        # they alter flavor eligibility without touching any CQ quota
        # generation, so topology-derived caches key on this too.
        self.flavor_spec_epoch = 0
        # Bumped on any change to the encoded solver TOPOLOGY (CQ set /
        # quotas / cohort tree / flavors / activity) — deliberately NOT on
        # workload add/remove, which only moves usage. The solver keys its
        # topology tensors on this instead of per-CQ allocatable
        # generations (those bump on every workload deletion purely to
        # invalidate flavor-resume state).
        self.topology_epoch = 0
        # Usage journal: every usage-moving workload mutation appends
        # (seq, kind, cq, key, usage, aux) so consumers can reconcile
        # derived state with tiny deltas instead of a full rebuild per
        # cycle. Two consumers share it through per-consumer cursors
        # (entries are pruned once EVERY cursor has passed them): the
        # solver's device-resident state ("solver", registered by
        # enable_usage_journal) and the incremental snapshot maintainer
        # ("snapshot", registered below). kinds: 'add'/'del' move usage;
        # 'cq'/'ready' are snapshot-replay-only records (non-structural
        # ClusterQueue updates, pods-ready flips) with usage=None.
        self.usage_journal_enabled = False
        self._journal: list = []
        self._journal_seq = 0
        self._journal_cap = 200_000
        # MultiKueue remote-cluster capacity source: a callable returning
        # (columns tuple, MultiKueue check-name frozenset), stamped on
        # every snapshot handout, full and light (Snapshot.remote_clusters,
        # mk_check_names), so the solver scores cross-cluster placement
        # inside the fused solve.
        self.remote_capacity_source = None
        self._remote_columns_cache = None  # last FULL snapshot's stamp
        self._journal_cursors: dict = {}  # consumer -> consumed-up-to seq
        self._journal_overflowed: set = set()  # consumers that lost entries
        self._journal_aux_stripped = 0  # aux dropped for seqs <= this
        # Incremental snapshot maintenance (see incremental.py): keep one
        # persistent full Snapshot advanced by journal replay instead of
        # deep-cloning 2k CQ trees per cycle.
        self._maintainer = None
        if incremental_snapshots:
            from kueue_tpu_torch.cache.incremental import SnapshotMaintainer
            self._maintainer = SnapshotMaintainer(self)
            self._journal_cursors[SNAPSHOT_CONSUMER] = 0
            self.usage_journal_enabled = True
        # Structural-dirty bookkeeping for the maintainer's per-CQ
        # partial rebuild (incremental.py): a single-CQ structural edit
        # (quota/resource-group change on ONE ClusterQueue, same cohort
        # edge) records just that CQ's name, so the next snapshot sync
        # rebuilds only that CQ's subtree instead of every master.
        # Anything wider (CQ add/delete, cohort or flavor or check
        # changes) sets the all-flag and keeps the full-rebuild path.
        # Only maintained when a maintainer exists (the set would
        # otherwise grow without a consumer).
        self._structural_dirty_cqs: set = set()
        self._structural_dirty_all = False
        # Snapshot-build accounting: which path served each full
        # snapshot() and how long the build took.
        # "partial" = per-CQ structural rebuild + journal replay.
        self.snapshot_stats = {"full": 0, "incremental": 0, "light": 0,
                               "partial": 0}
        self.snapshot_build_s: list = []
        # Handout accounting: every FULL snapshot handed out through
        # snapshot() counts as taken, every
        # release_snapshot of one counts as released (idempotent — a
        # double release counts once). live_handouts is the leak
        # detector.
        self.handouts_taken = 0
        self.handouts_released = 0

    def _new_cohort(self, name: str) -> CohortCache:
        cohort = CohortCache(name)
        cohort.manager = self.hm
        return cohort

    # --- usage journal (device-resident solver state reconciliation) ---

    def enable_usage_journal(self, consumer: str = SOLVER_CONSUMER) -> None:
        with self._lock:
            self.usage_journal_enabled = True
            self._journal_cursors.setdefault(consumer, self._journal_seq)

    def _journal_usage(self, kind: str, cq_name: str, key: str,
                       usage: Optional[dict], aux=None) -> None:
        """kind: 'add' | 'del' (usage-moving, consumed by solver AND
        snapshot maintainer) | 'cq' | 'ready' (snapshot-replay-only,
        usage=None). aux: (Info, not_ready) for 'add' entries so snapshot
        replay can reconstruct workload maps. Caller holds the lock."""
        if not self.usage_journal_enabled:
            return
        if self._maintainer is None:
            aux = None  # only snapshot replay reads it
        self._journal_seq += 1
        self._journal.append((self._journal_seq, kind, cq_name, key,
                              usage, aux))
        if len(self._journal) > self._journal_cap:
            # Bound memory when a consumer stops draining: only the
            # laggards lose their backlog (and see the overflow flag on
            # their next drain, falling back to a full rebuild); an
            # actively-draining consumer keeps its pending entries.
            for name, cur in self._journal_cursors.items():
                if self._journal_seq - cur > self._journal_cap:
                    self._journal_overflowed.add(name)
                    self._journal_cursors[name] = self._journal_seq
            self._prune_journal_locked()

    def _prune_journal_locked(self) -> None:
        """Drop entries every registered consumer has consumed. Seqs are
        contiguous (+1 per append, pruned only from the front), so list
        index == seq - first_seq."""
        if not self._journal:
            return
        if not self._journal_cursors:
            self._journal.clear()
            return
        low = min(self._journal_cursors.values())
        first = self._journal[0][0]
        if low >= first:
            del self._journal[:low - first + 1]
        # Entries the snapshot maintainer has consumed can never be read
        # for replay again — drop their aux payload so a lagging solver
        # consumer doesn't pin deleted workloads' Info objects (full pod
        # sets/conditions) for up to a journal-cap of entries. Each
        # entry is stripped at most once (amortized O(1) per append).
        if not self._journal:
            return
        snap_cur = self._journal_cursors.get(SNAPSHOT_CONSUMER)
        if snap_cur is None:
            return
        first = self._journal[0][0]
        upto = min(snap_cur, self._journal[-1][0])
        for seq in range(max(self._journal_aux_stripped + 1, first),
                         upto + 1):
            entry = self._journal[seq - first]
            if entry[5] is not None:
                self._journal[seq - first] = entry[:5] + (None,)
        self._journal_aux_stripped = max(self._journal_aux_stripped, upto)

    def _mark_structural(self, cq_name: Optional[str] = None) -> None:
        """Record the scope of a structural (epoch-bumping) change for
        the snapshot maintainer: a CQ name when the change is contained
        to that ClusterQueue's subtree, None for anything wider. Caller
        holds the lock and has already bumped the epoch."""
        if self._maintainer is None:
            return
        if cq_name is None:
            self._structural_dirty_all = True
        else:
            self._structural_dirty_cqs.add(cq_name)

    def take_structural_dirty(self) -> tuple:
        """Consume the structural-dirty scope accumulated since the last
        call: (dirty CQ names, all-flag). Caller holds the lock (the
        maintainer's _sync runs under Cache.snapshot's lock)."""
        dirty, dirty_all = (self._structural_dirty_cqs,
                            self._structural_dirty_all)
        self._structural_dirty_cqs = set()
        self._structural_dirty_all = False
        return dirty, dirty_all

    def generation_token(self) -> tuple:
        """The structural generation stamp for speculative solves
        (scheduler/stages.SpeculationToken): three epoch ints, read
        under the lock. Workload churn does NOT move any of these —
        usage movement reconciles through the journal; only structural
        edits (CQ/cohort/flavor-spec changes) invalidate an in-flight
        speculative result."""
        with self._lock:
            return (self.topology_epoch, self.cohort_epoch,
                    self.flavor_spec_epoch)

    def generation_lag(self, token: tuple) -> int:
        """How many structural generations a consumer's stamped token
        lags the live cache: the sum of per-epoch deltas (each epoch is
        monotonic, so the sum is 0 iff the token is current)."""
        with self._lock:
            cur = (self.topology_epoch, self.cohort_epoch,
                   self.flavor_spec_epoch)
        return sum(abs(c - t) for c, t in zip(cur, tuple(token)))

    def snapshot_current(self, snap: Snapshot) -> bool:
        """Cheap generation-token check: True iff no structural epoch
        moved since ``snap`` was produced (see
        incremental.generations_current)."""
        from kueue_tpu_torch.cache.incremental import generations_current
        with self._lock:
            return generations_current(snap, self)

    def journal_overflowed(self, consumer: str = SOLVER_CONSUMER) -> bool:
        """Peek (without clearing) whether ``consumer`` lost journal
        entries since its last drain — a speculative result computed on
        residency whose corrections were dropped is unsound and must
        abort (the flag itself still resets at the next drain, which
        falls back to a full rebuild)."""
        with self._lock:
            return consumer in self._journal_overflowed

    def drain_usage_journal(self, upto_seq: int,
                            consumer: str = SOLVER_CONSUMER) -> tuple:
        """Return (entries with cursor < seq <= upto_seq, overflowed) for
        `consumer` and advance its cursor; the overflow flag resets once
        observed. Entries stay visible to the other registered consumers
        until everyone's cursor has passed them — draining for one
        consumer never loses entries for another."""
        with self._lock:
            cursor = self._journal_cursors.get(consumer, 0)
            upto = min(upto_seq, self._journal_seq)
            entries: list = []
            if self._journal and upto >= self._journal[0][0]:
                first = self._journal[0][0]
                lo = max(0, cursor - first + 1)
                hi = upto - first + 1
                if hi > lo:
                    entries = self._journal[lo:hi]
            self._journal_cursors[consumer] = max(cursor, upto)
            overflow = consumer in self._journal_overflowed
            self._journal_overflowed.discard(consumer)
            self._prune_journal_locked()
            return entries, overflow

    # --- ClusterQueues ---

    def add_cluster_queue(self, cq: api.ClusterQueue) -> ClusterQueueCache:
        with self._lock:
            self._capacity_version += 1
            self.topology_epoch += 1
            self._mark_structural()  # may materialize a new cohort node
            cqc = ClusterQueueCache(cq)
            self.hm.add_cluster_queue(cqc.name, cqc)
            self.hm.update_cluster_queue_edge(cqc.name, cq.spec.cohort)
            self._wire_cohort(cqc)
            cqc.update_with_flavors(self.resource_flavors)
            cqc.update_with_checks(self.admission_checks)
            self._refresh_cohort(cqc)
            return cqc

    @staticmethod
    def _topo_signature(cqc) -> tuple:
        """The CQ fields the solver topology encodes: changes here (and
        only here) invalidate the encoded tensors. Reconcilers re-push
        ClusterQueues on every STATUS write; bumping the epoch on those
        would rebuild the topology (and drop device-resident solver
        state) every admission cycle."""
        return (cqc.cohort_name,
                tuple((tuple(sorted(rg.covered_resources)), tuple(rg.flavors))
                      for rg in cqc.resource_groups),
                tuple(sorted(cqc.resource_node.quotas.items())),
                cqc.fair_weight,
                cqc.flavor_fungibility.when_can_borrow,
                cqc.active,
                tuple(sorted((k, tuple(sorted(v)))
                             for k, v in cqc.admission_checks.items())))

    def update_cluster_queue(self, cq: api.ClusterQueue) -> None:
        with self._lock:
            self._capacity_version += 1
            cqc = self.hm.cluster_queues.get(cq.metadata.name)
            if cqc is None:
                return
            old_sig = self._topo_signature(cqc)
            old_cohort = cqc.cohort
            cqc.update(cq)
            self.hm.update_cluster_queue_edge(cqc.name, cq.spec.cohort)
            self._wire_cohort(cqc)
            cqc.update_with_flavors(self.resource_flavors)
            cqc.update_with_checks(self.admission_checks)
            if old_cohort is not None and old_cohort is not cqc.cohort:
                update_cohort_resource_node(old_cohort)
            self._refresh_cohort(cqc)
            if self._topo_signature(cqc) != old_sig:
                self.topology_epoch += 1
                # Same cohort payload => the cohort graph's SHAPE is
                # unchanged (quota edits only move this CQ's node and
                # the tree's aggregates): the maintainer may rebuild
                # just this CQ's subtree. An edge move (or to/from a
                # fresh cohort) invalidates the master cohort graph.
                self._mark_structural(
                    cqc.name if old_cohort is cqc.cohort else None)
            else:
                # Non-structural update (namespace selector, preemption
                # policy, fungibility knobs): invisible to every epoch,
                # so snapshot replay must refresh this CQ explicitly.
                self._journal_usage("cq", cqc.name, "", None)

    def terminate_cluster_queue(self, name: str) -> None:
        """Stop admissions while keeping the usage accounting alive until
        the last reserving workload finishes (reference:
        cache.TerminateClusterQueue, cache.go:~300)."""
        with self._lock:
            cqc = self.hm.cluster_queues.get(name)
            if cqc is not None:
                cqc.status = TERMINATING
                self.topology_epoch += 1
                self._mark_structural(name)  # an activity flip, CQ-local

    def delete_cluster_queue(self, name: str) -> None:
        with self._lock:
            self._capacity_version += 1
            self.topology_epoch += 1
            self._mark_structural()  # cohort membership/GC changes
            cqc = self.hm.cluster_queues.get(name)
            if cqc is None:
                return
            cqc.status = TERMINATING
            old_cohort = cqc.cohort
            self.hm.delete_cluster_queue(name)
            if old_cohort is not None:
                update_cohort_resource_node(old_cohort)

    def cluster_queue(self, name: str) -> Optional[ClusterQueueCache]:
        return self.hm.cluster_queues.get(name)

    def cluster_queue_active(self, name: str) -> bool:
        cqc = self.hm.cluster_queues.get(name)
        return cqc is not None and cqc.active

    def _wire_cohort(self, cqc: ClusterQueueCache) -> None:
        node = self.hm.cohort_of(cqc.name)
        cqc.cohort = node.payload if node else None

    def _refresh_cohort(self, cqc: ClusterQueueCache) -> None:
        if cqc.cohort is not None:
            update_cohort_resource_node(cqc.cohort)

    # --- Cohorts (explicit v1alpha1 objects with quotas) ---

    def add_or_update_cohort(self, cohort: api.Cohort) -> None:
        """Raises ValueError on a cycle-inducing parent edge; the quota
        update still lands and both trees stay consistent."""
        with self._lock:
            existing = self.hm.cohorts.get(cohort.metadata.name)
            if existing is not None:
                # No-op re-push guard (reconcilers re-deliver on status
                # writes): same parent + quotas -> keep the epochs, or
                # every resync would drop the solver topology + device
                # residency.
                parent = (existing.parent.name
                          if existing.parent is not None else "")
                if parent == (cohort.spec.parent or "") \
                        and existing.payload.resource_node.quotas \
                        == build_quotas(cohort.spec.resource_groups):
                    return
            self.cohort_epoch += 1
            self._capacity_version += 1
            self.topology_epoch += 1
            self._mark_structural()
            node = self.hm.add_cohort(cohort.metadata.name)
            node.payload.resource_node.quotas = build_quotas(cohort.spec.resource_groups)
            old_root = node.payload.root()
            try:
                self.hm.update_cohort_edge(cohort.metadata.name,
                                           cohort.spec.parent or "")
            finally:
                # A re-parent detaches this subtree: refresh the old tree
                # too (and always re-aggregate the quota edit above, even
                # when the edge update raises on a cycle).
                if old_root.name != node.payload.root().name:
                    update_cohort_resource_node(old_root)
                update_cohort_resource_node(node.payload)

    def delete_cohort(self, name: str) -> None:
        with self._lock:
            self.cohort_epoch += 1
            self._capacity_version += 1
            self.topology_epoch += 1
            self._mark_structural()
            node = self.hm.cohorts.get(name)
            if node is None:
                return
            payload = node.payload
            payload.resource_node.quotas = {}
            old_root = payload.root()
            self.hm.delete_cohort(name)
            if old_root is not payload:
                update_cohort_resource_node(old_root)
            if name in self.hm.cohorts:  # still referenced by CQs/children
                update_cohort_resource_node(payload)

    # --- flavors & checks ---

    def add_or_update_resource_flavor(self, rf: api.ResourceFlavor) -> set:
        with self._lock:
            old = self.resource_flavors.get(rf.metadata.name)
            self.resource_flavors[rf.metadata.name] = rf
            if old is not None and old.spec == rf.spec:
                # No-op re-push (reconcilers re-deliver on status/metadata
                # writes): eligibility didn't change, keep the epochs —
                # bumping them drops solver topology + device residency.
                return set()
            return self._refresh_flavor_dependents()

    def delete_resource_flavor(self, name: str) -> set:
        with self._lock:
            self.resource_flavors.pop(name, None)
            return self._refresh_flavor_dependents()

    def _refresh_flavor_dependents(self) -> set:
        self._capacity_version += 1
        self.flavor_spec_epoch += 1
        self.topology_epoch += 1
        self._mark_structural()
        affected = set()
        for cqc in self.hm.cluster_queues.values():
            was = cqc.active
            cqc.update_with_flavors(self.resource_flavors)
            if cqc.active != was:
                affected.add(cqc.name)
        return affected

    def add_or_update_admission_check(self, ac: api.AdmissionCheck) -> set:
        with self._lock:
            entry = AdmissionCheckEntry(
                controller_name=ac.spec.controller_name,
                active=is_condition_true(ac.status.conditions, api.ADMISSION_CHECK_ACTIVE))
            if self.admission_checks.get(ac.metadata.name) == entry:
                # No-op re-push: CQ activity can't change, keep the epoch.
                return set()
            self.admission_checks[ac.metadata.name] = entry
            return self._refresh_check_dependents()

    def delete_admission_check(self, name: str) -> set:
        with self._lock:
            self.admission_checks.pop(name, None)
            return self._refresh_check_dependents()

    def _refresh_check_dependents(self) -> set:
        self.topology_epoch += 1
        self._mark_structural()
        affected = set()
        for cqc in self.hm.cluster_queues.values():
            was = cqc.active
            cqc.update_with_checks(self.admission_checks)
            if cqc.active != was:
                affected.add(cqc.name)
        return affected

    # --- local queues ---

    def add_local_queue(self, lq: api.LocalQueue) -> None:
        with self._lock:
            cqc = self.hm.cluster_queues.get(lq.spec.cluster_queue)
            if cqc is None:
                return
            key = f"{lq.metadata.namespace}/{lq.metadata.name}"
            usage = LocalQueueUsage()
            # Rebuild usage from workloads already in the CQ (reference:
            # clusterqueue.go:440-448).
            for info in cqc.workloads.values():
                if wlpkg.queue_key(info.obj) != key:
                    continue
                for fr, q in info.flavor_resource_usage().items():
                    usage.usage[fr] = usage.usage.get(fr, 0) + q
                    if wlpkg.is_admitted(info.obj):
                        usage.admitted_usage[fr] = usage.admitted_usage.get(fr, 0) + q
                usage.reserving_workloads += 1
                if wlpkg.is_admitted(info.obj):
                    usage.admitted_workloads += 1
            cqc.local_queues[key] = usage

    def delete_local_queue(self, lq: api.LocalQueue) -> None:
        with self._lock:
            cqc = self.hm.cluster_queues.get(lq.spec.cluster_queue)
            if cqc is not None:
                cqc.local_queues.pop(f"{lq.metadata.namespace}/{lq.metadata.name}", None)

    def local_queue_usage(self, lq: api.LocalQueue) -> Optional[LocalQueueUsage]:
        cqc = self.hm.cluster_queues.get(lq.spec.cluster_queue)
        if cqc is None:
            return None
        return cqc.local_queues.get(f"{lq.metadata.namespace}/{lq.metadata.name}")

    # --- workloads (reference: cache.go:390-595) ---

    def add_or_update_workload(self, wl: api.Workload) -> bool:
        with self._lock:
            self._delete_workload_locked(wl)
            if wl.status.admission is None:
                return False
            cqc = self.hm.cluster_queues.get(wl.status.admission.cluster_queue)
            if cqc is None:
                return False
            info = self._new_info(wl)
            cqc.add_workload(info)
            not_ready = (self.pods_ready_tracking and not is_condition_true(
                wl.status.conditions, api.WORKLOAD_PODS_READY))
            self._journal_usage("add", cqc.name, info.key,
                                info.flavor_resource_usage(),
                                (info, not_ready))
            if not_ready:
                cqc.workloads_not_ready.add(info.key)
            self._pods_ready_cond.notify_all()
            return True

    def delete_workload(self, wl: api.Workload) -> bool:
        with self._lock:
            deleted = self._delete_workload_locked(wl)
            self._pods_ready_cond.notify_all()
            return deleted

    def _delete_workload_locked(self, wl: api.Workload) -> bool:
        key = wlpkg.key(wl)
        cq_name = self.assumed_workloads.pop(key, None)
        if cq_name is None and wl.status.admission is not None:
            cq_name = wl.status.admission.cluster_queue
        if cq_name is None:
            # The admission may already be cleared on the object (eviction
            # completed); fall back to membership lookup by key.
            for candidate in self.hm.cluster_queues.values():
                if key in candidate.workloads:
                    cq_name = candidate.name
                    break
        if cq_name is None:
            return False
        cqc = self.hm.cluster_queues.get(cq_name)
        if cqc is None:
            return False
        info = cqc.workloads.get(key)
        if info is None:
            return False
        cqc.delete_workload(info)
        self._journal_usage("del", cqc.name, key,
                            info.flavor_resource_usage())
        cqc.workloads_not_ready.discard(key)
        self._capacity_version += 1  # freed capacity invalidates resume state
        return True

    def assume_workload(self, wl: api.Workload,
                        info: Optional[wlpkg.Info] = None) -> None:
        """Optimistically account for a workload before the API write
        (reference: cache.go:546). `info` (optional) skips re-parsing the
        admission when the caller just built it (scheduler admit path)."""
        with self._lock:
            key = wlpkg.key(wl)
            if key in self.assumed_workloads:
                raise KeyError(f"workload {key} already assumed")
            if wl.status.admission is None:
                raise ValueError("cannot assume workload without admission")
            cqc = self.hm.cluster_queues.get(wl.status.admission.cluster_queue)
            if cqc is None:
                raise KeyError(f"cluster queue {wl.status.admission.cluster_queue} not found")
            if info is None or info.obj is not wl:
                info = self._new_info(wl)
            cqc.add_workload(info)
            not_ready = (self.pods_ready_tracking and not is_condition_true(
                wl.status.conditions, api.WORKLOAD_PODS_READY))
            self._journal_usage("add", cqc.name, key,
                                info.flavor_resource_usage(),
                                (info, not_ready))
            if not_ready:
                cqc.workloads_not_ready.add(key)
            self.assumed_workloads[key] = cqc.name

    def forget_workload(self, wl: api.Workload) -> None:
        with self._lock:
            key = wlpkg.key(wl)
            if key not in self.assumed_workloads:
                raise KeyError(f"workload {key} not assumed")
            self._delete_workload_locked(wl)
            self._pods_ready_cond.notify_all()

    def is_assumed_or_admitted(self, info: wlpkg.Info) -> bool:
        with self._lock:
            key = info.key
            if key in self.assumed_workloads:
                return True
            cqc = self.hm.cluster_queues.get(info.cluster_queue)
            return cqc is not None and key in cqc.workloads

    def _new_info(self, wl: api.Workload) -> wlpkg.Info:
        return wlpkg.Info(wl, excluded_resource_prefixes=self.excluded_resource_prefixes)

    # --- PodsReady gating (reference: cache.go:145-192) ---

    def pods_ready_for_all_admitted_workloads(self) -> bool:
        with self._lock:
            if not self.pods_ready_tracking:
                return True
            return all(not cqc.workloads_not_ready
                       for cqc in self.hm.cluster_queues.values())

    def mark_workload_pods_ready(self, wl: api.Workload) -> None:
        with self._lock:
            key = wlpkg.key(wl)
            for cqc in self.hm.cluster_queues.values():
                if key in cqc.workloads_not_ready:
                    cqc.workloads_not_ready.discard(key)
                    self._journal_usage("ready", cqc.name, key, None)
            self._pods_ready_cond.notify_all()

    def wait_for_pods_ready(self, timeout: Optional[float] = None) -> bool:
        with self._pods_ready_cond:
            return self._pods_ready_cond.wait_for(
                lambda: all(not c.workloads_not_ready
                            for c in self.hm.cluster_queues.values()),
                timeout=timeout)

    # --- snapshot (reference: snapshot.go:79-142) ---

    def snapshot(self, light: bool = False) -> Snapshot:
        # light=True shares the cache trees instead of deep-copying (see
        # ClusterQueueSnapshot): READ-ONLY cycles only (the pipelined
        # all-fit path, whose usage truth is the device-resident state).
        # Full snapshots go through the incremental maintainer when one
        # is attached: the persistent snapshot is advanced by journal
        # replay and handed out under copy-on-write
        # instead of deep-cloning every CQ's trees per cycle.
        with self._lock:
            if light:
                self.snapshot_stats["light"] += 1
                if self._maintainer is not None:
                    # Periodic background advance: a long pipelined
                    # all-fit stretch takes only light snapshots, so the
                    # snapshot consumer's journal backlog would hit the
                    # cursor cap and pay a surprise full rebuild on the
                    # next sync cycle. Catch up (replay, no handout)
                    # once the backlog passes half the cap.
                    backlog = self._journal_seq - self._journal_cursors.get(
                        SNAPSHOT_CONSUMER, 0)
                    if backlog > self._journal_cap // 2:
                        self._maintainer.catch_up()
                snap = self._build_snapshot(light=True)
            else:
                t0 = _time.perf_counter()
                if self._maintainer is not None:
                    snap, mode = self._maintainer.advance()
                else:
                    snap, mode = self._build_snapshot(), "full"
                self.snapshot_stats[mode] += 1
                if len(self.snapshot_build_s) >= (1 << 20):
                    # Bound the sample buffer on very long runs; late
                    # samples (steady state) are the ones the
                    # percentiles should reflect anyway.
                    del self.snapshot_build_s[:1 << 19]
                self.snapshot_build_s.append(_time.perf_counter() - t0)
                self.handouts_taken += 1
                snap._handout_live = True
        # OUTSIDE the cache lock: the capacity source reads the local
        # Store and the remote managers' caches — taking Store._lock
        # while holding Cache._lock would invert the store-watch
        # handlers' Store._lock -> Cache._lock order (AB-BA risk in
        # threaded deployments).
        return self._stamp_remote(snap, light=light)

    def _stamp_remote(self, snap: Snapshot, light: bool = False) -> Snapshot:
        """Attach the current remote-cluster capacity columns (read-only
        per handout; the source rebuilds the tuple on change). Called
        WITHOUT the cache lock held — see snapshot(). LIGHT snapshots
        (the depth-2 pipelined all-fit hot path takes one per cycle)
        reuse the last FULL snapshot's columns instead of re-walking
        every remote cache + the plan table — capacity is an advisory
        score, stale by at most one sync cycle there."""
        src = self.remote_capacity_source
        if src is None:
            return snap
        cached = self._remote_columns_cache
        if light and cached is not None:
            snap.remote_clusters, snap.mk_check_names = cached
            return snap
        try:
            cols, checks = src()
        except Exception:  # noqa: BLE001 — capacity is advisory
            # A torn read during remote churn degrades to "no columns
            # this cycle" (placement falls back to the controller's
            # mirror-to-all race), never a failed cycle.
            cols, checks = (), frozenset()
        self._remote_columns_cache = (cols, checks)
        snap.remote_clusters = cols
        snap.mk_check_names = checks
        return snap

    def release_snapshot(self, snap: Snapshot) -> None:
        """Optional hint that the caller will never read or mutate
        `snap` again: the incremental maintainer may then recycle its
        un-materialized copy-on-write shells into the NEXT handout,
        skipping the O(CQs) shell rebuild per cycle. Safe to omit —
        unreleased snapshots are simply never reused. Releasing a
        snapshot that is still read afterwards is a caller bug (its
        shells may start reflecting a newer cycle)."""
        if getattr(snap, "light", False):
            return
        with self._lock:
            if getattr(snap, "_handout_live", False):
                snap._handout_live = False
                self.handouts_released += 1
            if self._maintainer is not None:
                self._maintainer.release(snap)

    @property
    def live_handouts(self) -> int:
        """Full snapshots handed out and not yet released — the leak
        detector for abandoned cycles. Consumers
        that legitimately never release (debug oracles) keep their
        handouts counted here; the scheduler/solver paths all
        release."""
        return self.handouts_taken - self.handouts_released

    def _build_snapshot(self, light: bool = False) -> Snapshot:
        """From-scratch snapshot construction (the full deep clone, or
        the shared-tree light view). The incremental maintainer uses the
        same building blocks; this stays the equivalence oracle."""
        with self._lock:
            snap = Snapshot()
            snap.light = light
            for name, cqc in self.hm.cluster_queues.items():
                if not cqc.active:
                    snap.inactive_cluster_queue_sets.add(name)
                    continue
                snap.cluster_queues[name] = ClusterQueueSnapshot(cqc,
                                                                light=light)
            snap.resource_flavors = dict(self.resource_flavors)
            cohort_snaps: dict = {}
            for cname, node in self.hm.cohorts.items():
                cohort_snap = CohortSnapshot(
                    cname, node.payload.resource_node if light
                    else node.payload.resource_node.clone())
                # The monotonic capacity version: any capacity change
                # anywhere (including in sibling subtrees of a tree)
                # invalidates stored flavor-resume state via a `>` check.
                cohort_snap.allocatable_resource_generation = self._capacity_version
                cohort_snaps[cname] = cohort_snap
                for cqc in node.child_cqs.values():
                    if cqc.name in snap.cluster_queues:
                        cq_snap = snap.cluster_queues[cqc.name]
                        cq_snap.cohort = cohort_snap
                        cohort_snap.members.add(cq_snap)
            # Wire the cohort tree (hierarchical v1alpha1 cohorts).
            for cname, node in self.hm.cohorts.items():
                if node.parent is not None:
                    parent_snap = cohort_snaps[node.parent.name]
                    cohort_snaps[cname].parent = parent_snap
                    parent_snap.child_cohorts.add(cohort_snaps[cname])
            snap.cohort_epoch = self.cohort_epoch
            snap.flavor_spec_epoch = self.flavor_spec_epoch
            snap.topology_epoch = self.topology_epoch
            snap.journal_seq = self._journal_seq
            return snap

    # --- usage reporting (status/metrics) ---

    def usage_for_cluster_queue(self, name: str) -> tuple:
        """(reservation usage, admitted usage) as FlavorResource dicts."""
        with self._lock:
            cqc = self.hm.cluster_queues.get(name)
            if cqc is None:
                return {}, {}
            return dict(cqc.resource_node.usage), dict(cqc.admitted_usage)
