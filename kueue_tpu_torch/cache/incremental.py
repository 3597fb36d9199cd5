"""Incremental journal-replay snapshot maintenance.

The port of kueue_tpu/cache/incremental.py (the JAX package's
kueue_tpu/cache/SNAPSHOTS.md states the copy-on-write contract).

Keeps ONE persistent full Snapshot ("master") and advances it on every
`Cache.snapshot()` call by replaying drained usage-journal entries
(workload add/del usage deltas, non-structural CQ updates, pods-ready
flips) onto the cloned ResourceNode trees and CQ workload maps, instead
of deep-cloning every ClusterQueue's resource groups, workload maps and
hierarchical usage nodes from scratch — an O(CQs x flavors x resources)
copy that was pure overhead when only a handful of workloads moved since
the last cycle.

Fallback to a from-scratch rebuild happens only when a structural epoch
moved (cohort_epoch / flavor_spec_epoch / topology_epoch — CQ and cohort
adds/deletes, quota or flavor-spec changes, activity flips) or the
journal overflowed for the snapshot consumer. Equal epochs guarantee
every journaled entry in between is non-structural, so replay is exact.

Handouts are copy-on-write:
each call returns a fresh Snapshot of shallow per-CQ/per-cohort shells
sharing the master's containers. A cycle that mutates its snapshot for
preemption simulation privatizes just the touched CQ (and its cohort
chain) on first write; the master likewise privatizes a CQ's containers
before replaying a delta onto it while a handout may still hold them —
so handed-out snapshots stay frozen at their journal_seq and per-cycle
cloning is bounded by the CQs actually touched on either side.

Inactive ClusterQueues are absent from snapshots but their admitted
usage still bubbles into live cohort nodes, so the maintainer keeps
"hidden" master snapshots for them: replay targets for usage bubbling
that are never handed out.
"""

from __future__ import annotations

from kueue_tpu_torch.cache import resource_node as rnode
from kueue_tpu_torch.cache.snapshot import ClusterQueueSnapshot, CohortSnapshot, Snapshot

# Mirrors kueue_tpu_torch.cache.cache.SNAPSHOT_CONSUMER (importing it here
# would be circular: Cache.__init__ imports this module at runtime).
SNAPSHOT_CONSUMER = "snapshot"


def snapshot_generations(snapshot) -> tuple:
    """A snapshot's structural generation stamp, in the SAME canonical
    order as ``Cache.generation_token()`` — the one place the tuple
    layout is defined on the snapshot side, so a future fourth epoch
    has exactly two producers to touch (here and generation_token)."""
    return (snapshot.topology_epoch, snapshot.cohort_epoch,
            snapshot.flavor_spec_epoch)


def generations_current(snapshot, cache) -> bool:
    """Generation-token validation for the speculative admission
    pipeline: True iff no STRUCTURAL epoch moved since ``snapshot`` was
    produced — the cheap alternative to comparing snapshots field by
    field (three int compares instead of an O(CQs x flavors) walk).

    The epochs used are exactly the ones the maintainer's ``_sync``
    keys its full-rebuild fallback on: equal epochs guarantee every
    journaled entry since the snapshot is non-structural, so a
    speculative solve dispatched against the snapshot stays sound —
    workload churn reconciles through the usage journal and through the
    encode arena's per-slot generations, which the SpeculationToken
    checks separately. Caller holds the cache lock (or tolerates a
    torn read, as the scheduler's single-threaded cycle does).
    """
    return snapshot_generations(snapshot) == cache.generation_token()


class SnapshotMaintainer:
    def __init__(self, cache):
        self._cache = cache
        self._cqs: dict = {}      # name -> master snapshot (active CQs)
        self._hidden: dict = {}   # name -> master for inactive CQs
        self._cohorts: dict = {}  # name -> master CohortSnapshot
        self._inactive: set = set()
        self._epochs = None
        # Master containers NOT shared with any handout (privatized
        # since the last handout, or never handed out). Tracked here by
        # name — not as per-object flags — so the hot handout loop does
        # no per-CQ lease bookkeeping at all: a handout simply clears
        # these sets (everything is shared again) and _own re-privatizes
        # on demand.
        self._fresh_cqs: set = set()
        self._fresh_cohorts: set = set()
        # Shell recycling (see release()): the latest handout, returned
        # by its consumer, whose un-materialized CQ shells the next
        # handout may reuse instead of re-allocating O(CQs) objects.
        self._handout_gen = 0
        self._reusable = None  # (handout gen, its cluster_queues dict)
        # Engagement counters (perf artifacts / the smoke test assert
        # that steady-state cycles take the incremental path).
        self.full_rebuilds = 0
        self.incremental_advances = 0
        self.partial_rebuilds = 0
        self.background_advances = 0
        self.shell_reuses = 0

    def advance(self) -> tuple:
        """Bring the persistent snapshot up to the cache's current state
        and return (handout snapshot, "incremental" | "full"). Caller
        holds the cache lock."""
        mode = self._sync()
        return self._handout(self._epochs), mode

    def catch_up(self) -> None:
        """Background advance WITHOUT a handout: drains and replays the
        journal so a long light-snapshot-only stretch (pipelined all-fit
        cycles) cannot overflow the snapshot consumer's cursor cap and
        pay a surprise full rebuild at the next sync cycle. Caller holds
        the cache lock."""
        self.background_advances += 1
        self._sync()

    def _sync(self) -> str:
        cache = self._cache
        epochs = (cache.cohort_epoch, cache.flavor_spec_epoch,
                  cache.topology_epoch)
        entries, overflow = cache.drain_usage_journal(
            cache._journal_seq, consumer=SNAPSHOT_CONSUMER)
        if overflow or self._epochs != epochs:
            dirty, dirty_all = cache.take_structural_dirty()
            if (not overflow and not dirty_all and dirty
                    and self._epochs is not None
                    and self._epochs[0] == epochs[0]
                    and self._epochs[1] == epochs[1]):
                # Every structural change since the last sync was a
                # single-CQ edit with an unchanged cohort edge (quota /
                # resource-group / activity): rebuild ONLY those CQs'
                # subtrees from live state and replay the journal for
                # everyone else, instead of re-cloning 2k masters
                # because one tenant's quota moved (the flavor-churn
                # scenario's steady diet). Entries for the dirty CQs
                # are subsumed by their from-live rebuild.
                self._replay([e for e in entries if e[2] not in dirty])
                for name in dirty:
                    self._rebuild_cq(name)
                self._epochs = epochs
                self.partial_rebuilds += 1
                return "partial"
            # Structural change (or lost journal entries): the drained
            # entries are subsumed by rebuilding from live state.
            self._rebuild()
            self._epochs = epochs
            self.full_rebuilds += 1
            return "full"
        self._replay(entries)
        self.incremental_advances += 1
        return "incremental"

    # --- full rebuild (the epoch/overflow fallback) ---

    def _rebuild(self) -> None:
        cache = self._cache
        self._cqs = {}
        self._hidden = {}
        self._cohorts = {}
        self._inactive = set()
        for name, cqc in cache.hm.cluster_queues.items():
            snap_cq = ClusterQueueSnapshot(cqc)
            # Stamped once so the handout __dict__ copy hands every
            # shell _shared=True for free (see ClusterQueueSnapshot).
            snap_cq._shared = True
            if cqc.active:
                self._cqs[name] = snap_cq
            else:
                self._inactive.add(name)
                self._hidden[name] = snap_cq
        self._fresh_cqs = set(cache.hm.cluster_queues)
        self._fresh_cohorts = set(cache.hm.cohorts)
        for cname, node in cache.hm.cohorts.items():
            self._cohorts[cname] = CohortSnapshot(
                cname, node.payload.resource_node.clone())
        for cname, node in cache.hm.cohorts.items():
            cohort = self._cohorts[cname]
            if node.parent is not None:
                cohort.parent = self._cohorts[node.parent.name]
                cohort.parent.child_cohorts.add(cohort)
            for cqc in node.child_cqs.values():
                member = self._cqs.get(cqc.name) \
                    or self._hidden.get(cqc.name)
                if member is not None:
                    # Hidden CQs get the cohort pointer (usage bubbling)
                    # but are not members; handouts rebuild member sets.
                    member.cohort = cohort

    # --- per-CQ structural rebuild (single-CQ epoch bumps) ---

    def _rebuild_cq(self, name: str) -> None:
        """Rebuild ONE ClusterQueue's master from live state after a
        structural edit contained to it (quota / resource-group /
        activity change, cohort edge unchanged), then re-sync its cohort
        tree's aggregates — the live tree was already re-aggregated by
        update_cohort_resource_node, so quotas/subtree_quota/usage come
        from there. Preconditions enforced by _sync: no cohort-graph
        shape change, no flavor-spec or cohort-object epoch movement."""
        cache = self._cache
        self._cqs.pop(name, None)
        self._hidden.pop(name, None)
        self._inactive.discard(name)
        cqc = cache.hm.cluster_queues.get(name)
        if cqc is None:
            # CQ deletes are dirty-all (full rebuild); defensive only.
            return
        snap_cq = ClusterQueueSnapshot(cqc)
        snap_cq._shared = True
        if cqc.active:
            self._cqs[name] = snap_cq
        else:
            self._inactive.add(name)
            self._hidden[name] = snap_cq
        # The fresh clone shares nothing with any handout.
        self._fresh_cqs.add(name)
        node = cache.hm.cohort_of(name)
        if node is not None:
            cohort = self._cohorts.get(node.name)
            if cohort is not None:
                snap_cq.cohort = cohort
                self._sync_cohort_tree_from_live(cohort.root())

    def _sync_cohort_tree_from_live(self, cohort) -> None:
        """Re-sync a master cohort tree's resource nodes (quotas,
        subtree_quota, usage) from the live tree, privatizing shared
        nodes first (handouts keep their frozen view). Used by the
        per-CQ rebuild: a quota edit on one member re-aggregates the
        live tree wholesale, exactly like a non-structural CQ refresh
        re-syncs usage (see _sync_cohort_tree_usage)."""
        live = self._cache.hm.cohorts.get(cohort.name)
        if live is not None:
            if cohort.name not in self._fresh_cohorts:
                cohort.resource_node = cohort.resource_node.clone()
                self._fresh_cohorts.add(cohort.name)
            node = live.payload.resource_node
            # Re-share the live quota dicts exactly like a fresh clone
            # would (ResourceNode.clone shares quotas/subtree_quota).
            cohort.resource_node.quotas = node.quotas
            cohort.resource_node.subtree_quota = node.subtree_quota
            cohort.resource_node.usage = dict(node.usage)
        for child in cohort.child_cohorts:
            self._sync_cohort_tree_from_live(child)

    # --- journal replay (the steady-state path) ---

    def _replay(self, entries: list) -> None:
        cache = self._cache
        refresh: set = set()
        for entry in entries:
            kind, cq_name, key = entry[1], entry[2], entry[3]
            if kind == "cq":
                refresh.add(cq_name)
                continue
            mcq = self._cqs.get(cq_name)
            if mcq is None:
                mcq = self._hidden.get(cq_name)
                if mcq is None:
                    continue
            if kind == "add":
                usage = entry[4]
                info, not_ready = entry[5]
                self._own(mcq)
                mcq.workloads[key] = info
                if not_ready:
                    mcq.workloads_not_ready.add(key)
                for fr, q in usage.items():
                    rnode.add_usage(mcq, fr, q)
            elif kind == "del":
                usage = entry[4]
                self._own(mcq)
                mcq.workloads.pop(key, None)
                mcq.workloads_not_ready.discard(key)
                for fr, q in usage.items():
                    rnode.remove_usage(mcq, fr, q)
                # Freed capacity invalidates flavor-resume state
                # (mirrors ClusterQueueCache.delete_workload).
                mcq.allocatable_resource_generation += 1
            elif kind == "ready":
                self._own(mcq)
                mcq.workloads_not_ready.discard(key)
        for name in refresh:
            self._refresh_cq(name)

    def _refresh_cq(self, name: str) -> None:
        """Re-sync the fields a non-structural ClusterQueue update can
        move. Anything else (quotas, resource-group shape, cohort edge,
        activity) changes the topology signature and takes the
        full-rebuild path instead — usage and workload maps are
        exclusively owned by the delta entries."""
        cqc = self._cache.hm.cluster_queues.get(name)
        mcq = self._cqs.get(name) or self._hidden.get(name)
        if cqc is None or mcq is None:
            return
        self._own(mcq)
        mcq.namespace_selector = cqc.namespace_selector
        mcq.preemption = cqc.preemption
        mcq.flavor_fungibility = cqc.flavor_fungibility
        mcq.fair_weight = cqc.fair_weight
        mcq.resource_groups = [rg.clone() for rg in cqc.resource_groups]
        mcq.admission_checks = {k: set(v)
                                for k, v in cqc.admission_checks.items()}
        # Equal content by the no-topo-bump precondition; re-share the
        # live dicts exactly like a fresh clone would.
        mcq.resource_node.quotas = cqc.resource_node.quotas
        mcq.resource_node.subtree_quota = cqc.resource_node.subtree_quota
        # The update rebuilt the LIVE cohort tree's usage wholesale
        # (update_cohort_resource_node), which drops zero-valued entries
        # that incremental bubbling keeps; re-sync the tree from live
        # state so the maintained snapshot matches a fresh clone exactly.
        if mcq.cohort is not None:
            self._sync_cohort_tree_usage(mcq.cohort.root())

    def _sync_cohort_tree_usage(self, cohort) -> None:
        live = self._cache.hm.cohorts.get(cohort.name)
        if live is not None:
            if cohort.name not in self._fresh_cohorts:
                cohort.resource_node = cohort.resource_node.clone()
                self._fresh_cohorts.add(cohort.name)
            cohort.resource_node.usage = \
                dict(live.payload.resource_node.usage)
        for child in cohort.child_cohorts:
            self._sync_cohort_tree_usage(child)

    def _own(self, mcq: ClusterQueueSnapshot) -> None:
        """Master-side copy-on-write: privatize this CQ's containers (and
        the cohort chain's usage nodes) before replaying a delta, so a
        handout that still shares them keeps its frozen view."""
        fresh = self._fresh_cqs
        if mcq.name not in fresh:
            mcq.workloads = dict(mcq.workloads)
            mcq.workloads_not_ready = set(mcq.workloads_not_ready)
            mcq.resource_node = mcq.resource_node.clone()
            fresh.add(mcq.name)
        fresh = self._fresh_cohorts
        cohort = mcq.cohort
        while cohort is not None and cohort.name not in fresh:
            cohort.resource_node = cohort.resource_node.clone()
            fresh.add(cohort.name)
            cohort = cohort.parent

    # --- copy-on-write handout ---

    def release(self, snap: Snapshot) -> None:
        """The consumer is done with this handout (it will never read or
        mutate it again): its un-materialized shells become candidates
        for recycling into the NEXT handout. Only the latest handout
        qualifies — an older one would hand back shells whose master
        state has since been re-shared with a newer snapshot."""
        if getattr(snap, "_handout_gen", -1) == self._handout_gen:
            self._reusable = (self._handout_gen, snap.cluster_queues)

    def _handout(self, epochs: tuple) -> Snapshot:
        cache = self._cache
        snap = Snapshot()
        snap.cohort_epoch, snap.flavor_spec_epoch, snap.topology_epoch = \
            epochs
        snap.journal_seq = cache._journal_seq
        snap.resource_flavors = dict(cache.resource_flavors)
        snap.inactive_cluster_queue_sets = set(self._inactive)
        # Shells released back from the previous handout (release()):
        # one whose master was untouched since (not in _fresh_cqs) and
        # that its cycle never materialized (_shared still True) is
        # VALUE-identical to the fresh __dict__ copy we would build — so
        # recycle the object and skip the allocation + copy. Everything
        # else (replayed masters, materialized shells) is rebuilt.
        prev_cqs = None
        if self._reusable is not None \
                and self._reusable[0] == self._handout_gen:
            prev_cqs = self._reusable[1]
        self._reusable = None
        self._handout_gen += 1
        snap._handout_gen = self._handout_gen
        cohort_shells: dict = {}
        for cname, cohort in self._cohorts.items():
            # The monotonic capacity version (see Cache.snapshot's full
            # build): refreshed on every handout.
            cohort.allocatable_resource_generation = cache._capacity_version
            cohort_shells[cname] = cohort.clone_shell()
        for cname, cohort in self._cohorts.items():
            if cohort.parent is not None:
                shell = cohort_shells[cname]
                parent = cohort_shells[cohort.parent.name]
                shell.parent = parent
                parent.child_cohorts.add(shell)
        # Hot loop (2k CQs per cycle): a shell is a bare __dict__ copy of
        # the master — _shared=True rides along from the master's stamp —
        # with `cohort` rewired into this handout's cohort shells.
        snap_cqs = snap.cluster_queues
        new = ClusterQueueSnapshot.__new__
        cls = ClusterQueueSnapshot
        fresh_cqs = self._fresh_cqs
        for name, mcq in self._cqs.items():
            shell = prev_cqs.get(name) if prev_cqs is not None else None
            if shell is not None and shell._shared \
                    and name not in fresh_cqs:
                self.shell_reuses += 1
            else:
                shell = new(cls)
                shell.__dict__.update(mcq.__dict__)
            cohort = mcq.cohort
            if cohort is not None:
                cohort_shell = cohort_shells[cohort.name]
                shell.cohort = cohort_shell
                cohort_shell.members.add(shell)
            else:
                shell.cohort = None
            snap_cqs[name] = shell
        # Everything just handed out is shared again: master-side COW
        # re-privatizes on demand. Hidden masters never ship, so they
        # stay permanently fresh.
        self._fresh_cqs = set(self._hidden)
        self._fresh_cohorts = set()
        return snap
