"""The port's incremental and light snapshots (kueue_tpu_torch/cache/
incremental.py, snapshot.py, cache.py) against the JAX package's.

Every scenario runs the same operations, on the same objects (the JAX
package's api objects, converted field by field for the port), on a
Cache of each package. After each snapshot the port's handout is held
equal to the JAX maintainer's handout (every CQ's workload keys,
not-ready set, usage, quotas, admission checks, weights, policies,
generations, resource groups, cohort and DRF share; every cohort's
usage, subtree quota, generation, members and parent; the epochs,
journal position and inactive set), and each package's handout to a
from-scratch rebuild of its own cache (tests/test_incremental_snapshot.
assert_snapshots_equal, the JAX test's own oracle); the snapshot_stats
mode of every snapshot (full, incremental, partial, light) must be the
same sequence on both. No tolerance: everything compared is an integer,
a name or a set. The cases are those of
tests/test_incremental_snapshot.py: the randomized interleaved
operations (24 seeds), the partial and full fallbacks, pods-ready
replay and the hidden masters of inactive CQs, light snapshots and the
background catch-up, copy-on-write, shell reuse and stale release, the
journal overflow races, and the three-cycle steady state through each
package's Scheduler.
"""

import dataclasses
import random
from enum import Enum

import pytest

from kueue_tpu.api import kueue as japi
from kueue_tpu.cache import Cache as JaxCache
from kueue_tpu.core import workload as jwlpkg
from kueue_tpu.core.resources import FlavorResource as JaxFR
from kueue_tpu_torch.cache import Cache as TorchCache
from kueue_tpu_torch.core.resources import FlavorResource as TorchFR
from tests.test_incremental_snapshot import (
    admitted_workload,
    assert_snapshots_equal,
    make_cq,
)
from tests.test_torch_scheduler import Env as SchedEnv
from tests.test_torch_scheduler import to_pkg
from tests.wrappers import (
    ClusterQueueWrapper,
    WorkloadWrapper,
    flavor_quotas,
    make_cohort,
    make_flavor,
)

PKG = "kueue_tpu_torch"
MODES = ("full", "incremental", "partial", "light")


def canon(obj):
    """A package-free value of obj: dataclasses and enums by class name
    and fields, containers sorted where unordered."""
    if isinstance(obj, Enum):
        return (type(obj).__name__, obj.name)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, canon(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return tuple(sorted((canon(k), canon(v)) for k, v in obj.items()))
    if isinstance(obj, (set, frozenset)):
        return tuple(sorted(canon(x) for x in obj))
    if isinstance(obj, (list, tuple)):
        return tuple(canon(x) for x in obj)
    return obj


def cohort_closure(snap) -> dict:
    out, stack = {}, []
    for cq in snap.cluster_queues.values():
        cohort = cq.cohort
        while cohort is not None and cohort.name not in out:
            out[cohort.name] = cohort
            stack.append(cohort)
            cohort = cohort.parent
    while stack:
        for child in stack.pop().child_cohorts:
            if child.name not in out:
                out[child.name] = child
                stack.append(child)
    return out


def view(snap) -> dict:
    """Everything a handout holds that a cycle reads, package-free."""
    cqs = {}
    for name, cq in snap.cluster_queues.items():
        cqs[name] = dict(
            workloads=sorted(cq.workloads),
            not_ready=sorted(cq.workloads_not_ready),
            usage=canon(cq.resource_node.usage),
            quotas=canon(cq.resource_node.quotas),
            subtree_quota=canon(cq.resource_node.subtree_quota),
            checks=canon(cq.admission_checks),
            fair_weight=cq.fair_weight,
            preemption=canon(cq.preemption),
            selector=canon(cq.namespace_selector),
            fungibility=canon(cq.flavor_fungibility),
            generation=cq.allocatable_resource_generation,
            groups=canon(cq.resource_groups),
            cohort=cq.cohort.name if cq.cohort is not None else None,
            share=cq.dominant_resource_share())
    cohorts = {
        name: dict(usage=canon(c.resource_node.usage),
                   subtree_quota=canon(c.resource_node.subtree_quota),
                   generation=c.allocatable_resource_generation,
                   members=sorted(m.name for m in c.members),
                   parent=c.parent.name if c.parent else None)
        for name, c in cohort_closure(snap).items()}
    return dict(cqs=cqs, cohorts=cohorts,
                inactive=sorted(snap.inactive_cluster_queue_sets),
                epochs=(snap.cohort_epoch, snap.flavor_spec_epoch,
                        snap.topology_epoch, snap.journal_seq),
                flavors=sorted(snap.resource_flavors), light=snap.light)


class Both:
    """A JAX Cache and a port Cache driven by the same operations."""

    def __init__(self, **kwargs):
        self.jax = JaxCache(**kwargs)
        self.port = TorchCache(**kwargs)
        self.modes = {"jax": [], "port": []}

    def each(self):
        """(cache, to-package conversion, FlavorResource class)."""
        yield self.jax, (lambda o: o), JaxFR
        yield self.port, (lambda o: to_pkg(o, PKG)), TorchFR

    def do(self, method: str, *objs, **kwargs):
        out = []
        for cache, conv, _ in self.each():
            out.append(getattr(cache, method)(*(conv(o) for o in objs),
                                              **kwargs))
        return out

    def snapshot(self, light=False, ctx="") -> tuple:
        """Both caches' handouts, held equal to each other; each side's
        mode is recorded."""
        snaps = []
        for key, (cache, _, _) in zip(("jax", "port"), self.each()):
            before = dict(cache.snapshot_stats)
            snaps.append(cache.snapshot(light=light))
            moved = [m for m in MODES
                     if cache.snapshot_stats[m] != before[m]]
            assert len(moved) == 1, (ctx, moved)
            self.modes[key].append(moved[0])
        assert view(snaps[0]) == view(snaps[1]), ctx
        assert self.modes["jax"] == self.modes["port"], ctx
        return tuple(snaps)

    def check(self, ctx=""):
        """A full snapshot of both, each also equal to a rebuild of its
        own cache."""
        snaps = self.snapshot(ctx=ctx)
        for snap, (cache, _, _) in zip(snaps, self.each()):
            assert_snapshots_equal(snap, cache._build_snapshot(), ctx)
        return snaps

    def stats(self) -> tuple:
        return self.jax.snapshot_stats, self.port.snapshot_stats

    def maintainer_counts(self) -> tuple:
        def counts(m):
            return (m.full_rebuilds, m.incremental_advances,
                    m.partial_rebuilds, m.background_advances,
                    m.shell_reuses)
        return (counts(self.jax._maintainer),
                counts(self.port._maintainer))


def build_both(**kwargs) -> Both:
    """tests/test_incremental_snapshot.build_cache on both packages."""
    b = Both(**kwargs)
    b.do("add_or_update_resource_flavor", make_flavor("f0"))
    b.do("add_or_update_resource_flavor", make_flavor("f1"))
    b.do("add_or_update_cohort", make_cohort("root"))
    b.do("add_or_update_cohort",
         make_cohort("left", "root", flavor_quotas("f0", cpu="8")))
    b.do("add_or_update_cohort", make_cohort("right", "root"))
    for i, (cohort, lending) in enumerate(
            [("left", None), ("left", 4), ("left", None),
             ("right", 2), ("right", None), ("", None)]):
        b.do("add_cluster_queue", make_cq(f"cq{i}", cohort, lending=lending))
    return b


def usage(snap, cq: str, fr_cls) -> int:
    return snap.cluster_queues[cq].usage_for(fr_cls("f0", "cpu"))


def test_default_cache_is_incremental():
    cache = TorchCache()
    assert cache._maintainer is not None
    assert "snapshot" in cache._journal_cursors
    assert TorchCache(incremental_snapshots=False)._maintainer is None


# --- randomized interleavings (tests/test_incremental_snapshot.py:130) ---

CQ_COHORT = {0: "left", 1: "left", 2: "left", 3: "right", 4: "right",
             5: ""}
CQ_LENDING = {1: 4, 3: 2}


def run_interleaved(seed: int, steps: int) -> Both:
    rng = random.Random(seed)
    b = build_both()
    admitted: dict = {}
    assumed: dict = {}
    extra_cqs: list = []
    counter = [0]

    def fresh_name():
        counter[0] += 1
        return f"w{counter[0]}"

    def cq_pool():
        return [f"cq{i}" for i in range(6)] + extra_cqs

    def op_admit():
        wl = admitted_workload(fresh_name(), rng.choice(cq_pool()),
                               rng.randint(1, 5),
                               flavor=rng.choice(["f0", "f1"]))
        b.do("add_or_update_workload", wl)
        admitted[jwlpkg.key(wl)] = wl

    def op_assume():
        wl = admitted_workload(fresh_name(), rng.choice(cq_pool()),
                               rng.randint(1, 5))
        b.do("assume_workload", wl)
        assumed[jwlpkg.key(wl)] = wl

    def op_forget():
        if assumed:
            b.do("forget_workload", assumed.pop(rng.choice(sorted(assumed))))

    def op_delete():
        if admitted:
            b.do("delete_workload", admitted.pop(rng.choice(sorted(admitted))))

    def op_cq_nonstructural():
        i = rng.randrange(6)
        b.do("update_cluster_queue", make_cq(
            f"cq{i}", CQ_COHORT[i], lending=CQ_LENDING.get(i),
            preemption=rng.choice([japi.PREEMPTION_NEVER,
                                   japi.PREEMPTION_LOWER_PRIORITY])))

    def op_cq_structural():
        b.do("update_cluster_queue",
             make_cq("cq0", "left", nominal=rng.randint(8, 12)))

    def op_flavor():
        b.do("add_or_update_resource_flavor",
             make_flavor("f1", node_labels={"zone": str(rng.random())}))

    def op_cohort():
        b.do("add_or_update_cohort", make_cohort(
            "left", "root", flavor_quotas("f0", cpu=rng.randint(6, 10))))

    def op_add_cq():
        name = f"xcq{len(extra_cqs)}"
        b.do("add_cluster_queue", make_cq(name, "right"))
        extra_cqs.append(name)

    def op_del_cq():
        if extra_cqs:
            name = extra_cqs.pop()
            for pool in (admitted, assumed):
                for key in [k for k, wl in pool.items()
                            if wl.status.admission.cluster_queue == name]:
                    pool.pop(key)
            b.do("delete_cluster_queue", name)

    def op_light():
        b.snapshot(light=True, ctx="light")

    ops = ([op_admit] * 8 + [op_assume] * 4 + [op_forget] * 3
           + [op_delete] * 5 + [op_cq_nonstructural] * 3
           + [op_cq_structural] + [op_flavor] + [op_cohort]
           + [op_add_cq] + [op_del_cq] + [op_light])
    b.check("initial")
    for step in range(steps):
        rng.choice(ops)()
        b.check(f"seed {seed} step {step}")
    return b


@pytest.mark.parametrize("seed", range(24))
def test_interleaved_ops_equal_jax_and_rebuild(seed):
    b = run_interleaved(4242 + seed, 160)
    jstats, pstats = b.stats()
    assert jstats == pstats
    assert pstats["incremental"] > 20, pstats
    assert pstats["full"] + pstats["partial"] > 2, pstats
    assert b.maintainer_counts()[0] == b.maintainer_counts()[1]


def test_single_cq_edit_storm_stays_partial():
    rng = random.Random(777)
    b = build_both()
    b.check("initial")
    full_before = b.port.snapshot_stats["full"]
    admitted: list = []
    nominal = {i: 10 for i in range(6)}
    for step in range(120):
        roll = rng.random()
        if roll < 0.5:
            wl = admitted_workload(f"p{step}", f"cq{rng.randrange(6)}",
                                   rng.randint(1, 4),
                                   flavor=rng.choice(["f0", "f1"]))
            b.do("add_or_update_workload", wl)
            admitted.append(wl)
        elif roll < 0.7 and admitted:
            b.do("delete_workload", admitted.pop(rng.randrange(len(admitted))))
        else:
            i = rng.randrange(6)
            nominal[i] += rng.choice([-1, 1, 2])
            b.do("update_cluster_queue", make_cq(
                f"cq{i}", CQ_COHORT[i], nominal=nominal[i],
                lending=CQ_LENDING.get(i)))
        b.check(f"partial-storm step {step}")
    assert b.port.snapshot_stats["full"] == full_before
    assert b.port.snapshot_stats["partial"] > 20
    assert b.stats()[0] == b.stats()[1]


# --- partial and full fallbacks (:225-340) ---

def test_multiple_dirty_cqs_rebuild_in_one_partial_sync():
    b = build_both()
    b.do("add_or_update_workload", admitted_workload("w1", "cq0", 3))
    b.do("add_or_update_workload", admitted_workload("w2", "cq3", 2))
    b.check("pre")
    partial_before = b.port.snapshot_stats["partial"]
    full_before = b.port.snapshot_stats["full"]
    b.do("update_cluster_queue", make_cq("cq0", "left", nominal=14))
    b.do("add_or_update_workload", admitted_workload("w3", "cq4", 1))
    b.do("update_cluster_queue", make_cq("cq3", "right", nominal=7,
                                         lending=2))
    _, snap = b.check("two dirty CQs")
    assert b.port.snapshot_stats["partial"] == partial_before + 1
    assert b.port.snapshot_stats["full"] == full_before
    live = b.port.hm.cluster_queues
    for name in ("cq0", "cq3"):
        assert snap.cluster_queues[name].resource_node.quotas \
            == live[name].resource_node.quotas, name
    assert "default/w3" in snap.cluster_queues["cq4"].workloads


@pytest.mark.parametrize("case", ["edge_move", "wider_epoch"])
def test_structural_fallbacks_to_full(case):
    b = build_both()
    b.check("pre")
    full_before = b.port.snapshot_stats["full"]
    partial_before = b.port.snapshot_stats["partial"]
    if case == "edge_move":
        # same quota, another cohort: the graph's shape moved
        b.do("update_cluster_queue", make_cq("cq0", "right"))
        b.check("edge move")
        assert b.port.snapshot_stats["full"] == full_before + 1
        return
    b.do("update_cluster_queue", make_cq("cq1", "left", nominal=13,
                                         lending=4))
    b.do("add_or_update_resource_flavor",
         make_flavor("f1", node_labels={"zone": "z9"}))
    b.check("mixed")
    assert b.port.snapshot_stats["full"] == full_before + 1
    assert b.port.snapshot_stats["partial"] == partial_before
    # the dirty scope was consumed: the next single-CQ edit is partial
    b.do("update_cluster_queue", make_cq("cq1", "left", nominal=9,
                                         lending=4))
    b.check("post-mixed edit")
    assert b.port.snapshot_stats["partial"] == partial_before + 1


def test_terminate_cluster_queue_takes_partial_path():
    b = build_both()
    b.do("add_or_update_workload", admitted_workload("w1", "cq2", 2))
    b.check("pre")
    partial_before = b.port.snapshot_stats["partial"]
    b.do("terminate_cluster_queue", "cq2")
    _, snap = b.check("terminated")
    assert b.port.snapshot_stats["partial"] == partial_before + 1
    assert "cq2" not in snap.cluster_queues
    assert "cq2" in snap.inactive_cluster_queue_sets


def test_journal_overflow_falls_back_to_rebuild():
    b = build_both()
    for cache, _, _ in b.each():
        cache._journal_cap = 5
    b.check("pre")
    full_before = b.port.snapshot_stats["full"]
    wls = [admitted_workload(f"o{i}", f"cq{i % 6}", 1) for i in range(12)]
    for wl in wls:
        b.do("add_or_update_workload", wl)
    b.check("overflowed")
    assert b.port.snapshot_stats["full"] == full_before + 1
    incr_before = b.port.snapshot_stats["incremental"]
    b.do("delete_workload", wls[0])
    b.check("post-overflow delta")
    assert b.port.snapshot_stats["incremental"] == incr_before + 1


# --- pods-ready replay and hidden-CQ bubbling (:342-366) ---

def test_pods_ready_tracking_replay():
    b = build_both(pods_ready_tracking=True)
    b.check("initial")
    wl = admitted_workload("w1", "cq0", 3)
    b.do("add_or_update_workload", wl)
    _, snap = b.check("unready")
    assert snap.cluster_queues["cq0"].workloads_not_ready == {"default/w1"}
    b.do("mark_workload_pods_ready", wl)
    _, snap = b.check("ready")
    assert not snap.cluster_queues["cq0"].workloads_not_ready


def test_inactive_cq_usage_bubbles_through_replay():
    b = build_both()
    ghost = (ClusterQueueWrapper("ghost").cohort("left")
             .resource_group(flavor_quotas("missing", cpu="10")).obj())
    b.do("add_cluster_queue", ghost)
    assert not b.port.cluster_queue_active("ghost")
    b.check("inactive added")
    b.do("add_or_update_workload", admitted_workload("g1", "ghost", 4))
    _, snap = b.check("inactive usage")
    assert "ghost" not in snap.cluster_queues
    left = snap.cluster_queues["cq0"].cohort
    assert left.resource_node.usage.get(TorchFR("f0", "cpu"), 0) >= 4000


def test_consumed_entries_drop_their_info_payload():
    b = build_both()
    b.do("enable_usage_journal")  # a solver cursor, never drained
    for i in range(6):
        b.do("add_or_update_workload", admitted_workload(f"w{i}", "cq0", 1))
    b.check("adds consumed")
    for cache, _, _ in b.each():
        assert cache._journal
        assert all(e[5] is None for e in cache._journal)
        entries, overflow = cache.drain_usage_journal(
            cache._journal_seq, consumer="solver")
        assert not overflow and len(entries) == 6
        assert all(e[1] == "add" and e[4] for e in entries)


# --- light snapshots and catch-up (:387, :516) ---

def test_light_snapshots_do_not_disturb_the_maintainer():
    b = build_both()
    b.check("initial")
    b.do("add_or_update_workload", admitted_workload("w1", "cq0", 2))
    for _ in range(3):
        snaps = b.snapshot(light=True, ctx="light")
        assert all(s.light for s in snaps)
    incr_before = b.port.snapshot_stats["incremental"]
    b.check("after lights")
    assert b.port.snapshot_stats["incremental"] == incr_before + 1


def test_light_snapshot_rejects_writes():
    b = build_both()
    wl = admitted_workload("w1", "cq0", 2)
    b.do("add_or_update_workload", wl)
    for snap, (cache, conv, fr) in zip(b.snapshot(light=True), b.each()):
        cq = snap.cluster_queues["cq0"]
        info = cq.workloads["default/w1"]
        with pytest.raises(RuntimeError, match="light"):
            cq.add_usage({fr("f0", "cpu"): 1})
        with pytest.raises(RuntimeError, match="light"):
            cq.remove_usage({fr("f0", "cpu"): 1})
        with pytest.raises(RuntimeError, match="light"):
            snap.remove_workload(info)
        with pytest.raises(RuntimeError, match="light"):
            snap.add_workload(info)
        cache.release_snapshot(snap)  # a no-op for a light one
        assert cache.live_handouts == 0


def test_light_stretch_catches_up_before_cursor_overflow():
    b = build_both()
    b.check("establish")
    for cache, _, _ in b.each():
        cache._journal_cap = 40
    for i in range(60):
        b.do("add_or_update_workload",
             admitted_workload(f"bg{i}", f"cq{i % 3}", 1))
        b.snapshot(light=True, ctx=f"light {i}")
    m = b.port._maintainer
    assert m.background_advances > 0
    full_before = m.full_rebuilds
    b.check("sync after light stretch")
    assert m.full_rebuilds == full_before
    assert b.maintainer_counts()[0] == b.maintainer_counts()[1]


# --- copy-on-write (:400-450) ---

def test_cycle_mutation_does_not_poison_the_persistent_copy():
    b = build_both()
    b.do("add_or_update_workload", admitted_workload("w1", "cq0", 8))
    s1s = b.snapshot()
    for s1, (_, _, fr) in zip(s1s, b.each()):
        info = s1.cluster_queues["cq0"].workloads["default/w1"]
        s1.remove_workload(info)  # preemption simulation
        s1.cluster_queues["cq1"].add_usage({fr("f0", "cpu"): 1000})
    s2s = b.check("after mutation")
    for s1, s2, (_, _, fr) in zip(s1s, s2s, b.each()):
        assert usage(s2, "cq0", fr) == 8000
        assert usage(s2, "cq1", fr) == 0
        assert "default/w1" in s2.cluster_queues["cq0"].workloads
        assert usage(s1, "cq0", fr) == 0
        assert usage(s1, "cq1", fr) == 1000
    assert view(s1s[0]) == view(s1s[1])


def test_handout_is_frozen_at_its_journal_seq():
    b = build_both()
    wl = admitted_workload("w1", "cq0", 8)
    b.do("add_or_update_workload", wl)
    s1s = b.snapshot()
    b.do("delete_workload", wl)
    s2s = b.check("after delete")
    for s1, s2, (_, _, fr) in zip(s1s, s2s, b.each()):
        assert usage(s1, "cq0", fr) == 8000
        assert "default/w1" in s1.cluster_queues["cq0"].workloads
        assert usage(s2, "cq0", fr) == 0
        s1.cluster_queues["cq0"].add_usage({fr("f0", "cpu"): 500})
    b.check("after stale mutation")


def test_cohort_chain_cow_covers_sibling_subtrees():
    b = build_both()
    b.do("add_or_update_workload", admitted_workload("w1", "cq0", 12))
    for s1, (_, _, fr) in zip(b.snapshot(), b.each()):
        s1.remove_workload(s1.cluster_queues["cq0"].workloads["default/w1"])
        s1.cluster_queues["cq3"].add_usage({fr("f0", "cpu"): 7000})
    for s2, (_, _, fr) in zip(b.check("after sibling mutations"), b.each()):
        root = s2.cluster_queues["cq3"].cohort.root()
        assert root.resource_node.usage.get(fr("f0", "cpu"), 0) == 12000


# --- shell reuse and stale release (:452-510) ---

def test_released_handout_shells_are_recycled():
    b = build_both()
    b.do("add_or_update_workload", admitted_workload("w1", "cq0", 2))
    s1s = b.check("initial")
    shells = []
    for s1, (cache, _, _) in zip(s1s, b.each()):
        cache.release_snapshot(s1)
        shells.append(dict(s1.cluster_queues))
    b.do("add_or_update_workload", admitted_workload("w2", "cq1", 3))
    s2s = b.check("after release")
    for s2, old, (cache, _, _) in zip(s2s, shells, b.each()):
        assert cache._maintainer.shell_reuses > 0
        assert s2.cluster_queues["cq2"] is old["cq2"]
        assert s2.cluster_queues["cq1"] is not old["cq1"]
        assert cache.live_handouts == 1
    assert b.maintainer_counts()[0] == b.maintainer_counts()[1]


@pytest.mark.parametrize("case", ["materialized", "unreleased", "stale"])
def test_shells_not_recycled(case):
    b = build_both()
    b.do("add_or_update_workload", admitted_workload("w1", "cq0", 2))
    s1s = b.snapshot()
    for s1, (cache, _, fr) in zip(s1s, b.each()):
        if case == "materialized":
            s1.cluster_queues["cq3"].add_usage({fr("f0", "cpu"): 1000})
            cache.release_snapshot(s1)
    if case == "stale":
        b.snapshot()  # a newer handout exists
        for s1, (cache, _, _) in zip(s1s, b.each()):
            cache.release_snapshot(s1)  # stale: never enters the pool
    s2s = b.check(case)
    for s1, s2, (_, _, fr) in zip(s1s, s2s, b.each()):
        names = ["cq3"] if case == "materialized" else list(s1.cluster_queues)
        for name in names:
            assert s2.cluster_queues[name] is not s1.cluster_queues[name]
        assert usage(s2, "cq3", fr) == 0
    assert b.maintainer_counts()[0] == b.maintainer_counts()[1]


# --- journal overflow races (:537-609) ---

def test_overflow_during_catch_up_rebuilds_exactly_once():
    b = build_both()
    b.do("enable_usage_journal")
    b.check("establish")
    for cache, _, _ in b.each():
        cache._journal_cap = 10
    full_before = b.port._maintainer.full_rebuilds
    for i in range(18):
        b.do("add_or_update_workload",
             admitted_workload(f"r{i}", f"cq{i % 6}", 1))
    b.snapshot(light=True)
    assert b.port._maintainer.full_rebuilds == full_before + 1
    b.do("add_or_update_workload", admitted_workload("post", "cq1", 2))
    b.check("post-overflow sync")
    assert b.port._maintainer.full_rebuilds == full_before + 1
    for cache, _, _ in b.each():
        # the solver's overflow, seen once, apart from the maintainer's
        assert cache.drain_usage_journal(cache._journal_seq,
                                         consumer="solver")[1]
        assert not cache.drain_usage_journal(cache._journal_seq,
                                             consumer="solver")[1]
    assert b.maintainer_counts()[0] == b.maintainer_counts()[1]


def test_solver_overflow_does_not_rebuild_the_snapshot():
    # a lagging solver consumer overflows; the maintainer, draining
    # every snapshot, keeps its incremental path
    b = build_both()
    b.do("enable_usage_journal")
    b.check("establish")
    for cache, _, _ in b.each():
        cache._journal_cap = 6
    full_before = b.port._maintainer.full_rebuilds
    for i in range(20):
        b.do("add_or_update_workload",
             admitted_workload(f"s{i}", f"cq{i % 6}", 1))
        b.check(f"step {i}")
    assert b.port._maintainer.full_rebuilds == full_before
    for cache, _, _ in b.each():
        assert cache.journal_overflowed("solver")
        assert not cache.journal_overflowed("snapshot")


def test_released_shells_are_not_recycled_across_a_rebuild():
    b = build_both()
    s1s = b.snapshot()
    for s1, (cache, _, _) in zip(s1s, b.each()):
        cache.release_snapshot(s1)
        cache._journal_cap = 4
    for i in range(10):
        b.do("add_or_update_workload", admitted_workload(f"x{i}", "cq0", 1))
    full_before = b.port._maintainer.full_rebuilds
    s2s = b.check("post-overflow")
    assert b.port._maintainer.full_rebuilds == full_before + 1
    for s1, s2 in zip(s1s, s2s):
        for name in s1.cluster_queues:
            assert s2.cluster_queues[name] is not s1.cluster_queues[name]


def test_double_release_same_handout_is_a_guarded_noop():
    b = build_both()
    b.do("add_or_update_workload", admitted_workload("w1", "cq0", 2))
    s1s = b.snapshot()
    for s1, (cache, _, _) in zip(s1s, b.each()):
        cache.release_snapshot(s1)
        cache.release_snapshot(s1)
        assert cache.live_handouts == 0
    s2s = b.check("after double release")
    for s1, (cache, _, _) in zip(s1s, b.each()):
        cache.release_snapshot(s1)
    s3s = b.check("after stale re-release")
    for s2, s3 in zip(s2s, s3s):
        for name in s3.cluster_queues:
            assert s3.cluster_queues[name] is not s2.cluster_queues[name]


# --- through the Scheduler (:491, :612) ---

def sched_pair():
    """tests/test_torch_scheduler.Env of both packages on the CPU route
    (the port's with no solver: the JAX test's plain Scheduler)."""
    envs = []
    for pkg in ("kueue_tpu", PKG):
        env = SchedEnv(pkg, "cpu")
        env.scheduler.solver = None
        env.add_flavor("default")
        envs.append(env)
    return envs


def test_three_cycle_steady_state_takes_the_incremental_path():
    envs = sched_pair()
    for env in envs:
        env.add_cq(ClusterQueueWrapper("cq")
                   .resource_group(flavor_quotas("default", cpu="100"))
                   .obj(), "lq")
    for i in range(3):
        for env in envs:
            env.submit(WorkloadWrapper(f"w{i}").queue("lq")
                       .pod_set(count=1, cpu="1").obj())
            env.cycle()
            assert f"default/w{i}" in env.client.applied
    for env in envs:
        stats = env.cache.snapshot_stats
        assert stats["full"] == 1 and stats["incremental"] == 2, stats
        m = env.cache._maintainer
        assert m.full_rebuilds == 1 and m.incremental_advances == 2
        assert env.cache.live_handouts == 0  # every cycle released its own
    assert envs[1].scheduler._cycle_snapshot is None


def test_reuse_through_scheduler_cycles():
    envs = sched_pair()
    for env in envs:
        for c in range(3):
            env.add_cq(ClusterQueueWrapper(f"cq{c}")
                       .resource_group(flavor_quotas("default", cpu="100"))
                       .obj(), f"lq{c}")
    for i in range(4):
        for env in envs:
            env.submit(WorkloadWrapper(f"w{i}").queue("lq0")
                       .pod_set(count=1, cpu="1").obj())
            env.cycle()
            assert f"default/w{i}" in env.client.applied
    reuses = [env.cache._maintainer.shell_reuses for env in envs]
    assert reuses[0] == reuses[1] > 0


def test_solver_takes_its_own_full_snapshot_off_a_light_one():
    """A bound solver handed a light snapshot on an establishing cycle
    encodes the topology and the state off full snapshots of its own and
    releases them (kueue_tpu/solver/service.py:916-943, :1062-1065); its
    decisions equal those off a full snapshot, and it holds no handout."""
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import BatchSolver
    got = []
    for light in (True, False):
        cache, queues = ns.build_cluster(16, 4, ["f0", "f1"], 40)
        ns.stage_waves(queues, 2, 16, 40)
        solver = BatchSolver(device="cpu")
        solver.bind_cache(cache)
        solver.bind_queues(queues)
        heads = queues.heads_nonblocking()
        snap = cache.snapshot(light=light)
        taken = cache.handouts_taken
        plan = solver.prepare(snap, heads)
        decisions, _ = solver.solve_prepared(plan, snap)
        assert cache.handouts_taken - taken == (2 if light else 0)
        assert cache.live_handouts == (0 if light else 1)
        assert solver.resident is not None
        got.append({heads[i].key: (a.pod_sets, ok)
                    for i, (a, ok) in decisions.items()})
    assert got[0] == got[1] and len(got[0]) == 16
