"""The north-star deployment on the port's object model, driven through
the port's queue Manager.

The cluster is the flagship scenario of the JAX package's benchmark
(bench.py make_flavor / make_cq / make_workload / build_env,
BASELINE.json): ClusterQueues in cohorts, each CQ offering every flavor
with one resource group covering cpu and memory, and a LocalQueue
`lq{i}` in namespace "default" feeding `cq{i}`. Workloads are sized in
cpu units (1 unit = 1000 milli-cpu and 1 GiB).

Two ways to drive a cycle:
- the port's own Scheduler (`build_scheduler`, `SimClient`,
  `finish_applied`): the fair-sharing deployment of the JAX package's
  benchmark (bench.py bench_fair_sharing, builders bench.py:107-214),
  its preemption-heavy one (`build_preempt_reclaim`, bench.py
  bench_preemption_reclaim, with `admit_victim`), its fair-sharing
  preemption one (`build_fair_preemption`, bench.py
  bench_fair_preemption), elastic Jobs that PartialAdmission reduces
  (`build_partial_admission`) and a MultiKueue manager cluster placing its
  admissions on a fleet of worker clusters (`build_multikueue`, with
  `RemoteCapacity` standing in for the MultiKueue controller's capacity
  columns);
- the solver by hand: heads from `Manager.heads_nonblocking` (one per
  CQ), `solve`, then `apply_decisions`: admitted heads are assumed into
  the cache and handed to `solver.release_workload`, the rest are
  requeued. `finish_admitted` ends admitted workloads between cycles, as
  their jobs completing would.
"""

from __future__ import annotations

from collections import deque

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.corev1 import Container, PodSpec, PodTemplateSpec
from kueue_tpu_torch.api.meta import (
    Condition,
    FakeClock,
    LabelSelector,
    ObjectMeta,
    find_condition,
)
from kueue_tpu_torch.cache import Cache
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.queue import Manager, RequeueReason
from kueue_tpu_torch.scheduler.scheduler import Scheduler, SchedulerClient
from kueue_tpu_torch.solver import encode


def make_flavor(name: str) -> api.ResourceFlavor:
    return api.ResourceFlavor(metadata=ObjectMeta(name=name, uid=f"rf-{name}"))


def make_cq(name: str, cohort: str, flavors: list, nominal_units: int,
            queueing_strategy: str = api.BEST_EFFORT_FIFO,
            fair_weight: int = None,
            preemption: api.ClusterQueuePreemption = None,
            admission_checks: tuple = ()) -> api.ClusterQueue:
    """fair_weight: the CQ's fair-sharing weight in milli-units (None
    leaves the spec without one, which weighs 1000); preemption: the
    CQ's preemption policy (None leaves the default, Never/Never);
    admission_checks: the names of the AdmissionChecks it carries."""
    cq = api.ClusterQueue(metadata=ObjectMeta(name=name, uid=f"cq-{name}"))
    cq.spec.namespace_selector = LabelSelector()
    cq.spec.cohort = cohort
    cq.spec.queueing_strategy = queueing_strategy
    cq.spec.admission_checks = list(admission_checks)
    if preemption is not None:
        cq.spec.preemption = preemption
    if fair_weight is not None:
        cq.spec.fair_sharing = api.FairSharing(weight=fair_weight)
    cq.spec.resource_groups.append(api.ResourceGroup(
        covered_resources=["cpu", "memory"],
        flavors=[api.FlavorQuotas(name=f, resources=[
            api.ResourceQuota(name="cpu", nominal_quota=nominal_units * 1000),
            api.ResourceQuota(name="memory", nominal_quota=nominal_units << 30),
        ]) for f in flavors]))
    return cq


def make_local_queue(name: str, cluster_queue: str) -> api.LocalQueue:
    return api.LocalQueue(
        metadata=ObjectMeta(name=name, namespace="default"),
        spec=api.LocalQueueSpec(cluster_queue=cluster_queue))


def make_workload(name: str, queue: str, cpu_units: int, priority: int = 0,
                  creation: float = 0.0, count: int = 1,
                  min_count: int = None) -> api.Workload:
    """One pod set "main" of `count` pods of cpu_units each (cpu and
    GiB); with min_count, PartialAdmission may reduce it to that many."""
    wl = api.Workload(metadata=ObjectMeta(
        name=name, namespace="default", uid=f"wl-{name}",
        creation_timestamp=creation))
    wl.spec.queue_name = queue
    wl.spec.priority = priority
    spec = PodSpec(containers=[Container(
        name="c", requests={"cpu": cpu_units * 1000,
                            "memory": cpu_units << 30})])
    wl.spec.pod_sets.append(api.PodSet(
        name="main", count=count, min_count=min_count,
        template=PodTemplateSpec(spec=spec)))
    return wl


def build_cluster(num_cqs: int, num_cohorts: int, flavors: list,
                  nominal_units: int,
                  queueing_strategy: str = api.BEST_EFFORT_FIFO,
                  queues: Manager = None, fair_weights: tuple = None,
                  preemption: api.ClusterQueuePreemption = None,
                  cq_checks=None, incremental_snapshots: bool = True) -> tuple:
    """cq{i} in cohort-{i % num_cohorts}, every flavor at nominal_units,
    fed by lq{i}; with fair_weights, cq{i} weighs
    fair_weights[i % len(fair_weights)]; every CQ takes `preemption`;
    with cq_checks, cq{i} carries the AdmissionChecks cq_checks(i); the
    Cache takes incremental snapshots unless told otherwise.
    Returns (Cache, Manager)."""
    cache = Cache(incremental_snapshots=incremental_snapshots)
    queues = Manager() if queues is None else queues
    for f in flavors:
        cache.add_or_update_resource_flavor(make_flavor(f))
    for i in range(num_cqs):
        cq = make_cq(f"cq{i}", f"cohort-{i % num_cohorts}", flavors,
                     nominal_units, queueing_strategy,
                     fair_weights[i % len(fair_weights)]
                     if fair_weights else None, preemption,
                     cq_checks(i) if cq_checks else ())
        cache.add_cluster_queue(cq)
        queues.add_cluster_queue(cq)
        queues.add_local_queue(make_local_queue(f"lq{i}", f"cq{i}"))
    return cache, queues


def stage_waves(queues: Manager, waves: int, num_cqs: int,
                cpu_units: int) -> int:
    """`waves` workloads per CQ, made as the JAX package's benchmark makes
    them (bench.py _run_e2e): workload n has priority n % 5 and creation
    time n. Returns the number staged."""
    n = 0
    for wave in range(waves):
        for i in range(num_cqs):
            wl = make_workload(f"w{wave}-{i}", f"lq{i}", cpu_units=cpu_units,
                               priority=n % 5, creation=float(n))
            if not queues.add_or_update_workload(wl):
                raise ValueError(f"no queue for {wl.metadata.name}")
            n += 1
    return n


def admitted_workload(name: str, cq: str, flavor: str, cpu_units: int,
                      now: float) -> api.Workload:
    """A workload holding quota in `cq` on `flavor`, as a past admission
    left it: for filling a cluster before the first cycle."""
    wl = make_workload(name, "", cpu_units)
    wlpkg.set_quota_reservation(wl, api.Admission(
        cluster_queue=cq, pod_set_assignments=[api.PodSetAssignment(
            name="main", flavors={"cpu": flavor, "memory": flavor},
            resource_usage={"cpu": cpu_units * 1000,
                            "memory": cpu_units << 30}, count=1)]), now)
    return wl


def admit(cache: Cache, info: wlpkg.Info, assignment,
          now: float) -> api.Workload:
    """Reserve quota for an admitted head as the scheduler's admit does
    (scheduler.go:571-623): the admission goes on a status copy of the
    workload, and the cache assumes it so the next snapshot carries its
    usage. Returns the admitted copy."""
    new_wl = wlpkg.clone_for_status_update(info.obj)
    admission = api.Admission(cluster_queue=info.cluster_queue,
                              pod_set_assignments=assignment.to_api())
    wlpkg.set_quota_reservation(new_wl, admission, now)
    cq = cache.cluster_queue(info.cluster_queue)
    checks = wlpkg.admission_checks_for_workload(new_wl, cq.admission_checks)
    if wlpkg.has_all_checks(new_wl, checks):
        wlpkg.sync_admitted_condition(new_wl, now)
    cache.assume_workload(new_wl, info=wlpkg.Info.from_assignment(
        new_wl, info.cluster_queue, assignment))
    return new_wl


def apply_decisions(cache: Cache, queues: Manager, solver, heads: list,
                    decisions: dict, now: float,
                    admitted: deque = None) -> int:
    """Apply one cycle's decisions as the scheduler does: every decided
    head keeps its assignment's resume state (scheduler.go's
    `w.last_assignment = assignment.last_state`); admitted heads are
    assumed into the cache and their arena slots released
    (solver.release_workload; solver may be None when unbound); every
    other head is requeued. The admitted workloads are appended to
    `admitted` when given. Returns the number admitted."""
    n = 0
    for i, info in enumerate(heads):
        decision = decisions.get(i)
        if decision is not None:
            assignment, ok = decision
            info.last_assignment = assignment.last_state
            if ok:
                wl = admit(cache, info, assignment, now)
                if solver is not None:
                    solver.release_workload(info.key)
                if admitted is not None:
                    admitted.append(wl)
                n += 1
                continue
        queues.requeue_workload(info, RequeueReason.GENERIC)
    return n


def finish_admitted(cache: Cache, admitted: deque, count: int) -> int:
    """Finish the `count` oldest admitted workloads: their quota is
    released (cache.delete_workload), which the usage journal carries to
    a bound solver. Returns the number finished."""
    n = 0
    while admitted and n < count:
        cache.delete_workload(admitted.popleft())
        n += 1
    return n


class SimClient(SchedulerClient):
    """The sim's SchedulerClient (bench.py BenchClient): no store; counts
    admission writes and evictions, keeps the admitted workloads until
    `drain_applied` and each eviction as (workload name, Preempted
    reason) in `evictions`."""

    def __init__(self):
        self.admitted = 0
        self.evicted = 0
        self.new_applied: list = []  # admission writes since the drain
        self.evictions: list = []

    def apply_admission(self, wl: api.Workload) -> None:
        if wlpkg.is_evicted(wl):
            self.evicted += 1
            cond = find_condition(wl.status.conditions,
                                  api.WORKLOAD_PREEMPTED)
            self.evictions.append((wl.metadata.name,
                                   cond.reason if cond else ""))
        else:
            self.admitted += 1
            self.new_applied.append(wl)

    def drain_applied(self) -> list:
        out, self.new_applied = self.new_applied, []
        return out


def build_scheduler(num_cqs: int, num_cohorts: int, flavors: list,
                    nominal_units: int, solver=None,
                    fair_sharing: bool = False,
                    fair_weights: tuple = None,
                    preemption: api.ClusterQueuePreemption = None,
                    cq_checks=None) -> tuple:
    """The JAX package's benchmark environment (bench.py build_env) on
    the port: a FakeClock at 1000 s, the cluster of build_cluster and a
    Scheduler that takes the device route on every cycle when a solver
    is given (solver_min_heads 0). fair_weights, preemption and
    cq_checks as in build_cluster. Returns (Scheduler, Cache, Manager,
    SimClient)."""
    clock = FakeClock(1000.0)
    cache, queues = build_cluster(num_cqs, num_cohorts, flavors,
                                  nominal_units,
                                  queues=Manager(clock=clock),
                                  fair_weights=fair_weights,
                                  preemption=preemption,
                                  cq_checks=cq_checks)
    client = SimClient()
    sched = Scheduler(queues, cache, client, clock=clock, solver=solver,
                      solver_min_heads=0, fair_sharing_enabled=fair_sharing)
    return sched, cache, queues, client


def finish_applied(cache: Cache, queues: Manager, client: SimClient,
                   remote: "RemoteCapacity" = None) -> int:
    """The admissions since the last call finish: their quota is
    released, and each cohort's parked inadmissible workloads are queued
    again, as the workload controller does on delete (manager.go:381);
    with a MultiKueue fleet, the remote capacity each held is credited
    back. Returns the number finished."""
    done = client.drain_applied()
    for wl in done:
        cache.delete_workload(wl)
        queues.queue_associated_inadmissible_workloads_after(wl)
        if remote is not None:
            remote.release(wlpkg.key(wl))
    return len(done)


def victim_workload(name: str, lq: str, cq: str, milli: int, priority: int,
                    creation: float) -> api.Workload:
    """A workload of `milli` milli-cpu and as many MiB of memory holding
    quota in `cq` on flavor f0 since `creation` (bench.py _admit_victim,
    bench.py:1518-1533)."""
    wl = make_workload(name, lq, cpu_units=0, priority=priority,
                       creation=creation)
    wl.spec.pod_sets[0].template.spec.containers[0].requests = {
        "cpu": milli, "memory": milli << 20}
    admission = api.Admission(
        cluster_queue=cq,
        pod_set_assignments=[api.PodSetAssignment(
            name="main", flavors={"cpu": "f0", "memory": "f0"},
            resource_usage={"cpu": milli, "memory": milli << 20},
            count=1)])
    wlpkg.set_quota_reservation(wl, admission, creation)
    return wl


def admit_victim(cache: Cache, name: str, lq: str, cq: str, milli: int,
                 priority: int, creation: float) -> api.Workload:
    """victim_workload, added to the cache as an admitted workload."""
    wl = victim_workload(name, lq, cq, milli, priority, creation)
    cache.add_or_update_workload(wl)
    return wl


def reclaim_preemption() -> api.ClusterQueuePreemption:
    """The reclaim configuration's policy: LowerPriority within the CQ,
    reclaim from any borrower of the cohort tree."""
    return api.ClusterQueuePreemption(
        within_cluster_queue=api.PREEMPTION_LOWER_PRIORITY,
        reclaim_within_cohort=api.PREEMPTION_ANY)


def build_preempt_reclaim(num_roots: int = 128, children_per_root: int = 2,
                          cqs_per_child: int = 8,
                          victims_per_borrower: int = 36,
                          solver=None) -> tuple:
    """The JAX package's preemption-heavy benchmark configuration
    (bench.py bench_preemption_reclaim, bench.py:1807-1850): hierarchical
    cohorts, cq{i} in child cohort-(i % children) and child c under
    root-(c // children_per_root); one flavor f0 of 8 units (cpu and
    GiB) per CQ. cq0..cq{children-1}, one per child cohort, are idle
    lenders; every other CQ holds `victims_per_borrower` admitted
    priority-0 victims of 9 units in all (a unit over its nominal, so it
    borrows). One 8-unit preemptor of priority 10 waits in every CQ, with
    LowerPriority within the CQ and reclaimWithinCohort Any: a lender's
    reclaims from its root's borrowers, a borrower's preempts within its
    own CQ. Returns (Scheduler, Cache, Manager, SimClient)."""
    num_children = num_roots * children_per_root
    num_cqs = num_children * cqs_per_child
    sched, cache, queues, client = build_scheduler(
        num_cqs, num_children, ["f0"], 8, solver=solver,
        preemption=reclaim_preemption())
    for c in range(num_children):
        cohort = api.Cohort(metadata=ObjectMeta(name=f"cohort-{c}",
                                                uid=f"co-{c}"))
        cohort.spec.parent = f"root-{c // children_per_root}"
        cache.add_or_update_cohort(cohort)
    victim_milli = 9000 // victims_per_borrower
    for i in range(num_cqs):
        if i >= num_children:
            for v in range(victims_per_borrower):
                admit_victim(cache, f"victim{i}-{v}", f"lq{i}", f"cq{i}",
                             victim_milli, 0, float(v))
        queues.add_or_update_workload(
            make_workload(f"preemptor{i}", f"lq{i}", cpu_units=8,
                          priority=10, creation=1000.0))
    return sched, cache, queues, client


def build_fair_preemption(num_cqs: int = 2048, num_cohorts: int = 256,
                          victims_per_cq: int = 12, solver=None) -> tuple:
    """The JAX package's fair-sharing preemption benchmark configuration
    (bench.py bench_fair_preemption, bench.py:1727-1775) with fair sharing
    on: cq{i} in cohort-(i % num_cohorts), one flavor f0 of 8 units (cpu
    and GiB) per CQ, LowerPriority within the CQ and reclaimWithinCohort
    Any. Member 0 of each cohort (cq0 .. cq{num_cohorts - 1}) is idle and
    holds one 8-unit preemptor of priority 10; each other member holds
    `victims_per_cq` admitted priority-0 victims of (members * 8000 -
    2000) // (members - 1) // victims_per_cq milli-cpu (and as many MiB),
    so it borrows a little and the cohort has less than 8 units free:
    each preemptor's fairPreemptions drains the borrowers share by share
    until it fits. Returns (Scheduler, Cache, Manager, SimClient)."""
    sched, cache, queues, client = build_scheduler(
        num_cqs, num_cohorts, ["f0"], 8, solver=solver, fair_sharing=True,
        preemption=reclaim_preemption())
    members = num_cqs // num_cohorts
    victim_milli = (members * 8000 - 2000) // (members - 1) // victims_per_cq
    for i in range(num_cqs):
        if i >= num_cohorts:
            for v in range(victims_per_cq):
                admit_victim(cache, f"victim{i}-{v}", f"lq{i}", f"cq{i}",
                             victim_milli, 0, float(v))
        else:
            queues.add_or_update_workload(
                make_workload(f"preemptor{i}", f"lq{i}", cpu_units=8,
                              priority=10, creation=1000.0))
    return sched, cache, queues, client


def build_mixed_preemption(num_borrowers: int = 6, victims_per_cq: int = 12,
                           solver=None) -> tuple:
    """A fair-sharing cycle with both kinds of preemption problem: one
    cohort of num_borrowers + 2 CQs of 8 units (cpu and GiB), fair
    sharing on. cq0 is idle and its 8-unit preemptor of priority 10
    reclaims from the borrowers cq1 .. cq{num_borrowers} (a fair
    problem, K11); the last CQ may not borrow (borrowing limit 0) nor
    reclaim (reclaimWithinCohort Never) and holds its nominal quota in
    four priority-0 victims, and its 4-unit preemptor of priority 10 can
    only preempt within its own CQ (a minimal problem, K9). The
    borrowers hold `victims_per_cq` victims of what leaves 2 units of the
    cohort free. Returns (Scheduler, Cache, Manager, SimClient)."""
    clock = FakeClock(1000.0)
    cache, queues = Cache(), Manager(clock=clock)
    cache.add_or_update_resource_flavor(make_flavor("f0"))
    own_only = api.ClusterQueuePreemption(
        within_cluster_queue=api.PREEMPTION_LOWER_PRIORITY,
        reclaim_within_cohort=api.PREEMPTION_NEVER)
    last = num_borrowers + 1
    for i in range(last + 1):
        cq = make_cq(f"cq{i}", "cohort-0", ["f0"], 8,
                     preemption=own_only if i == last
                     else reclaim_preemption())
        if i == last:
            for quota in cq.spec.resource_groups[0].flavors[0].resources:
                quota.borrowing_limit = 0
        cache.add_cluster_queue(cq)
        queues.add_cluster_queue(cq)
        queues.add_local_queue(make_local_queue(f"lq{i}", f"cq{i}"))
    milli = ((last + 1) * 8000 - 8000 - 2000) // num_borrowers \
        // victims_per_cq
    for i in range(1, last):
        for v in range(victims_per_cq):
            admit_victim(cache, f"victim{i}-{v}", f"lq{i}", f"cq{i}", milli,
                         0, float(v))
    for v in range(4):
        admit_victim(cache, f"own{v}", f"lq{last}", f"cq{last}", 2000, 0,
                     float(v))
    queues.add_or_update_workload(make_workload(
        "claimant", "lq0", cpu_units=8, priority=10, creation=1000.0))
    queues.add_or_update_workload(make_workload(
        "own-high", f"lq{last}", cpu_units=4, priority=10, creation=1001.0))
    client = SimClient()
    sched = Scheduler(queues, cache, client, clock=clock, solver=solver,
                      solver_min_heads=0, fair_sharing_enabled=True)
    return sched, cache, queues, client


def build_partial_admission(num_cqs: int = 2048, num_cohorts: int = 256,
                            num_flavors: int = 32, nominal_units: int = 40,
                            cpu_units: int = 40, partial_cohorts: int = 128,
                            count: int = 512, min_count: int = 64,
                            waves: int = 8, solver=None) -> tuple:
    """Elastic Jobs under PartialAdmission on the north star:
    build_scheduler's cluster (flavors f0..f{num_flavors-1} of
    nominal_units per CQ, Never/Never preemption), `waves` waves staged
    as stage_waves stages them (workload n: priority n % 5, creation n).
    The CQs of cohorts 0..partial_cohorts-1 queue Jobs of one pod set of
    `count` pods of 1 cpu and 1 GiB that may run with min_count; with
    the north star's 8 CQs a cohort, 512 pods are more than the 320 a
    cohort holds in one flavor, so none fits whole and each searches its
    count. The other CQs queue the north star's one-pod workloads of
    cpu_units. Returns (Scheduler, Cache, Manager, SimClient)."""
    flavors = [f"f{i}" for i in range(num_flavors)]
    sched, cache, queues, client = build_scheduler(
        num_cqs, num_cohorts, flavors, nominal_units, solver=solver)
    n = 0
    for wave in range(waves):
        for i in range(num_cqs):
            if i % num_cohorts < partial_cohorts:
                wl = make_workload(f"p{wave}-{i}", f"lq{i}", cpu_units=1,
                                   priority=n % 5, creation=float(n),
                                   count=count, min_count=min_count)
            else:
                wl = make_workload(f"w{wave}-{i}", f"lq{i}",
                                   cpu_units=cpu_units, priority=n % 5,
                                   creation=float(n))
            if not queues.add_or_update_workload(wl):
                raise ValueError(f"no queue for {wl.metadata.name}")
            n += 1
    return sched, cache, queues, client


# --- MultiKueue: a manager cluster placing admissions on worker clusters ---

MK_CHECK = "mk-check"
MK_CONTROLLER = "kueue.x-k8s.io/multikueue"


def mk_admission_check(name: str = MK_CHECK) -> api.AdmissionCheck:
    """An active AdmissionCheck owned by the MultiKueue controller."""
    ac = api.AdmissionCheck(metadata=ObjectMeta(name=name, uid=f"ac-{name}"))
    ac.spec.controller_name = MK_CONTROLLER
    ac.status.conditions.append(Condition(
        type=api.ADMISSION_CHECK_ACTIVE, status="True", reason="Active"))
    return ac


class RemoteCapacity:
    """The worker clusters of a MultiKueue fleet, standing in for
    MultiKueueController.capacity_columns
    (kueue_tpu/controller/admissionchecks/multikueue.py:224-280):
    `capacity_columns` (a Cache's remote_capacity_source) stamps each
    cluster's free capacity {(flavor, resource): quantity} in sorted-name
    order, a lost cluster as active=False with no capacity; `place` (a
    Scheduler's on_placement sink) debits the workload's request
    (request_of(key)) from its cluster by the shared placement rule
    (encode.consume_remote_dicts), and `release` credits it back when the
    workload finishes. So capacity moves from cycle to cycle.
    `placements` keeps every (key, cluster) the sink received."""

    def __init__(self, clusters: dict, request_of):
        self.free = {name: dict(caps) for name, caps in clusters.items()}
        self.request_of = request_of
        self.lost: set = set()
        self.held: dict = {}  # key -> (cluster, {(flavor, resource): debit})
        self.placements: list = []

    def capacity_columns(self) -> tuple:
        cols = tuple((name, {} if name in self.lost else dict(self.free[name]),
                      name not in self.lost) for name in sorted(self.free))
        return cols, frozenset({MK_CHECK})

    def place(self, key: str, cluster: str) -> None:
        self.placements.append((key, cluster))
        caps = self.free[cluster]
        ((_, left, _),) = encode.consume_remote_dicts(
            ((cluster, caps, True),), [self.request_of(key)], [cluster])
        self.held[key] = (cluster, {fr: caps[fr] - v for fr, v in left.items()
                                    if caps[fr] != v})
        self.free[cluster] = left

    def release(self, key: str) -> None:
        cluster, debit = self.held.pop(key, (None, {}))
        for fr, v in debit.items():
            self.free[cluster][fr] += v


def multikueue_fleet(flavors: list, cpu_units: int) -> dict:
    """Five worker clusters w0..w4 in slots of one cpu_units workload
    (cpu and GiB): w0 offers the first four flavors, 32 slots each; w1
    and w2 every flavor, 11 slots each; w3 every flavor, 11 slots each,
    and a flavor unknown to the manager (`remote-only`, 4 slots); w4 the
    last flavor, 64 slots, and the one before it with cpu only (a partial
    offer that never fits)."""
    cpu, mem = cpu_units * 1000, cpu_units << 30

    def slots(fl, n, resources=("cpu", "memory")):
        per = {"cpu": cpu, "memory": mem}
        return {(f, r): n * per[r] for f in fl for r in resources}

    return {
        "w0": slots(flavors[:4], 32),
        "w1": slots(flavors, 11),
        "w2": slots(flavors, 11),
        "w3": {**slots(flavors, 11), **slots(["remote-only"], 4)},
        "w4": {**slots(flavors[-1:], 64),
               **slots(flavors[-2:-1], 64, ("cpu",))},
    }


def build_multikueue(num_cqs: int = 2048, num_cohorts: int = 256,
                     num_flavors: int = 32, nominal_units: int = 40,
                     cpu_units: int = 40, waves: int = 25, solver=None,
                     fleet: dict = None) -> tuple:
    """A MultiKueue manager cluster on the north star: build_scheduler's
    cluster (flavors f0..f{num_flavors-1}), `waves` waves of cpu_units
    workloads staged (stage_waves), the MultiKueue AdmissionCheck
    `mk-check` on every even CQ, and a RemoteCapacity over `fleet`
    (multikueue_fleet by default) with w2 lost, wired to
    cache.remote_capacity_source and sched.on_placement. Returns
    (Scheduler, Cache, Manager, SimClient, RemoteCapacity)."""
    flavors = [f"f{i}" for i in range(num_flavors)]
    sched, cache, queues, client = build_scheduler(
        num_cqs, num_cohorts, flavors, nominal_units, solver=solver,
        cq_checks=lambda i: (MK_CHECK,) if i % 2 == 0 else ())
    cache.add_or_update_admission_check(mk_admission_check())
    stage_waves(queues, waves, num_cqs, cpu_units)
    request = {"cpu": cpu_units * 1000, "memory": cpu_units << 30}
    remote = RemoteCapacity(
        fleet if fleet is not None else multikueue_fleet(flavors, cpu_units),
        lambda key: request)
    remote.lost.add("w2")
    cache.remote_capacity_source = remote.capacity_columns
    sched.on_placement = remote.place
    return sched, cache, queues, client, remote
