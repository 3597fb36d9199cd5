"""The north-star deployment on the port's object model, and a pending
heap per ClusterQueue in place of the queue manager.

The cluster is the flagship scenario of the JAX package's benchmark
(bench.py make_flavor / make_cq / make_workload / build_env,
BASELINE.json): ClusterQueues in cohorts, each CQ offering every flavor
with one resource group covering cpu and memory. Workloads are sized in
cpu units (1 unit = 1000 milli-cpu and 1 GiB).

`PendingHeaps` keeps each CQ's pending workloads in the queue's own
order (priority descending, then queue-order timestamp; the JAX
package's queue/cluster_queue.py:34-39). A cycle takes the top of every
non-empty heap as its heads; an admitted head is popped, a head that is
not admitted stays on top for the next cycle.
"""

from __future__ import annotations

import heapq
import itertools

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.corev1 import Container, PodSpec, PodTemplateSpec
from kueue_tpu_torch.api.meta import LabelSelector, ObjectMeta
from kueue_tpu_torch.cache import Cache
from kueue_tpu_torch.core import priority as prioritypkg
from kueue_tpu_torch.core import workload as wlpkg


def make_flavor(name: str) -> api.ResourceFlavor:
    return api.ResourceFlavor(metadata=ObjectMeta(name=name, uid=f"rf-{name}"))


def make_cq(name: str, cohort: str, flavors: list,
            nominal_units: int) -> api.ClusterQueue:
    cq = api.ClusterQueue(metadata=ObjectMeta(name=name, uid=f"cq-{name}"))
    cq.spec.namespace_selector = LabelSelector()
    cq.spec.cohort = cohort
    cq.spec.resource_groups.append(api.ResourceGroup(
        covered_resources=["cpu", "memory"],
        flavors=[api.FlavorQuotas(name=f, resources=[
            api.ResourceQuota(name="cpu", nominal_quota=nominal_units * 1000),
            api.ResourceQuota(name="memory", nominal_quota=nominal_units << 30),
        ]) for f in flavors]))
    return cq


def make_workload(name: str, queue: str, cpu_units: int, priority: int = 0,
                  creation: float = 0.0) -> api.Workload:
    wl = api.Workload(metadata=ObjectMeta(
        name=name, namespace="default", uid=f"wl-{name}",
        creation_timestamp=creation))
    wl.spec.queue_name = queue
    wl.spec.priority = priority
    spec = PodSpec(containers=[Container(
        name="c", requests={"cpu": cpu_units * 1000,
                            "memory": cpu_units << 30})])
    wl.spec.pod_sets.append(api.PodSet(
        name="main", count=1, template=PodTemplateSpec(spec=spec)))
    return wl


def build_cluster(num_cqs: int, num_cohorts: int, flavors: list,
                  nominal_units: int) -> Cache:
    """cq{i} in cohort-{i % num_cohorts}, every flavor at nominal_units."""
    cache = Cache()
    for f in flavors:
        cache.add_or_update_resource_flavor(make_flavor(f))
    for i in range(num_cqs):
        cache.add_cluster_queue(make_cq(f"cq{i}", f"cohort-{i % num_cohorts}",
                                        flavors, nominal_units))
    return cache


# queue-order timestamps under the default policy
_ORDERING = wlpkg.Ordering()


class PendingHeaps:
    """Per-CQ pending heaps in queue order (priority desc, then
    queue-order timestamp asc, then arrival)."""

    def __init__(self):
        self._heaps: dict = {}
        self._seq = itertools.count()

    def push(self, info: wlpkg.Info) -> None:
        key = (-prioritypkg.priority(info.obj),
               _ORDERING.queue_order_timestamp(info.obj), next(self._seq))
        heapq.heappush(self._heaps.setdefault(info.cluster_queue, []),
                       (key, info))

    def heads(self) -> list:
        """The top of every non-empty heap, in CQ-name order."""
        return [h[0][1] for _, h in sorted(self._heaps.items()) if h]

    def pop(self, info: wlpkg.Info) -> None:
        """Remove an admitted head (it is the top of its heap)."""
        heap = self._heaps[info.cluster_queue]
        if heap[0][1] is not info:
            raise ValueError(f"{info.key} is not the head of its queue")
        heapq.heappop(heap)

    def __len__(self) -> int:
        return sum(len(h) for h in self._heaps.values())


def stage_waves(heaps: PendingHeaps, waves: int, num_cqs: int,
                cpu_units: int) -> int:
    """`waves` workloads per CQ, made as the JAX package's benchmark makes
    them (bench.py _run_e2e): workload n has priority n % 5 and creation
    time n. Returns the number staged."""
    n = 0
    for wave in range(waves):
        for i in range(num_cqs):
            wl = make_workload(f"w{wave}-{i}", f"lq{i}", cpu_units=cpu_units,
                               priority=n % 5, creation=float(n))
            heaps.push(wlpkg.Info(wl, cluster_queue=f"cq{i}"))
            n += 1
    return n


def admit(cache: Cache, info: wlpkg.Info, assignment, now: float) -> None:
    """Reserve quota for an admitted head as the scheduler's admit does
    (scheduler.go:571-623): the admission goes on a status copy of the
    workload, and the cache assumes it so the next snapshot carries its
    usage."""
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


def apply_decisions(cache: Cache, heaps: PendingHeaps, heads: list,
                    decisions: dict, now: float) -> int:
    """Apply one cycle's decisions as the scheduler does: every decided
    head keeps its assignment's resume state (scheduler.go's
    `w.last_assignment = assignment.last_state`); admitted heads are
    reserved and popped, the rest stay pending. Returns the number
    admitted."""
    n = 0
    for i, info in enumerate(heads):
        decision = decisions.get(i)
        if decision is None:
            continue
        assignment, admitted = decision
        info.last_assignment = assignment.last_state
        if not admitted:
            continue
        admit(cache, info, assignment, now)
        heaps.pop(info)
        n += 1
    return n
