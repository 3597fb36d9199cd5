"""The port's queue Manager and ClusterQueue heaps against the JAX
package's, over one seeded script of adds, updates, deletes, head pops,
requeues and inadmissible flushes: the same heads in the same order, the
same pending counts and queue orders, the same listener events.

`PkgEnv` builds the same cluster and workloads with either package's
api, cache and queue Manager; the arena and resident-solver parity
tests build on it too.
"""

import importlib
import random

import pytest

import kueue_tpu.solver.kernel  # noqa: F401  enables jax x64 before any array

QUEUE_KEYS = ("cq0", "cq1", "cq2", "cq3")


class PkgEnv:
    """A Cache and a queue Manager of one package (`kueue_tpu` or
    `kueue_tpu_torch`); each ClusterQueue <name> is fed by the
    LocalQueue lq-<name>."""

    def __init__(self, pkg: str, flavors=("f0", "f1"), tainted=("f1",)):
        self.pkg = pkg
        self.api = importlib.import_module(f"{pkg}.api.kueue")
        self.meta = importlib.import_module(f"{pkg}.api.meta")
        self.corev1 = importlib.import_module(f"{pkg}.api.corev1")
        self.wlpkg = importlib.import_module(f"{pkg}.core.workload")
        self.resources = importlib.import_module(f"{pkg}.core.resources")
        queue = importlib.import_module(f"{pkg}.queue")
        cache_mod = importlib.import_module(f"{pkg}.cache.cache")
        self.RequeueReason = queue.RequeueReason
        self.clock = self.meta.FakeClock(1000.0)
        kwargs = {"incremental_snapshots": False} if pkg == "kueue_tpu" else {}
        self.cache = cache_mod.Cache(**kwargs)
        self.queues = queue.Manager(clock=self.clock)
        self.events = []
        self.queues.add_workload_listener(
            lambda kind, key: self.events.append((kind, key)))
        self.flavors = list(flavors)
        for f in self.flavors:
            rf = self.api.ResourceFlavor(metadata=self.meta.ObjectMeta(name=f))
            if f in tainted:
                rf.spec.node_taints = [self.corev1.Taint(
                    key="spot", value="true", effect="NoSchedule")]
            self.cache.add_or_update_resource_flavor(rf)

    def add_cq(self, name: str, cohort: str, quotas: list,
               strict: bool = False, try_next: bool = False) -> None:
        """quotas: [(flavor, cpu units, borrowing limit units or None)]."""
        api, meta = self.api, self.meta
        cq = api.ClusterQueue(metadata=meta.ObjectMeta(name=name))
        cq.spec.namespace_selector = meta.LabelSelector()
        cq.spec.cohort = cohort
        if strict:
            cq.spec.queueing_strategy = api.STRICT_FIFO
        if try_next:
            cq.spec.flavor_fungibility = api.FlavorFungibility(
                when_can_borrow=api.TRY_NEXT_FLAVOR)
        cq.spec.resource_groups.append(api.ResourceGroup(
            covered_resources=["cpu", "memory"],
            flavors=[api.FlavorQuotas(name=f, resources=[
                api.ResourceQuota(name="cpu", nominal_quota=units * 1000,
                                  borrowing_limit=None if bl is None
                                  else bl * 1000),
                api.ResourceQuota(name="memory", nominal_quota=units << 30),
            ]) for f, units, bl in quotas]))
        self.cache.add_cluster_queue(cq)
        self.queues.add_cluster_queue(cq)
        lq = api.LocalQueue(
            metadata=meta.ObjectMeta(name=f"lq-{name}", namespace="default"),
            spec=api.LocalQueueSpec(cluster_queue=name))
        self.queues.add_local_queue(lq)

    def workload(self, name: str, cq: str, priority: int, creation: float,
                 podsets: list, rv: int = 1):
        """podsets: [(count, cpu units, tolerates spot)]."""
        api, meta, corev1 = self.api, self.meta, self.corev1
        wl = api.Workload(metadata=meta.ObjectMeta(
            name=name, namespace="default", creation_timestamp=creation))
        wl.metadata.resource_version = rv
        wl.spec.queue_name = f"lq-{cq}"
        wl.spec.priority = priority
        for k, (count, cpu, tolerate) in enumerate(podsets):
            pod = corev1.PodSpec(containers=[corev1.Container(
                name="c", requests={"cpu": cpu * 1000, "memory": 1 << 30})])
            if tolerate:
                pod.tolerations = [corev1.Toleration(key="spot",
                                                     operator="Exists")]
            wl.spec.pod_sets.append(api.PodSet(
                name=f"ps{k}", count=count,
                template=corev1.PodTemplateSpec(spec=pod)))
        return wl

    def pending_infos(self) -> dict:
        out = {}
        for items in self.queues.local_queues.values():
            out.update(items.items)
        return out


def random_podsets(rng: random.Random, max_podsets: int = 2) -> list:
    n = rng.choice([1, 1, 1, 2, max_podsets + 1])  # sometimes > P
    return [(rng.randrange(1, 3), rng.randrange(1, 5), rng.random() < 0.5)
            for _ in range(n)]


def queue_state(env) -> tuple:
    q = env.queues
    return (q.pending_total(),
            [(name, q.pending(name), cqh.pending_active(),
              cqh.pending_inadmissible(),
              [i.key for i in q.pending_order(name)])
             for name, cqh in q.cluster_queues.items()])


def run_script(seed: int, steps: int = 60):
    """One seeded script through both Managers; asserts after every
    step. Returns the number of heads popped."""
    rng = random.Random(seed)
    envs = [PkgEnv("kueue_tpu"), PkgEnv("kueue_tpu_torch")]
    layout = (("cq0", "a", False), ("cq1", "a", True), ("cq2", "", False),
              ("cq3", "b", True))
    for env in envs:
        for name, cohort, strict in layout:
            env.add_cq(name, cohort, [("f0", 4, None), ("f1", 2, None)],
                       strict=strict)
    live: dict = {}
    n = popped = 0
    reasons = ("GENERIC", "FAILED_AFTER_NOMINATION", "PENDING_PREEMPTION",
               "NAMESPACE_MISMATCH")
    inflight: list = []
    for step in range(steps):
        op = rng.random()
        if op < 0.35 or not live:
            name = f"w{n}"
            n += 1
            args = (name, rng.choice(QUEUE_KEYS), rng.randrange(0, 3),
                    float(rng.randrange(0, 20)), random_podsets(rng))
            live[name] = args
            added = [env.queues.add_or_update_workload(env.workload(*args))
                     for env in envs]
        elif op < 0.5:
            name = rng.choice(sorted(live))
            old = live[name]
            # an update: same queue, a new priority or new requests
            args = (name, old[1], rng.randrange(0, 3), old[3],
                    random_podsets(rng) if rng.random() < 0.5 else old[4])
            live[name] = args
            added = [env.queues.add_or_update_workload(
                env.workload(*args, rv=step + 2)) for env in envs]
        elif op < 0.6:
            name = rng.choice(sorted(live))
            args = live.pop(name)
            for env in envs:
                env.queues.delete_workload(env.workload(*args))
            added = None
        elif op < 0.8:
            heads = [env.queues.heads_nonblocking() for env in envs]
            assert [h.key for h in heads[0]] == [h.key for h in heads[1]]
            assert [h.cluster_queue for h in heads[0]] == \
                [h.cluster_queue for h in heads[1]]
            popped += len(heads[0])
            inflight = list(zip(*heads))
            added = None
        elif op < 0.93 and inflight:
            reason = rng.choice(reasons)
            pair = inflight.pop(rng.randrange(len(inflight)))
            added = [env.queues.requeue_workload(
                info, getattr(env.RequeueReason, reason))
                for env, info in zip(envs, pair)]
        else:
            names = set(rng.sample(QUEUE_KEYS, 2))
            for env in envs:
                env.queues.queue_inadmissible_workloads(names)
            added = None
        if added is not None:
            assert added[0] == added[1], step
        assert queue_state(envs[0]) == queue_state(envs[1]), step
        assert envs[0].events == envs[1].events, step
        assert sorted(envs[0].pending_infos()) == \
            sorted(envs[1].pending_infos()), step
    return popped


@pytest.mark.parametrize("seed", range(6))
def test_manager_matches_jax(seed):
    assert run_script(seed) > 0


def test_strict_fifo_requeue_keeps_the_head():
    """StrictFIFO puts a requeued head back at the front; BestEffortFIFO
    parks it until an inadmissible flush (cluster_queue.go:228-255)."""
    for pkg in ("kueue_tpu", "kueue_tpu_torch"):
        env = PkgEnv(pkg)
        env.add_cq("cq0", "", [("f0", 4, None)], strict=True)
        env.add_cq("cq1", "", [("f0", 4, None)])
        for cq in ("cq0", "cq1"):
            for k in range(2):
                env.queues.add_or_update_workload(env.workload(
                    f"{cq}-w{k}", cq, 0, float(k), [(1, 1, False)]))
        first = env.queues.heads_nonblocking()
        for info in first:
            env.queues.requeue_workload(info, env.RequeueReason.GENERIC)
        second = env.queues.heads_nonblocking()
        assert [h.key for h in second] == ["default/cq0-w0", "default/cq1-w1"]
        assert env.queues.pending("cq1") == 2
        assert env.events == [("upsert", f"default/{cq}-w{k}")
                              for cq in ("cq0", "cq1") for k in range(2)]
