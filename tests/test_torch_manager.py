"""The port's KueueManager with a solver against the JAX package's.

Each case builds one seeded stream of batch/v1 Jobs through `store.create`
into a KueueManager of each package: the JAX package's with its
BatchSolver() on JAX-CPU, the port's with BatchSolver(device="cpu") (its
kernels' plain versions), at the manager's production wiring (the
speculative pipeline at depth 2, the watchdog, the breaker, supervised
dispatch, the warm governor, journeys, the query plane), with two
settings made alike on both: `solver.min_heads = 0`, so every cycle of
these narrow clusters takes the solver, and `solver.routing = "always"`
(adaptive routing picks the engine from the rates each package measures
on its own clock, so the two would route apart), and a watchdog clamp of
600 s (the JAX package's first cycles compile). The stream runs Jobs
arriving and finishing over several `schedule_once` calls; the
tests/torch_twin.py Trace holds the two stores equal after every drain
and every cycle: every object (Jobs' suspend flags and injected node
selectors, Workloads' admissions, conditions and requeue state, CQ and
LQ status) and every event, in order, with no tolerance.

Variants: 16-64 ClusterQueues in cohorts of 4 or 8 over two flavors of
cpu and memory; "preempt" (LowerPriority within the CQ, reclaim within
the cohort, no borrowing, small CQs filled with one-pod low-priority
Jobs, then high-priority arrivals), "fair" (fair
sharing with weighted CQs), "multikueue" (the MultiKueue check on every
CQ, two worker KueueManagers with no solver, the controller's capacity
columns feeding the solver's cluster columns).

The threaded loop: `scheduler.start()` on the port's manager with a
solver, stopped once the queues are settled, admits the same set as
`schedule_until_settled` on a twin manager, and after `shutdown()`
`cache.live_handouts` is 0.
"""

import time

import numpy as np
import pytest

from tests.torch_twin import assert_script_twins

import kueue_tpu.solver.kernel  # noqa: F401  enables jax x64 before any array

FLAVORS = ("on-demand", "spot")
VARIANTS = ("fit", "preempt", "fair", "multikueue")
STEPS = 2


def make_solver(M):
    solver = M("solver")
    if solver.__name__.startswith("kueue_tpu_torch"):
        return solver.BatchSolver(device="cpu")
    return solver.BatchSolver()


def make_cfg(M, variant):
    cfgpkg = M("config")
    cfg = cfgpkg.Configuration()
    cfg.solver.min_heads = 0
    cfg.solver.routing = "always"
    cfg.solver.watchdog_max_deadline_s = 600.0
    cfg.fair_sharing.enable = variant == "fair"
    return cfg


def setup_cluster(M, store, rng, num_cqs, cohort_size, variant,
                  check=None):
    """Flavors, cohorts of CQs, one LocalQueue each, through the store."""
    api, meta = M("api.kueue"), M("api.meta")
    for f in FLAVORS:
        store.create(api.ResourceFlavor(
            metadata=meta.ObjectMeta(name=f),
            spec=api.ResourceFlavorSpec(node_labels={"flavor": f})))
    if variant == "preempt":
        store.create(api.WorkloadPriorityClass(
            metadata=meta.ObjectMeta(name="high"), value=100))
    for i in range(num_cqs):
        quotas = []
        for f in FLAVORS:
            # the preempt variant's CQs are small, so that they fill
            cpu = int(rng.integers(*((1, 3) if variant == "preempt"
                                     else (2, 9)))) * 1000
            mem = int(rng.integers(4, 17)) * 2 ** 30
            quotas.append(api.FlavorQuotas(name=f, resources=[
                # preempt: no borrowing, so that a full CQ preempts
                api.ResourceQuota(name="cpu", nominal_quota=cpu,
                                  borrowing_limit=0 if variant == "preempt"
                                  else cpu if i % 3 else None),
                api.ResourceQuota(name="memory", nominal_quota=mem)]))
        spec = api.ClusterQueueSpec(
            cohort=f"cohort-{i // cohort_size}",
            namespace_selector=meta.LabelSelector(),
            resource_groups=[api.ResourceGroup(
                covered_resources=["cpu", "memory"], flavors=quotas)])
        if variant == "preempt":
            spec.preemption = api.ClusterQueuePreemption(
                within_cluster_queue=api.PREEMPTION_LOWER_PRIORITY,
                reclaim_within_cohort=api.PREEMPTION_ANY)
        if variant == "fair":
            spec.fair_sharing = api.FairSharing(weight=1000 * (1 + i % 3))
        if check:
            spec.admission_checks = [check]
        store.create(api.ClusterQueue(
            metadata=meta.ObjectMeta(name=f"cq-{i}"), spec=spec))
        store.create(api.LocalQueue(
            metadata=meta.ObjectMeta(name=f"lq-{i}", namespace="default"),
            spec=api.LocalQueueSpec(cluster_queue=f"cq-{i}")))


def make_job(M, name, lq, rng, high=False, small=False):
    api, meta = M("api.kueue"), M("api.meta")
    batchv1, corev1 = M("api.batchv1"), M("api.corev1")
    labels = {api.QUEUE_LABEL: lq}
    if high:
        labels[api.PRIORITY_CLASS_LABEL] = "high"
    job = batchv1.Job(metadata=meta.ObjectMeta(
        name=name, namespace="default", labels=labels))
    job.spec.suspend = True
    job.spec.parallelism = 1 if small else int(rng.integers(1, 4))
    job.spec.template = corev1.PodTemplateSpec(spec=corev1.PodSpec(
        containers=[corev1.Container(name="c", requests={
            "cpu": int(rng.integers(1, 4 if small else 5)) * 500,
            "memory": int(rng.integers(1, 5)) * 2 ** 30})]))
    return job


def finish_some(M, store, rng, fraction):
    """Mark a seeded share of the running Jobs Complete."""
    batchv1, meta = M("api.batchv1"), M("api.meta")
    running = sorted(j.metadata.name for j in store.list("Job")
                     if not j.spec.suspend and not j.status.conditions)
    for name in running:
        if rng.random() < fraction:
            job = store.get("Job", "default", name)
            job.status.conditions.append(meta.Condition(
                type=batchv1.JOB_COMPLETE, status="True", message="done"))
            store.update(job)


def make_workers(M, clock, rng, num_cqs, cohort_size):
    manager_mod = M("manager")
    workers = {}
    for w in ("worker1", "worker2"):
        wm = manager_mod.KueueManager(clock=clock)
        setup_cluster(M, wm.store, rng, num_cqs, cohort_size, "fit")
        workers[w] = wm
    return workers


def setup_multikueue(M, store):
    api, meta, asapi = M("api.kueue"), M("api.meta"), M("api.autoscaling")
    mk = M("controller.admissionchecks.multikueue")
    for w in ("worker1", "worker2"):
        store.create(asapi.MultiKueueCluster(metadata=meta.ObjectMeta(name=w)))
    store.create(asapi.MultiKueueConfig(
        metadata=meta.ObjectMeta(name="mk-config"),
        spec=asapi.MultiKueueConfigSpec(clusters=["worker1", "worker2"])))
    ac = api.AdmissionCheck(metadata=meta.ObjectMeta(name="mk-check"))
    ac.spec.controller_name = mk.CONTROLLER_NAME
    ac.spec.parameters = api.AdmissionCheckParametersReference(
        kind="MultiKueueConfig", name="mk-config")
    store.create(ac)


def stream(seed: int, num_cqs: int, cohort_size: int, variant: str):
    def script(M):
        rng = np.random.default_rng(seed)
        clock = M("api.meta").FakeClock(1000.0)
        workers = None
        if variant == "multikueue":
            workers = make_workers(M, clock, rng, num_cqs, cohort_size)
        mgr = M("manager").KueueManager(
            cfg=make_cfg(M, variant), clock=clock, solver=make_solver(M),
            remote_clusters=workers)
        if variant == "multikueue":
            setup_multikueue(M, mgr.store)
        setup_cluster(M, mgr.store, rng, num_cqs, cohort_size, variant,
                      check="mk-check" if workers else None)
        mgr.run_until_idle()
        n = 0
        for step in range(STEPS):
            # in the preempt variant one-pod low-priority Jobs fill the CQs
            # first; high-priority ones arrive from the second step on
            fill = 3.0 if variant == "preempt" else 1.5
            for _ in range(int(num_cqs * (fill if step == 0 else 0.5))):
                lq = f"lq-{int(rng.integers(0, num_cqs))}"
                high = variant == "preempt" and step > 0
                mgr.store.create(make_job(M, f"j{n}", lq, rng, high,
                                          small=variant == "preempt"))
                n += 1
            mgr.schedule_once()
            mgr.schedule_once()
            if workers:
                for wm in workers.values():
                    wm.schedule_until_settled()
                mgr.run_until_idle()
            clock.advance(5.0)
            finish_some(M, mgr.store, rng, 0.3)
            mgr.run_until_idle()
        mgr.schedule_until_settled()
        counts = mgr.scheduler.cycle_counts
        assert any(r.startswith("device") for r in counts), counts
        if workers:
            assert mgr.multikueue.placements_planned > 0
    return script


# fit and fair at 16, 32 and 64 CQs; preempt (its K9 programs compile on
# JAX-CPU) and multikueue (two worker managers) at 16 and 32
CASES = [(seed, (16, 32, 64)[seed % 3] if seed % 2 == 0
          else (16, 32)[seed // 4 % 2],
          (4, 8)[seed // 4 % 2], VARIANTS[seed % len(VARIANTS)])
         for seed in range(30)]


@pytest.mark.parametrize("seed,num_cqs,cohort_size,variant", CASES,
                         ids=[f"{v}-{c}cq-s{s}" for s, c, _, v in CASES])
def test_manager_stream_matches_jax(seed, num_cqs, cohort_size, variant):
    steps = assert_script_twins(stream(seed, num_cqs, cohort_size, variant))
    cycles = [s for s in steps if s[0] == "cycle"]
    assert len(cycles) >= 2 * STEPS


def admitted_keys(mgr):
    from kueue_tpu_torch.core import workload as wlpkg
    return sorted(w.metadata.owner_references[0].name
                  for w in mgr.store.list("Workload")
                  if wlpkg.has_quota_reservation(w))


def test_threaded_loop_admits_the_settled_set():
    import importlib

    def M(name):
        return importlib.import_module(f"kueue_tpu_torch.{name}")

    def build():
        rng = np.random.default_rng(7)
        mgr = M("manager").KueueManager(
            cfg=make_cfg(M, "fit"), clock=M("api.meta").FakeClock(1000.0),
            solver=make_solver(M))
        setup_cluster(M, mgr.store, rng, 16, 4, "fit")
        for n in range(40):
            lq = f"lq-{int(rng.integers(0, 16))}"
            mgr.store.create(make_job(M, f"j{n}", lq, rng))
        mgr.run_until_idle()
        return mgr

    settled = build()
    settled.schedule_until_settled()
    want = admitted_keys(settled)
    settled.shutdown()
    assert want

    mgr = build()
    mgr.scheduler.start()
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        time.sleep(0.05)
        if (mgr.scheduler._inflight is None and admitted_keys(mgr) == want
                and not any(cqh.pending_active()
                            for cqh in mgr.queues.cluster_queues.values())):
            break
    mgr.scheduler.stop()
    assert not mgr.scheduler._thread.is_alive()
    mgr.run_until_idle()
    assert admitted_keys(mgr) == want
    mgr.shutdown()
    assert mgr.cache.live_handouts == 0


def test_scheduler_verbose_logs_match_jax():
    """At verbosity 6 the port's Scheduler logs the cycle's snapshot
    (vlog.dump_snapshot) and every nomination attempt (vlog.dump_attempts)
    line for line as the JAX package's does, here on the CPU scheduler
    (solver=None) over a seeded stream."""
    import logging

    logs = {}

    def script(M):
        pkg = M("manager").__name__.split(".")[0]
        vlog = M("utils.vlog")
        records = logs.setdefault(pkg, [])

        class Keep(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if msg.startswith(("snapshot.clusterQueue", "attempt")):
                    records.append(msg)

        base = logging.getLogger(pkg)
        handler = Keep()
        base.addHandler(handler)
        level = vlog.verbosity()
        cfg = M("config").Configuration()
        cfg.verbosity = 6   # the manager sets the level from its config
        try:
            rng = np.random.default_rng(11)
            mgr = M("manager").KueueManager(
                cfg, clock=M("api.meta").FakeClock(1000.0))
            setup_cluster(M, mgr.store, rng, 8, 4, "fit")
            for n in range(24):
                lq = f"lq-{int(rng.integers(0, 8))}"
                mgr.store.create(make_job(M, f"j{n}", lq, rng))
            mgr.schedule_until_settled()
            finish_some(M, mgr.store, rng, 0.5)
            mgr.schedule_until_settled()
        finally:
            vlog.set_verbosity(level)
            base.removeHandler(handler)

    assert_script_twins(script)
    want = logs["kueue_tpu"]
    assert any(m.startswith("attempt") for m in want)
    assert any(m.startswith("snapshot.clusterQueue") for m in want)
    assert logs["kueue_tpu_torch"] == want
