"""The port's core and job controllers against the JAX package's.

The scenarios of tests/test_controllers.py (TestEndToEndAdmission,
TestAdmissionChecks, TestLifecycle, TestPodsReadyTimeout) and
tests/test_jobs.py TestBatchJob run on both packages
(tests/torch_twin.py): each through the manager's store, runtime,
webhooks, core controllers and the batch/job integration with the
reference's CPU scheduler. After every drain and every cycle the stores
are equal object by object (Jobs' suspend flags and injected node
selectors, Workloads' admissions, conditions and requeue state, CQ and
LQ status, finalizers and owner references) and the events equal in
order, with no tolerance. TestBatchJob's manager enables only batch/job
on both packages (the other integrations wait for ROADMAP item 5b).
"""

import pytest

from tests.torch_twin import assert_twins

CONTROLLER_CASES = [
    f"{cls}.{t}" for cls, tests in [
        ("TestEndToEndAdmission", [
            "test_workload_admitted_through_full_stack",
            "test_over_quota_stays_pending_with_reason",
            "test_fifo_order_and_second_cycle",
            "test_missing_local_queue_marks_inadmissible",
            "test_inactive_cq_missing_flavor",
            "test_local_queue_active_condition"]),
        ("TestAdmissionChecks", [
            "test_checks_gate_admitted_condition",
            "test_retry_check_evicts",
            "test_rejected_check_deactivates",
            "test_unregistered_controller_check_inactive"]),
        ("TestLifecycle", [
            "test_deactivation_evicts_and_requeue_on_reactivate",
            "test_cq_stop_policy_drains",
            "test_resource_flavor_finalizer"]),
        ("TestPodsReadyTimeout", [
            "test_timeout_evicts_with_backoff",
            "test_backoff_limit_deactivates"]),
    ] for t in tests]

# tests/test_jobs.py with only batch/job enabled: the module's imports of
# the other integrations' API modules go, on both packages alike.
JOBS_SUBS = (
    ("from kueue_tpu.api import appsv1, batchv1, corev1, jobset as jobsetapi\n"
     "from kueue_tpu.api import kubeflow as kf\n",
     "from kueue_tpu.api import batchv1, corev1\n"),
    ("from kueue_tpu.api import ray as rayapi\n", ""),
    ("from kueue_tpu.controller.jobs.pod import (\n"
     "    GROUP_NAME_LABEL,\n    GROUP_TOTAL_COUNT_ANNOTATION,\n)\n", ""),
    ("frameworks=list(cfgpkg.ALL_INTEGRATIONS)", 'frameworks=["batch/job"]'),
)

BATCH_JOB_CASES = [f"TestBatchJob.{t}" for t in (
    "test_full_lifecycle",
    "test_job_without_queue_name_ignored",
    "test_manage_without_queue_name",
    "test_partial_admission_scales_parallelism",
    "test_eviction_stops_job_and_clears_reservation",
    "test_preemption_requeues_immediately",
    "test_reclaimable_pods_propagate",
    "test_prebuilt_workload",
)]


@pytest.mark.parametrize("test", CONTROLLER_CASES)
def test_controller_case(test):
    steps = assert_twins("tests.test_controllers", test)
    assert any(s[0] == "drain" for s in steps)


@pytest.mark.parametrize("test", BATCH_JOB_CASES)
def test_batch_job_case(test):
    steps = assert_twins("tests.test_jobs", test, subs=JOBS_SUBS)
    assert any(s[0] == "drain" for s in steps)


def test_unported_integrations_are_refused():
    from kueue_tpu_torch import config as cfgpkg
    from kueue_tpu_torch.controller import jobframework, jobs
    from kueue_tpu_torch.manager import KueueManager
    cfg = cfgpkg.Configuration(integrations=cfgpkg.Integrations(
        frameworks=list(cfgpkg.ALL_INTEGRATIONS)))
    with pytest.raises(NotImplementedError, match="item 5b"):
        KueueManager(cfg=cfg)
    jobs.register_all()
    assert jobframework.integration_names() == ["batch/job"]
    with pytest.raises(ValueError, match="unknown integration"):
        jobframework.setup_integrations(None, None, None, cfg,
                                        frameworks=["pod"])


@pytest.mark.parametrize("switch", ["leader_election", "store"])
def test_unported_switches_are_refused(switch):
    from kueue_tpu_torch import config as cfgpkg
    from kueue_tpu_torch.manager import KueueManager
    cfg = cfgpkg.Configuration()
    if switch == "leader_election":
        cfg.leader_election.leader_elect = True
    else:
        cfg.store.durable = True
    with pytest.raises(NotImplementedError, match="item 6"):
        KueueManager(cfg=cfg)
    mgr = KueueManager()
    for call, item in ((lambda: KueueManager.standby(None), "item 6"),
                       (lambda: KueueManager.restore(None), "item 6"),
                       (mgr.serve_visibility, "item 5b"),
                       (mgr.dumper, "item 5b")):
        with pytest.raises(NotImplementedError, match=item):
            call()
    mgr.shutdown()


def pods_ready_jitter(M):
    """Three workloads time out waiting for their pods twice, with a
    requeue jitter: the backoff draws from the workload controller's
    random.Random(0), so both packages' requeue times must agree."""
    cfgpkg, api, meta = M("config"), M("api.kueue"), M("api.meta")
    corev1, core = M("api.corev1"), M("core.workload")
    clock = meta.FakeClock(1000.0)
    cfg = cfgpkg.Configuration(wait_for_pods_ready=cfgpkg.WaitForPodsReady(
        enable=True, timeout_seconds=30.0, block_admission=False,
        requeuing_strategy=cfgpkg.RequeuingStrategy(
            backoff_base_seconds=10, backoff_jitter=0.5)))
    mgr = M("manager").KueueManager(cfg=cfg, clock=clock)
    mgr.store.create(api.ResourceFlavor(metadata=meta.ObjectMeta(name="f")))
    mgr.store.create(api.ClusterQueue(
        metadata=meta.ObjectMeta(name="cq"), spec=api.ClusterQueueSpec(
            namespace_selector=meta.LabelSelector(),
            resource_groups=[api.ResourceGroup(
                covered_resources=["cpu"], flavors=[api.FlavorQuotas(
                    name="f", resources=[api.ResourceQuota(
                        name="cpu", nominal_quota=8000)])])])))
    mgr.store.create(api.LocalQueue(
        metadata=meta.ObjectMeta(name="lq", namespace="default"),
        spec=api.LocalQueueSpec(cluster_queue="cq")))
    for i in range(3):
        wl = api.Workload(metadata=meta.ObjectMeta(
            name=f"w{i}", namespace="default"))
        wl.spec.queue_name = "lq"
        wl.spec.pod_sets = [api.PodSet(name="main", count=1,
                                       template=corev1.PodTemplateSpec(
                                           spec=corev1.PodSpec(containers=[
                                               corev1.Container(
                                                   name="c",
                                                   requests={"cpu": 1000})])))]
        mgr.store.create(wl)
    requeues = []
    for _ in range(2):
        mgr.schedule_until_settled()
        mgr.advance(31.0)
        for wl in mgr.store.list("Workload"):
            rs = wl.status.requeue_state
            requeues.append((wl.metadata.name, rs.count if rs else None,
                             rs.requeue_at if rs else None))
            if core.is_evicted(wl) and core.has_quota_reservation(wl):
                wl.status.admission = None
                wl.status.conditions = [
                    c for c in wl.status.conditions
                    if c.type not in (api.WORKLOAD_QUOTA_RESERVED,
                                      api.WORKLOAD_ADMITTED)]
                mgr.store.update_status(wl)
        mgr.run_until_idle()
        mgr.advance(40.0)
    assert any(at is not None and at != int(at) for _, _, at in requeues)


def test_pods_ready_jitter_matches_jax():
    from tests.torch_twin import assert_script_twins
    assert_script_twins(pods_ready_jitter)
