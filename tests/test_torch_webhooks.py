"""The port's webhooks against the JAX package's.

Every case of tests/test_webhooks.py runs on both packages
(tests/torch_twin.py): the same defaults, the same accepted writes and
the same Invalid messages, with the store after every drain equal. Scripts
written once for both add the limits (16 resource groups, 16 flavors and
16 resources a group, 8 podSets: the last allowed and the first refused,
with their messages), the name rules, the Workload, ClusterQueue,
LocalQueue and ResourceFlavor validations called directly, and the
Deployment hook's queue-label propagation.
"""

import inspect

import pytest

from tests.torch_twin import assert_script_twins, assert_twins, load_twin


def case_names(modname: str) -> list:
    mod = load_twin(modname, "kueue_tpu")
    names = []
    for n, obj in vars(mod).items():
        if n.startswith("Test") and inspect.isclass(obj):
            names += [f"{n}.{m}" for m in vars(obj) if m.startswith("test_")]
    return names


WEBHOOK_CASES = case_names("tests.test_webhooks")


def test_every_webhook_case_is_paired():
    assert len(WEBHOOK_CASES) == 19


@pytest.mark.parametrize("test", WEBHOOK_CASES)
def test_webhook_case(test):
    assert_twins("tests.test_webhooks", test)


def cq_with(M, groups, flavors, resources, name="cq"):
    api, meta = M("api.kueue"), M("api.meta")
    rgs = []
    for g in range(groups):
        res = [f"r{g}-{r}" for r in range(resources)]
        rgs.append(api.ResourceGroup(covered_resources=res, flavors=[
            api.FlavorQuotas(name=f"f{g}-{f}", resources=[
                api.ResourceQuota(name=r, nominal_quota=1) for r in res])
            for f in range(flavors)]))
    return api.ClusterQueue(metadata=meta.ObjectMeta(name=name),
                            spec=api.ClusterQueueSpec(resource_groups=rgs))


def outcome(fn, *args):
    try:
        fn(*args)
        return "ok"
    except Exception as e:
        return type(e).__name__, str(e)


LIMITS = [(16, 1, 1), (17, 1, 1), (1, 16, 1), (1, 17, 1), (1, 1, 16),
          (1, 1, 17), (17, 17, 17)]


@pytest.mark.parametrize("groups,flavors,resources", LIMITS)
def test_cluster_queue_limits(groups, flavors, resources):
    results = {}

    def script(M):
        mgr = M("manager").KueueManager(clock=M("api.meta").FakeClock(0.0))
        cq = cq_with(M, groups, flavors, resources)
        results[M("sim").__name__] = (
            outcome(mgr.store.create, cq),
            M("webhooks").validate_cluster_queue(cq))

    assert_script_twins(script)
    ref, port = results["kueue_tpu.sim"], results["kueue_tpu_torch.sim"]
    assert port == ref
    assert (ref[0] == "ok") == (max(groups, flavors, resources) <= 16)


def podsets_script(count):
    def script(M):
        api, meta = M("api.kueue"), M("api.meta")
        corev1 = M("api.corev1")
        mgr = M("manager").KueueManager(clock=meta.FakeClock(0.0))
        wl = api.Workload(metadata=meta.ObjectMeta(
            name="w", namespace="default"))
        wl.spec.queue_name = "lq"
        wl.spec.pod_sets = [api.PodSet(
            name=f"ps{i}", count=1, template=corev1.PodTemplateSpec(
                spec=corev1.PodSpec(containers=[corev1.Container(
                    name="c", requests={"cpu": 1000})])))
            for i in range(count)]
        mgr.store.create(wl)
    return script


@pytest.mark.parametrize("count", [8, 9])
def test_workload_podset_limit(count):
    assert_script_twins(podsets_script(count),
                        expect="passed" if count <= 8 else
                        "Invalid: Workload 'w' is invalid: spec.podSets: "
                        "must have at most 8 podSets")


def direct_validations(M):
    api, meta, wh = M("api.kueue"), M("api.meta"), M("webhooks")
    corev1 = M("api.corev1")
    out = []
    for name in ("ok-name", "Bad_Name", "", "x" * 64, "-lead"):
        rf = api.ResourceFlavor(metadata=meta.ObjectMeta(name=name))
        out.append(wh.validate_resource_flavor(rf))
        lq = api.LocalQueue(metadata=meta.ObjectMeta(
            name="lq", namespace="default"),
            spec=api.LocalQueueSpec(cluster_queue=name))
        out.append(wh.validate_local_queue(lq))
    rf = api.ResourceFlavor(metadata=meta.ObjectMeta(name="t"))
    rf.spec.node_taints = [corev1.Taint(key="", value="v", effect="Bogus")]
    out.append(wh.validate_resource_flavor(rf))
    wl = api.Workload(metadata=meta.ObjectMeta(name="w", namespace="d"))
    wl.spec.pod_sets = [api.PodSet(name="a", count=-1),
                        api.PodSet(name="a", count=1, min_count=3)]
    out.append(wh.validate_workload(wl))
    wh.default_workload(wl)
    single = api.Workload(metadata=meta.ObjectMeta(name="s", namespace="d"))
    single.spec.pod_sets = [api.PodSet(name="", count=1)]
    wh.default_workload(single)
    out.append(single.spec.pod_sets[0].name)
    cq = cq_with(M, 1, 2, 2)
    cq.spec.cohort = ""
    cq.spec.resource_groups[0].flavors[0].resources[0].borrowing_limit = 1
    cq.spec.resource_groups[0].flavors[0].resources[1].lending_limit = 5
    out.append(wh.validate_cluster_queue(cq))
    return out


def deployment_label(M):
    wh, api, meta = M("webhooks"), M("api.kueue"), M("api.meta")
    corev1 = M("api.corev1")

    class Deployment:
        def __init__(self, labels):
            self.metadata = meta.ObjectMeta(name="d", namespace="default",
                                            labels=labels)
            self.spec = type("Spec", (), {})()
            self.spec.template = corev1.PodTemplateSpec()

    changed = []
    for labels in ({}, {api.QUEUE_LABEL: "lq"}):
        d = Deployment(dict(labels))
        first = wh.propagate_queue_label(d)
        again = wh.propagate_queue_label(d)
        changed.append((first, again, dict(d.spec.template.labels)))
    return changed


def test_direct_validations_match_jax():
    import importlib
    got = [f(lambda n, p=p: importlib.import_module(f"{p}.{n}"))
           for p in ("kueue_tpu", "kueue_tpu_torch")
           for f in (direct_validations,)]
    assert got[1] == got[0]
    assert any(got[0][:10])


def test_deployment_label_propagation_matches_jax():
    import importlib
    mods = {"kueue_tpu": "kueue_tpu.controller.jobs.deployment",
            "kueue_tpu_torch": "kueue_tpu_torch.webhooks"}
    got = {}
    for pkg, modname in mods.items():
        def M(n, pkg=pkg, modname=modname):
            if n == "webhooks":
                return importlib.import_module(modname)
            return importlib.import_module(f"{pkg}.{n}")
        got[pkg] = deployment_label(M)
    assert got["kueue_tpu_torch"] == got["kueue_tpu"]
    assert got["kueue_tpu"][1][0] is True
