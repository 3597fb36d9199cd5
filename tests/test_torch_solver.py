"""The port's BatchSolver against the JAX package's, cycle by cycle.

One seeded scenario spec (nested and flat cohorts, a CQ with no cohort,
lending and borrowing limits, TryNextFlavor CQs, a tainted flavor, one
and two podsets) is built twice: once with kueue_tpu's api and cache,
once with kueue_tpu_torch's. Each cycle takes the head of every CQ's
pending list, solves it with both solvers on the CPU and compares the
decisions exactly: admitted set, flavor per podset and resource,
borrowing, tried_flavor_idx and the resume generations. Between cycles
both sides apply the same admissions and keep each decided head's
last_assignment, as the scheduler does, so heads skipped inside a cycle
come back with flavor-resume state (start_rank).
"""

import importlib
import random

import numpy as np
import pytest

import kueue_tpu.solver.kernel  # noqa: F401  enables jax x64 before any array
from kueue_tpu import features as jax_features
from kueue_tpu.solver import BatchSolver as JaxBatchSolver
from kueue_tpu_torch import features as torch_features
from kueue_tpu_torch.solver import BatchSolver as TorchBatchSolver

@pytest.fixture(autouse=True)
def _reset_torch_features():
    torch_features.reset()
    yield
    torch_features.reset()


def make_spec(seed: int) -> dict:
    rng = random.Random(seed)
    flavors = ["f0", "f1", "spot"]
    cqs = []
    homes = ["left", "left", "right", "right", "team", "team", "team", ""]
    for i, cohort in enumerate(homes):
        order = flavors[:]
        rng.shuffle(order)
        fqs = [(f, rng.choice([2, 4, 6]), rng.choice([None, None, 2]),
                rng.choice([None, 1])) for f in order[:rng.randint(2, 3)]]
        cqs.append((f"cq{i}", cohort, fqs, rng.random() < 0.4))
    wls = []
    for i in range(48):
        podsets = [(f"ps{k}", rng.randint(1, 2), rng.choice([1, 2, 3]))
                   for k in range(rng.choice([1, 1, 2]))]
        wls.append((f"w{i}", f"cq{rng.randrange(len(cqs))}",
                    rng.randint(0, 3), float(rng.randint(0, 30)), podsets,
                    rng.random() < 0.5))
    return {"flavors": flavors, "cqs": cqs, "wls": wls}


def build(pkg: str, spec: dict):
    api = importlib.import_module(f"{pkg}.api.kueue")
    meta = importlib.import_module(f"{pkg}.api.meta")
    corev1 = importlib.import_module(f"{pkg}.api.corev1")
    wlpkg = importlib.import_module(f"{pkg}.core.workload")
    cache_mod = importlib.import_module(f"{pkg}.cache.cache")
    kwargs = {"incremental_snapshots": False} if pkg == "kueue_tpu" else {}
    cache = cache_mod.Cache(**kwargs)
    for f in spec["flavors"]:
        rf = api.ResourceFlavor(metadata=meta.ObjectMeta(name=f))
        if f == "spot":
            rf.spec.node_taints = [corev1.Taint(key="spot", value="true")]
        cache.add_or_update_resource_flavor(rf)
    cache.add_or_update_cohort(api.Cohort(metadata=meta.ObjectMeta(name="root")))
    for name in ("left", "right"):
        cache.add_or_update_cohort(api.Cohort(
            metadata=meta.ObjectMeta(name=name),
            spec=api.CohortSpec(parent="root")))
    for name, cohort, fqs, try_next in spec["cqs"]:
        cq = api.ClusterQueue(metadata=meta.ObjectMeta(name=name))
        cq.spec.namespace_selector = meta.LabelSelector()
        cq.spec.cohort = cohort
        if try_next:
            cq.spec.flavor_fungibility = api.FlavorFungibility(
                when_can_borrow=api.TRY_NEXT_FLAVOR)
        cq.spec.resource_groups.append(api.ResourceGroup(
            covered_resources=["cpu", "memory"],
            flavors=[api.FlavorQuotas(name=f, resources=[
                api.ResourceQuota(name="cpu", nominal_quota=n * 1000,
                                  borrowing_limit=None if b is None else b * 1000,
                                  lending_limit=None if lend is None else lend * 1000),
                api.ResourceQuota(name="memory", nominal_quota=n << 30),
            ]) for f, n, b, lend in fqs]))
        cache.add_cluster_queue(cq)
    pending = {}
    for name, cq, prio, ts, podsets, tolerate in spec["wls"]:
        wl = api.Workload(metadata=meta.ObjectMeta(
            name=name, namespace="default", creation_timestamp=ts))
        wl.spec.priority = prio
        for ps_name, count, cpu in podsets:
            pod = corev1.PodSpec(containers=[corev1.Container(
                name="c", requests={"cpu": cpu * 1000, "memory": 1 << 30})])
            if tolerate:
                pod.tolerations = [corev1.Toleration(key="spot",
                                                     operator="Exists")]
            wl.spec.pod_sets.append(api.PodSet(
                name=ps_name, count=count,
                template=corev1.PodTemplateSpec(spec=pod)))
        pending.setdefault(cq, []).append(wlpkg.Info(wl, cluster_queue=cq))
    for infos in pending.values():  # queue order: priority desc, then time
        infos.sort(key=lambda i: (-i.obj.spec.priority,
                                  i.obj.metadata.creation_timestamp))
    return {"api": api, "wlpkg": wlpkg, "cache": cache, "pending": pending}


def heads_of(env) -> list:
    return [infos[0] for _, infos in sorted(env["pending"].items()) if infos]


def apply(env, heads, decisions, now):
    api, wlpkg, cache = env["api"], env["wlpkg"], env["cache"]
    for i, info in enumerate(heads):
        if i not in decisions:
            continue
        assignment, admitted = decisions[i]
        info.last_assignment = assignment.last_state
        if not admitted:
            continue
        new_wl = wlpkg.clone_for_status_update(info.obj)
        wlpkg.set_quota_reservation(new_wl, api.Admission(
            cluster_queue=info.cluster_queue,
            pod_set_assignments=assignment.to_api()), now)
        cache.assume_workload(new_wl, info=wlpkg.Info.from_assignment(
            new_wl, info.cluster_queue, assignment))
        env["pending"][info.cluster_queue].pop(0)


def normalize(decisions: dict) -> dict:
    out = {}
    for i, (a, admitted) in decisions.items():
        out[i] = (admitted, a.borrowing,
                  [(ps.name, ps.count, sorted(
                      (r, fl.name, fl.mode, fl.tried_flavor_idx)
                      for r, fl in ps.flavors.items()))
                   for ps in a.pod_sets],
                  a.last_state.last_tried_flavor_idx,
                  a.last_state.cluster_queue_generation,
                  a.last_state.cohort_generation)
    return out


def assert_encodings_equal(jax_env, torch_env, heads_j, heads_t):
    from kueue_tpu.solver import encode as jenc
    from kueue_tpu_torch.solver import encode as tenc
    snap_j, snap_t = jax_env["cache"].snapshot(), torch_env["cache"].snapshot()
    topo_j, topo_t = jenc.encode_topology(snap_j), tenc.encode_topology(snap_t)
    for name in ("resources", "flavors", "cq_names", "cohort_names"):
        assert getattr(topo_j, name) == getattr(topo_t, name), name
    for name, value in vars(topo_j).items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(getattr(topo_t, name), value,
                                          err_msg=name)
    batch_j, state_j = (jenc.encode_workloads(heads_j, snap_j, topo_j),
                        jenc.encode_state(snap_j, topo_j))
    batch_t, state_t = (tenc.encode_workloads(heads_t, snap_t, topo_t),
                        tenc.encode_state(snap_t, topo_t))
    for name in ("requests", "podset_active", "wl_cq", "priority",
                 "timestamp", "eligible", "solvable", "start_rank"):
        np.testing.assert_array_equal(getattr(batch_t, name),
                                      getattr(batch_j, name), err_msg=name)
    np.testing.assert_array_equal(state_t.usage, state_j.usage)
    np.testing.assert_array_equal(state_t.cohort_usage, state_j.cohort_usage)
    return batch_t


def run_cycles(seed: int, cycles: int = 3) -> int:
    """Both solvers over `cycles` cycles of one scenario; returns how many
    cycles had a head with flavor-resume state."""
    jax_features.reset()
    spec = make_spec(seed)
    jax_env, torch_env = build("kueue_tpu", spec), build("kueue_tpu_torch", spec)
    jax_solver = JaxBatchSolver()
    torch_solver = TorchBatchSolver(device="cpu")
    admitted_total, resumed = 0, 0
    for cycle in range(cycles):
        heads_j, heads_t = heads_of(jax_env), heads_of(torch_env)
        assert [h.key for h in heads_j] == [h.key for h in heads_t]
        batch = assert_encodings_equal(jax_env, torch_env, heads_j, heads_t)
        resumed += int((batch.start_rank > 0).any())
        dec_j = jax_solver.solve(jax_env["cache"].snapshot(), heads_j)
        dec_t = torch_solver.solve(torch_env["cache"].snapshot(), heads_t)
        assert normalize(dec_t) == normalize(dec_j), f"cycle {cycle}"
        admitted_total += sum(adm for _, adm in dec_t.values())
        apply(jax_env, heads_j, dec_j, 100.0 + cycle)
        apply(torch_env, heads_t, dec_t, 100.0 + cycle)
    assert admitted_total > 0
    assert torch_solver.counters["dispatches"] == cycles
    return resumed


@pytest.mark.parametrize("seed", range(4))
def test_solver_matches_jax_over_cycles(seed):
    run_cycles(seed)


def test_skipped_head_resumes_from_its_flavor():
    """Seed 1 skips a head inside a cycle; the next cycle encodes its
    flavor-resume position, so start_rank reaches both solves."""
    assert run_cycles(1) > 0
