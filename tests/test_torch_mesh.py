"""The port's sharded cycle (parallel/mesh.py) against the JAX package's.

The same seeded numpy inputs go through kueue_tpu.parallel.mesh on a JAX
mesh of n host devices and through kueue_tpu_torch.parallel.mesh on n
gloo ranks (tests/torch_mesh_rank.py, one process each, on a FileStore:
no network), at n = 1, 2, 4 and on the (2, 2) ("hosts", "cohorts")
mesh. Every output must be exactly equal:

- solve_cycle_sharded (dense) against the JAX sharded cycle: fit only,
  fair sharing, start_rank, cluster columns, W not divisible by n, more
  ranks than occupied domains, nested cohorts; the compact form against
  the port's single-device solve_cycle_fused; every rank the same; the
  rank's plan columns equal to the JAX plan_cycle's;
- solve_preempt_sharded against the JAX sharded cycle's fused preemption
  outputs and (with the stats) the port's single-device solve_preempt;
- the port's Scheduler with BatchSolver(mesh=make_mesh(device="cpu"))
  (world size 1 in this process) against the JAX Scheduler with a
  2-device JAX mesh solver: minimal preemption on the device, fair
  sharing with fair preemption routed to the CPU Preemptor, MultiKueue
  placements.

The ranks of each mesh are started once for all the cases, each with a
timeout of its own.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kueue_tpu.solver.kernel  # noqa: F401  enables jax x64 before any array
from kueue_tpu.parallel import mesh as jmesh
from kueue_tpu.solver.encode import State
from kueue_tpu_torch.parallel import mesh as tmesh
from kueue_tpu_torch.solver import kernel as tk
from kueue_tpu_torch.solver.synth import (synth_nested_inputs,
                                          synth_preempt_inputs,
                                          synth_solver_inputs,
                                          synth_start_rank)
from tests.test_torch_clusters import (cycle_cluster_args, finish_and_lose,
                                       mk_setup, mk_workloads)
from tests.test_torch_kernels import WL_KEYS, assert_same, jax_topo
from tests.test_torch_scheduler import PREEMPT_CASES as SCHED_PREEMPT
from tests.test_torch_scheduler import (PREEMPT_SEEDS,
                                        cpu_workloads, fair_cohort,
                                        fair_sharing_scenario,
                                        port_cpu_preemptor,
                                        random_fair_scenario,
                                        random_preempt_scenario, run_both,
                                        with_existing)

RANK = Path(__file__).resolve().parent / "torch_mesh_rank.py"
# layout -> (ranks, mesh kind)
LAYOUTS = {"flat1": (1, "flat"), "flat2": (2, "flat"), "flat4": (4, "flat"),
           "hosts4": (4, "hosts")}
RANK_TIMEOUT = 120  # seconds for one mesh's ranks to run every case
DENSE = ("admitted", "chosen", "borrows", "chosen_borrow", "fit", "usage",
         "cohort_usage")
P = 3


def tighten(topo, usage, wl):
    usage = usage + topo["nominal"] // 3  # Phase B rejects some heads
    wl["solvable"][::7] = False
    return usage


def flat(seed, W=40, Q=24, C=4):
    topo, usage, cu, wl = synth_solver_inputs(
        num_cqs=Q, num_cohorts=C, num_flavors=5, num_resources=2,
        num_workloads=W, num_podsets=P, seed=seed)
    return topo, tighten(topo, usage, wl), cu, wl


def nested(seed, depth, W=40):
    topo, usage, cu, wl = synth_nested_inputs(
        num_cqs=24, num_leaf_cohorts=4, fanout=2, depth=depth, num_flavors=5,
        num_resources=2, num_workloads=W, num_podsets=P, no_cohort_every=5,
        seed=seed)
    return topo, tighten(topo, usage, wl), cu, wl


def fair(topo, seed):
    """Fair weights 0/500/1000/3000 and the first root lending nothing."""
    rng = np.random.default_rng(seed + 70)
    topo = dict(topo)
    Q = topo["cq_cohort"].shape[0]
    topo["fair_weight"] = np.array([0, 500, 1000, 3000],
                                   np.int64)[rng.integers(0, 4, size=Q)]
    roots = topo["cohort_root"][topo["cq_cohort"][topo["cq_cohort"] >= 0]]
    topo["cohort_lendable"] = topo["cohort_lendable"].copy()
    topo["cohort_lendable"][roots.min()] = 0
    return topo


def cycle_case(topo, usage, cu, wl, fair_sharing=False, start_rank=None,
               cargs=None) -> dict:
    case = {f"topo/{k}": np.asarray(topo[k]) for k in tk.TOPO_FIELDS}
    case.update(usage=usage, cohort_usage=cu, num_podsets=np.int64(P),
                fair_sharing=np.bool_(fair_sharing),
                **{k: np.asarray(wl[k]) for k in WL_KEYS})
    if start_rank is not None:
        case["start_rank"] = start_rank
    if cargs is not None:
        case.update({f"cargs/{i}": a for i, a in enumerate(cargs)})
    return case


def preempt_case(depth, seed) -> dict:
    topo, usage, cu, args = synth_preempt_inputs(
        13, 20, depth=depth, num_cqs=32, num_flavors=2, seed=seed)
    case = {f"topo/{k}": np.asarray(topo[k]) for k in tk.TOPO_FIELDS}
    case.update(usage=usage, cohort_usage=cu)
    case.update({f"pargs/{i}": a for i, a in enumerate(args)})
    return case


def build_cases() -> dict:
    cases = {}
    cases["fit_flat"] = cycle_case(*flat(0))
    topo, usage, cu, wl = nested(1, 2)
    cases["fair_nested2"] = cycle_case(fair(topo, 1), usage, cu, wl,
                                       fair_sharing=True)
    topo, usage, cu, wl = flat(2)
    cases["start_rank"] = cycle_case(topo, usage, cu, wl,
                                     start_rank=synth_start_rank(wl, 5, 2))
    topo, usage, cu, wl = nested(3, 3)
    cases["clusters"] = cycle_case(topo, usage, cu, wl,
                                   cargs=cycle_cluster_args(topo, wl, 3))
    cases["ragged_w"] = cycle_case(*nested(4, 3, W=37))
    # one cohort of 3 CQs: one occupied domain, fewer than the ranks
    cases["one_domain"] = cycle_case(*flat(5, W=11, Q=3, C=1))
    topo, usage, cu, wl = nested(6, 3, W=45)
    cases["nested3_all"] = cycle_case(
        fair(topo, 6), usage, cu, wl, fair_sharing=True,
        start_rank=synth_start_rank(wl, 5, 6),
        cargs=cycle_cluster_args(topo, wl, 6))
    for depth in (1, 2, 3):
        cases[f"preempt_depth{depth}"] = preempt_case(depth, depth)
    return cases


CASES = build_cases()
CYCLE_CASES = [n for n in CASES if not n.startswith("preempt")]
K9_CASES = [n for n in CASES if n.startswith("preempt")]


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every case through every layout's gloo ranks: {(case, layout):
    [outputs of rank 0, rank 1, ...]}."""
    d = tmp_path_factory.mktemp("mesh")
    for name, case in CASES.items():
        np.savez(d / f"{name}.in.npz", **case)
    out = {}
    for layout, (n, kind) in LAYOUTS.items():
        store = d / f"store-{layout}"
        procs = [subprocess.Popen(
            [sys.executable, str(RANK), str(store), str(n), str(r), kind,
             str(d)], stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for r in range(n)]
        try:
            errs = [p.communicate(timeout=RANK_TIMEOUT)[1] for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for p, err in zip(procs, errs):
            assert p.returncode == 0, err.decode()[-3000:]
        for name in CASES:
            out[name, layout] = [dict(np.load(
                d / f"{name}.{kind}{n}.r{r}.npz")) for r in range(n)]
    return out


def jax_mesh(layout: str):
    n, kind = LAYOUTS[layout]
    devices = jax.devices()[:n]
    return jmesh.make_mesh(devices) if kind == "flat" \
        else jmesh.make_host_mesh(devices, hosts=2)


class Batch:
    def __init__(self, case):
        for k in WL_KEYS:
            setattr(self, k, case[k])


def topo_of(case) -> dict:
    return {k: case[f"topo/{k}"] for k in tk.TOPO_FIELDS}


def jax_cycle(case, layout, pargs=None, batch=None):
    topo = topo_of(case)
    return jmesh.solve_cycle_sharded(
        jax_mesh(layout), jax_topo(topo),
        State(usage=case["usage"], cohort_usage=case["cohort_usage"]),
        batch or Batch(case), P, fair_sharing=bool(case.get(
            "fair_sharing", False)),
        start_rank=case.get("start_rank"),
        preempt_args=None if pargs is None else tuple(
            jnp.asarray(a) for a in pargs),
        cluster_args=(tuple(case[f"cargs/{i}"] for i in range(4))
                      if "cargs/0" in case else None))


def same_on_every_rank(ranks: list) -> dict:
    first = ranks[0]
    for other in ranks[1:]:
        assert set(other) == set(first)
        for k in first:
            if k != "collectives":
                assert_same(other[k], first[k], k)
    return first


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", CYCLE_CASES)
def test_solve_cycle_sharded_matches_jax(name, layout, port_runs):
    case = CASES[name]
    got = same_on_every_rank(port_runs[name, layout])
    ref = jax_cycle(case, layout)
    keys = DENSE + (("mk_cluster",) if "cargs/0" in case else ())
    for k in keys:
        assert_same(got[f"dense/{k}"], np.asarray(ref[k]), k)
    # the compact form equals the single-device cycle's
    t = {k: torch.from_numpy(np.array(v)) for k, v in case.items()}
    fused = tk.solve_cycle_fused(
        tk.topo_to_device(topo_of(case), "cpu"), t["usage"],
        t["cohort_usage"], *(t[k] for k in WL_KEYS), num_podsets=P,
        fair_sharing=bool(case["fair_sharing"]),
        start_rank=t.get("start_rank"),
        cluster_args=(tuple(t[f"cargs/{i}"] for i in range(4))
                      if "cargs/0" in t else None))
    for k, v in fused.items():
        assert_same(got[f"compact/{k}"], v.numpy(), k)
    plan = jmesh.plan_cycle(jax_mesh(layout), topo_of(case), Batch(case))
    assert_same(got["plan/columns"], plan.columns, "columns")
    # per cycle (dense, then compact): phase_a's all-gather and the
    # combine's all-reduce, staged over two axes on the (2, 2) mesh
    axes = 2 if LAYOUTS[layout][1] == "hosts" else 1
    assert int(got["collectives"]) == 2 * (1 + axes)


def empty_batch(topo, W=8) -> Batch:
    """A batch with nothing to solve, for the preemption-only cases."""
    Q, F, R = topo["nominal"].shape
    return Batch({"requests": np.zeros((W, P, R), np.int64),
                  "podset_active": np.zeros((W, P), bool),
                  "wl_cq": np.zeros(W, np.int32),
                  "priority": np.zeros(W, np.int64),
                  "timestamp": np.zeros(W, np.float64),
                  "eligible": np.zeros((W, P, F), bool),
                  "solvable": np.zeros(W, bool)})


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", K9_CASES)
def test_solve_preempt_sharded_matches_jax(name, layout, port_runs):
    case = CASES[name]
    got = same_on_every_rank(port_runs[name, layout])
    pargs = tuple(case[f"pargs/{i}"] for i in range(15))
    ref = jax_cycle(case, layout, pargs=pargs,
                    batch=empty_batch(topo_of(case)))
    assert_same(got["targets"], np.asarray(ref["preempt_targets"]), "targets")
    assert_same(got["feasible"], np.asarray(ref["preempt_feasible"]),
                "feasible")
    single = tk.solve_preempt(
        tk.topo_to_device(topo_of(case), "cpu"),
        torch.from_numpy(case["usage"]),
        torch.from_numpy(case["cohort_usage"]),
        *(torch.from_numpy(a) for a in pargs))
    for k, v in zip(("targets", "feasible", "stats"), single):
        assert_same(got[k], v.numpy(), k)
    assert got["feasible"].any() and got["targets"].any()


# --- the Scheduler with a mesh solver on both sides ---

@pytest.fixture(scope="module")
def mesh_solvers():
    """Factories of mesh solvers: the JAX package's on a 2-device JAX
    mesh, the port's on a world-size-1 gloo group in this process
    (destroyed at teardown)."""
    from kueue_tpu.solver import BatchSolver as JaxSolver
    from kueue_tpu_torch.solver import BatchSolver as PortSolver
    port = tmesh.make_mesh(device="cpu")
    jm = jmesh.make_mesh(jax.devices()[:2])
    yield {"kueue_tpu": lambda: JaxSolver(mesh=jm),
           "kueue_tpu_torch": lambda: PortSolver(mesh=port)}
    port.close()


def mesh_run(solvers, setup, workloads, cycles=1, **kw):
    """run_both on the device route with the mesh solvers; the port's
    solver stays unbound (no journal, no resident state). Returns the
    observation and both Envs (JAX first)."""
    envs = []
    got, _ = run_both(setup, workloads, "device", cycles=cycles,
                      envs_out=envs, solvers=solvers, **kw)
    port = envs[1].scheduler.solver
    assert port.mesh is not None and not port.resident_capable
    assert port.resident is None and port.last_domain_plan is not None
    return got, envs


@pytest.mark.parametrize("case", sorted(SCHED_PREEMPT))
def test_scheduler_mesh_device_preemption(case, mesh_solvers):
    """Minimal preemption under a mesh: the port's K9 through
    solve_preempt_sharded against the JAX sharded execute's."""
    setup, existing, workloads, evicted = SCHED_PREEMPT[case]
    got, envs = mesh_run(mesh_solvers, with_existing(setup, existing),
                         workloads, preempt="device")
    assert envs[1].scheduler.last_preempt_gate == "device"
    assert got["evicted"]
    if evicted is not None:
        assert set(got["evicted"]) == evicted


@pytest.mark.parametrize("seed", PREEMPT_SEEDS[:4])
def test_scheduler_mesh_random_preemption(seed, mesh_solvers):
    setup, workloads = random_preempt_scenario(seed)
    mesh_run(mesh_solvers, setup, workloads, cycles=2, preempt="device")


@pytest.mark.parametrize("case", ("differential", "random"))
def test_scheduler_mesh_fair_preemption_on_cpu(case, mesh_solvers):
    """Fair sharing under a mesh: every preempt-mode head's targets come
    from the CPU Preemptor at nomination (no device preemption solve),
    on both sides alike, and equal the port's own CPU Preemptor's."""
    if case == "differential":
        setup = with_existing(fair_cohort(names=("a", "b", "c"), quota="3"),
                              lambda: cpu_workloads(
                                  [(f"a{i}", "a", 0, float(i), "1")
                                   for i in range(3)]
                                  + [(f"b{i}", "b", 0, float(i), "1")
                                     for i in range(5)]
                                  + [("c0", "c", 0, 0.0, "1")],
                                  reserve=True))
        workloads = lambda: cpu_workloads(  # noqa: E731
            [("c_incoming", "c", 0, 100.0, "1")])
        cycles = 1
    else:
        setup, workloads, _ = random_fair_scenario(3)
        cycles = 2
    got, envs = mesh_run(mesh_solvers, setup, workloads, cycles=cycles,
                         fair_sharing=True, preempt="device")
    port = envs[1].scheduler
    assert port.last_preempt_gate in ("", "cpu")
    assert port.solver.counters["syncs"] == port.solver.counters[
        "dispatches"] * 2  # the upload's sync and the cycle's: no K9/K11
    cpu = port_cpu_preemptor(setup, workloads, cycles)
    assert cpu["evicted"] == got["evicted"]
    assert cpu["applied"] == got["applied"]
    if case == "differential":
        assert got["evicted"]


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_scheduler_mesh_fair_sharing(seed, mesh_solvers):
    """The DRF order under a mesh (drf_share replicated on the ranks)."""
    setup, workloads = fair_sharing_scenario(seed)
    mesh_run(mesh_solvers, setup, workloads, cycles=2, fair_sharing=True)


@pytest.mark.parametrize("fair", (False, True))
def test_scheduler_mesh_multikueue(fair, mesh_solvers):
    """MultiKueue under a mesh: cluster columns scored replicated after
    the combine; five cycles with finishes and a lost cluster, the same
    placements as the JAX Scheduler's."""
    envs = []
    run_both(mk_setup("fleet"), mk_workloads, "device", fair_sharing=fair,
             cycles=5, between=finish_and_lose, envs_out=envs,
             solvers=mesh_solvers)
    ref, got = (env.fleet.placements for env in envs)
    assert got == ref
    assert {"w0", "w1", "w3"} <= set(dict(got).values())
    assert all(c != "w1" for _, c in got[envs[1].lost_from:])


# --- the mesh's own contract ---

def test_mesh_refuses_other_devices(mesh_solvers, monkeypatch):
    """A gloo group runs no collective on another device's tensors, a
    mesh on the card needs one, and init_distributed starts nothing
    without a coordinator."""
    import torch.distributed as dist
    mesh = tmesh.make_mesh(device="cpu")  # the fixture's group, reused
    assert mesh.size == 1 and mesh.rank == 0
    with pytest.raises(ValueError, match="cannot run collectives"):
        tmesh.Mesh(dist.group.WORLD, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="a collective on a meta tensor"):
        mesh.all_reduce(torch.zeros(2, device="meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh()
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tmesh.init_distributed() is False


def test_mesh_solver_is_unbound_and_refuses_fair_batches(mesh_solvers):
    """Under a mesh: no solver consumer of the usage journal (the
    journal has only the incremental snapshot's), no resident state, and
    a fair batch raises (the Scheduler sends fair preemption to the
    CPU)."""
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver.synth import synth_fair_problems
    solver = mesh_solvers["kueue_tpu_torch"]()
    sched, cache, queues, _ = ns.build_scheduler(8, 2, ["f0"], 4,
                                                 solver=solver)
    assert set(cache._journal_cursors) == {"snapshot"}
    assert not solver.resident_capable and solver._cache is cache
    ns.stage_waves(queues, 1, 8, 4)
    heads = queues.heads_nonblocking()
    snapshot = cache.snapshot()
    plan = solver.prepare(snapshot, heads)
    fair = synth_fair_problems(plan.topo, 2, 4, seed=0)
    with pytest.raises(ValueError, match="does not run under a mesh"):
        solver.solve_prepared(plan, snapshot, fair_batch=fair)
    decisions, _ = solver.solve_prepared(plan, snapshot)
    assert decisions and solver.resident is None
    with pytest.raises(ValueError, match="does not run under a mesh"):
        solver.solve_preemptions(None, fair, ())
    assert solver.last_domain_plan.n_devices == 1
    assert solver.last_phase_s["plan"] > 0


@pytest.mark.parametrize("plan", (False, True))
def test_per_device_scan_width_matches_jax(plan):
    case = CASES["nested3_all"]
    args = (case["wl_cq"], case["topo/cq_cohort"], case["topo/cohort_root"],
            case["topo/offered"], 4)
    from kueue_tpu.parallel.domains import plan_domains as jplan
    from kueue_tpu_torch.parallel.domains import plan_domains as tplan
    got = tmesh.per_device_scan_width(24, 7, 4, tplan(*args) if plan else None)
    ref = jmesh.per_device_scan_width(24, 7, 4, jplan(*args) if plan else None)
    assert got == ref
