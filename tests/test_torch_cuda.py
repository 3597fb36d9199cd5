"""The CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips on a machine without a CUDA
device. The file imports no JAX, so that it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

from collections import deque

import numpy as np
import pytest
import torch

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.parallel import domains as tdom
from kueue_tpu_torch.parallel import mesh as tmesh
from kueue_tpu_torch.sim import northstar as ns
from kueue_tpu_torch.solver import BatchSolver, encode
from kueue_tpu_torch.solver import kernel as tk
from kueue_tpu_torch.solver.fairpreempt import strategy_flags
from kueue_tpu_torch.scheduler.preemption import parse_strategies
from kueue_tpu_torch.solver.synth import (cluster_oracle,
                                          synth_cluster_inputs,
                                          synth_deltas, synth_fair_inputs,
                                          synth_fair_problems,
                                          synth_nested_inputs,
                                          synth_preempt_inputs,
                                          synth_preempt_problems,
                                          synth_solver_inputs,
                                          synth_start_rank)

WL_KEYS = ("requests", "podset_active", "wl_cq", "priority", "timestamp",
           "eligible", "solvable")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def inputs(kind: str):
    if kind == "flat":
        topo, usage, cu, wl = synth_solver_inputs(
            num_cqs=64, num_cohorts=8, num_flavors=40, num_resources=3,
            num_workloads=96, num_podsets=3, seed=3)
    else:
        topo, usage, cu, wl = synth_nested_inputs(
            num_cqs=64, num_leaf_cohorts=8, fanout=2, depth=3,
            num_flavors=40, num_resources=3, num_workloads=96, num_podsets=3,
            no_cohort_every=5, seed=3)
    return topo, usage + topo["nominal"] // 3, cu, wl


def fair_inputs(kind: str):
    """inputs() with fair weights 0/500/1000/3000 and the first root
    cohort lending nothing (shares of -1000 // weight, floored)."""
    topo, usage, cu, wl = inputs(kind)
    rng = np.random.default_rng(9)
    Q = topo["cq_cohort"].shape[0]
    topo["fair_weight"] = np.array([0, 500, 1000, 3000],
                                   np.int64)[rng.integers(0, 4, size=Q)]
    roots = topo["cohort_root"][topo["cq_cohort"][topo["cq_cohort"] >= 0]]
    topo["cohort_lendable"] = topo["cohort_lendable"].copy()
    topo["cohort_lendable"][roots.min()] = 0
    return topo, usage, cu, wl


@pytest.mark.cuda
@pytest.mark.parametrize("fair", (False, True))
@pytest.mark.parametrize("compact", (True, False))
@pytest.mark.parametrize("kind", ("flat", "nested"))
def test_fused_cycle_on_card_equals_plain(kind, compact, fair, cuda_device):
    """F=40 puts more than one flavor on a lane; R=3 and P=3 widen the
    per-podset loops; with fair sharing the order takes drf_share's
    shares."""
    topo, usage, cu, wl = fair_inputs(kind) if fair else inputs(kind)
    start_rank = torch.from_numpy(synth_start_rank(wl, 40, seed=3))
    host = [tk.topo_to_device(topo, "cpu"),
            *tk.state_to_device(usage, cu, "cpu"),
            *(torch.from_numpy(np.array(wl[k])) for k in WL_KEYS)]
    card = [{k: v.to(cuda_device) for k, v in host[0].items()}] + \
        [t.to(cuda_device) for t in host[1:]]
    want = tk.solve_cycle_fused(*host, num_podsets=3, max_rank=0,
                                fair_sharing=fair, start_rank=start_rank,
                                compact=compact)
    before = tk.launch_counts()
    got = tk.solve_cycle_fused(*card, num_podsets=3, max_rank=0,
                               fair_sharing=fair,
                               start_rank=start_rank.to(cuda_device),
                               compact=compact)
    torch.cuda.synchronize()
    after = tk.launch_counts()
    launched = ("avail", "phase_a", "order", "phase_b") + \
        (("pack",) if compact else ()) + (("drf_share",) if fair else ())
    assert all(after[k] == before[k] + 1 for k in launched)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("flat", "nested"))
def test_order_deltas_arena_on_card_equal_plain(kind, cuda_device):
    """order with ties (priorities and timestamps drawn from a few
    values), deltas on a nested chain, and the arena scatter (padded
    with `cap`) and gather (padded with -1)."""
    topo, usage, cu, wl = inputs(kind)
    rng = np.random.default_rng(5)
    W = wl["wl_cq"].shape[0]
    host_topo = tk.topo_to_device(topo, "cpu")
    card_topo = {k: v.to(cuda_device) for k, v in host_topo.items()}
    args = [torch.from_numpy(a) for a in (
        rng.uniform(size=W) < 0.7, rng.uniform(size=W) < 0.3,
        rng.integers(0, 3, size=W).astype(np.int64),
        rng.integers(0, 4, size=W).astype(np.float64), wl["wl_cq"])]
    for n in (W, W - 5):  # W - 5: a ragged last warp and block
        want = tk.order_csr(host_topo, *(a[:n] for a in args))
        got = tk.order_csr(card_topo, *(a[:n].to(cuda_device) for a in args))
        assert got[2] is None and want[2] is None
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a.cpu(), b)

    deltas = [torch.from_numpy(a) for a in synth_deltas(topo, usage, 100,
                                                         seed=5)]
    u, c = tk.state_to_device(usage, cu, "cpu")
    u_card, c_card = u.to(cuda_device), c.to(cuda_device)
    tk.apply_state_deltas(host_topo, u, c, *deltas)
    tk.apply_state_deltas(card_topo, u_card, c_card,
                          *(d.to(cuda_device) for d in deltas))
    assert torch.equal(u_card.cpu(), u) and torch.equal(c_card.cpu(), c)

    S, D = 512, 32
    twin = {k: torch.from_numpy(np.ascontiguousarray(v[rng.integers(
        0, W, size=S)])) for k, v in wl.items() if k in tk.ARENA_FIELDS}
    rows = {k: v[torch.from_numpy(rng.integers(0, S, size=D))]
            for k, v in twin.items()}
    upd = np.full(D, S, np.int32)
    upd[:D - 5] = rng.choice(S, size=D - 5, replace=False)
    card_twin = {k: v.to(cuda_device) for k, v in twin.items()}
    tk.scatter_arena_rows(twin, torch.from_numpy(upd), rows)
    tk.scatter_arena_rows(card_twin, torch.from_numpy(upd).to(cuda_device),
                          {k: v.to(cuda_device) for k, v in rows.items()})
    for k in tk.ARENA_FIELDS:
        assert torch.equal(card_twin[k].cpu(), twin[k]), k
    slots = rng.integers(-1, S, size=W).astype(np.int32)
    want = tk.gather_arena(twin, torch.from_numpy(slots))
    got = tk.gather_arena(card_twin, torch.from_numpy(slots).to(cuda_device))
    for k, a, b in zip(tk.ARENA_FIELDS, got, want):
        assert torch.equal(a.cpu(), b), k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("flat", "nested"))
def test_drf_share_and_shared_order_on_card_equal_plain(kind, cuda_device):
    """drf_share on Phase A's assignment (weights 0/500/1000/3000, a root
    lending nothing), W and the ragged W - 5; the order with those
    shares and with a mix of ties, negatives and NO_LIMIT; and the floor
    case: drs -1 over weight 3000 is -1."""
    topo, usage, cu, wl = fair_inputs(kind)
    host_topo = tk.topo_to_device(topo, "cpu")
    card_topo = {k: v.to(cuda_device) for k, v in host_topo.items()}
    u, c = tk.state_to_device(usage, cu, "cpu")
    a = tk.phase_a(host_topo, tk.avail(host_topo, u, c), u,
                   *(torch.from_numpy(np.array(wl[k])) for k in
                     ("requests", "podset_active", "wl_cq", "eligible",
                      "solvable")), 3)
    fit, borrows, asg = a[0], a[1], a[4]
    wl_cq = torch.from_numpy(wl["wl_cq"])
    rng = np.random.default_rng(4)
    W = wl_cq.shape[0]
    mixed = torch.from_numpy(rng.choice(np.array(
        [-2, -1, 0, 0, 125, 125, 333, tk.NO_LIMIT], np.int64), size=W))
    prio = torch.from_numpy(rng.integers(0, 3, size=W).astype(np.int64))
    ts = torch.from_numpy(rng.integers(0, 4, size=W).astype(np.float64))
    for n in (W, W - 5):
        want = tk.drf_share(host_topo, u, asg[:n], wl_cq[:n])
        got = tk.drf_share(card_topo, u.to(cuda_device),
                           asg[:n].to(cuda_device), wl_cq[:n].to(cuda_device))
        assert torch.equal(got.cpu(), want)
        assert (want < 0).any() and (want == tk.NO_LIMIT).any()
        for share in (want, mixed[:n]):
            args = (fit[:n], borrows[:n], prio[:n], ts[:n], wl_cq[:n], share)
            ref = tk.order_csr(host_topo, *args)
            out = tk.order_csr(card_topo, *(x.to(cuda_device) for x in args))
            assert out[2] is None
            for x, y in zip(out[:2], ref[:2]):
                assert torch.equal(x.cpu(), y)
    floor_topo = {k: v.clone() for k, v in card_topo.items()}
    floor_topo["fair_weight"][:] = 3000
    floor_topo["cohort_lendable"][:] = 0
    share = tk.drf_share(floor_topo, u.to(cuda_device), asg.to(cuda_device),
                         wl_cq.to(cuda_device)).cpu()
    assert (share == -1).any() and not (share == 0).all()
    assert torch.equal(share, tk.drf_share_plain(
        {k: v.cpu() for k, v in floor_topo.items()}, u, asg, wl_cq))


@pytest.mark.cuda
def test_batch_solver_on_card_equals_cpu(cuda_device):
    flavors = [f"f{i}" for i in range(6)]
    cache, queues = ns.build_cluster(48, 6, flavors, 40)
    ns.stage_waves(queues, 4, 48, 40)
    on_card, on_cpu = BatchSolver(device=cuda_device), BatchSolver(device="cpu")
    for cycle in range(3):
        heads = queues.heads_nonblocking()
        snapshot = cache.snapshot()
        got = on_card.solve(snapshot, heads)
        want = on_cpu.solve(snapshot, heads)
        assert {i: (a.pod_sets, ok) for i, (a, ok) in got.items()} == \
            {i: (a.pod_sets, ok) for i, (a, ok) in want.items()}
        assert ns.apply_decisions(cache, queues, None, heads, got,
                                  float(cycle)) == 48


@pytest.mark.cuda
@pytest.mark.parametrize("fair", (False, True))
def test_bound_solver_on_card_equals_cpu(fair, cuda_device):
    """A short churn on a full cluster: finishes feed the delta prologue,
    requeued heads keep their arena rows, new heads are scattered; each
    cycle also carries a preemption batch over the cycle's topology, and
    with fair sharing a fair-sharing preemption batch too, solved in the
    same dispatch against the pre-cycle usage (K10's preemption
    composition). Every kernel of the bound cycle launches, solve_preempt
    included; drf_share and solve_fair only with fair sharing, and
    cluster_cols never (the snapshots carry no cluster columns)."""
    flavors = [f"f{i}" for i in range(4)]
    cache, queues = ns.build_cluster(32, 4, flavors, 10, api.STRICT_FIFO)
    admitted = deque()
    for f in flavors:
        for i in range(32):
            wl = ns.admitted_workload(f"pre-{f}-{i}", f"cq{i}", f, 10, 0.0)
            cache.assume_workload(wl)
            admitted.append(wl)
    ns.stage_waves(queues, 4, 32, 10)
    solver = BatchSolver(device=cuda_device)
    solver.bind_cache(cache)
    solver.bind_queues(queues)
    reference = BatchSolver(device="cpu")
    tk.reset_launch_counts()
    for cycle in range(4):
        ns.finish_admitted(cache, admitted, 8)
        heads = queues.heads_nonblocking()
        snapshot = cache.snapshot()
        plans = [s.prepare(snapshot, heads) for s in (solver, reference)]
        batch = synth_preempt_problems(plans[0].topo, 12, 40, seed=cycle)
        fair_batch = synth_fair_problems(plans[0].topo, 12, 40, seed=cycle) \
            if fair else None
        (got, got_pre), (want, want_pre) = (
            s.solve_prepared(p, snapshot, preempt_batch=batch,
                             fair_sharing=fair, fair_batch=fair_batch,
                             fs_flags=strategy_flags(parse_strategies(None)))
            for s, p in zip((solver, reference), plans))
        assert {i: (a.pod_sets, ok) for i, (a, ok) in got.items()} == \
            {i: (a.pod_sets, ok) for i, (a, ok) in want.items()}
        assert set(got_pre) == set(want_pre)
        for key in ("preempt", "preempt_stats", "fair", "fair_stats"):
            if key not in want_pre:
                continue
            pair = (got_pre[key], want_pre[key])
            for a, b in zip(*(p if isinstance(p, tuple) else (p,)
                              for p in pair)):
                assert np.array_equal(a, b), key
        assert want_pre["preempt"][1].any()
        assert ns.apply_decisions(cache, queues, solver, heads, got,
                                  float(cycle), admitted) > 0
        rs = solver.resident
        truth = encode.encode_state(cache.snapshot(), solver._topo_cache[0])
        assert np.array_equal(rs.usage_dev.cpu().numpy(), truth.usage)
        assert np.array_equal(rs.cohort_dev.cpu().numpy(), truth.cohort_usage)
    launched = tk.launch_counts()
    assert all(n > 0 for name, n in launched.items()
               if name not in ("drf_share", "solve_fair", "cluster_cols",
                               "mesh_combine", "global_scan"))
    assert launched["mesh_combine"] == 0  # no mesh here
    assert launched["global_scan"] == 0  # the oracle: no production path
    assert (launched["drf_share"] > 0) == fair
    assert (launched["solve_fair"] > 0) == fair
    assert launched["cluster_cols"] == 0  # no cluster columns here


@pytest.mark.cuda
@pytest.mark.parametrize("weights", (None, (500, 1000, 3000, 0, 2000)))
def test_scheduler_fair_on_card_equals_cpu(weights, cuda_device):
    """The port's Scheduler with fair sharing on the fair-sharing
    configuration (2 units per CQ, 4-unit workloads), on the card and on
    the CPU: the same admissions and usage every cycle, every cycle on
    the device route, drf_share launched. With the configuration's equal
    weights every share is the same; with mixed weights the shares set
    the order within each cohort (test_torch_scheduler.py
    test_fair_weights_change_the_admissions)."""
    runs = []
    tk.reset_launch_counts()
    for device in (cuda_device, "cpu"):
        env = ns.build_scheduler(32, 8, ["f0"], 2,
                                 solver=BatchSolver(device=device),
                                 fair_sharing=True, fair_weights=weights)
        ns.stage_waves(env[2], 5, 32, 4)
        runs.append(env)
    for cycle in range(4):
        rows = []
        for sched, cache, queues, client in runs:
            ns.finish_applied(cache, queues, client)
            sched.schedule(timeout=0)
            assert sched.last_route == "device"
            rows.append((client.admitted,
                         sorted(wl.metadata.name for wl in client.new_applied),
                         [cache.usage_for_cluster_queue(f"cq{i}")
                          for i in range(32)]))
        assert rows[0] == rows[1], cycle
    assert runs[0][3].admitted == 4 * 16
    assert tk.launch_counts()["drf_share"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("depth,max_candidates", ((1, 40), (2, 120), (3, 600)))
def test_solve_preempt_on_card_equals_plain(depth, max_candidates,
                                            cuda_device):
    """K9 against its plain version on seeded batches: a flat cohort
    forest and trees 2 and 3 deep (a node shared by CQs at two depths),
    within-CQ, reclaim and threshold problems, problems with no
    candidates or no fitting prefix, padding problems; at K = 2048 each
    thread owns a chunk of 8 candidates. All three outputs equal."""
    topo, usage, cu, args = synth_preempt_inputs(
        200, max_candidates, max_local_cqs=6, depth=depth, seed=depth)
    tt = tk.topo_to_device(topo, cuda_device)
    state = tk.state_to_device(usage, cu, cuda_device)
    dev_args = [torch.from_numpy(a).to(cuda_device) for a in args]
    want = tk.solve_preempt_plain(tt, *state, *dev_args)
    before = tk.launch_counts()["solve_preempt"]
    got = tk.solve_preempt(tt, *state, *dev_args)
    torch.cuda.synchronize()
    assert tk.launch_counts()["solve_preempt"] == before + 1
    for name, a, b in zip(("targets", "feasible", "stats"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    targets, feasible, stats = (t.cpu() for t in want)
    assert feasible[:200].any() and not feasible[:200].all()
    assert stats[:, 3].sum() > 0 and stats[:, 2].max() >= 2
    assert targets.any()


@pytest.mark.cuda
def test_scheduler_preempt_on_card_equals_cpu(cuda_device):
    """The port's Scheduler with device preemption on the reclaim
    configuration at 2 roots x 2 children x 4 CQs x 6 victims, on the
    card and on the CPU: the same evictions (workload, reason) and
    admissions each cycle, the same solve stats, solve_preempt launched
    on the card."""
    runs = []
    tk.reset_launch_counts()
    for device in (cuda_device, "cpu"):
        env = ns.build_preempt_reclaim(2, 2, 4, 6,
                                       solver=BatchSolver(device=device))
        env[0].solver_sync_floor_ms = 0.0
        runs.append(env)
    for cycle in range(3):
        rows = []
        for sched, cache, queues, client in runs:
            sched.schedule(timeout=0)
            assert sched.last_route == "device"
            rows.append((list(client.evictions),
                         sorted(wl.metadata.name for wl in client.new_applied),
                         sched.last_preempt_plan))
        assert rows[0] == rows[1], cycle
    assert runs[0][3].evictions and runs[0][0].last_preempt_gate == "device"
    assert tk.launch_counts()["solve_preempt"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("depth", (1, 2, 3))
def test_solve_fair_on_card_equals_plain(depth, cuda_device):
    """K11 against its plain version on seeded batches (a flat cohort
    forest, trees 2 and 3 deep with a node shared at two depths; weight
    0, roots lending nothing, borrowing outside the slots, thresholds,
    padding problems), under every strategy order. All four outputs
    equal, padding untouched."""
    topo, usage, cu, args = synth_fair_inputs(
        200, 120, max_local_cqs=8, depth=depth, num_flavors=3, seed=depth)
    tt = tk.topo_to_device(topo, cuda_device)
    state = tk.state_to_device(usage, cu, cuda_device)
    dev_args = [torch.from_numpy(a).to(cuda_device) for a in args]
    for strat in ((True, True, False), (True, False, False),
                  (False, False, False), (False, True, True)):
        want = tk.solve_fair_plain(tt, *state, *dev_args, strat=strat)
        before = tk.launch_counts()["solve_fair"]
        got = tk.solve_fair(tt, *state, *dev_args, strat=strat)
        torch.cuda.synchronize()
        assert tk.launch_counts()["solve_fair"] == before + 1
        for name, a, b in zip(("targets", "feasible", "reasons", "stats"),
                              got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, strat)
        targets, feasible, reasons, stats = (t.cpu() for t in want)
        assert feasible[:200].any() and not feasible[:200].all()
        assert not targets[200:].any() and not stats[200:].any()
        assert stats[:, 1].max() > 1


def preemptions_syncs(solver, calls: list) -> None:
    """Record (the solves run, syncs made) of each solve_preemptions."""
    real = solver.solve_preemptions

    def counted(*a, **kw):
        before = solver.counters["syncs"]
        aux = real(*a, **kw)
        calls.append((sorted(aux or ()), solver.counters["syncs"] - before))
        return aux
    solver.solve_preemptions = counted


@pytest.mark.cuda
def test_scheduler_fair_preempt_on_card_equals_cpu(cuda_device):
    """The port's Scheduler with fair sharing and device preemption on
    the fair-sharing preemption configuration at 32 CQs in 4 cohorts,
    and on a cycle with a minimal and a fair problem, on the card and
    on the CPU: the same evictions (workload, reason) and admissions and
    the same solve stats; solve_fair launched on the card; K9 and K11
    of the mixed cycle after one sync."""
    tk.reset_launch_counts()
    for build, kinds in ((lambda s: ns.build_fair_preemption(32, 4, solver=s),
                          ["fair"]),
                         (lambda s: ns.build_mixed_preemption(solver=s),
                          ["fair", "minimal"])):
        rows, calls = [], []
        for device in (cuda_device, "cpu"):
            sched, cache, queues, client = build(BatchSolver(device=device))
            sched.solver_sync_floor_ms = 0.0
            preemptions_syncs(sched.solver, calls)
            sched.schedule(timeout=0)
            assert sched.last_route == "device"
            assert sched.last_preempt_gate == "device"
            assert sorted(sched.last_preempt_plan) == kinds
            rows.append((list(client.evictions),
                         sorted(wl.metadata.name for wl in client.new_applied),
                         sched.last_preempt_plan))
        assert rows[0] == rows[1]
        assert rows[0][0]
        solves = sorted({"fair": "fair", "minimal": "preempt"}[k]
                        for k in kinds)
        want = sorted(solves + [f"{k}_stats" for k in solves])
        assert calls == [(want, 1), (want, 1)]
    assert tk.launch_counts()["solve_fair"] == 2
    assert tk.launch_counts()["solve_preempt"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((8, 32, 2, 2048, 4), (3, 5, 3, 97, 2),
                                   (16, 126, 4, 1024, 3)))
def test_cluster_cols_on_card_equals_plain_and_oracle(shape, cuda_device):
    """K12 on K clusters, F flavors, R resources, W rows, P podsets: equal
    to its plain version and to the host oracle walked in the admit order.
    (3, 5, 3, 97, 2): fewer columns than lanes and a ragged last warp;
    (16, 126, 4, ...): 72 KB of shared memory, above the default 48."""
    K, F, R, W, P = shape
    for seed in (0, 1):
        cols, _, resources, args = synth_cluster_inputs(
            num_clusters=K, num_flavors=F, num_resources=R, num_workloads=W,
            num_podsets=P, seed=seed)
        host = [torch.from_numpy(a) for a in args]
        want = tk.score_cluster_columns(*host)
        before = tk.score_cluster_columns.launches
        got = tk.score_cluster_columns(*(t.to(cuda_device) for t in host))
        torch.cuda.synchronize()
        assert tk.score_cluster_columns.launches == before + 1
        assert torch.equal(got.cpu(), want)
        oracle = cluster_oracle(cols, resources, args[4], args[5], args[6],
                                args[7], args[8], args[3])
        np.testing.assert_array_equal(got.cpu().numpy(), oracle)
        assert (oracle >= 0).any() and (oracle[args[8]] == -1).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("flat", "nested"))
def test_global_order_on_card_equals_plain(kind, cuda_device):
    """order_csr's global admit order (with_order) with ties, NaN
    timestamps and shares with negatives and NO_LIMIT."""
    topo, usage, cu, wl = inputs(kind)
    rng = np.random.default_rng(8)
    W = wl["wl_cq"].shape[0]
    ts = rng.integers(0, 4, size=W).astype(np.float64)
    ts[rng.random(W) < 0.1] = np.nan
    share = rng.choice(np.array([-2, -1, 0, 0, 125, 333, tk.NO_LIMIT],
                                np.int64), size=W)
    host_topo = tk.topo_to_device(topo, "cpu")
    card_topo = {k: v.to(cuda_device) for k, v in host_topo.items()}
    args = [torch.from_numpy(a) for a in (
        rng.uniform(size=W) < 0.7, rng.uniform(size=W) < 0.3,
        rng.integers(0, 3, size=W).astype(np.int64), ts, wl["wl_cq"], share)]
    for n in (W, W - 5):
        want = tk.order_csr(host_topo, *(a[:n] for a in args),
                            with_order=True)
        got = tk.order_csr(card_topo, *(a[:n].to(cuda_device) for a in args),
                           with_order=True)
        assert len(got) == 3
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_scheduler_multikueue_on_card_equals_cpu(cuda_device):
    """The MultiKueue cell at 64 CQs: each cycle the bound cycle on the
    card launches cluster_cols once, and the placements (on_placement, in
    order) and admissions equal the same cycles with device="cpu", also
    after a cluster is lost."""
    def run(device):
        sched, cache, queues, client, remote = ns.build_multikueue(
            num_cqs=64, num_cohorts=8, num_flavors=8, waves=6,
            solver=BatchSolver(device=device),
            fleet={"w0": {("f0", "cpu"): 400_000,
                          ("f0", "memory"): 400 << 30},
                   "w1": {(f, r): 200_000 if r == "cpu" else 200 << 30
                          for f in ("f1", "f10", "f2") for r in
                          ("cpu", "memory")},
                   "w2": {("f7", "cpu"): 10**9}})
        out = []
        for cycle in range(4):
            if cycle == 2:
                remote.lost.add("w1")
            ns.finish_applied(cache, queues, client, remote)
            start = len(remote.placements)
            before = tk.score_cluster_columns.launches
            sched.schedule(timeout=0)
            assert sched.last_route == "device"
            launched = tk.score_cluster_columns.launches - before
            out.append((tuple(wl.metadata.name for wl in client.new_applied),
                        tuple(remote.placements[start:]), launched))
        return out

    got, want = run(cuda_device), run("cpu")
    assert [g[:2] for g in got] == [w[:2] for w in want]
    assert all(g[2] == 1 for g in got)
    clusters = {c for g in got for _, c in g[1]}
    assert {"w0", "w1"} <= clusters and "w2" not in clusters
    assert all(c != "w1" for g in got[2:] for _, c in g[1])


# --- the sharded cycle's pieces (parallel/mesh.py) ---

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("flat", "nested"))
def test_phase_b_columns_on_card_equal_plain(kind, cuda_device):
    """phase_b over each rank's columns of a 3-way plan (padded with the
    sentinel D and with -1) against the plain version; the three ranks'
    admissions are disjoint and their deltas add up to the whole cycle's."""
    topo, usage, cu, wl = inputs(kind)
    host_topo = tk.topo_to_device(topo, "cpu")
    card_topo = {k: v.to(cuda_device) for k, v in host_topo.items()}
    u, c = tk.state_to_device(usage, cu, "cpu")
    batch = [torch.from_numpy(np.array(wl[k])) for k in WL_KEYS]
    requests, podset_active, wl_cq, priority, timestamp, eligible, \
        solvable = batch
    fit, borrows, _, _, asg = tk.phase_a(host_topo, tk.avail(host_topo, u, c),
                                         u, requests, podset_active, wl_cq,
                                         eligible, solvable, 3)
    offsets, members, _ = tk.order_csr(host_topo, fit, borrows, priority,
                                       timestamp, wl_cq)
    D = offsets.shape[0] - 1
    plan = tdom.plan_domains(wl["wl_cq"], topo["cq_cohort"],
                             topo["cohort_root"], topo["offered"], 3)
    whole = tk.phase_b(host_topo, u, c, asg, fit, wl_cq, offsets, members)
    admitted = torch.zeros_like(whole[0])
    du, dc = torch.zeros_like(u), torch.zeros_like(c)
    args = (u, c, asg, fit, wl_cq, offsets, members)
    for r, row in enumerate(plan.columns):
        cols = np.where(row >= 0, row, D if r % 2 else -1).astype(np.int32)
        cols = torch.from_numpy(cols)
        want = tk.phase_b(host_topo, *args, cols)
        got = tk.phase_b(card_topo, *(a.to(cuda_device) for a in args),
                         cols.to(cuda_device))
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        assert not (admitted & want[0]).any()
        admitted |= want[0]
        du += want[1] - u
        dc += want[2] - c
    assert (plan.columns < 0).any()  # the plan has padding lanes
    assert torch.equal(admitted, whole[0])
    assert torch.equal(u + du, whole[1]) and torch.equal(c + dc, whole[2])


@pytest.mark.cuda
@pytest.mark.parametrize("depth", (1, 3))
def test_solve_preempt_slots_on_card_equal_plain(depth, cuda_device):
    """K9 over each rank's slots of a 3-way problem plan (pad lanes B and
    -1) against the plain version; the rows of the three ranks add up to
    the single launch's outputs."""
    topo, usage, cu, args = synth_preempt_inputs(
        50, 40, depth=depth, num_cqs=64, num_flavors=3, seed=depth)
    host = (tk.topo_to_device(topo, "cpu"),
            *tk.state_to_device(usage, cu, "cpu"),
            *(torch.from_numpy(a) for a in args))
    card = ({k: v.to(cuda_device) for k, v in host[0].items()},
            *(t.to(cuda_device) for t in host[1:]))
    whole = tk.solve_preempt(*card)
    perm, _, b_local = tdom.plan_problems(tmesh.preempt_weights(args[7]), 3)
    B = args[7].shape[0]
    sums = [torch.zeros_like(t) for t in whole]
    for r in range(3):
        mine = perm[r * b_local:(r + 1) * b_local].astype(np.int32)
        mine[mine == B] = -1 if r == 1 else B
        slots = torch.from_numpy(mine)
        want = tk.solve_preempt(*host, slots=slots)
        got = tk.solve_preempt(*card, slots=slots.to(cuda_device))
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        for acc, part in zip(sums, got):
            acc += part
    assert (perm == B).any()  # some lanes are padding
    for acc, t in zip(sums, whole):
        assert torch.equal(acc, t)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ("flat", "nested"))
def test_mesh_combine_on_card_equals_plain(kind, cuda_device):
    topo, usage, cu, _ = inputs(kind)
    rng = np.random.default_rng(8)
    u, c = tk.state_to_device(usage, cu, "cpu")
    admitted = torch.from_numpy(rng.random(97) < 0.4)
    u_out = u + torch.from_numpy(rng.integers(-5, 6, size=usage.shape))
    c_out = c + torch.from_numpy(rng.integers(-5, 6, size=cu.shape))
    host = (admitted, u, u_out, c, c_out)
    want = tk.combine_pack_plain(*host)
    got = tk.combine_pack(*(t.to(cuda_device) for t in host))
    assert torch.equal(got.cpu(), want)
    back = tk.combine_unpack(got, u.to(cuda_device), c.to(cuda_device))
    for a, b in zip(back, (admitted, u_out, c_out)):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(back, tk.combine_unpack_plain(want, u, c)):
        assert torch.equal(a.cpu(), b)


@pytest.fixture
def nccl_mesh(cuda_device):
    mesh = tmesh.make_mesh()
    yield mesh
    mesh.close()


@pytest.mark.cuda
@pytest.mark.parametrize("fair", (False, True))
@pytest.mark.parametrize("kind", ("flat", "nested"))
def test_sharded_cycle_world_size_1_on_card(kind, fair, nccl_mesh,
                                            cuda_device):
    """solve_cycle_sharded at world size 1 over NCCL equals
    solve_cycle_fused on the card, and solve_preempt_sharded equals
    solve_preempt; mesh_combine launches once each way per cycle."""
    assert nccl_mesh.size == 1 and nccl_mesh.device.type == "cuda"
    topo, usage, cu, wl = fair_inputs(kind) if fair else inputs(kind)
    card = [tk.topo_to_device(topo, cuda_device),
            *tk.state_to_device(usage, cu, cuda_device),
            *(torch.from_numpy(np.array(wl[k])).to(cuda_device)
              for k in WL_KEYS)]
    want = tk.solve_cycle_fused(*card, num_podsets=3, fair_sharing=fair)
    before = tk.launch_counts()
    got = tmesh.solve_cycle_sharded(nccl_mesh, *card, num_podsets=3,
                                    fair_sharing=fair)
    torch.cuda.synchronize()
    assert tk.launch_counts()["mesh_combine"] == before["mesh_combine"] + 2
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ptopo, pusage, pcu, args = synth_preempt_inputs(
        30, 24, depth=2, num_cqs=64, num_flavors=3, seed=4)
    pcard = (tk.topo_to_device(ptopo, cuda_device),
             *tk.state_to_device(pusage, pcu, cuda_device))
    pargs = tuple(torch.from_numpy(a).to(cuda_device) for a in args)
    got = tmesh.solve_preempt_sharded(nccl_mesh, *pcard, pargs)
    want = tk.solve_preempt(*pcard, *pargs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


ORACLE_KEYS = ("admitted", "fit", "borrows", "chosen", "chosen_borrow",
               "usage", "cohort_usage")


def oracle_inputs(kind: str):
    """The small flat and nested inputs, and the north star's and the
    nested kernel inputs at chip_smoke's shapes."""
    if kind == "north_star":
        return synth_solver_inputs(num_cqs=2048, num_cohorts=256,
                                   num_flavors=32, num_resources=2,
                                   num_workloads=2048, num_podsets=4, seed=42)
    if kind == "nested_large":
        return synth_nested_inputs(num_cqs=2048, num_leaf_cohorts=256,
                                   fanout=4, depth=3, num_flavors=32,
                                   num_resources=2, num_workloads=2048,
                                   num_podsets=3, no_cohort_every=16, seed=7)
    return inputs(kind)


@pytest.mark.cuda
@pytest.mark.parametrize("fair", (False, True))
@pytest.mark.parametrize("kind", ("flat", "nested", "north_star",
                                  "nested_large"))
def test_global_scan_on_card_equals_plain(kind, fair, cuda_device):
    """global_scan against global_scan_plain on the same card tensors,
    then solve_cycle on the card against the CPU's, and against
    solve_cycle_cohort_parallel and solve_cycle_fused on the card; with
    fair sharing the order takes drf_share's shares."""
    topo, usage, cu, wl = oracle_inputs(kind)
    if fair:
        rng = np.random.default_rng(9)
        Q = topo["cq_cohort"].shape[0]
        topo["fair_weight"] = np.array([0, 500, 1000, 3000], np.int64)[
            rng.integers(0, 4, size=Q)]
    P = wl["requests"].shape[1]
    host = [tk.topo_to_device(topo, "cpu"),
            *tk.state_to_device(usage, cu, "cpu"),
            *(torch.from_numpy(np.array(wl[k])) for k in WL_KEYS)]
    card = [{k: v.to(cuda_device) for k, v in host[0].items()}] + \
        [t.to(cuda_device) for t in host[1:]]
    ctopo, cusage, ccu = card[:3]
    fit, borrows, _, _, asg, share = tk.solve_phase_a(
        *card[:6], *card[8:], num_podsets=P, fair_sharing=fair)
    order = tk.order_csr(ctopo, fit, borrows, card[6], card[7], card[5],
                         share if fair else None, with_order=True)[2]
    args = (ctopo, cusage, ccu, asg, fit, card[5], order)
    before = tk.launch_counts()["global_scan"]
    got = tk.global_scan(*args)
    torch.cuda.synchronize()
    assert tk.launch_counts()["global_scan"] == before + 1
    for name, a, b in zip(("admitted", "usage", "cohort_usage"), got,
                          tk.global_scan_plain(*args)):
        assert torch.equal(a, b), name
    assert got[0].any() and not torch.equal(got[0], fit)
    kw = dict(num_podsets=P, fair_sharing=fair)
    want = tk.solve_cycle(*host, **kw)
    seq = tk.solve_cycle(*card, **kw)
    par = tk.solve_cycle_cohort_parallel(ctopo, topo, *card[1:], **kw)
    fused = tk.solve_cycle_fused(*card, compact=False, **kw)
    for k in ORACLE_KEYS:
        assert torch.equal(seq[k].cpu(), want[k]), k
        assert torch.equal(par[k], seq[k]), k
        assert torch.equal(fused[k], seq[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("start_rank", (False, True))
@pytest.mark.parametrize("fair", (False, True))
@pytest.mark.parametrize("kind", ("flat", "nested"))
def test_solve_phase_a_on_card_equals_cpu(kind, fair, start_rank,
                                          cuda_device):
    """Phase A alone: avail, phase_a and, with fair sharing, drf_share
    launched once each; the six outputs equal the CPU's."""
    topo, usage, cu, wl = fair_inputs(kind) if fair else inputs(kind)
    sr = torch.from_numpy(synth_start_rank(wl, 40, seed=3)) \
        if start_rank else None
    host = [tk.topo_to_device(topo, "cpu"),
            *tk.state_to_device(usage, cu, "cpu"),
            *(torch.from_numpy(np.array(wl[k])) for k in
              ("requests", "podset_active", "wl_cq", "eligible",
               "solvable"))]
    card = [{k: v.to(cuda_device) for k, v in host[0].items()}] + \
        [t.to(cuda_device) for t in host[1:]]
    want = tk.solve_phase_a(*host, num_podsets=3, fair_sharing=fair,
                            start_rank=sr)
    before = tk.launch_counts()
    got = tk.solve_phase_a(*card, num_podsets=3, fair_sharing=fair,
                           start_rank=None if sr is None
                           else sr.to(cuda_device))
    torch.cuda.synchronize()
    after = tk.launch_counts()
    for name in ("avail", "phase_a", "drf_share"):
        assert after[name] - before[name] == \
            (1 if name != "drf_share" or fair else 0), name
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_batched_partial_admission_on_card_equals_cpu(cuda_device):
    """The Scheduler on sim/northstar's partial-admission cell at 64 CQs
    in 8 cohorts (4 of them elastic), on the card and on the CPU: the
    same admissions, counts and Pending messages every cycle, avail and
    phase_a launched once per search round beside the fit cycle's, one
    sync a round."""
    runs = []
    for device in (cuda_device, "cpu"):
        env = ns.build_partial_admission(
            num_cqs=64, num_cohorts=8, num_flavors=4, partial_cohorts=4,
            waves=6, solver=BatchSolver(device=device))
        msgs = []
        real = env[0].requeue_and_update

        def requeue(e, real=real, msgs=msgs):
            real(e)
            msgs.append((e.info.key, e.status, e.inadmissible_msg))
        env[0].requeue_and_update = requeue
        runs.append((env, msgs))
    for cycle in range(4):
        rows = []
        for (sched, cache, queues, client), msgs in runs:
            ns.finish_applied(cache, queues, client)
            msgs.clear()
            syncs = sched.solver.counters["syncs"]
            tk.reset_launch_counts()
            sched.schedule(timeout=0)
            rounds = sched.solver.last_partial_rounds
            assert rounds > 0 and sched.last_route == "device"
            assert sched.solver.counters["syncs"] - syncs == 2 + rounds
            rows.append((sorted((wl.metadata.name, [
                p.count for p in wl.status.admission.pod_set_assignments])
                for wl in client.new_applied), sorted(msgs), rounds))
            if sched.solver.device.type == "cuda":
                launched = tk.launch_counts()
                assert launched["avail"] == launched["phase_a"] == 1 + rounds
                assert launched["phase_b"] == 1
                assert launched["global_scan"] == 0
        assert rows[0] == rows[1], cycle
        assert any(c[0] < 512 for name, c in rows[0][0]
                   if name.startswith("p"))
    assert runs[0][0][3].admitted > 0
