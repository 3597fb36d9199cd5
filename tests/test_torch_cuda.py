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
from kueue_tpu_torch.solver.preempt import active_slot_count
from kueue_tpu_torch.solver.service import PREEMPT_KEYS, preempt_aux
from kueue_tpu_torch.solver.synth import (cluster_oracle,
                                          fill_inactive_slots,
                                          shared_level_coords,
                                          synth_cluster_inputs,
                                          synth_deltas, synth_fair_edges,
                                          synth_fair_inputs,
                                          synth_fair_problems,
                                          synth_full_k_inputs,
                                          synth_nested_inputs,
                                          synth_preempt_inputs,
                                          synth_preempt_problems,
                                          synth_share_inputs,
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


def fair_card_batch(case: str):
    """K11's batches for the forms and edges: (numpy batch, real problems,
    FAIR_SMEM for the launch or None). "staged" and "global" are one
    nested batch under two shared-memory caps; "past_smem" is QL = 64,
    RF = 32, K = 4096, DC = 3, whose arena passes a block's shared memory
    with the candidate rows staged (the global form); "ql64" has 64 local
    CQs (the general instance); "ties" and "limits" are
    synth_fair_edges' batches."""
    if case in ("staged", "global"):
        batch = synth_fair_inputs(200, 120, max_local_cqs=8, depth=3,
                                  num_flavors=3, seed=4)
        return batch, 200, None if case == "staged" else 0
    if case == "past_smem":
        topo, usage, cu, args = synth_fair_inputs(
            12, 3000, max_local_cqs=40, depth=3, num_cqs=2048,
            num_leaf_cohorts=16, fanout=4, num_flavors=4, num_resources=16,
            table_rows=2048, seed=5)
        args = list(args)
        for i in (7, 8, 14):  # cand_idx, cand_ql, cand_rank: K = 4096
            assert (args[8][:, 4096:] < 0).all()
            args[i] = np.ascontiguousarray(args[i][:, :4096])
        return (topo, usage, cu, tuple(args)), 12, None
    if case == "ql64":
        return synth_fair_inputs(150, 300, max_local_cqs=40, depth=2,
                                 num_cqs=2048, num_leaf_cohorts=16, fanout=4,
                                 num_flavors=4, table_rows=512, seed=3), \
            150, None
    return synth_fair_edges(case, num_problems=200, max_candidates=60,
                            seed=2, max_local_cqs=8, num_cqs=256,
                            num_flavors=3, depth=2), 200, None


FAIR_FORMS = {"staged": "shared", "global": "global", "past_smem": "global",
              "ql64": "shared", "ties": "shared", "limits": "shared"}


@pytest.mark.cuda
@pytest.mark.parametrize("case", tuple(FAIR_FORMS))
def test_solve_fair_forms_on_card(case, cuda_device, monkeypatch):
    """K11 in each form (the arena in shared memory, in global scratch),
    past 32 local CQs (the general instance),
    at QL = 64, RF = 32, K = 4096, DC = 3, on shares that tie on the high
    word and on the share (cq_order decides) and on limits around
    2^61 / 4 with weight 0, under every strategy order: all four outputs
    equal the plain version's on the same card tensors, and padding
    problems keep the outputs' defaults."""
    (topo, usage, cu, args), n_real, smem = fair_card_batch(case)
    if smem is not None:
        monkeypatch.setattr(tk, "FAIR_SMEM", smem)
    tt = tk.topo_to_device(topo, cuda_device)
    state = tk.state_to_device(usage, cu, cuda_device)
    dev_args = [torch.from_numpy(a).to(cuda_device) for a in args]
    B = args[0].shape[0]
    for strat in ((True, True, False), (True, False, False),
                  (False, False, False), (False, True, True)):
        want = tk.solve_fair_plain(tt, *state, *dev_args, strat=strat)
        got = tk.solve_fair(tt, *state, *dev_args, strat=strat)
        torch.cuda.synchronize()
        assert tk.solve_fair.last_plan["form"] == FAIR_FORMS[case]
        assert tk.solve_fair.last_plan["lane_per_cq"] == (
            args[0].shape[1] <= 32 and args[1].shape[1] <= 32)
        for name, a, b in zip(("targets", "feasible", "reasons", "stats"),
                              got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, strat)
        targets, feasible, reasons, stats = (x.cpu() for x in got)
        assert feasible[:n_real].any()
        if n_real < B:
            assert not targets[n_real:].any() and not feasible[n_real:].any()
            assert not reasons[n_real:].any() and not stats[n_real:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("W,P,R,off", [
    (1, 1, 1, 0), (31, 3, 1, 1), (33, 3, 3, 1), (2047, 4, 2, 1),
    (2049, 1, 5, 3), (2048, 4, 2, 0), (2049, 4, 2, 0), (100, 2, 2, 2),
    (32, 4, 2, 0)])
def test_pack_edge_shapes_on_card(W, P, R, off, cuda_device):
    """K8 at W not a multiple of 32 or 8 (bit-plane rows that leave 4-byte
    boundaries), odd P * R, and chosen / chosen_borrow starting `off`
    elements past a 16-byte boundary: equal to pack_plain."""
    rng = np.random.default_rng(W + off)
    n = W * P * R
    chosen_all = torch.from_numpy(
        rng.integers(-1, 40, size=n + 8).astype(np.int32)).to(cuda_device)
    borrow_all = torch.from_numpy(rng.random(n + 8) < 0.3).to(cuda_device)
    chosen = chosen_all[off:off + n].view(W, P, R)
    borrow = borrow_all[off:off + n].view(W, P, R)
    fit, admitted, borrows = (torch.from_numpy(rng.random(W) < p)
                              .to(cuda_device) for p in (0.7, 0.5, 0.3))
    args = (chosen, borrow, fit, admitted, borrows)
    before = tk.launch_counts()["pack"]
    got = tk.pack(*args)
    torch.cuda.synchronize()
    assert tk.launch_counts()["pack"] == before + 1
    want = tk.pack_plain(*(a.cpu() for a in args))
    for name, a, b in zip(("dec_pr", "dec_bits"), got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), name


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


# the H100's shared memory a block may opt in to, less the kernel's static
# 128 B: cluster_cols' arena moves to global scratch above it
CLUSTER_SMEM = 227 * 1024 - 128


@pytest.mark.cuda
@pytest.mark.parametrize("shape", (
    (8, 32, 2, 2048, 4, {}), (3, 5, 3, 97, 2, {}),
    (16, 126, 4, 1024, 3, {}),
    (8, 32, 6, 2048, 4, {"requested_share": 0.4}),
    (8, 32, 8, 2048, 4, {"requested_share": 0.3}),
    (8, 32, 16, 2048, 4, {"requested_share": 0.15}),
    (64, 32, 16, 2048, 4, {"requested_share": 0.15}),
    (4, 8, 20, 256, 2, {"requested_share": 0.2}),
    (8, 32, 32, 2048, 4, {"requested_share": 0.1}),
    (2, 3, 1, 300, 2, {})))
def test_cluster_cols_on_card_equals_plain_and_oracle(shape, cuda_device):
    """K12 on K clusters, F flavors, R resources, W rows, P podsets: equal
    to its plain version and to the host oracle walked in the admit order.
    (3, 5, 3, 97, 2) and (2, 3, 1, ...): a few live columns, one or few
    stages a warp; (16, 126, 4, ...): 2016 columns over 32 warps of
    stages; R = 3 and 6: the register form with R padded (to 4, 8);
    (8, 32, 16, ...): the register form's 16 warps, the arena in global
    scratch; (64, 32, 16, ...): 2048 columns of 16 resources (270,336 B
    of columns alone); (4, 8, 20, ...) and (8, 32, 32, ...): the requests
    read from the arena, in shared memory and in global scratch."""
    K, F, R, W, P, extra = shape
    rt = 1 << (R - 1).bit_length() if R <= 16 else 0
    ra = rt or R
    arena = K * F * ra * 8 + ra * W * 8 + -(-W // 32) * 8 + K * F * 8 + W * 4
    arena = -(-arena // 16) * 16
    for seed in (0, 1):
        cols, _, resources, args = synth_cluster_inputs(
            num_clusters=K, num_flavors=F, num_resources=R, num_workloads=W,
            num_podsets=P, seed=seed, **extra)
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
        plan = tk.score_cluster_columns.last_plan
        N, S, G, per_warp = tk.score_cluster_columns.last_stats.tolist()
        assert plan["register_r"] == rt
        assert plan["threads"] == (512 if rt == 16 else 1024)
        assert plan["arena_bytes"] == arena
        assert plan["rule"] == ("shared" if arena <= CLUSTER_SMEM
                                else "global")
        assert S == int((np.repeat(args[2], F)
                         & args[1].reshape(K * F, R).any(1)).sum())
        assert N > 0
        assert G == min(plan["threads"] // 32,
                        max(1, -(-S // plan["warp_stages"])))
        assert per_warp == -(-S // G)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((8, 32, 2, 2048, 4), (64, 32, 16, 1024, 4),
                                   (3, 5, 3, 97, 2)))
def test_cluster_cols_negative_requests_on_card_equal_plain(shape,
                                                            cuda_device):
    """Rows whose total request is negative in a resource: no column has
    to cover it, and the taking column's debit gives capacity back. The
    kernel equals its plain version (the JAX scan's semantics, which the
    host oracle does not share here)."""
    K, F, R, W, P = shape
    _, _, _, args = synth_cluster_inputs(
        num_clusters=K, num_flavors=F, num_resources=R, num_workloads=W,
        num_podsets=P, seed=4, negative_share=0.15,
        requested_share=0.15 if R > 4 else 1.0)
    host = [torch.from_numpy(a) for a in args]
    want = tk.score_cluster_columns(*host)
    got = tk.score_cluster_columns(*(t.to(cuda_device) for t in host))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    treq = np.where(args[5][:, :, None], args[4], 0).sum(1)
    assert (want.numpy()[(treq < 0).any(1)] >= 0).any()


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


def preempt_on(device, topo, usage, cu, args) -> tuple:
    """solve_preempt's arguments (synth_preempt_inputs') on `device`."""
    return (tk.topo_to_device(topo, device),
            *tk.state_to_device(usage, cu, device),
            *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
              for a in args))


def k9_equals_plain(card, **kw) -> tuple:
    """K9 launched once on `card` (with kw) equal to the plain version on
    the same tensors in all three outputs. Returns the plain outputs on
    the host."""
    want = tk.solve_preempt_plain(*card, slots=kw.get("slots"))
    before = tk.launch_counts()["solve_preempt"]
    got = tk.solve_preempt(*card, **kw)
    torch.cuda.synchronize()
    assert tk.launch_counts()["solve_preempt"] == before + 1
    for name, a, b in zip(("targets", "feasible", "stats"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    return tuple(t.cpu() for t in want)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", (1, 2, 3))
def test_solve_preempt_inactive_slots_on_card_equal_plain(depth,
                                                          cuda_device):
    """Inactive slots (no request, not needs-preemption) pointed at real
    quota, with candidate usage in them, change no output: K9 over the
    batch's active slots and over all RF equal the plain version, which
    computes every slot."""
    topo, usage, cu, args = synth_preempt_inputs(
        120, 120, max_local_cqs=6, depth=depth, num_flavors=4,
        seed=40 + depth)
    args = fill_inactive_slots(args, 4, 2, seed=depth)
    gf, req, frs = args[1], args[5], args[6]
    assert ((gf >= 0) & (req <= 0) & ~frs).any()
    rfa = active_slot_count(req, frs)
    assert 0 < rfa < gf.shape[1]
    card = preempt_on(cuda_device, topo, usage, cu, args)
    targets, feasible, stats = k9_equals_plain(card, active_slots=rfa)
    plan = tk.solve_preempt.last_plan
    assert plan["active_slots"] == rfa and plan["rule"] == "shared"
    k9_equals_plain(card)
    assert tk.solve_preempt.last_plan["active_slots"] == gf.shape[1]
    assert feasible[:120].any() and not feasible[:120].all()
    assert stats[:, 3].sum() > 0 and targets.any()


@pytest.mark.cuda
@pytest.mark.parametrize("max_candidates,every_slot,rule",
                         ((1500, True, "global"), (400, False, "shared")))
def test_solve_preempt_scratch_rules_on_card(max_candidates, every_slot,
                                             rule, cuda_device):
    """K = 2048 with every slot of every real problem active takes the
    global-scratch rule; K = 512 over 2 active slots (the reclaim cell's
    shape) the shared-memory rule. Both equal the plain version."""
    topo, usage, cu, args = synth_preempt_inputs(
        60, max_candidates, max_local_cqs=6, depth=2, num_flavors=4,
        seed=7)
    args = fill_inactive_slots(args, 4, 2, seed=7, every_slot=every_slot)
    rfa = active_slot_count(args[5], args[6])
    RF = args[1].shape[1]
    assert rfa == (RF if every_slot else 2)
    card = preempt_on(cuda_device, topo, usage, cu, args)
    targets, feasible, stats = k9_equals_plain(card, active_slots=rfa)
    plan = tk.solve_preempt.last_plan
    assert plan["rule"] == rule and plan["active_slots"] == rfa
    assert plan["blocks_per_sm"] >= 1
    assert feasible[:60].any() and targets.any()


@pytest.mark.cuda
def test_solve_preempt_padding_only_on_card(cuda_device):
    """A batch whose every problem has no valid candidate: nothing to
    remove, infeasible, stats (0, 0, 1, 0) in every row, as the plain
    version writes them."""
    topo, usage, cu, args = synth_preempt_inputs(40, 60, depth=3, seed=9)
    args = list(args)
    args[8] = np.full_like(args[8], -1)
    card = preempt_on(cuda_device, topo, usage, cu, args)
    targets, feasible, stats = k9_equals_plain(
        card, active_slots=active_slot_count(args[5], args[6]))
    assert not targets.any() and not feasible.any()
    assert (stats == torch.tensor([0, 0, 1, 0], dtype=torch.int32)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("K", (8, 40, 200))
def test_solve_preempt_odd_k_on_card(K, cuda_device):
    """K that is not a multiple of a warp (idle lanes in the last warp,
    chunks of one candidate or of several)."""
    topo, usage, cu, args = synth_preempt_inputs(80, K, max_local_cqs=5,
                                                 depth=2, seed=K)
    args = list(args)
    for i in (7, 8):
        args[i] = np.ascontiguousarray(args[i][:, :K])
    card = preempt_on(cuda_device, topo, usage, cu, args)
    targets, feasible, stats = k9_equals_plain(
        card, active_slots=active_slot_count(args[5], args[6]))
    assert targets.shape[1] == K and feasible[:80].any()


@pytest.mark.cuda
def test_solve_preempt_padded_slots_on_card(cuda_device):
    """K9 over problem slots in a shuffled order with padding entries (B
    and -1) between them, over the batch's active slots: equal to the
    plain version with the same slots; the other rows stay zero."""
    topo, usage, cu, args = synth_preempt_inputs(90, 100, depth=3, seed=5)
    B = args[7].shape[0]
    rng = np.random.default_rng(5)
    slots = rng.permutation(B)[:70].astype(np.int32)
    slots[::7] = B
    slots[3::11] = -1
    card = preempt_on(cuda_device, topo, usage, cu, args)
    targets, feasible, stats = k9_equals_plain(
        card, slots=torch.from_numpy(slots).to(cuda_device),
        active_slots=active_slot_count(args[5], args[6]))
    solved = np.zeros(B, bool)
    solved[slots[(slots >= 0) & (slots < B)]] = True
    assert not stats[torch.from_numpy(~solved)].any()
    assert stats[torch.from_numpy(solved)][:, 2].min() >= 1


@pytest.mark.cuda
def test_solve_preempt_reclaim_batch_on_card(cuda_device, monkeypatch):
    """K9 on the batch the port's Scheduler builds on the reclaim
    configuration at 4 roots x 2 children x 8 CQs x 36 victims (the
    cell's K = 512, QL = 16 and RF = 8 with 2 active slots), captured
    from the cycle, equal to the plain version."""
    calls = []
    real = tk.solve_preempt

    def capture(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    capture.launches = 0  # solve_preempt counts on its module name
    monkeypatch.setattr(tk, "solve_preempt", capture)
    sched, cache, queues, client = ns.build_preempt_reclaim(
        4, 2, 8, 36, solver=BatchSolver(device=cuda_device))
    sched.solver_sync_floor_ms = 0.0
    sched.schedule(timeout=0)
    monkeypatch.undo()
    assert sched.last_preempt_gate == "device" and len(calls) == 1
    a, kw = calls[0]
    assert kw["active_slots"] == 2
    assert (a[11].shape[1], a[3].shape[1], a[4].shape[1]) == (512, 16, 8)
    targets, feasible, stats = k9_equals_plain(a, **kw)
    assert feasible.any() and targets.any()


@pytest.mark.cuda
def test_solve_preempt_full_k_on_card(cuda_device):
    """K = 32768, the largest K of 16-bit candidate indices, with a
    problem of exactly K candidates whose k* is the last one (the place
    of a candidate in its CQ's run then reaches K), and every other
    problem at up to K candidates: equal to the plain version. With 8
    more candidate columns (K = 32776, problem 0's new candidates copies
    of its first 8) the kernel takes 32-bit indices and still equals the
    plain version."""
    K = tk.PREEMPT_NARROW_K
    topo, usage, cu, args = synth_full_k_inputs(4, K, seed=21)
    card = preempt_on(cuda_device, topo, usage, cu, args)
    slots = active_slot_count(args[5], args[6])
    targets, feasible, stats = k9_equals_plain(card, active_slots=slots)
    assert feasible[0] and stats[0, 0] == K and stats[0, 1] == K
    plan = tk.solve_preempt.last_plan
    assert plan["rule"] == "global" and plan["index_bits"] == 16
    wide = list(card)
    for i in (10, 11):  # cand_idx, cand_ql: 8 more candidate columns
        wide[i] = torch.cat([card[i], card[i][:, :8]], dim=1)
    targets, feasible, stats = k9_equals_plain(wide, active_slots=slots)
    assert tk.solve_preempt.last_plan["index_bits"] == 32
    assert stats[0, 0] == K + 8 and feasible[0]


@pytest.mark.cuda
@pytest.mark.parametrize("num_problems", (2, 4))
def test_solve_preempt_k131072_on_card(num_problems, cuda_device):
    """K = 131072, the bucket above 32768 candidates: problem 0 has
    exactly K candidates (k* the last), the others up to K. The kernel
    takes 32-bit candidate indices on the global rule and equals the
    plain version."""
    K = 131072
    topo, usage, cu, args = synth_full_k_inputs(num_problems, K, seed=5)
    assert ((args[8] >= 0).sum(1) > tk.PREEMPT_NARROW_K).any()
    card = preempt_on(cuda_device, topo, usage, cu, args)
    targets, feasible, stats = k9_equals_plain(
        card, active_slots=active_slot_count(args[5], args[6]))
    plan = tk.solve_preempt.last_plan
    assert plan["index_bits"] == 32 and plan["rule"] == "global"
    assert feasible[0] and stats[0, 0] == K and stats[0, 1] == K


@pytest.mark.cuda
@pytest.mark.parametrize("every_slot", (False, True))
def test_solve_preempt_wide_slots_on_card(every_slot, cuda_device):
    """More than 8 active slots: 12 resources give RF = 32, and the kernel
    runs its groups of 8 slots over a row stride set at launch, every
    scan and fit walking two groups (12 active slots: a stride of 16) or
    four (every slot active), under the shared and the global rule."""
    topo, usage, cu, args = synth_preempt_inputs(
        60, 100, max_local_cqs=6, depth=2, num_flavors=3, num_resources=12,
        seed=11)
    args = fill_inactive_slots(args, 3, 12, seed=11, every_slot=every_slot)
    rfa = active_slot_count(args[5], args[6])
    assert args[1].shape[1] == 32 and rfa == (32 if every_slot else 12)
    card = preempt_on(cuda_device, topo, usage, cu, args)
    targets, feasible, stats = k9_equals_plain(card, active_slots=rfa)
    plan = tk.solve_preempt.last_plan
    assert (plan["group_slots"], plan["row_slots"]) == \
        (8, 32 if every_slot else 16)
    assert plan["rule"] == ("global" if every_slot else "shared")
    assert feasible[:60].any() and targets.any() and stats[:, 3].sum() > 0


@pytest.mark.cuda
def test_solve_preempt_unsized_slots_refused_on_card(cuda_device):
    """A launch sized below the active slots of a problem with candidates
    writes that problem no targets, infeasible and stats of -1 and solves
    the rest as the plain version does; service.preempt_aux refuses the
    -1 rows. (active_slots 2 sizes rows of 2 slots; the problems ask
    for up to 3.)"""
    topo, usage, cu, args = synth_preempt_inputs(40, 60, depth=2,
                                                 num_resources=3, seed=3)
    per = ((args[5] > 0) | args[6]).sum(1)
    over = (per > 2) & (args[8] >= 0).any(1)
    assert over.any() and (~over[:40]).any()
    card = preempt_on(cuda_device, topo, usage, cu, args)
    got = tk.solve_preempt(*card, active_slots=2)
    want = tk.solve_preempt_plain(*card)
    torch.cuda.synchronize()
    targets, feasible, stats = (x.cpu() for x in got)
    assert (stats[over] == -1).all()
    assert not feasible[over].any() and not targets[over].any()
    for a, b in zip((targets, feasible, stats), want):
        assert torch.equal(a[~over], b.cpu()[~over])
    with pytest.raises(RuntimeError, match="active slots"):
        preempt_aux({k: x.numpy() for k, x in
                     zip(PREEMPT_KEYS, (targets, feasible, stats))})


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


def scan_card_args(topo, usage, cu, wl, device, fair=False, order=None):
    """global_scan's arguments on the card: Phase A and the global order
    of the card's cycle, or `order` (numpy) in its place."""
    if fair:
        rng = np.random.default_rng(9)
        Q = topo["cq_cohort"].shape[0]
        topo["fair_weight"] = np.array([0, 500, 1000, 3000], np.int64)[
            rng.integers(0, 4, size=Q)]
    P = wl["requests"].shape[1]
    ctopo = tk.topo_to_device(topo, device)
    cusage, ccu = tk.state_to_device(usage, cu, device)
    cwl = {k: torch.from_numpy(np.array(wl[k])).to(device) for k in WL_KEYS}
    fit, borrows, _, _, asg, share = tk.solve_phase_a(
        ctopo, cusage, ccu, cwl["requests"], cwl["podset_active"],
        cwl["wl_cq"], cwl["eligible"], cwl["solvable"], num_podsets=P,
        fair_sharing=fair)
    if order is None:
        order = tk.order_csr(ctopo, fit, borrows, cwl["priority"],
                             cwl["timestamp"], cwl["wl_cq"],
                             share if fair else None, with_order=True)[2]
    else:
        order = torch.from_numpy(order.astype(np.int32)).to(device)
    return ctopo, cusage, ccu, asg, fit, cwl["wl_cq"], order


def scan_on_card(args, form):
    """global_scan in `form` against global_scan_plain on the same card
    tensors; returns the launch's plan."""
    before = tk.launch_counts()["global_scan"]
    got = tk.global_scan(*args, form=form)
    torch.cuda.synchronize()
    assert tk.launch_counts()["global_scan"] == before + 1
    plan = tk.global_scan.last_plan
    assert plan["form"] == form
    for name, a, b in zip(("admitted", "usage", "cohort_usage"), got,
                          tk.global_scan_plain(*args)):
        assert torch.equal(a, b), name
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("form", tk.GLOBAL_SCAN_FORMS)
@pytest.mark.parametrize("fair", (False, True))
@pytest.mark.parametrize("kind", ("flat", "nested", "north_star",
                                  "nested_large"))
def test_global_scan_forms_on_card(kind, fair, form, cuda_device):
    """K14 in each form, forced, against global_scan_plain on the cycle's
    own Phase A and global order: the small flat and nested trees (F*R =
    120: four warps of lanes, a barrier's vote), the north star (64
    lanes, cohort_usage 131,072 bytes) and nested_large (336 cohorts,
    172,032 bytes), all in the register form."""
    args = scan_card_args(*oracle_inputs(kind), cuda_device, fair)
    plan = scan_on_card(args, form)
    assert plan["register_dc"] >= args[0]["cq_chain"].shape[1]
    assert args[4].any() and not torch.equal(tk.global_scan_plain(*args)[0],
                                             args[4])


def scan_random_inputs(kind: str):
    """Inputs whose order interleaves fit and non-fit steps at random and
    repeats a CQ on runs of consecutive steps: flat and nested (the
    register form at F*R = 16, one warp's vote), a chain of 10 levels (the looping
    form in one warp) and F*R = 320 (the looping form, a block vote)."""
    if kind == "deep":
        topo, usage, cu, wl = synth_nested_inputs(
            num_cqs=512, num_leaf_cohorts=512, fanout=2, depth=10,
            num_flavors=8, num_resources=2, num_workloads=300, num_podsets=2,
            no_cohort_every=7, seed=5)
    elif kind == "wide":
        topo, usage, cu, wl = synth_solver_inputs(
            num_cqs=64, num_cohorts=8, num_flavors=40, num_resources=8,
            num_workloads=300, num_podsets=2, seed=5)
    else:
        make = synth_solver_inputs if kind == "flat" else synth_nested_inputs
        extra = {"num_cohorts": 8} if kind == "flat" else {
            "num_leaf_cohorts": 8, "fanout": 2, "depth": 3,
            "no_cohort_every": 5}
        topo, usage, cu, wl = make(num_cqs=64, num_flavors=8,
                                   num_resources=2, num_workloads=300,
                                   num_podsets=2, seed=5, **extra)
    rng = np.random.default_rng(13)
    W = wl["wl_cq"].shape[0]
    # runs of up to 6 workloads on one CQ, in a random order of runs
    wl["wl_cq"] = np.repeat(rng.integers(0, topo["cq_cohort"].shape[0],
                                         size=W), rng.integers(1, 7, size=W)
                            )[:W].astype(np.int32)
    wl["solvable"] = wl["solvable"] & (rng.uniform(size=W) < 0.7)
    order = rng.permutation(W)
    return (topo, usage + topo["nominal"] // 4, cu, wl), \
        np.concatenate([np.sort(order[:W // 2]), order[W // 2:]])


@pytest.mark.cuda
@pytest.mark.parametrize("form", tk.GLOBAL_SCAN_FORMS)
@pytest.mark.parametrize("kind", ("flat", "nested", "deep", "wide"))
def test_global_scan_random_order_on_card(kind, form, cuda_device):
    """K14 on an order that is not the admit order (fit and non-fit steps
    interleaved, CQs repeated on consecutive steps: the forwarded usage),
    in both forms and, for a 10-level chain and F*R = 320, the looping
    form."""
    inputs_, order = scan_random_inputs(kind)
    args = scan_card_args(*inputs_, cuda_device, order=order)
    w, _, has_cohort, repeat = tk.global_scan_steps(
        args[4].cpu(), args[5].cpu(), torch.from_numpy(order),
        args[0]["cq_cohort"].cpu())
    assert 0 < w.numel() < len(order) and repeat.any() and has_cohort.any()
    plan = scan_on_card(args, form)
    assert (plan["register_dc"] == 0) == (kind in ("deep", "wide"))


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
@pytest.mark.parametrize("start_rank", (False, True))
@pytest.mark.parametrize("num_resources", (17, 32))
@pytest.mark.parametrize("kind", ("flat", "nested"))
def test_phase_a_wide_resources_on_card(kind, num_resources, start_rank,
                                        cuda_device):
    """phase_a over more than 16 resources (17 names as they are, and 32,
    the encode's bucket for them): the chosen flavor of each resource in
    the warp's shared memory. phase_a and solve_phase_a equal the plain
    versions."""
    if kind == "flat":
        topo, usage, cu, wl = synth_solver_inputs(
            num_cqs=64, num_cohorts=8, num_flavors=40,
            num_resources=num_resources, num_workloads=96, num_podsets=3,
            seed=num_resources)
    else:
        topo, usage, cu, wl = synth_nested_inputs(
            num_cqs=64, num_leaf_cohorts=8, fanout=2, depth=3,
            num_flavors=40, num_resources=num_resources, num_workloads=96,
            num_podsets=3, no_cohort_every=5, seed=num_resources)
    usage = usage + topo["nominal"] // 3
    sr = torch.from_numpy(synth_start_rank(wl, 40, seed=3)) \
        if start_rank else None
    host = [tk.topo_to_device(topo, "cpu"),
            *tk.state_to_device(usage, cu, "cpu"),
            *(torch.from_numpy(np.array(wl[k])) for k in
              ("requests", "podset_active", "wl_cq", "eligible",
               "solvable"))]
    card = [{k: v.to(cuda_device) for k, v in host[0].items()}] + \
        [t.to(cuda_device) for t in host[1:]]
    card_sr = None if sr is None else sr.to(cuda_device)
    av = tk.avail_plain(*card[:3])
    want = tk.phase_a_plain(card[0], av, card[1], *card[3:], 3, card_sr)
    before = tk.launch_counts()["phase_a"]
    got = tk.phase_a(card[0], av, card[1], *card[3:], 3, card_sr)
    torch.cuda.synchronize()
    assert tk.launch_counts()["phase_a"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert want[2].shape[2] == num_resources and want[0].any()
    want = tk.solve_phase_a(*host, num_podsets=3, start_rank=sr)
    got = tk.solve_phase_a(*card, num_podsets=3, start_rank=card_sr)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


# 17 resource names: cpu, memory and 15 extended resources
WIDE_RESOURCES = ("cpu", "memory", *(f"example.com/r{i}" for i in range(15)))


def wide_resource_env(device):
    """A Scheduler (as sim/northstar build_scheduler makes it) over 16 CQs
    in 4 cohorts and 3 flavors, every CQ covering the 17 resources of
    WIDE_RESOURCES at 8 units each (f0 none of every other extended
    resource, so that some heads take f1), and 4 waves of one-pod workloads
    asking for cpu, memory and 2-4 of the extended resources (1-4 units
    each). Returns (Scheduler, Cache, Manager, SimClient)."""
    from kueue_tpu_torch.api.corev1 import (Container, PodSpec,
                                            PodTemplateSpec)
    from kueue_tpu_torch.api.meta import FakeClock
    from kueue_tpu_torch.cache import Cache
    from kueue_tpu_torch.queue import Manager
    from kueue_tpu_torch.scheduler.scheduler import Scheduler
    flavors = ["f0", "f1", "f2"]
    clock = FakeClock(1000.0)
    cache, queues = Cache(), Manager(clock=clock)
    for f in flavors:
        cache.add_or_update_resource_flavor(ns.make_flavor(f))
    for i in range(16):
        cq = ns.make_cq(f"cq{i}", f"cohort-{i % 4}", flavors, 8)
        cq.spec.resource_groups = [api.ResourceGroup(
            covered_resources=list(WIDE_RESOURCES),
            flavors=[api.FlavorQuotas(name=f, resources=[
                api.ResourceQuota(name=r, nominal_quota=8000 if r == "cpu"
                                  else 8 << 30 if r == "memory"
                                  else 0 if f == "f0" and k % 2 else 8)
                for k, r in enumerate(WIDE_RESOURCES)]) for f in flavors])]
        cache.add_cluster_queue(cq)
        queues.add_cluster_queue(cq)
        queues.add_local_queue(ns.make_local_queue(f"lq{i}", f"cq{i}"))
    rng = np.random.default_rng(17)
    for wave in range(4):
        for i in range(16):
            n = wave * 16 + i
            wl = ns.make_workload(f"w{wave}-{i}", f"lq{i}", 2,
                                  priority=n % 5, creation=float(n))
            extra = rng.choice(15, size=rng.integers(2, 5), replace=False)
            requests = {"cpu": int(rng.integers(1, 4)) * 1000,
                        "memory": int(rng.integers(1, 4)) << 30}
            requests.update({WIDE_RESOURCES[2 + int(e)]:
                             int(rng.integers(1, 5)) for e in extra})
            wl.spec.pod_sets[0].template = PodTemplateSpec(spec=PodSpec(
                containers=[Container(name="c", requests=requests)]))
            assert queues.add_or_update_workload(wl)
    client = ns.SimClient()
    sched = Scheduler(queues, cache, client, clock=clock,
                      solver=BatchSolver(device=device), solver_min_heads=0)
    return sched, cache, queues, client


@pytest.mark.cuda
def test_scheduler_17_resources_on_card_equals_cpu(cuda_device):
    """The port's Scheduler on a topology of 17 resource names (the
    encode buckets them to 32): every cycle on the device route, phase_a
    launched with R = 32, and the admissions and usage of each cycle
    equal to the same cycles with device="cpu"."""
    runs = [wide_resource_env(d) for d in (cuda_device, "cpu")]
    topo = encode.encode_topology(runs[0][1].snapshot())
    assert topo.nominal.shape[2] == 32
    tk.reset_launch_counts()
    admitted = 0
    for cycle in range(4):
        rows = []
        for sched, cache, queues, client in runs:
            ns.finish_applied(cache, queues, client)
            sched.schedule(timeout=0)
            assert sched.last_route == "device"
            rows.append((sorted(wl.metadata.name for wl in client.new_applied),
                         [sorted(cache.usage_for_cluster_queue(f"cq{i}")[0]
                                 .items()) for i in range(16)]))
        assert rows[0] == rows[1], cycle
        admitted += len(rows[0][0])
    assert admitted > 0
    assert tk.launch_counts()["phase_a"] == 4


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


# --- K5 and K2 forms (csrc/phase_b.cu, csrc/phase_a.cu) ---

def phase_inputs(kind: str, F: int = 40, R: int = 3, W: int = 96,
                 Q: int = 64, cohorts: int = 8, seed: int = 3):
    """inputs() at other widths: flat cohorts, or trees 3 deep with every
    5th CQ outside any cohort."""
    if kind == "flat":
        topo, usage, cu, wl = synth_solver_inputs(
            num_cqs=Q, num_cohorts=cohorts, num_flavors=F, num_resources=R,
            num_workloads=W, num_podsets=3, seed=seed)
    else:
        topo, usage, cu, wl = synth_nested_inputs(
            num_cqs=Q, num_leaf_cohorts=cohorts, fanout=2, depth=3,
            num_flavors=F, num_resources=R, num_workloads=W, num_podsets=3,
            no_cohort_every=5, seed=seed)
    return topo, usage + topo["nominal"] // 3, cu, wl


def phase_b_case(topo, usage, cu, wl, device):
    """(card args, host args) of phase_b on the plain Phase A and order."""
    host_topo = tk.topo_to_device(topo, "cpu")
    u, c = tk.state_to_device(usage, cu, "cpu")
    requests, podset_active, wl_cq, priority, timestamp, eligible, \
        solvable = [torch.from_numpy(np.array(wl[k])) for k in WL_KEYS]
    fit, borrows, _, _, asg = tk.phase_a(host_topo, tk.avail(host_topo, u, c),
                                         u, requests, podset_active, wl_cq,
                                         eligible, solvable, 3)
    offsets, members, _ = tk.order_csr(host_topo, fit, borrows, priority,
                                       timestamp, wl_cq)
    host = (host_topo, u, c, asg, fit, wl_cq, offsets, members)
    card = ({k: v.to(device) for k, v in host_topo.items()},
            *(a.to(device) for a in host[1:]))
    return card, host


@pytest.mark.cuda
@pytest.mark.parametrize("form", ("shared", "lazy", "global", "block",
                                  "block_unstaged", "chunks"))
@pytest.mark.parametrize("kind", ("flat", "nested"))
def test_phase_b_forms_on_card_equal_plain(kind, form, cuda_device,
                                           monkeypatch):
    """Each form of K5 against the plain version, alone and over a column
    list with padding: the shared form (rows with the CQs' constants); the
    lazy form (the rows members touch, claimed in a bitmap as they are
    staged; the CQs' constants from the topology), by a launch's shared
    memory cut below the largest domain's shared form; the global scratch,
    by one cut to the chunk buffers; the block vote (FR = 320) and, past
    FR = 2048, the rows read from asg in the walk (and from the global
    scratch); and chunks of one or two members (double-buffered staging,
    lazy rows claimed across chunks)."""
    F, R, W, Q, cohorts = 40, 3, 96, 64, 8
    if form == "block":
        F, R = 20, 16
    elif form == "block_unstaged":
        F, R, W = 40, 64, 48
    elif form == "chunks":
        W, Q, cohorts = 160, 24, 2
    topo, usage, cu, wl = phase_inputs(kind, F, R, W, Q, cohorts)
    FR = F * R
    if form == "chunks":
        # two members a chunk (phase_b_plan: 24 bytes a column a member)
        monkeypatch.setattr(tk, "PHASE_B_ASG_BYTES",
                            2 * 24 * (-(-FR // 32) * 32))
    card, host = phase_b_case(topo, usage, cu, wl, cuda_device)
    t = host[0]
    shape = (FR, topo["cq_chain"].shape[1], t["dom_cqs"].shape[1],
             t["dom_cohorts"].shape[1])
    plan = tk.phase_b_plan(*shape)
    bufs = plan["smem"] - plan["state_cap"]
    nq = t["dom_nq"].numpy().astype(np.int64)
    nc = t["dom_nc"].numpy().astype(np.int64)
    head = tk._lazy_head(nq + nc, FR)
    if form in ("lazy", "chunks"):
        cap = int((head + (nq + 3 * nc) * 8 * FR).max()) + 16
        assert int((head + 3 * (nq + nc) * 8 * FR).max()) > cap
        monkeypatch.setattr(tk, "PHASE_B_SMEM", bufs + cap)
    elif form == "global":
        monkeypatch.setattr(tk, "PHASE_B_SMEM", bufs)
    plan = tk.phase_b_plan(*shape)
    forms = tk.phase_b_forms(t, plan, FR)
    want_form = {"lazy": "lazy", "chunks": "lazy", "global": "global",
                 "block_unstaged": "global"}.get(form, "shared")
    assert forms.get(want_form, 0) > 0, forms
    D = host[6].shape[0] - 1
    rng = np.random.default_rng(5)
    cols = np.concatenate([rng.permutation(D)[:D // 2], [D, -1]]).astype(
        np.int32)
    for extra in ((), (torch.from_numpy(cols),)):
        want = tk.phase_b(*host, *extra)
        got = tk.phase_b(*card, *(a.to(cuda_device) for a in extra))
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        assert want[0].any() and not want[0].all()
    plan = tk.phase_b.last_plan
    assert plan["vote"] == ("block" if FR > tk.PHASE_B_WARP_FR else "warp")
    assert plan["stage_asg"] == (FR <= 2048)
    if form == "chunks":
        assert plan["chunk"] <= 2
        assert np.diff(host[6].numpy()).max() > 2 * plan["chunk"]


def no_borrow_target_inputs():
    """Three flavors of ranks 1, 0, 1 in every CQ, prefer-no-borrow on:
    flavors 0 and 1 full and alike (every request borrows), flavor 2
    empty; where 0 and 1 fit, the target is the non-borrowing rank 1, and
    flavor 0, borrowing, the lowest fitting index at it (a third
    reduction). tests/test_torch_phase_forms.py holds the plain version
    to the JAX package on the same construction."""
    topo, usage, cu, wl = synth_solver_inputs(
        num_cqs=8, num_cohorts=2, num_flavors=3, num_resources=1,
        num_workloads=24, num_podsets=2, seed=11)
    Q = topo["cq_cohort"].shape[0]
    topo["flavor_rank"] = np.tile(np.array([1, 0, 1], np.int32), (Q, 1))
    topo["prefer_no_borrow"] = np.ones(Q, bool)
    topo["nominal"][:, 1] = topo["nominal"][:, 0]
    usage = np.zeros_like(usage)
    usage[:, :2] = topo["nominal"][:, :2]
    for c in range(topo["cohort_subtree"].shape[0]):
        members = topo["cq_cohort"] == c
        topo["cohort_subtree"][c] = topo["nominal"][members].sum(axis=0)
        cu[c] = usage[members].sum(axis=0)
    topo["cohort_subtree"][:, :2] *= 2
    wl["requests"] = np.minimum(wl["requests"], 3000)
    return topo, usage, cu, wl


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ("plain", "start_rank", "no_borrow",
                                     "near_inf", "past_key"))
@pytest.mark.parametrize("F,R", ((32, 2), (32, 16), (40, 2), (8, 17),
                                 (6, 32)))
def test_phase_a_forms_on_card_equal_plain(F, R, variant, cuda_device):
    """Each form of K2 against the plain version: the register form at
    R = 2 and 16 (F = 32), the general form past 32 flavors (strided
    lanes) and past 16 resources; with start ranks, prefer-no-borrow, ranks
    at INF_RANK - 1, INF_RANK and INF_RANK + 1, and ranks past the packed
    key's range (two reductions)."""
    topo, usage, cu, wl = phase_inputs("nested", F, R, seed=F + R)
    rng = np.random.default_rng(F * R)
    if variant in ("no_borrow", "near_inf", "past_key"):
        topo["prefer_no_borrow"] = rng.random(topo["cq_cohort"].shape[0]) < 0.6
    if variant in ("near_inf", "past_key"):
        fr = topo["flavor_rank"]
        values = ([tk.INF_RANK - 1, tk.INF_RANK, tk.INF_RANK + 1]
                  if variant == "near_inf" else [-(2**27), 2**27, 2**30, -3])
        topo["flavor_rank"] = np.where(rng.random(fr.shape) < 0.3,
                                       rng.choice(values, size=fr.shape),
                                       fr).astype(np.int32)
    sr = torch.from_numpy(synth_start_rank(wl, F, seed=3)) \
        if variant in ("start_rank", "near_inf") else None
    host = [tk.topo_to_device(topo, "cpu"),
            *tk.state_to_device(usage, cu, "cpu"),
            *(torch.from_numpy(np.array(wl[k])) for k in
              ("requests", "podset_active", "wl_cq", "eligible",
               "solvable"))]
    av = tk.avail_plain(*host[:3])
    want = tk.phase_a_plain(host[0], av, host[1], *host[3:], 3, sr)
    card = [{k: v.to(cuda_device) for k, v in host[0].items()}] + \
        [t.to(cuda_device) for t in host[1:]]
    got = tk.phase_a(card[0], av.to(cuda_device), card[1], *card[3:], 3,
                     None if sr is None else sr.to(cuda_device))
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert want[0].any()
    assert tk.phase_a.last_plan == tk.phase_a_plan(F, R, 3)
    assert tk.phase_a.last_plan["form"] == (
        "register" if F <= 32 and R <= 16 else "general")


@pytest.mark.cuda
def test_phase_a_no_borrow_target_on_card(cuda_device):
    """prefer-no-borrow with a borrowing flavor of lower index at the
    non-borrowing target rank: the third reduction picks it, as the plain
    version (held to the JAX package on the CPU) does."""
    topo, usage, cu, wl = no_borrow_target_inputs()
    host = [tk.topo_to_device(topo, "cpu"),
            *tk.state_to_device(usage, cu, "cpu"),
            *(torch.from_numpy(np.array(wl[k])) for k in
              ("requests", "podset_active", "wl_cq", "eligible",
               "solvable"))]
    av = tk.avail_plain(*host[:3])
    want = tk.phase_a_plain(host[0], av, host[1], *host[3:], 2)
    assert ((want[2] == 0) & want[3]).any()
    card = [{k: v.to(cuda_device) for k, v in host[0].items()}] + \
        [t.to(cuda_device) for t in host[1:]]
    got = tk.phase_a(card[0], av.to(cuda_device), card[1], *card[3:], 2)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("csr", ("order", "grid"))
def test_phase_b_writes_every_admitted_bit_on_card(csr, cuda_device):
    """Over order_csr's CSR of every workload the wrapper leaves admitted
    unset (torch.empty) and the kernel writes every member's bit; over
    the host grid's CSR of the fitting heads (solve_phase_b_domains) the
    rest stay zero. Both with the allocator's block poisoned with ones
    first, against the plain version."""
    topo, usage, cu, wl = phase_inputs("nested")
    card, host = phase_b_case(topo, usage, cu, wl, cuda_device)
    fit = host[4]
    if csr == "grid":
        grid = tk.build_order_grid(
            fit.numpy(), np.zeros_like(fit.numpy()), wl["priority"],
            wl["timestamp"], wl["wl_cq"], topo["cq_cohort"],
            topo["cohort_subtree"].shape[0], cohort_root=topo["cohort_root"])
        offsets, members = tk.grid_csr(torch.from_numpy(grid))
        assert members.shape[0] < fit.shape[0]  # unfit heads left out
        host = (*host[:6], offsets, members)
        card = (*card[:6], offsets.to(cuda_device), members.to(cuda_device))
    W = fit.shape[0]
    for _ in range(4):  # the caching allocator hands the block back
        poison = torch.ones(W, dtype=torch.bool).to(cuda_device)
        del poison
        got = tk.phase_b(*card)
        torch.cuda.synchronize()
        want = tk.phase_b(*host)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


# ---------------------------------------------------------------------------
# K4 (csrc/order.cu) and K7b (csrc/arena_gather.cu), redesigned
# ---------------------------------------------------------------------------

ORDER_NAN_BITS = np.array([0x7ff8000000000000, 0x7ff8000000000123,
                           0xfff8000000000000, 0xfff0000000000001,
                           0x7ff0000000000001], np.uint64)
ORDER_LIMIT = tk.ORDER_THREADS * tk.ORDER_ILP  # the staged form's W


def order_case(W, seed, Q=64, C=8, edge=False, one_domain=False,
               solo_every=0):
    """order_csr's host inputs (topology, positional args, share)."""
    rng = np.random.default_rng(seed)
    cq_cohort = rng.integers(0, C, size=Q).astype(np.int32)
    if solo_every:
        cq_cohort[::solo_every] = -1
    cohort_root = np.zeros(C, np.int32) if one_domain else \
        np.arange(C, dtype=np.int32) // 2 * 2  # pairs under one root
    i64 = np.iinfo(np.int64)
    if edge:
        prio = rng.choice(np.array([i64.min, i64.max, 0, 1, -1, i64.min + 1],
                                   np.int64), size=W)
        ts = rng.choice(np.concatenate([
            [0.0, -0.0, np.inf, -np.inf, 1.5, -1.5, 5e-324, -5e-324],
            ORDER_NAN_BITS.view(np.float64)]), size=W)
        share = rng.choice(np.array([tk.NO_LIMIT, -1, -2, 0, i64.max, i64.min,
                                     7], np.int64), size=W)
    else:
        prio = rng.integers(0, 3, size=W).astype(np.int64)
        ts = rng.integers(0, 4, size=W).astype(np.float64)
        share = rng.choice(np.array([-2, -1, 0, 0, 125, 333, tk.NO_LIMIT],
                                    np.int64), size=W)
    topo = {"cq_cohort": torch.from_numpy(cq_cohort),
            "cohort_root": torch.from_numpy(cohort_root),
            "cohort_subtree": torch.zeros((C, 1, 1), dtype=torch.int64)}
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        rng.random(W) < 0.7, rng.random(W) < 0.3, prio, ts,
        rng.integers(0, Q, size=W).astype(np.int32)))
    return topo, args, torch.from_numpy(share)


def order_equal_on_card(topo, args, share, device, with_order):
    """order_csr on the card against the plain version on the host; members
    a permutation of range(W); the kernels launched, counted by the
    profiler, as many as order_plan states. Returns the plan."""
    from torch.profiler import ProfilerActivity, profile
    card_topo = {k: v.to(device) for k, v in topo.items()}
    card = tuple(a.to(device) for a in args)
    card_share = None if share is None else share.to(device)
    want = tk.order_csr(topo, *args, share, with_order=with_order)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = tk.order_csr(card_topo, *card, card_share,
                           with_order=with_order)
        torch.cuda.synchronize()
    plan = tk.order_csr.last_plan
    assert (got[2] is None) == (not with_order)
    for a, b in zip(got, want):
        if b is not None:
            assert torch.equal(a.cpu(), b)
    W = args[0].shape[0]
    assert torch.equal(torch.sort(got[1].cpu()).values,
                       torch.arange(W, dtype=torch.int32))
    kernels = sum(e.count for e in prof.key_averages()
                  if e.key.startswith("order_")
                  and str(e.device_type).endswith("CUDA"))
    assert kernels == plan["launches"], (kernels, plan)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("with_order", (False, True))
@pytest.mark.parametrize("share", ("mixed", "none"))
@pytest.mark.parametrize("W", (2048, 33))
def test_order_edge_keys_on_card(W, share, with_order, cuda_device):
    """-0.0 beside 0.0, NaNs of both signs and several payloads,
    subnormals, +-inf, INT64_MIN and INT64_MAX priorities, NO_LIMIT,
    INT64_MIN, INT64_MAX and negative shares, CQs with no cohort."""
    topo, args, sh = order_case(W, 6, Q=2048 if W > 64 else 64,
                                C=256 if W > 64 else 8, edge=True,
                                solo_every=5)
    plan = order_equal_on_card(topo, args, sh if share == "mixed" else None,
                               cuda_device, with_order)
    assert plan["form"] == "staged"


@pytest.mark.cuda
@pytest.mark.parametrize("with_order", (False, True))
@pytest.mark.parametrize("W", (0, 1, 31, 33, ORDER_LIMIT, ORDER_LIMIT + 1))
def test_order_shapes_on_card(W, with_order, cuda_device):
    """W = 0 (offsets all zero), 1, a ragged warp, the staged form's limit
    and one above it (the global form, three launches)."""
    topo, args, share = order_case(W, W + 1, Q=2048, C=256, solo_every=9)
    plan = order_equal_on_card(topo, args, share, cuda_device, with_order)
    assert plan["form"] == ("staged" if W <= ORDER_LIMIT else "global")


@pytest.mark.cuda
@pytest.mark.parametrize("with_order", (False, True))
@pytest.mark.parametrize("W", (64, 2048))
def test_order_one_domain_on_card(W, with_order, cuda_device):
    """Every workload in one domain: all CQs under one cohort tree."""
    topo, args, share = order_case(W, 7, Q=2048, C=64, one_domain=True)
    assert order_equal_on_card(topo, args, share, cuda_device,
                               with_order)["form"] == "staged"


@pytest.mark.cuda
@pytest.mark.parametrize("with_order", (False, True))
def test_order_65536_on_card(with_order, cuda_device):
    """W = 65,536 over D = 65,536 + 256 domains: the global form."""
    topo, args, share = order_case(65536, 11, Q=65536, C=256, solo_every=7)
    assert order_equal_on_card(topo, args, share, cuda_device,
                               with_order)["form"] == "global"


@pytest.mark.cuda
@pytest.mark.parametrize("with_order", (False, True))
@pytest.mark.parametrize("edge", (False, True))
def test_order_global_form_forced_on_card(edge, with_order, cuda_device,
                                          monkeypatch):
    """The global form at the north star's W, ORDER_SMEM shrunk to 0."""
    monkeypatch.setattr(tk, "ORDER_SMEM", 0)
    topo, args, share = order_case(2048, 12, Q=2048, C=256, edge=edge,
                                   solo_every=5)
    assert order_equal_on_card(topo, args, share, cuda_device,
                               with_order)["form"] == "global"


def gather_twin(S, W, P, F, R, seed, offset=0):
    """A host twin of S rows, each field `offset` elements into a larger
    buffer (off a 16-byte boundary for offset 1), and W slots with -1, -7,
    S and S - 1 among them."""
    rng = np.random.default_rng(seed)
    shapes = {"requests": (P, R), "podset_active": (P,), "wl_cq": (),
              "priority": (), "timestamp": (), "eligible": (P, F),
              "solvable": ()}
    twin = {}
    for name in tk.ARENA_FIELDS:
        shape = (S,) + shapes[name]
        size = int(np.prod(shape))
        dtype = tk.ARENA_DTYPES[name]
        if dtype == torch.bool:
            buf = torch.from_numpy(rng.random(size + 1) < 0.5)
        elif dtype == torch.float64:
            buf = torch.from_numpy(rng.random(size + 1))
        else:
            buf = torch.from_numpy(rng.integers(-1000, 1000, size=size + 1)
                                   ).to(dtype)
        twin[name] = buf
    slots = rng.integers(-3, S + 2, size=W).astype(np.int32)
    slots[:4] = (-1, -7, S, S - 1)[:min(4, W)]
    return twin, shapes, torch.from_numpy(slots)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("shape", ((4, 32, 2), (3, 5, 3), (4, 32, 32)))
@pytest.mark.parametrize("W", (1, 203, 2045))
def test_gather_arena_on_card(W, shape, offset, cuda_device):
    """Slots -1 and -7 (zero rows), cap and cap + 1 (clamped to row cap -
    1) and cap - 1, P=3 F=5 R=3 (odd row bytes), R = 32 (two passes),
    sources sliced one element off a 16-byte boundary, W not a multiple
    of 8."""
    P, F, R = shape
    S = 512
    bufs, shapes, slots = gather_twin(S, W, P, F, R, W + P, offset)
    host, card = {}, {}
    for name, buf in bufs.items():
        size = int(np.prod((S,) + shapes[name]))
        host[name] = buf[offset:offset + size].view((S,) + shapes[name])
        card[name] = buf.to(cuda_device)[offset:offset + size].view(
            (S,) + shapes[name])
        assert card[name].is_contiguous()
    if offset:
        assert card["requests"].data_ptr() % 16 == 8
    want = tk.gather_arena(host, slots)
    got = tk.gather_arena(card, slots.to(cuda_device))
    torch.cuda.synchronize()
    for name, a, b in zip(tk.ARENA_FIELDS, got, want):
        assert torch.equal(a.cpu(), b), name
    pad = min(W, 2)  # slots -1 and -7: zero rows
    assert not want[0][:pad].any() and not want[5][:pad].any()
    if W > 2:  # slot cap: the last row
        assert torch.equal(want[0][2], host["requests"][S - 1])


def twin_views(bufs, shapes, S, offset, device):
    """Each field of gather_twin's buffers as S rows `offset` elements
    into its buffer, on `device`."""
    out = {}
    for name, buf in bufs.items():
        size = int(np.prod((S,) + shapes[name]))
        out[name] = buf.to(device)[offset:offset + size].view(
            (S,) + shapes[name])
        assert out[name].is_contiguous()
    return out


# the slots JAX's scatter drops: cap and past it, below -cap, the int32 ends
SCATTER_DROPS = (512, 517, -513, -1024, 2**31 - 1, -2**31)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("shape", ((4, 32, 2), (3, 5, 3), (4, 32, 32)))
@pytest.mark.parametrize("D", (1, 203, 512))
def test_scatter_arena_on_card(D, shape, offset, cuda_device):
    """K7a against its plain version: P=3 F=5 R=3 (odd row bytes), R = 32
    (two passes), D not a multiple of 8, the rows and the twin one element
    off a 16-byte boundary; distinct targets, each written as its slot or
    slot - cap (-1 and -cap among them), a quarter of the slots dropped
    (cap, cap + 5, -cap - 1, -2 cap, the int32 ends)."""
    P, F, R = shape
    S = 512
    twin_bufs, shapes, _ = gather_twin(S, 1, P, F, R, D + P, offset)
    row_bufs, _, _ = gather_twin(D, 1, P, F, R, D + P + 1, offset)
    rng = np.random.default_rng(D + 7 * P + offset)
    perm = rng.permutation(S)
    targets = np.concatenate([[S - 1, 0], perm[(perm != S - 1)
                                                & (perm != 0)]])[:D]
    slots = np.where(rng.uniform(size=D) < 0.5, targets, targets - S)
    slots[:2] = (-1, -S)[:D]
    drop = rng.uniform(size=D) < 0.25
    drop[:2] = False
    slots[drop] = rng.choice(SCATTER_DROPS, size=int(drop.sum()))
    slots = torch.from_numpy(slots.astype(np.int32))
    host = twin_views(twin_bufs, shapes, S, offset, "cpu")
    card = twin_views(twin_bufs, shapes, S, offset, cuda_device)
    rows = twin_views(row_bufs, shapes, D, offset, "cpu")
    if offset:
        assert card["requests"].data_ptr() % 16 == 8
    before = tk.launch_counts()["arena_scatter"]
    tk.scatter_arena_rows(card, slots.to(cuda_device),
                          {k: v.to(cuda_device) for k, v in rows.items()})
    torch.cuda.synchronize()
    assert tk.launch_counts()["arena_scatter"] == before + 1
    tk.scatter_arena_rows(host, slots, rows)
    for name in tk.ARENA_FIELDS:
        assert torch.equal(card[name].cpu(), host[name]), name
    assert torch.equal(host["requests"][S - 1], rows["requests"][0])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
def test_gather_arena_clamps_on_card(offset, cuda_device):
    """K7b under JAX's gather rule: a slot >= cap (cap, cap + 5, the int32
    maximum) reads row cap - 1; a slot < 0 (-1, -cap - 1, the int32
    minimum) gives a zero row."""
    S, W = 512, 64
    bufs, shapes, _ = gather_twin(S, 1, 3, 5, 3, 17, offset)
    host = twin_views(bufs, shapes, S, offset, "cpu")
    card = twin_views(bufs, shapes, S, offset, cuda_device)
    rng = np.random.default_rng(offset)
    slots = rng.integers(0, S, size=W).astype(np.int32)
    edges = (S, S + 5, 2**31 - 1, -1, -S - 1, -2**31)
    slots[:len(edges)] = edges
    slots = torch.from_numpy(slots)
    want = tk.gather_arena(host, slots)
    got = tk.gather_arena(card, slots.to(cuda_device))
    torch.cuda.synchronize()
    for name, a, b in zip(tk.ARENA_FIELDS, got, want):
        assert torch.equal(a.cpu(), b), name
    for i in range(3):
        assert torch.equal(want[0][i], host["requests"][S - 1])
    assert not want[0][3:6].any() and not want[6][3:6].any()


def deltas_on_card(topo, usage, cu, deltas, device):
    """apply_state_deltas on the card against its plain version on the
    CPU, each on its own copy of the state; returns the card's plan."""
    host = tk.topo_to_device(topo, "cpu")
    card = {k: v.to(device) for k, v in host.items()}
    want = (torch.from_numpy(usage.copy()), torch.from_numpy(cu.copy()))
    got = tuple(t.to(device) for t in want)
    d = [torch.from_numpy(a) for a in deltas]
    tk.apply_state_deltas(host, *want, *d)
    before = tk.launch_counts()["deltas"]
    tk.apply_state_deltas(card, *got, *(a.to(device) for a in d))
    torch.cuda.synchronize()
    assert tk.launch_counts()["deltas"] == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert not torch.equal(want[0], torch.from_numpy(usage))
    return tk.apply_state_deltas.last_plan


def mixed_depth_tree():
    """The north star's widths on trees 3 deep with every 3rd CQ attached
    to its leaf cohort's parent (a node shared by CQs at two depths)."""
    topo, usage, cu, _ = synth_nested_inputs(
        num_cqs=2048, num_leaf_cohorts=256, fanout=4, depth=3,
        num_flavors=32, num_resources=2, num_workloads=8,
        no_cohort_every=16, attach_up_every=3, seed=7)
    return topo, usage, cu


@pytest.mark.cuda
@pytest.mark.parametrize("coords,D,form", ((2049, 8192, "shared"),
                                           (16384, 32768, "global")))
def test_deltas_past_2048_coords_on_card(coords, D, form, cuda_device):
    """K6 at any D: 2049 coords bucket to D = 8192 (128 KB of sums in
    opted-in shared memory), 16,384 to D = 32,768 (512 KB, the global
    form), on the mixed-depth tree."""
    topo, usage, cu = mixed_depth_tree()
    deltas = synth_deltas(topo, usage, coords, seed=coords, level_pairs=8)
    assert deltas[0].shape[0] == D and shared_level_coords(deltas[4]) > 0
    plan = deltas_on_card(topo, usage, cu, deltas, cuda_device)
    assert plan["form"] == form


@pytest.mark.cuda
@pytest.mark.parametrize("form", ("register", "shared", "global"))
def test_deltas_mixed_depth_on_card(form, cuda_device, monkeypatch):
    """A cohort coord at levels 0 and 1 of one tuple, whose old usage at
    level 1 is the value after level 0's add, in each form (the staged
    ones forced by shrinking the register form and the shared memory)."""
    if form != "register":
        monkeypatch.setattr(tk, "DELTAS_REGISTER_ROWS", 0)
    if form == "global":
        monkeypatch.setattr(tk, "DELTAS_SMEM", 0)
    topo, usage, cu = mixed_depth_tree()
    deltas = synth_deltas(topo, usage, 256, seed=11, level_pairs=8)
    lv0 = {tuple(c) for c in deltas[4][0][deltas[4][0, :, 0] >= 0].tolist()}
    lv1 = {tuple(c) for c in deltas[4][1][deltas[4][1, :, 0] >= 0].tolist()}
    assert lv0 & lv1
    multilevel = tk.topo_to_device(topo, "cpu")["cohort_multilevel"]
    assert all(multilevel[c] for c, _, _ in lv0 & lv1)
    assert deltas_on_card(topo, usage, cu, deltas, cuda_device)["form"] \
        == form


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ("flat", "deep3", "zero_levels",
                                   "deep10"))
def test_deltas_chains_on_card(chain, cuda_device):
    """Flat cohorts (L = 1), trees 3 deep (L = 3), a tuple with no
    levels (L = 0) and trees 10 deep (L = 10, past the register form's
    levels)."""
    if chain == "flat":
        topo, usage, cu, _ = synth_solver_inputs(
            num_cqs=2048, num_cohorts=256, num_flavors=32, num_resources=2,
            num_workloads=8, seed=42)
    elif chain == "deep10":
        topo, usage, cu, _ = synth_nested_inputs(
            num_cqs=512, num_leaf_cohorts=512, fanout=2, depth=10,
            num_flavors=4, num_resources=2, num_workloads=8,
            attach_up_every=5, seed=3)
    else:
        topo, usage, cu, _ = synth_nested_inputs(
            num_cqs=2048, num_leaf_cohorts=256, fanout=4, depth=3,
            num_flavors=32, num_resources=2, num_workloads=8,
            no_cohort_every=16, seed=7)
    deltas = synth_deltas(topo, usage, 256, seed=5)
    if chain == "zero_levels":
        deltas = deltas[:4] + (deltas[4][:0], deltas[5][:0])
    plan = deltas_on_card(topo, usage, cu, deltas, cuda_device)
    assert plan["form"] == ("shared" if chain == "deep10" else "register")


def share_on_card(topo, usage, asg, wl_cq, device):
    host = tk.topo_to_device(topo, "cpu")
    args = [torch.from_numpy(a) for a in (usage, asg, wl_cq)]
    want = tk.drf_share(host, *args)
    before = tk.launch_counts()["drf_share"]
    got = tk.drf_share({k: v.to(device) for k, v in host.items()},
                       *(a.to(device) for a in args))
    torch.cuda.synchronize()
    assert tk.launch_counts()["drf_share"] == before + 1
    assert torch.equal(got.cpu(), want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("F", (1, 32, 33))
@pytest.mark.parametrize("R", (1, 2, 3, 17, 32))
def test_drf_share_shapes_on_card(R, F, cuda_device):
    """K3 at R = 1, 2, 3, 17 and 32 and F = 1, 32 and 33: lane groups of
    1 to 32, resources that divide the group or not, up to 33 passes."""
    want = share_on_card(*synth_share_inputs(F, R, seed=F * 100 + R),
                         cuda_device)
    assert (want != 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("scale", (1, 2**33, 2**45))
def test_drf_share_weights_on_card(scale, cuda_device):
    """Weights 0, 500, 1000 and 3000, a root lending nothing (drs -1:
    -1000 // 3000 is -1, -1000 // 500 is -2, weight 0 NO_LIMIT), a root
    lending in every other resource; at scale 2^33 borrowing x 1000 is
    past 2^53 (the int64 division), at 2^45 past int64 (it wraps)."""
    topo, usage, asg, wl_cq = synth_share_inputs(32, 2, scale=scale, seed=1,
                                                 num_cqs=256,
                                                 num_workloads=2048)
    weights = topo["fair_weight"][wl_cq]
    assert {0, 500, 1000, 3000} <= set(weights.tolist())
    want = share_on_card(topo, usage, asg, wl_cq, cuda_device)
    if scale == 1:
        assert (want == -1).any() and (want == -2).any()
        assert (want == tk.NO_LIMIT).any() and (want > 0).any()


@pytest.mark.cuda
def test_chain_tables_required_on_card(cuda_device):
    """A topology dict without the chain tables is refused, never sent to
    the plain version."""
    topo, usage, asg, wl_cq = synth_share_inputs(4, 2, seed=2)
    card = {k: v.to(cuda_device)
            for k, v in tk.topo_to_device(topo, "cpu").items()
            if k not in tk.CHAIN_FIELDS}
    args = [torch.from_numpy(a).to(cuda_device) for a in (usage, asg, wl_cq)]
    with pytest.raises(KeyError):
        tk.drf_share(card, *args)
    deltas = [torch.from_numpy(a).to(cuda_device)
              for a in synth_deltas(topo, usage, 8, seed=2)]
    cu = torch.zeros(card["cohort_guaranteed"].shape, dtype=torch.int64,
                     device=cuda_device)
    with pytest.raises(KeyError):
        tk.apply_state_deltas(card, args[0], cu, *deltas)


# --- device-fault containment on the card ---

def bound_pair(device, num_cqs=32, waves=4):
    """A bound solver on `device` over a 4-flavor cluster with staged
    waves, and its cache and queues."""
    flavors = [f"f{i}" for i in range(4)]
    cache, queues = ns.build_cluster(num_cqs, 4, flavors, 40)
    ns.stage_waves(queues, waves, num_cqs, 40)
    solver = BatchSolver(device=device)
    solver.bind_cache(cache)
    solver.bind_queues(queues)
    return solver, cache, queues


def bound_cycle(solver, cache, queues, cycle, **kwargs):
    heads = queues.heads_nonblocking()
    snapshot = cache.snapshot()
    plan = solver.prepare(snapshot, heads)
    got = solver.solve_prepared(plan, snapshot, **kwargs)[0]
    ns.apply_decisions(cache, queues, solver, heads, got, float(cycle))
    return {heads[i].key: (a.pod_sets, ok) for i, (a, ok) in got.items()}


@pytest.mark.cuda
def test_collect_deadline_through_the_event_poll(cuda_device, monkeypatch):
    """The card still runs the cycle (a sleep kernel queued after the
    dispatch's uploads, ahead of its launches) when the collect's
    deadline passes: collect polls the event, raises DispatchTimeout and
    copies nothing; the next cycle, on fresh resident state, decides as
    the CPU does."""
    import time
    from kueue_tpu_torch.resilience.watchdog import DispatchTimeout
    solver, cache, queues = bound_pair(cuda_device)
    ref, rcache, rqueues = bound_pair("cpu")
    assert bound_cycle(solver, cache, queues, 0) \
        == bound_cycle(ref, rcache, rqueues, 0)
    heads = queues.heads_nonblocking()
    snapshot = cache.snapshot()
    plan = solver.prepare(snapshot, heads)
    real_sync = solver._sync

    def sync_then_stall():
        real_sync()
        torch.cuda._sleep(int(2e9))  # about a second of the card's time
    monkeypatch.setattr(solver, "_sync", sync_then_stall)
    inflight = solver.dispatch(plan, deadline_s=0.05)
    monkeypatch.undo()
    assert not inflight.event.query()
    t0 = time.perf_counter()
    with pytest.raises(DispatchTimeout):
        solver.collect(inflight, snapshot)
    assert time.perf_counter() - t0 < 0.5
    assert solver.counters["dispatch_timeouts"] == 1
    for info in heads:
        queues.requeue_workload(info, ns.RequeueReason.GENERIC)
    solver.invalidate_resident()
    rheads = rqueues.heads_nonblocking()
    for info in rheads:
        rqueues.requeue_workload(info, ns.RequeueReason.GENERIC)
    assert bound_cycle(solver, cache, queues, 1, deadline_s=5.0) \
        == bound_cycle(ref, rcache, rqueues, 1)


@pytest.mark.cuda
def test_supervised_dispatch_launches_from_the_worker(cuda_device,
                                                      monkeypatch):
    """The supervised dispatch's kernels launch from the solver's worker
    thread, on the default stream, and decide as a main-thread dispatch."""
    import threading
    threads = []
    real = tk._launch

    def launch(*args, **kwargs):
        threads.append(threading.current_thread().name)
        return real(*args, **kwargs)
    monkeypatch.setattr(tk, "_launch", launch)
    sup, scache, squeues = bound_pair(cuda_device)
    inline, icache, iqueues = bound_pair(cuda_device)
    for cycle in range(3):
        n = len(threads)
        got = bound_cycle(sup, scache, squeues, cycle, deadline_s=30.0,
                          supervise_deadline_s=30.0)
        assert set(threads[n:]) == {"solver-dispatch"}
        n = len(threads)
        want = bound_cycle(inline, icache, iqueues, cycle)
        assert threading.current_thread().name in set(threads[n:])
        assert got == want
    assert sup._supervisor.calls == 3


@pytest.mark.cuda
def test_kernel_error_in_the_worker_propagates_unwrapped(cuda_device):
    """A kernel wrapper's raise on a CUDA tensor (the arena twin in the
    wrong dtype) inside the supervised dispatch reaches the caller of
    schedule() as it is: no fault counted, the breaker closed."""
    sched, cache, queues, client = ns.build_scheduler(
        32, 4, ["f0"], 40, solver=BatchSolver(device=cuda_device))
    ns.stage_waves(queues, 3, 32, 40)
    sched.schedule(timeout=0)
    assert sched.last_route == "device" and client.admitted == 32
    twin = sched.solver.arena.dev
    twin["wl_cq"] = twin["wl_cq"].to(torch.int64)
    with pytest.raises(TypeError, match="wl_cq|expected"):
        sched.schedule(timeout=0)
    assert sched.solver_faults == 0 and sched.breaker.state == "closed"
    assert sched.solver._supervisor.calls == 2


@pytest.mark.cuda
@pytest.mark.parametrize("wedge", ("site", "before_launch"))
def test_abandoned_worker_writes_nothing(wedge, cuda_device, monkeypatch):
    """A supervised dispatch wedged past its deadline (at the dispatch's
    fault site, or after its uploads, before its first launch) is
    abandoned; when it wakes it launches no kernel and writes neither
    the resident usage nor the arena twin."""
    import threading
    import time
    from kueue_tpu_torch.resilience import faultinject
    from kueue_tpu_torch.resilience.supervisor import SupervisedTimeout
    solver, cache, queues = bound_pair(cuda_device)
    bound_cycle(solver, cache, queues, 0)
    rs = solver.resident
    woke = threading.Event()
    if wedge == "site":
        faultinject.install(faultinject.FaultInjector(
            {faultinject.SITE_DISPATCH: {0: (faultinject.DELAY, 1.0)}}))
    else:
        real_sync = solver._sync

        def sync():
            real_sync()
            if threading.current_thread().name == "solver-dispatch":
                time.sleep(1.0)
        monkeypatch.setattr(solver, "_sync", sync)
    real_check = solver._check_epoch

    def check(epoch):
        try:
            real_check(epoch)
        except Exception:
            woke.set()
            raise
    monkeypatch.setattr(solver, "_check_epoch", check)
    heads = queues.heads_nonblocking()
    snapshot = cache.snapshot()
    plan = solver.prepare(snapshot, heads)
    try:
        with pytest.raises(SupervisedTimeout):
            solver.solve_prepared(plan, snapshot, deadline_s=5.0,
                                  supervise_deadline_s=0.2)
    finally:
        faultinject.uninstall()
    # the state when the dispatch was abandoned (the orphan sleeps on)
    torch.cuda.synchronize()
    assert not woke.is_set()
    launched = sum(tk.launch_counts().values())
    before = (rs.usage_dev.clone(), rs.cohort_dev.clone(),
              {k: v.clone() for k, v in solver.arena.dev.items()})
    assert solver._dispatch_epoch == 1
    assert woke.wait(5.0)  # the orphan woke and met the moved epoch
    time.sleep(0.1)
    torch.cuda.synchronize()
    assert sum(tk.launch_counts().values()) == launched
    assert solver.resident is rs
    assert torch.equal(rs.usage_dev, before[0])
    assert torch.equal(rs.cohort_dev, before[1])
    if solver.arena.dev is not None:
        for k, v in before[2].items():
            assert torch.equal(solver.arena.dev[k], v), k


# --- the speculative pipeline: the router, the started fetch, the lag ---

def routed_pair(device):
    """bound_pair with more waves than the cluster holds, four cycles in
    (every CQ full), then cohort 0's workloads finished: the next heads
    fit in cohort 0 only."""
    solver, cache, queues = bound_pair(device, waves=8)
    admitted = deque()
    for cycle in range(4):
        heads = queues.heads_nonblocking()
        snapshot = cache.snapshot()
        plan = solver.prepare(snapshot, heads)
        got = solver.solve_prepared(plan, snapshot)[0]
        ns.apply_decisions(cache, queues, solver, heads, got, float(cycle),
                           admitted)
        cache.release_snapshot(snapshot)
    for wl in admitted:
        if int(wl.status.admission.cluster_queue[2:]) % 4 == 0:
            cache.delete_workload(wl)
    return solver, cache, queues


@pytest.mark.cuda
def test_router_on_card_equals_cpu(cuda_device):
    """prepare(..., route=True) launches avail and phase_a once each on
    the card (kernel.solve_phase_a against the host mirror) and its fit
    bits equal the CPU solver's and solve_phase_a's plain versions on
    the same mirror and batch."""
    got, want = [], []
    for device, out in ((cuda_device, got), ("cpu", want)):
        solver, cache, queues = routed_pair(device)
        heads = queues.heads_nonblocking()
        snapshot = cache.snapshot()
        before = tk.launch_counts()
        syncs = solver.counters["syncs"]
        plan = solver.prepare(snapshot, heads, route=True)
        launched = {k: v - before[k] for k, v in tk.launch_counts().items()
                    if v != before[k]}
        out.append((plan.fit_pred, launched, solver.counters["syncs"] - syncs,
                    solver.last_phase_s["route"]))
        if device == "cpu":
            b = plan.batch
            plain = tk.solve_phase_a(
                tk.topo_to_device(plan.topo, "cpu"),
                *(torch.from_numpy(np.array(a)) for a in (
                    plan.state.usage, plan.state.cohort_usage, b.requests,
                    b.podset_active, b.wl_cq, b.eligible, b.solvable)),
                num_podsets=solver.max_podsets, fair_sharing=False,
                start_rank=None if plan.start_rank is None
                else torch.from_numpy(plan.start_rank))[0]
            out.append(plain.numpy()[:b.n])
        cache.release_snapshot(snapshot)
    (gfit, glaunched, gsyncs, gsec), (cfit, _, csyncs, _), plain = \
        got[0], want[0], want[1]
    assert gfit.dtype == np.bool_ and np.array_equal(gfit, cfit)
    assert np.array_equal(gfit, plain)
    assert not gfit.all() and gfit.any()
    assert glaunched == {"avail": 1, "phase_a": 1}
    assert gsyncs == csyncs == 1 and gsec > 0


@pytest.mark.cuda
def test_start_fetch_buffers_equal_the_per_key_fetch(cuda_device):
    """start_fetch copies the decision tensors into pinned host buffers
    behind the launches and records an event after them; the buffers
    equal the per-key copies, and the collect decides as a collect with
    no started fetch, adding no sync sample and reading the device phase
    from the events."""
    solver, cache, queues = routed_pair(cuda_device)
    ref, rcache, rqueues = routed_pair(cuda_device)
    heads = queues.heads_nonblocking()
    rheads = rqueues.heads_nonblocking()
    snapshot, rsnap = cache.snapshot(), rcache.snapshot()
    plan = solver.prepare(snapshot, heads, route=True)
    inflight = solver.dispatch(plan, deadline_s=5.0)
    solver.start_fetch(inflight)
    inflight.fetch_event.synchronize()
    for k in inflight.keys:
        buf = inflight.host[k]
        assert buf.device.type == "cpu" and buf.is_pinned()
        assert torch.equal(buf, inflight.result[k].cpu()), k
    samples = list(solver._sync_samples)
    got = solver.collect(inflight, snapshot)[0]
    assert solver._sync_samples == samples
    assert 0 < solver.last_phase_s["device"] < 1.0
    want = ref.solve_prepared(ref.prepare(rsnap, rheads), rsnap,
                              deadline_s=5.0)[0]
    assert len(ref._sync_samples) > 0
    assert {i: (a.pod_sets, ok) for i, (a, ok) in got.items()} \
        == {i: (a.pod_sets, ok) for i, (a, ok) in want.items()}


@pytest.mark.cuda
def test_pipelined_collect_after_a_host_gap_raises_nothing(cuda_device):
    """A collect a host cycle after its dispatch (longer than the
    deadline) whose event completed long ago raises no DispatchTimeout
    and adds no sample to the watchdog's."""
    import time
    solver, cache, queues = routed_pair(cuda_device)
    heads = queues.heads_nonblocking()
    snapshot = cache.snapshot()
    plan = solver.prepare(snapshot, heads, route=True)
    inflight = solver.dispatch(plan, deadline_s=0.05)
    solver.start_fetch(inflight)
    samples = list(solver._sync_samples)
    time.sleep(0.3)
    solver.collect(inflight, snapshot)
    assert solver.counters["dispatch_timeouts"] == 0
    assert solver._sync_samples == samples


def pipelined_build(device, depth: int):
    sched, cache, queues, client = ns.build_scheduler(
        64, 8, [f"f{i}" for i in range(4)], 40,
        solver=BatchSolver(device=device))
    ns.stage_waves(queues, 6, 64, 40)
    sched.pipeline_enabled = True
    sched.pipeline_depth = depth
    return sched, cache, queues, client


@pytest.mark.cuda
@pytest.mark.parametrize("depth", (1, 2))
def test_pipelined_scheduler_on_card_equals_cpu(depth, cuda_device):
    """The pipelined Scheduler (the default watchdog, an injected
    mis-speculation on the third validation) on the card decides as on
    the CPU, cycle by cycle: admissions, cycle counts, hits and aborts;
    the router's kernels launch on the card."""
    from kueue_tpu_torch.resilience import faultinject as fi
    runs = []
    for device in (cuda_device, "cpu"):
        sched, cache, queues, client = pipelined_build(device, depth)
        before = tk.launch_counts()
        trace = []
        fi.install(fi.FaultInjector({fi.SITE_SPECULATION: {2: fi.RAISE}}))
        try:
            for _ in range(10):
                sched.schedule(timeout=0)
                trace.append((sorted(wl.metadata.name
                                     for wl in client.drain_applied()),
                              dict(sched.cycle_counts),
                              sched.speculation_hits,
                              dict(sched.speculation_abort_reasons)))
        finally:
            fi.uninstall()
        launched = {k: v - before[k] for k, v in tk.launch_counts().items()}
        usage = [sorted(cache.usage_for_cluster_queue(f"cq{i}")[0].items())
                 for i in range(64)]
        runs.append((trace, usage, launched, cache.live_handouts))
    (gt, gu, gl, gh), (ct, cu, _, ch) = runs
    assert gt == ct and gu == cu
    assert gt[-1][3].get("injected") == 1 and gt[-1][2] > 0
    assert gh == ch == 0
    assert gl["avail"] > gl["arena_gather"] > 0


# --- the compile governor on the card (slice 18) ---

def governed_env(device, num_cqs=32, waves=4):
    env = ns.build_scheduler(num_cqs, 8, ["f0", "f1"], 8,
                             solver=BatchSolver(device=device))
    ns.stage_waves(env[2], waves, num_cqs, 4)
    return env


@pytest.mark.cuda
def test_governor_on_the_card_is_warm_from_start(cuda_device):
    """Nothing on the card is compiled per shape: a governor started
    before the first cycle is warm at once (no walk, no thread, no
    bucket), warm_setup has no context to build, every cycle takes the
    device route and admits what the same Scheduler on the CPU admits,
    and the card counts no mid-traffic compile."""
    from kueue_tpu_torch.solver.warmgov import GOV_WARM, CompileGovernor
    card, cpu = governed_env(cuda_device), governed_env("cpu")
    solver = card[0].solver
    assert not solver.warm_ladder
    snap = card[1].snapshot()
    assert solver.warm_setup(snap) is None
    card[1].release_snapshot(snap)
    gov = CompileGovernor(solver, card[1], warm_preempt=False)
    card[0].warm_gov = gov
    gov.start()
    st = gov.status()
    assert gov.state == GOV_WARM and gov._thread is None
    assert st["buckets"] == [] and st["programs_warmed"] == 0
    assert st["source"] in ("fresh", "cache-hit")
    tk.reset_launch_counts()
    for cycle in range(3):
        for env in (card, cpu):
            if cycle:
                ns.finish_applied(env[1], env[2], env[3])
            env[0].schedule(timeout=0)
        assert card[0].last_route == "device"
        assert sorted(w.metadata.name for w in card[3].new_applied) \
            == sorted(w.metadata.name for w in cpu[3].new_applied)
    assert card[0].cycle_counts == {"device": 3}
    assert gov.unwarm_routed == 0
    assert tk.launch_counts()["phase_b"] == 3
    assert solver.counters["mid_traffic_compiles"] == 0


def _manager_twin(solver, seed: int = 5):
    """A 32-CQ KueueManager (4 cohorts of 8, 16 flavors in one resource
    group, chip_smoke's manager sizing: each CQ 8 cores of its home
    flavor, the odd ones borrowing up to 8 a flavor) on a FakeClock, every
    cycle on the solver: two schedule_once calls over 64 Jobs of 1-8
    one-core pods and calls until settled (no change, no cycle in
    flight: the pipeline lands a cycle's decisions a call or two
    later), then the first 16 running Jobs finish and calls settle
    again. Returns the store's state (a Pending condition's
    message left out: the device route's non-fit heads carry the batched
    assignment's) and the routes."""
    from kueue_tpu_torch.api import batchv1, corev1
    from kueue_tpu_torch.api.meta import (Condition, FakeClock,
                                          LabelSelector, ObjectMeta)
    from kueue_tpu_torch.manager import KueueManager
    mgr = KueueManager(clock=FakeClock(1000.0), solver=solver)
    mgr.scheduler.solver_min_heads = 0
    store = mgr.store
    flavors = [f"f{i}" for i in range(16)]
    for f in flavors:
        store.create(api.ResourceFlavor(
            metadata=ObjectMeta(name=f),
            spec=api.ResourceFlavorSpec(node_labels={"pool": f})))
    for i in range(32):
        home, lend = flavors[2 * (i % 8)], 8000 if i % 2 else 0
        store.create(api.ClusterQueue(
            metadata=ObjectMeta(name=f"cq{i}"), spec=api.ClusterQueueSpec(
                cohort=f"c{i // 8}", namespace_selector=LabelSelector(),
                resource_groups=[api.ResourceGroup(
                    covered_resources=["cpu"], flavors=[api.FlavorQuotas(
                        name=f, resources=[api.ResourceQuota(
                            name="cpu",
                            nominal_quota=8000 if f == home else 0,
                            borrowing_limit=lend)])
                        for f in [home] + [f for f in flavors
                                           if f != home]])])))
        store.create(api.LocalQueue(
            metadata=ObjectMeta(name=f"lq{i}", namespace="default"),
            spec=api.LocalQueueSpec(cluster_queue=f"cq{i}")))
    rng = np.random.default_rng(seed)
    for n in range(64):
        job = batchv1.Job(metadata=ObjectMeta(
            name=f"j{n}", namespace="default",
            labels={api.QUEUE_LABEL: f"lq{n % 32}"}))
        job.spec.suspend = True
        job.spec.parallelism = int(rng.integers(1, 9))
        job.spec.template = corev1.PodTemplateSpec(spec=corev1.PodSpec(
            containers=[corev1.Container(name="c",
                                         requests={"cpu": 1000})]))
        store.create(job)
    def settle():
        quiet = 0
        for _ in range(20):
            rv = store._rv
            mgr.schedule_once()
            quiet = quiet + 1 if (store._rv == rv and
                                  mgr.scheduler._inflight is None) else 0
            if quiet == 2:
                return
        raise AssertionError("the manager did not settle")

    mgr.schedule_once()
    mgr.schedule_once()
    settle()
    running = sorted((j.metadata.name for j in store.list("Job")
                      if not j.spec.suspend), key=lambda n: int(n[1:]))
    for name in running[:16]:
        job = store.get("Job", "default", name)
        job.status.conditions.append(Condition(
            type=batchv1.JOB_COMPLETE, status="True", message="done"))
        store.update(job)
    settle()
    state = {
        "jobs": {j.metadata.name: (j.spec.suspend,
                                   dict(j.spec.template.spec.node_selector),
                                   j.spec.parallelism)
                 for j in store.list("Job")},
        "workloads": {w.metadata.owner_references[0].name: (
            [(c.type, c.status, c.reason) for c in w.status.conditions],
            w.status.admission)
            for w in store.list("Workload")},
        "cluster_queues": {c.metadata.name: c.status
                           for c in store.list("ClusterQueue")}}
    counts = dict(mgr.scheduler.cycle_counts)
    mgr.shutdown()
    assert mgr.cache.live_handouts == 0
    return state, counts


@pytest.mark.cuda
def test_manager_on_card_equals_solver_none(cuda_device):
    """KueueManager with BatchSolver() on the card (the production wiring:
    the pipeline at depth 2, adaptive routing; every cycle may take the
    solver) ends in the store state of its solver=None twin: Jobs'
    suspend flags and node selectors, Workloads' conditions and
    admissions, CQ status."""
    tk.reset_launch_counts()
    card, counts = _manager_twin(BatchSolver())
    launches = tk.launch_counts()
    plain, _ = _manager_twin(None)
    assert card == plain
    assert any(r.startswith("device") for r in counts), counts
    assert launches["phase_a"] > 0 and launches["phase_b"] > 0
    assert sum(1 for s, _, _ in card["jobs"].values() if not s) > 16
    assert any(w[1] is None for w in card["workloads"].values())
