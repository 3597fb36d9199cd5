"""A bound port BatchSolver(device="cpu") against a bound JAX BatchSolver,
each on its own package's Cache and queue Manager, through one event
script: admissions, finishes between cycles (the journal's delta
prologue), an assume that fails and is reported with note_unapplied,
and a new ClusterQueue, which changes the topology and re-establishes
residency. After every cycle the decisions, the resident usage, the
host mirrors and the encode arena's device twin are equal. The script
runs with fair sharing off and on (the admit order by DRF share).

The cycle is the scheduler's: heads from the Manager, solve, then each
admitted head assumed into the cache and released from the arena, and
the rest requeued.
"""

import random

import numpy as np
import pytest

from kueue_tpu import features as jax_features
from kueue_tpu.solver import BatchSolver as JaxBatchSolver
from kueue_tpu_torch import features as torch_features
from kueue_tpu_torch.solver import BatchSolver as TorchBatchSolver
from kueue_tpu_torch.solver import encode as tenc
from kueue_tpu_torch.solver.arena import ARENA_FIELDS
from tests.test_torch_queue import PkgEnv
from tests.test_torch_solver import normalize

CYCLES = 7
FINISH_CYCLES = (2, 5)   # finishes land before these cycles' snapshots
FAIL_CYCLE = 3           # the first admitted head's assume fails
NEW_CQ_CYCLE = 4         # a new ClusterQueue before this cycle


@pytest.fixture(autouse=True)
def _reset_features():
    jax_features.reset()
    torch_features.reset()
    yield
    torch_features.reset()


LAYOUT = (  # name, cohort, [(flavor, cpu units, borrowing limit)], strict, try-next
    ("cq0", "a", [("f0", 6, None), ("f1", 4, None)], True, False),
    ("cq1", "a", [("f1", 4, 2), ("f0", 4, None)], False, True),
    ("cq2", "b", [("f0", 5, None), ("spot", 6, None)], True, False),
    ("cq3", "b", [("f0", 3, None)], True, False),
    ("cq4", "", [("f0", 4, None), ("f1", 4, None)], False, False),
)


def build(pkg: str, seed: int):
    env = PkgEnv(pkg, flavors=("f0", "f1", "spot"), tainted=("spot",))
    for name, cohort, quotas, strict, try_next in LAYOUT:
        env.add_cq(name, cohort, quotas, strict=strict, try_next=try_next)
    rng = random.Random(seed)
    for i in range(60):
        env.queues.add_or_update_workload(env.workload(
            f"w{i}", f"cq{rng.randrange(len(LAYOUT))}", rng.randrange(0, 3),
            float(rng.randrange(0, 40)),
            [(rng.randint(1, 2), rng.choice([1, 2, 3]), rng.random() < 0.5)
             for _ in range(rng.choice([1, 1, 2]))]))
    solver = (TorchBatchSolver(device="cpu") if pkg == "kueue_tpu_torch"
              else JaxBatchSolver())
    solver.bind_cache(env.cache)
    solver.bind_queues(env.queues)
    env.solver = solver
    env.admitted = []
    return env


def admit(env, info, assignment, now):
    api, wlpkg = env.api, env.wlpkg
    new_wl = wlpkg.clone_for_status_update(info.obj)
    wlpkg.set_quota_reservation(new_wl, api.Admission(
        cluster_queue=info.cluster_queue,
        pod_set_assignments=assignment.to_api()), now)
    env.cache.assume_workload(new_wl, info=wlpkg.Info.from_assignment(
        new_wl, info.cluster_queue, assignment))
    env.solver.release_workload(info.key)
    env.admitted.append(new_wl)


def apply(env, heads, decisions, now, fail_first: bool) -> int:
    n = 0
    for i, info in enumerate(heads):
        decision = decisions.get(i)
        if decision is not None:
            assignment, ok = decision
            info.last_assignment = assignment.last_state
            if ok and fail_first:
                # the assume write failed: revert the device's admission
                fail_first = False
                env.solver.note_unapplied(info.key)
                env.queues.requeue_workload(
                    info, env.RequeueReason.FAILED_AFTER_NOMINATION)
                continue
            if ok:
                admit(env, info, assignment, now)
                n += 1
                continue
        env.queues.requeue_workload(info, env.RequeueReason.GENERIC)
    return n


def resident_arrays(env) -> dict:
    solver = env.solver
    rs = solver._resident
    arena = solver._arena
    out = {"usage_dev": rs.usage_dev, "cohort_dev": rs.cohort_dev,
           "mirror_usage": rs.mirror_usage, "mirror_cohort": rs.mirror_cohort}
    out.update({f"twin.{k}": arena.dev[k] for k in ARENA_FIELDS})
    return {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v)
            for k, v in out.items()}


def backlog(rs) -> dict:
    return {(cq, fr.flavor, fr.resource): v
            for (cq, fr), v in rs.device_backlog.items()}


@pytest.mark.parametrize("fair", (False, True))
@pytest.mark.parametrize("seed", range(3))
def test_bound_solver_matches_jax(seed, fair, monkeypatch):
    from kueue_tpu_torch.solver import kernel as tk
    prologues, shares = [], []
    real = tk.apply_state_deltas_plain
    real_share = tk.drf_share_plain

    def spy(*args):
        prologues.append(cycle)
        return real(*args)

    def spy_share(*args):
        out = real_share(*args)
        shares.append(out)
        return out

    monkeypatch.setattr(tk, "apply_state_deltas_plain", spy)
    monkeypatch.setattr(tk, "drf_share_plain", spy_share)
    envs = [build("kueue_tpu", seed), build("kueue_tpu_torch", seed)]
    admitted = 0
    for cycle in range(CYCLES):
        now = 100.0 + cycle
        for env in envs:
            if cycle in FINISH_CYCLES:
                for wl in env.admitted[:2]:
                    env.cache.delete_workload(wl)
                del env.admitted[:2]
            if cycle == NEW_CQ_CYCLE:
                env.add_cq("cq5", "a", [("f0", 4, None)], strict=True)
                for k in range(3):
                    env.queues.add_or_update_workload(env.workload(
                        f"new{k}", "cq5", k, float(k), [(1, 2, False)]))
        heads = [env.queues.heads_nonblocking() for env in envs]
        assert [h.key for h in heads[0]] == [h.key for h in heads[1]]
        decisions = [env.solver.solve(env.cache.snapshot(), h,
                                      fair_sharing=fair)
                     for env, h in zip(envs, heads)]
        assert normalize(decisions[1]) == normalize(decisions[0]), cycle
        counts = [apply(env, h, d, now, cycle == FAIL_CYCLE)
                  for env, h, d in zip(envs, heads, decisions)]
        assert counts[0] == counts[1]
        admitted += counts[1]
        ref, got = resident_arrays(envs[0]), resident_arrays(envs[1])
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k],
                                          err_msg=f"cycle {cycle}: {k}")
        # the dispatched heads' slots and their encode generations, which
        # the admissions' releases have bumped
        gens = [env.solver.slot_generations(env.solver._arena._last_slots)
                for env in envs]
        np.testing.assert_array_equal(gens[1], gens[0])
        rs_t, rs_j = envs[1].solver._resident, envs[0].solver._resident
        # the mirror is the host truth: the cache after the admissions
        truth = tenc.encode_state(envs[1].cache.snapshot(),
                                  envs[1].solver._topo_cache[0])
        np.testing.assert_array_equal(got["mirror_usage"], truth.usage)
        np.testing.assert_array_equal(got["mirror_cohort"],
                                      truth.cohort_usage)
        assert rs_t.pending.keys() == rs_j.pending.keys()
        assert backlog(rs_t) == backlog(rs_j)
        if not rs_t.device_backlog:
            # the mirror is the device state plus the unshipped backlog
            np.testing.assert_array_equal(got["usage_dev"],
                                          got["mirror_usage"])
            np.testing.assert_array_equal(got["cohort_dev"],
                                          got["mirror_cohort"])
    port = envs[1].solver
    assert prologues == [2, 5]  # the finishes reached the device
    # with fair sharing every cycle computed the shares, some non-zero
    assert len(shares) == (CYCLES if fair else 0)
    assert not fair or any((s != 0).any() for s in shares)
    assert admitted > 0
    assert port.counters["resident_cycles"] == CYCLES
    assert port.counters["establishes"] == 2  # first cycle, new CQ
    assert port._arena.row_uploads > 0 and port._arena.full_uploads >= 2
