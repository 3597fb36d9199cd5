"""The port's WorkloadArena against the JAX package's, over a seeded
churn at the size of tests/test_encode_arena.py: arrivals, updates
(a resourceVersion bump on a fresh object, changed requests), deletions
(slot free and reuse), releases of admitted heads, topology bumps (a new
ClusterQueue), more podsets than the arena holds, flavor-resume state.
After every cycle both arenas hold the same slots, generations, host
arrays and device twin, and `assemble` equals encode.encode_workloads.
"""

import random

import numpy as np
import pytest

from kueue_tpu.solver.arena import ARENA_FIELDS as JAX_FIELDS
from kueue_tpu_torch.solver.arena import ARENA_FIELDS
from tests.test_torch_queue import PkgEnv, random_podsets

P = 2
BATCH_FIELDS = ("requests", "podset_active", "wl_cq", "priority",
                "timestamp", "eligible", "solvable", "start_rank")


def arena_env(pkg: str):
    env = PkgEnv(pkg)
    arena_mod = __import__(f"{pkg}.solver.arena", fromlist=["x"])
    env.encode = __import__(f"{pkg}.solver.encode", fromlist=["x"])
    env.arena = arena_mod.WorkloadArena(P)
    env.queues.add_workload_listener(env.arena.note)
    env.ordering = env.wlpkg.Ordering()
    env.num_cqs = 0
    env.topo_epoch = None
    return env


def add_cq(env) -> None:
    i = env.num_cqs
    env.num_cqs += 1
    env.add_cq(f"cq{i}", f"cohort-{i % 2}", [("f0", 10, None),
                                             ("f1", 10, None)])


def fresh_batch(env, entries, snapshot, topo):
    """The oracle, with its per-Info cache and resume side effects kept
    away from the arena pass (as tests/test_encode_arena.py does)."""
    resumes = [info.last_assignment for info in entries]
    for info in entries:
        info.__dict__.pop("_solver_enc", None)
    batch = env.encode.encode_workloads(entries, snapshot, topo,
                                        max_podsets=P)
    for info, la in zip(entries, resumes):
        if info.last_assignment is None and la is not None:
            info.last_assignment = la
    return batch


def device_twin(env) -> dict:
    dev, _ = (env.arena.prepare_device("cpu") if env.pkg == "kueue_tpu_torch"
              else env.arena.prepare_device())
    return {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v)
            for k, v in dev.items()}


def assert_arenas_equal(ja, ta, msg):
    assert ta.cap == ja.cap and ta.size == ja.size, msg
    assert ta.slot_of == ja.slot_of, msg
    assert ta.free == ja.free and ta.dirty == ja.dirty, msg
    np.testing.assert_array_equal(ta.gen, ja.gen, err_msg=msg)
    for name in ARENA_FIELDS:
        np.testing.assert_array_equal(getattr(ta, name), getattr(ja, name),
                                      err_msg=f"{msg}: {name}")
    assert (ta.encoded_rows, ta.gathers, ta.full_uploads, ta.row_uploads) == \
        (ja.encoded_rows, ja.gathers, ja.full_uploads, ja.row_uploads), msg


@pytest.mark.parametrize("seed", range(6))
def test_arena_matches_jax(seed):
    assert ARENA_FIELDS == JAX_FIELDS
    rng = random.Random(seed)
    envs = [arena_env("kueue_tpu"), arena_env("kueue_tpu_torch")]
    for env in envs:
        for _ in range(4):
            add_cq(env)
    live: dict = {}
    n = 0
    for cycle in range(10):
        for _ in range(rng.randrange(1, 6)):
            name = f"w{n}"
            n += 1
            live[name] = (name, f"cq{rng.randrange(envs[0].num_cqs)}",
                          rng.randrange(-2, 3), float(rng.randrange(10_000)),
                          random_podsets(rng, P))
            for env in envs:
                assert env.queues.add_or_update_workload(
                    env.workload(*live[name]))
        for name in rng.sample(sorted(live), min(2, len(live))):
            if rng.random() < 0.5:
                old = live[name]
                live[name] = (name, old[1], old[2], old[3],
                              random_podsets(rng, P))
                for env in envs:
                    env.queues.add_or_update_workload(
                        env.workload(*live[name], rv=cycle + 2))
            else:
                args = live.pop(name)
                for env in envs:
                    env.queues.delete_workload(env.workload(*args))
        if cycle in (4, 7):
            for env in envs:
                add_cq(env)  # topology epoch bump -> new topo token
        keys = sorted(envs[0].pending_infos())
        if not keys:
            continue
        picked = rng.sample(keys, rng.randrange(1, len(keys) + 1))
        resume = [(k, rng.choice([-1, 0, 1]))
                  for k in rng.sample(picked, min(2, len(picked)))]
        released = picked[: rng.randrange(0, 2)]
        twins = []
        for env in envs:
            infos = env.pending_infos()
            entries = [infos[k] for k in picked]
            for k, idx in resume:
                infos[k].last_assignment = env.wlpkg.AssignmentClusterQueueState(
                    last_tried_flavor_idx=[{"cpu": idx}],
                    cluster_queue_generation=10**9, cohort_generation=10**9)
            snapshot = env.cache.snapshot()
            if snapshot.topology_epoch != env.topo_epoch:
                # re-encoded only when the topology moves, as the solver
                # does: a new token makes every row and the twin stale
                env.topo = env.encode.encode_topology(snapshot)
                env.topo_epoch = snapshot.topology_epoch
            topo = env.topo
            env.arena.begin_cycle(topo)
            batch, slots = env.arena.assemble(entries, snapshot, topo,
                                              env.ordering, P)
            fresh = fresh_batch(env, entries, snapshot, topo)
            for name in BATCH_FIELDS:
                np.testing.assert_array_equal(
                    getattr(batch, name), getattr(fresh, name),
                    err_msg=f"{env.pkg} cycle {cycle}: {name}")
            env.slots = list(slots)
            twins.append(device_twin(env))
            # an admitted head leaves the pending set through the solver
            for k in released:
                env.arena.release(k)
        assert envs[0].slots == envs[1].slots, cycle
        for name in ARENA_FIELDS:
            np.testing.assert_array_equal(twins[1][name], twins[0][name],
                                          err_msg=f"cycle {cycle}: {name}")
        assert_arenas_equal(envs[0].arena, envs[1].arena, f"cycle {cycle}")
    # the changed-row scatter ran, not only wholesale uploads
    assert envs[1].arena.row_uploads > 0
