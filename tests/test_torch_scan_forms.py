"""global_scan's launch plan and a model of its register form.

The CUDA kernel (csrc/global_scan.cu, K14) runs only on the card
(tests/test_torch_cuda.py). Here: `kernel.global_scan_plan`'s form, vote
and sizes; `kernel.global_scan_steps`, the model of the prologue's list
(the fit steps of the order, in its order, with their CQ and the marks of
a CQ that repeats on consecutive fit steps); and a numpy model of the
register form's walk over that list, which reads each step's usage one
step ahead and forwards the value just written when the CQ repeats. The
model is held to global_scan_plain on orders that interleave fit and
non-fit steps and repeat CQs, and, through the port's Phase A and global
order, to the JAX package's solve_cycle (the lax.scan the kernel
replaces). Without the forwarding the model must differ on those orders:
they reach the case.
"""

import numpy as np
import pytest
import torch

from kueue_tpu_torch.solver import kernel as tk
from tests.test_torch_kernels import Q, make_inputs, t, torch_topo
from tests.test_torch_oracles import CASES, VARIANTS, port_args, reference

SCAN_KEYS = ("admitted", "usage", "cohort_usage")


@pytest.mark.parametrize("W,C,FR,DC,form,dct,threads,vote,smem", [
    # the north star: cohort_usage's 131,072 bytes in shared memory
    (2048, 256, 64, 1, "shared", 1, 256, "block", 131072),
    # nested_large: 336 cohorts, 172,032 bytes, chains of 3
    (2048, 336, 64, 3, "shared", 4, 256, "block", 172032),
    # past GLOBAL_SCAN_SMEM: the global form
    (2048, 512, 64, 1, "global", 1, 256, "block", 0),
    # one warp of lanes: __all_sync
    (300, 8, 16, 2, "shared", 2, 256, "warp", 1024),
    (300, 8, 32, 8, "shared", 8, 256, "warp", 2048),
    # past the register form: chains of 10, F*R = 320, F*R = 2000
    (300, 1000, 16, 10, "shared", 0, 32, "warp", 128000),
    (300, 8, 320, 1, "shared", 0, 320, "block", 20480),
    (300, 8, 2000, 1, "shared", 0, 1024, "block", 128000),
    (300, 8, 256, 1, "shared", 1, 256, "block", 16384),
])
def test_global_scan_plan(W, C, FR, DC, form, dct, threads, vote, smem):
    plan = tk.global_scan_plan(W, C, FR, DC)
    assert plan == {"form": form, "register_dc": dct, "threads": threads,
                    "vote": vote, "smem": smem, "scratch_ints": W * (3 + DC)}
    assert dct == 0 or dct >= DC
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 1024


def test_global_scan_plan_forced_forms():
    assert tk.global_scan_plan(64, 8, 16, 1, "global")["smem"] == 0
    assert tk.global_scan_plan(64, 8, 16, 1, "shared")["smem"] == 1024
    with pytest.raises(ValueError):
        tk.global_scan_plan(64, 512, 64, 1, "shared")
    with pytest.raises(ValueError):
        tk.global_scan_plan(64, 8, 16, 1, "staged")


def test_global_scan_steps_hand_example():
    fit = torch.tensor([True, False, True, True, True])
    wl_cq = torch.tensor([5, 1, 5, 5, 2], dtype=torch.int32)
    order = torch.tensor([3, 0, 1, 2, 4], dtype=torch.int32)
    cq_cohort = torch.tensor([-1, 0, 0, 1, 0, 2], dtype=torch.int32)
    w, q, has_cohort, repeat = tk.global_scan_steps(fit, wl_cq, order,
                                                    cq_cohort)
    assert w.tolist() == [3, 0, 2, 4]
    assert q.tolist() == [5, 5, 5, 2]
    assert has_cohort.tolist() == [True, True, True, True]
    assert repeat.tolist() == [False, True, True, False]


def avail_level(quota, guaranteed, borrow_limit, usage, parent):
    bl = np.minimum(borrow_limit, tk.NO_LIMIT // 4)
    cap = (quota - guaranteed) - np.maximum(usage - guaranteed, 0) + bl
    return np.maximum(guaranteed - usage, 0) + np.minimum(parent, cap)


def register_walk(topo, usage, cohort_usage, asg, fit, wl_cq, order,
                  forward=True):
    """The register form's walk in numpy, on the prologue's list: each
    step's usage row is read while the step before it runs (before that
    step's write), and replaced by the value written when the CQ repeats
    (`forward`)."""
    w, q, has_cohort, repeat = (a.numpy() for a in tk.global_scan_steps(
        fit, wl_cq, order, topo["cq_cohort"]))
    nom, guar, blim = (topo[k].numpy().reshape(len(topo[k]), -1) for k in
                       ("nominal", "guaranteed", "borrow_limit"))
    sub, cguar, climit = (topo[k].numpy().reshape(len(topo[k]), -1) for k in
                          ("cohort_subtree", "cohort_guaranteed",
                           "cohort_borrow_limit"))
    chains = topo["cq_chain"].numpy()
    u = usage.numpy().reshape(usage.shape[0], -1).copy()
    cu = cohort_usage.numpy().reshape(cohort_usage.shape[0], -1).copy()
    au_all = asg.numpy().reshape(asg.shape[0], -1)
    admitted = np.zeros(fit.shape[0], bool)
    nxt = u[q[0]].copy() if len(w) else None
    for n in range(len(w)):
        uq = nxt
        if n + 1 < len(w):
            nxt = u[q[n + 1]].copy()
        chain = [c for c in chains[q[n]] if c >= 0]
        au = au_all[w[n]]
        if has_cohort[n]:
            parent = sub[chain[-1]] - cu[chain[-1]]
            for c in reversed(chain[:-1]):
                parent = avail_level(sub[c], cguar[c], climit[c], cu[c],
                                     parent)
            avail = avail_level(nom[q[n]], guar[q[n]], blim[q[n]], uq,
                                parent)
        else:
            avail = nom[q[n]] - uq
        if not ((au == 0) | (au <= avail)).all():
            continue
        nq = uq + au
        u[q[n]] = nq
        if forward and n + 1 < len(w) and repeat[n + 1]:
            nxt = nq.copy()
        if has_cohort[n]:
            delta = np.maximum(nq - guar[q[n]], 0) - \
                np.maximum(uq - guar[q[n]], 0)
            for c in chain:
                old = cu[c].copy()
                cu[c] = old + delta
                delta = np.maximum(cu[c] - cguar[c], 0) - \
                    np.maximum(old - cguar[c], 0)
        admitted[w[n]] = True
    return (admitted, u.reshape(usage.shape),
            cu.reshape(cohort_usage.shape))


def cycle_scan_args(args, kw):
    """global_scan's arguments from the port's Phase A and global order
    (CPU) on a cycle's arguments."""
    topo, usage, cu, requests, podset_active, wl_cq, priority, timestamp, \
        eligible, solvable = args
    fit, borrows, _, _, asg, share = tk.solve_phase_a(
        topo, usage, cu, requests, podset_active, wl_cq, eligible, solvable,
        **kw)
    order = tk.order_csr(topo, fit, borrows, priority, timestamp, wl_cq,
                         share if kw["fair_sharing"] else None,
                         with_order=True)[2]
    return topo, usage, cu, asg, fit, wl_cq, order


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("kind,seed", CASES)
def test_register_walk_matches_jax_solve_cycle(kind, seed, variant):
    ref = reference(kind, seed, variant)["seq"]
    _, args, kw, _ = port_args(kind, seed, variant)
    got = register_walk(*cycle_scan_args(args, kw))
    for name, a in zip(SCAN_KEYS, got):
        assert np.array_equal(a, ref[name]), name


def repeat_inputs(kind: str, seed: int):
    """make_inputs' trees with runs of up to 6 workloads on one CQ, a
    third of them unsolvable, in an order that is not the admit order:
    its first half sorted by index, the rest shuffled."""
    topo, usage, cu, wl = make_inputs(kind, seed)
    rng = np.random.default_rng(seed + 40)
    W = wl["wl_cq"].shape[0]
    wl["wl_cq"] = np.repeat(rng.integers(0, Q, size=W),
                            rng.integers(1, 7, size=W))[:W].astype(np.int32)
    wl["solvable"] = wl["solvable"] & (rng.uniform(size=W) < 0.7)
    perm = rng.permutation(W)
    order = np.concatenate([np.sort(perm[:W // 2]), perm[W // 2:]])
    return topo, usage, cu, wl, order.astype(np.int32)


@pytest.mark.parametrize("seed", (0, 1, 2, 3))
@pytest.mark.parametrize("kind", ("flat", "nested2", "nested3"))
def test_register_walk_matches_plain_on_repeats(kind, seed):
    topo, usage, cu, wl, order = repeat_inputs(kind, seed)
    ttopo = torch_topo(topo)
    P = wl["requests"].shape[1]
    fit, _, _, _, asg, _ = tk.solve_phase_a(
        ttopo, t(usage), t(cu), t(wl["requests"]), t(wl["podset_active"]),
        t(wl["wl_cq"]), t(wl["eligible"]), t(wl["solvable"]), num_podsets=P)
    args = (ttopo, t(usage), t(cu), asg, fit, t(wl["wl_cq"]), t(order))
    want = tk.global_scan_plain(*args)
    steps = tk.global_scan_steps(fit, args[5], args[6], ttopo["cq_cohort"])
    assert 0 < steps[0].numel() < len(order) and steps[3].any()
    for name, a, b in zip(SCAN_KEYS, register_walk(*args), want):
        assert np.array_equal(a, b.numpy()), name


def test_forwarding_is_reached():
    """Without the forwarded usage the walk admits past a CQ's quota on
    some of these orders: the tests above reach the repeat case."""
    differs = 0
    for kind in ("flat", "nested2", "nested3"):
        for seed in range(4):
            topo, usage, cu, wl, order = repeat_inputs(kind, seed)
            ttopo = torch_topo(topo)
            P = wl["requests"].shape[1]
            fit, _, _, _, asg, _ = tk.solve_phase_a(
                ttopo, t(usage), t(cu), t(wl["requests"]),
                t(wl["podset_active"]), t(wl["wl_cq"]), t(wl["eligible"]),
                t(wl["solvable"]), num_podsets=P)
            args = (ttopo, t(usage), t(cu), asg, fit, t(wl["wl_cq"]),
                    t(order))
            want = tk.global_scan_plain(*args)
            got = register_walk(*args, forward=False)
            differs += not all(np.array_equal(a, b.numpy())
                               for a, b in zip(got, want))
    assert differs > 0
