"""The admission solve on the card: hand-written CUDA kernels, each with
a plain PyTorch version beside it.

Counterpart of kueue_tpu/solver/kernel.py's programs: the unbound cycle
`solve_cycle_fused_impl`, the production cycles of a solver bound to its
cache and queues, `solve_cycle_resident_impl` and
`solve_cycle_resident_arena_impl`, fair sharing included, and the
minimal-preemption solve of kueue_tpu/solver/preempt.py
(`solve_preempt`) and the fair-sharing preemption solve of
kueue_tpu/solver/fairpreempt.py (`solve_fair`), alone, back to back
(`solve_preemptions`) or composed with the fit cycle against the same
usage (`solve_cycle_with_preempt`, the `preempt_args` and
`fair_preempt_args` of the resident cycles), and MultiKueue's remote
cluster columns, scored inside the cycle (`cluster_args`). One fused
cycle is:

1. `avail`   - availability of every CQ, walked down its cohort chain.
2. `phase_a` - flavor assignment for every head (vectorized over W).
   With fair sharing on, `drf_share` then gives each head its dominant
   resource share, the admit order's third key.
3. `order_csr` - the admit order and the conflict-domain CSR of it
   (with cluster columns, also the global admit order).
4. `phase_b` - the order-dependent admit with intra-cycle accounting,
   one thread block per conflict domain, reading the CSR.
5. `score_cluster_columns` - with cluster columns, the remote cluster
   each admitted MultiKueue head is placed on (`mk_cluster`), scanned in
   the global admit order.
6. `pack`    - the compact decision wire format (`mk_cluster` passes).

Phase A also runs on its own (`solve_phase_a`: avail, phase_a and, with
fair sharing, drf_share), once per round of the batched partial-admission
search. The cycle's oracles compose the same kernels: the three-step
`solve_cycle_cohort_parallel` (Phase A, the host's [L,D] order grid of
`build_order_grid`, phase_b over it in `solve_phase_b_domains`) and the
global W-step scan `solve_cycle` (Phase A, the global admit order, then
`global_scan`, csrc/global_scan.cu, which no production path launches).

The sharded cycle (kueue_tpu_torch/parallel/mesh.py) runs the same
kernels on each rank: `phase_b` over the rank's planner columns (`cols`),
`solve_preempt` over its problem slots (`slots`), and `combine_pack` /
`combine_unpack` (csrc/mesh_combine.cu) around the all-reduce that joins
the ranks' admissions and usage deltas.

The resident cycle first applies the journal's sparse usage corrections
to the usage that stays on the card (`apply_state_deltas`); the arena
cycle first gathers the heads' rows from the device twin of the encode
arena (`gather_arena`), which `scatter_arena_rows` keeps current.

Each kernel has a wrapper (mesh_combine two, one per entry), a plain
PyTorch version in this module and a launch counter
(`<wrapper>.launches`, a plain int bumped once per launch). A wrapper
runs the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises. All quantities are
int64 (memory is in bytes) and decisions are bits, so the kernels and
the plain versions agree exactly.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from kueue_tpu_torch.solver import _build
from kueue_tpu_torch.solver.arena import ARENA_FIELDS

NO_LIMIT = 2**62
INF_RANK = 10**6  # "no fitting flavor" rank (kueue_tpu/solver/kernel.py:165)

# chosen + 1 must fit in 7 bits (bit 7 carries chosen_borrow)
MAX_COMPACT_FLAVORS = 126

# the packed decision keys, in fetch order
DECISION_KEYS = ("dec_pr", "dec_bits")

# Topology fields the kernels consume, in the JAX package's order
# (kueue_tpu/solver/kernel.py:941).
TOPO_FIELDS = (
    "cq_cohort", "nominal", "borrow_limit", "guaranteed", "offered",
    "group_id", "flavor_group", "flavor_rank", "prefer_no_borrow",
    "cohort_subtree", "cohort_parent", "cohort_depth", "cohort_root",
    "cohort_guaranteed", "cohort_borrow_limit", "cq_chain", "fair_weight",
    "cohort_lendable",
)

# The conflict-domain tables phase_b stages its rows by, derived once per
# topology (`domain_tables`), in topo_to_device's output beside
# TOPO_FIELDS.
DOMAIN_FIELDS = ("dom_roots", "dom_solo", "dom_row", "dom_cqs",
                 "dom_cohorts", "dom_nq", "dom_nc", "cq_slot", "cq_chain_slot")


def domain_tables(cq_cohort, cohort_root, cq_chain) -> dict:
    """The conflict domains of a topology as tables (numpy int32). A domain
    is a root cohort's tree, or a CQ with no cohort (a solo domain):
    - dom_roots [NR]: the root cohorts (cohort_root[c] == c), ascending;
      row b of the per-root tables is dom_roots[b];
    - dom_solo [NS]: the CQs with no cohort, ascending (domain C + q);
    - dom_row [C]: a root's row, -1 for a cohort that is not a root;
    - dom_cqs [NR,SQ], dom_cohorts [NR,SC]: each root's CQs and cohorts,
      ascending, -1 padded (SQ, SC at least 1); dom_nq, dom_nc [NR] their
      counts;
    - cq_slot [Q]: a CQ's index in its root's dom_cqs row (0 for a solo
      CQ); cq_chain_slot [Q,DC]: each cq_chain entry's index in the root's
      dom_cohorts row, -1 where cq_chain is -1.
    Raises ValueError where a chain leaves its root's tree."""
    cq_cohort = np.asarray(cq_cohort)
    cohort_root = np.asarray(cohort_root)
    cq_chain = np.asarray(cq_chain)
    C, Q = cohort_root.shape[0], cq_cohort.shape[0]
    roots = np.flatnonzero(cohort_root == np.arange(C)).astype(np.int32)
    dom_row = np.full(C, -1, np.int32)
    dom_row[roots] = np.arange(roots.shape[0], dtype=np.int32)
    in_cohort = cq_cohort >= 0
    cq_root = np.where(in_cohort, cohort_root[np.maximum(cq_cohort, 0)], -1)
    if (in_cohort & (dom_row[np.maximum(cq_root, 0)] < 0)).any():
        raise ValueError("a cohort's root is not a root cohort")
    co_row = np.where(cohort_root >= 0, dom_row[np.maximum(cohort_root, 0)],
                      -1)
    NR = roots.shape[0]

    def grouped(row_of):
        """Each row's members (indices whose row_of is the row), ascending,
        -1 padded; each member's index in its row; the rows' counts."""
        ids = np.flatnonzero(row_of >= 0)
        counts = np.bincount(row_of[ids], minlength=NR).astype(np.int32)
        start = np.concatenate(([0], np.cumsum(counts)[:-1])).astype(np.int64)
        by_row = ids[np.argsort(row_of[ids], kind="stable")]
        slot = np.zeros(row_of.shape[0], np.int32)
        slot[by_row] = np.arange(by_row.shape[0]) - np.repeat(start, counts)
        table = np.full((NR, max(1, int(counts.max(initial=0)))), -1,
                        np.int32)
        table[row_of[by_row], slot[by_row]] = by_row
        return table, slot, counts

    dom_cqs, cq_slot, dom_nq = grouped(
        np.where(in_cohort, dom_row[np.maximum(cq_root, 0)], -1))
    dom_cohorts, cohort_slot, dom_nc = grouped(co_row)
    valid = cq_chain >= 0
    chain_root = cohort_root[np.maximum(cq_chain, 0)]
    if (valid & (chain_root != cq_root[:, None])).any():
        raise ValueError("a cq_chain entry lies outside its CQ's root tree")
    cq_chain_slot = np.where(valid, cohort_slot[np.maximum(cq_chain, 0)],
                             -1).astype(np.int32)
    return {"dom_roots": roots, "dom_solo": np.flatnonzero(~in_cohort)
            .astype(np.int32), "dom_row": dom_row, "dom_cqs": dom_cqs,
            "dom_cohorts": dom_cohorts, "dom_nq": dom_nq, "dom_nc": dom_nc,
            "cq_slot": cq_slot, "cq_chain_slot": cq_chain_slot}


# The chain tables drf_share and the delta prologue read, derived once
# per topology (`chain_tables`), in topo_to_device's output beside
# DOMAIN_FIELDS.
CHAIN_FIELDS = ("cq_root", "cohort_multilevel")


def chain_tables(cq_cohort, cohort_root, cohort_parent, cq_chain) -> dict:
    """Per-topology tables that take dependent lookups off the kernels'
    chains (numpy):
    - cq_root [Q] int32: the root cohort of each CQ's cohort, -1 for a CQ
      with no cohort (drf_share's lendable row);
    - cohort_multilevel [C] bool: the cohorts that can sit at two levels
      of one delta tuple. encode.deltas_from_coords puts the CQs' direct
      cohorts (cq_chain[:, 0]) at level 0 and the parents of level l's
      cohorts at level l + 1, for cq_chain.shape[1] levels; a cohort
      reached at two of those levels (CQs attached under it at two
      depths) is marked, and the delta kernel reads its old usage at
      each level, after the earlier levels' adds."""
    cq_cohort = np.asarray(cq_cohort)
    cohort_root = np.asarray(cohort_root)
    cohort_parent = np.asarray(cohort_parent)
    cq_chain = np.asarray(cq_chain)
    C = cohort_root.shape[0]
    cq_root = np.where(cq_cohort >= 0,
                       cohort_root[np.maximum(cq_cohort, 0)] if C else -1,
                       -1).astype(np.int32)
    levels = np.zeros(C, np.int32)
    at = np.unique(cq_chain[:, 0]) if cq_chain.shape[1] else \
        np.zeros(0, np.int64)
    for _ in range(cq_chain.shape[1]):
        at = at[at >= 0]
        if not at.size:
            break
        levels[at] += 1
        at = np.unique(cohort_parent[at])
    return {"cq_root": cq_root, "cohort_multilevel": levels > 1}


def topo_to_device(topo, device) -> dict:
    """Encoded topology (a `Topology` or a dict of numpy arrays, as either
    package's encoder or synth makes it) -> dict of tensors on `device`:
    TOPO_FIELDS, the domain tables (DOMAIN_FIELDS) phase_b reads and the
    chain tables (CHAIN_FIELDS) drf_share and the delta prologue read."""
    get = topo.get if isinstance(topo, dict) else (lambda k: getattr(topo, k))
    arrays = {name: np.asarray(get(name)) for name in TOPO_FIELDS}
    arrays.update(domain_tables(arrays["cq_cohort"], arrays["cohort_root"],
                                arrays["cq_chain"]))
    arrays.update(chain_tables(arrays["cq_cohort"], arrays["cohort_root"],
                               arrays["cohort_parent"], arrays["cq_chain"]))
    return {name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for name, a in arrays.items()}


def state_to_device(usage, cohort_usage, device) -> tuple:
    """Encoded usage state (numpy int64 [Q,F,R], [C,F,R]) -> tensors."""
    return (torch.from_numpy(np.ascontiguousarray(usage)).to(device),
            torch.from_numpy(np.ascontiguousarray(cohort_usage)).to(device))


def reset_launch_counts() -> None:
    for fns in KERNEL_WRAPPERS.values():
        for fn in fns:
            fn.launches = 0


def launch_counts() -> dict:
    """{kernel name (its csrc/<name>.cu): launches of its wrappers since
    the reset}."""
    return {name: sum(fn.launches for fn in fns)
            for name, fns in KERNEL_WRAPPERS.items()}


# ---------------------------------------------------------------------------
# Launch plumbing
# ---------------------------------------------------------------------------

def _is_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _ptr(t: torch.Tensor, dtype: torch.dtype, name: str) -> int:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return t.data_ptr()


def _launch(name: str, ptrs: list, ints: list, device,
            symbol: str = None) -> None:
    fn = _build.entry(name, len(ptrs), len(ints), symbol)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*[ctypes.c_void_p(p) for p in ptrs],
            *[ctypes.c_longlong(i) for i in ints], ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# avail: availability of every CQ
# ---------------------------------------------------------------------------
#
# Replaces kueue_tpu/solver/kernel.py:39 _avail_level, :50 _cohort_avail
# and :70 _available. Bound on the H100: bytes — each (q,f,r) reads the
# CQ's four [Q,F,R] rows and up to DC cohort rows, all int64, and does a
# handful of integer ops. Design: one thread per (q,f,r) walks
# cq_chain[q] from its root end (the _chain_avail recursion), so there
# is no [C,F,R] intermediate and no launch per depth level.

def _avail_level(quota, guaranteed, borrow_limit, usage, parent_avail):
    local = (guaranteed - usage).clamp_min(0)
    cap = (quota - guaranteed) - (usage - guaranteed).clamp_min(0) + \
        borrow_limit.clamp_max(NO_LIMIT // 4)
    return local + torch.minimum(parent_avail, cap)


def _chain_avail(topo, cohort_usage, chain):
    """Availability of each chain's direct cohort ([N,DC] -> [N,F,R]),
    walking top-down from the first valid entry from the end (the root)."""
    N, DC = chain.shape
    F, R = topo["cohort_subtree"].shape[1:]
    avail = torch.zeros((N, F, R), dtype=torch.int64, device=chain.device)
    started = torch.zeros(N, dtype=torch.bool, device=chain.device)
    for d in range(DC - 1, -1, -1):
        c = chain[:, d].long()
        valid = c >= 0
        c_ = c.clamp_min(0)
        cu = cohort_usage[c_]
        subtree = topo["cohort_subtree"][c_]
        child = _avail_level(subtree, topo["cohort_guaranteed"][c_],
                             topo["cohort_borrow_limit"][c_], cu, avail)
        new = torch.where(started[:, None, None], child, subtree - cu)
        avail = torch.where(valid[:, None, None], new, avail)
        started |= valid
    return avail


def avail_plain(topo, usage, cohort_usage):
    """available[Q,F,R] (reference: resource_node.go:89-104)."""
    parent = _chain_avail(topo, cohort_usage, topo["cq_chain"])
    with_cohort = _avail_level(topo["nominal"], topo["guaranteed"],
                               topo["borrow_limit"], usage, parent)
    has_cohort = (topo["cq_cohort"] >= 0)[:, None, None]
    return torch.where(has_cohort, with_cohort, topo["nominal"] - usage)


def avail(topo, usage, cohort_usage):
    if _is_cpu(usage):
        return avail_plain(topo, usage, cohort_usage)
    Q, F, R = usage.shape
    out = torch.empty_like(usage)
    _launch("avail", [
        _ptr(topo["cq_cohort"], torch.int32, "cq_cohort"),
        _ptr(topo["cq_chain"], torch.int32, "cq_chain"),
        _ptr(topo["nominal"], torch.int64, "nominal"),
        _ptr(topo["guaranteed"], torch.int64, "guaranteed"),
        _ptr(topo["borrow_limit"], torch.int64, "borrow_limit"),
        _ptr(usage, torch.int64, "usage"),
        _ptr(topo["cohort_subtree"], torch.int64, "cohort_subtree"),
        _ptr(topo["cohort_guaranteed"], torch.int64, "cohort_guaranteed"),
        _ptr(topo["cohort_borrow_limit"], torch.int64, "cohort_borrow_limit"),
        _ptr(cohort_usage, torch.int64, "cohort_usage"),
        _ptr(out, torch.int64, "out"),
    ], [Q, F * R, topo["cq_chain"].shape[1]], usage.device)
    avail.launches += 1
    return out


# ---------------------------------------------------------------------------
# phase_a: flavor assignment for every head
# ---------------------------------------------------------------------------
#
# Replaces kueue_tpu/solver/kernel.py:128 _choose_flavors_one_podset and
# :221 _phase_a. Bound on the H100: latency — a head is a chain of
# podsets, each a reduction over the flavors per resource for the best
# rank and the first fitting flavor at the chosen rank; the bytes (the
# head's rows and its CQ's [F,R] rows) are small. Design (csrc/phase_a.cu):
# one warp per workload, one lane per flavor (strided for F > 32). One
# __reduce_min_sync on the key rank * 2^fb + f gives the best rank and
# the lowest fitting index at it (jnp.argmax on bool picks the first); a
# CQ that prefers no borrowing takes a second over the non-borrowing
# candidates, and a third only when that rank is the target and differs
# from the best. The register form (`phase_a_plan`: F <= 32, R <= 16,
# P <= 32; R padded to a power of two) loads the head's and its CQ's rows
# once and keeps the assignment in registers across podsets; the general
# form (any F, R, P) reads the rows each podset and accumulates the
# assignment in place, the chosen flavors in the warp's shared slice.

PHASE_A_REGISTER_RS = (1, 2, 4, 8, 16)


@functools.lru_cache(maxsize=64)
def phase_a_plan(F: int, R: int, P: int) -> dict:
    """phase_a's form for F flavors, R resources and P podsets (as
    csrc/phase_a.cu pa_register_r picks it): "register" with R padded to
    register_r, or "general" (register_r 0)."""
    rt = next((r for r in PHASE_A_REGISTER_RS if R <= r), 0) \
        if F <= 32 and P <= 32 else 0
    return {"form": "register" if rt else "general", "register_r": rt}


def phase_a_plain(topo, avail_q, usage, requests, podset_active, wl_cq,
                  eligible, solvable, num_podsets: int, start_rank=None):
    """Returns (fit[W], borrows[W], chosen[W,NP,R] int32,
    chosen_borrow[W,NP,R], asg_usage[W,F,R])."""
    W, P, R = requests.shape
    F = eligible.shape[2]
    dev = requests.device
    q = wl_cq.long()
    group_id = topo["group_id"][q]            # [W,R]
    flavor_group = topo["flavor_group"][q]    # [W,F]
    flavor_rank = topo["flavor_rank"][q]      # [W,F]
    nominal = topo["nominal"][q]              # [W,F,R]
    offered = topo["offered"][q]
    avail_w = avail_q[q]
    usage_w = usage[q]
    prefer_no_borrow = topo["prefer_no_borrow"][q]
    f_idx = torch.arange(F, device=dev)
    asg_usage = torch.zeros((W, F, R), dtype=torch.int64, device=dev)
    ok_all = torch.ones(W, dtype=torch.bool, device=dev)
    chosen_all, borrow_all = [], []
    for p in range(num_podsets):
        req_p = requests[:, p, :]
        has_req = req_p > 0
        relevant = (group_id[:, None, :] == flavor_group[:, :, None]) & \
            (flavor_group[:, :, None] >= 0) & has_req[:, None, :]
        val = req_p[:, None, :] + asg_usage
        fits_r = offered & (val <= avail_w)
        borrow_r = (usage_w + val) > nominal
        fit_f = (~relevant | fits_r).all(dim=2) & relevant.any(dim=2) & \
            eligible[:, p, :]
        borrow_f = (relevant & borrow_r).any(dim=2)
        rank_fit = torch.where(fit_f, flavor_rank, INF_RANK)
        rank_fit_nb = torch.where(fit_f & ~borrow_f, flavor_rank, INF_RANK)
        same_group = (flavor_group[:, :, None] == group_id[:, None, :]) & \
            (group_id[:, None, :] >= 0)
        if start_rank is not None:
            same_group &= flavor_rank[:, :, None] >= start_rank[:, p, None, :]
        best = torch.where(same_group, rank_fit[:, :, None], INF_RANK).amin(1)
        best_nb = torch.where(same_group, rank_fit_nb[:, :, None],
                              INF_RANK).amin(1)
        use_nb = prefer_no_borrow[:, None] & (best_nb < INF_RANK)
        target = torch.where(use_nb, best_nb, best)            # [W,R]
        cand = same_group & (flavor_rank[:, :, None] == target[:, None, :]) \
            & fit_f[:, :, None]
        first = torch.where(cand, f_idx[None, :, None], F).amin(1)
        chosen_p = torch.where((target < INF_RANK) & has_req, first,
                               -1).to(torch.int32)             # [W,R]
        ok_p = (~has_req | (chosen_p >= 0)).all(dim=1)
        borrow_p = torch.gather(borrow_f, 1, chosen_p.long().clamp_min(0)) & \
            (chosen_p >= 0)
        additions = torch.where(
            f_idx[None, :, None] == chosen_p.long()[:, None, :],
            req_p[:, None, :], 0)                              # [W,F,R]
        active = podset_active[:, p]
        chosen_all.append(torch.where(active[:, None], chosen_p, -1))
        ok_all &= torch.where(active, ok_p, True)
        borrow_all.append(borrow_p & active[:, None])
        asg_usage += torch.where(active[:, None, None], additions, 0)
    chosen = torch.stack(chosen_all, dim=1)
    chosen_borrow = torch.stack(borrow_all, dim=1)
    borrows = chosen_borrow.flatten(1).any(dim=1)
    fit = ok_all & solvable & podset_active.any(dim=1)
    return fit, borrows, chosen, chosen_borrow, asg_usage


def phase_a(topo, avail_q, usage, requests, podset_active, wl_cq, eligible,
            solvable, num_podsets: int, start_rank=None):
    if _is_cpu(requests):
        return phase_a_plain(topo, avail_q, usage, requests, podset_active,
                             wl_cq, eligible, solvable, num_podsets,
                             start_rank)
    W, P, R = requests.shape
    F = eligible.shape[2]
    if not 0 < num_podsets <= P:
        raise ValueError(f"num_podsets {num_podsets} outside 1..{P}")
    dev = requests.device
    fit = torch.empty(W, dtype=torch.bool, device=dev)
    borrows = torch.empty(W, dtype=torch.bool, device=dev)
    chosen = torch.empty((W, num_podsets, R), dtype=torch.int32, device=dev)
    chosen_borrow = torch.empty((W, num_podsets, R), dtype=torch.bool,
                                device=dev)
    asg_usage = torch.empty((W, F, R), dtype=torch.int64, device=dev)
    sr_ptr = 0 if start_rank is None else \
        _ptr(start_rank, torch.int32, "start_rank")
    _launch("phase_a", [
        _ptr(topo["group_id"], torch.int32, "group_id"),
        _ptr(topo["flavor_group"], torch.int32, "flavor_group"),
        _ptr(topo["flavor_rank"], torch.int32, "flavor_rank"),
        _ptr(topo["nominal"], torch.int64, "nominal"),
        _ptr(topo["offered"], torch.bool, "offered"),
        _ptr(topo["prefer_no_borrow"], torch.bool, "prefer_no_borrow"),
        _ptr(avail_q, torch.int64, "avail"),
        _ptr(usage, torch.int64, "usage"),
        _ptr(requests, torch.int64, "requests"),
        _ptr(podset_active, torch.bool, "podset_active"),
        _ptr(wl_cq, torch.int32, "wl_cq"),
        _ptr(eligible, torch.bool, "eligible"),
        _ptr(solvable, torch.bool, "solvable"),
        sr_ptr,
        _ptr(fit, torch.bool, "fit"),
        _ptr(borrows, torch.bool, "borrows"),
        _ptr(chosen, torch.int32, "chosen"),
        _ptr(chosen_borrow, torch.bool, "chosen_borrow"),
        _ptr(asg_usage, torch.int64, "asg_usage"),
    ], [W, P, num_podsets, F, R], dev)
    phase_a.launches += 1
    phase_a.last_plan = phase_a_plan(F, R, P)
    return fit, borrows, chosen, chosen_borrow, asg_usage


phase_a.last_plan = None  # the last launch's phase_a_plan


def phase_a_tick(device, iters: int = 4096) -> float:
    """Clock cycles of one dependent __reduce_min_sync (csrc/phase_a.cu
    phase_a_tick_kernel), the least of three runs."""
    best = None
    for _ in range(3):
        out = torch.zeros(2, dtype=torch.int64, device=device)
        _launch("phase_a", [out.data_ptr()], [iters], device,
                symbol="phase_a_tick_launch")
        cycles = out[0].item() / iters
        best = cycles if best is None else min(best, cycles)
    return best


# ---------------------------------------------------------------------------
# drf_share: the fair-sharing sort key
# ---------------------------------------------------------------------------
#
# Replaces kueue_tpu/solver/kernel.py:197 _drf_share. The dominant
# resource share of each head against the pre-cycle usage (the resident
# usage after the delta prologue): the largest borrowing x 1000 // the
# root cohort's lendable over resources, then x 1000 // the CQ's fair
# weight; -1 where the root lends nothing, NO_LIMIT for weight 0, and 0
# for a head that borrows nothing or whose CQ has no cohort. Both
# divisions floor (JAX's //), which differs from C's truncation for the
# negative drs. Bound on the H100: latency — the bytes (the heads' [F,R]
# assignment rows and their CQs' nominal/offered/usage rows) take under
# a microsecond; a head's chain is three dependent global round trips
# (its CQ; the CQ's rows and cq_root, the chain table of topo_to_device;
# the root's lendable row), a few shuffles and two divisions. Design
# (csrc/drf_share.cu): a group of G lanes a head (`drf_share_plan`: the
# fewest lanes that load the row in one chunk), lane i taking elements
# i, i+m, ... of the row (m = R * (G // R), so its resource is fixed),
# every load of a chunk issued before any arithmetic, a shuffle tree over
# the lanes of each resource; past 32 resources a lane owns resources i,
# i+32, ...
# The divisions go through double precision below 2^53 (corrected by a
# multiply-back) and through the int64 division above, exact for every
# int64.

def drf_share_plain(topo, usage, asg_usage, wl_cq):
    """share[W] int64."""
    q = wl_cq.long()
    remaining = (topo["nominal"] - usage)[q]                  # [W,F,R]
    b = torch.where(topo["offered"][q], asg_usage - remaining, 0)
    borrowing = b.clamp_min(0).sum(dim=1)                     # [W,R]
    has_borrow = (borrowing > 0).any(dim=1)
    cohort = topo["cq_cohort"][q].long()
    root = topo["cohort_root"][cohort.clamp_min(0)].long()
    lendable = topo["cohort_lendable"][root]                  # [W,R]
    ratio = torch.where(lendable > 0,
                        torch.div(borrowing * 1000, lendable.clamp_min(1),
                                  rounding_mode="floor"), -1)
    drs = ratio.amax(dim=1)
    weight = topo["fair_weight"][q]
    dws = torch.where(weight > 0,
                      torch.div(drs * 1000, weight.clamp_min(1),
                                rounding_mode="floor"), NO_LIMIT)
    return torch.where(has_borrow & (cohort >= 0), dws, 0)


DRF_CHUNK = 4  # passes a lane loads at once (csrc/drf_share.cu KQ_DRF_CHUNK)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def drf_share_plan(F: int, R: int) -> dict:
    """drf_share's launch: G lanes a head, 32 // G heads a warp, and the
    form: "lanes" (R <= G: a lane's resource fixed, m = R * (G // R)
    elements a pass) or "wide" (R > 32: a lane owns resources i, i + 32,
    ...). G is the least power of two that holds a resource a lane and
    lets every lane load its share of the F*R row in one chunk of
    DRF_CHUNK passes, at most 32: more heads a warp where that costs no
    second chunk of loads."""
    G = min(32, max(_pow2_at_least(R),
                    _pow2_at_least(-(-F * R // DRF_CHUNK))))
    if R > G:
        return {"lanes_per_head": G, "heads_per_warp": 1, "form": "wide",
                "passes": F, "shuffles": 6}
    per = G // R
    # the chain's shuffle steps: the tree over a resource's lanes, the
    # ballot, the max over the resources
    return {"lanes_per_head": G, "heads_per_warp": 32 // G, "form": "lanes",
            "passes": -(-(F * R) // (R * per)),
            "shuffles": (per - 1).bit_length() + 1 + (R - 1).bit_length()}


def drf_share(topo, usage, asg_usage, wl_cq):
    if _is_cpu(asg_usage):
        return drf_share_plain(topo, usage, asg_usage, wl_cq)
    if "cq_root" not in topo:
        raise KeyError("drf_share: the topology dict lacks the chain table "
                       "cq_root (build it with topo_to_device)")
    W, F, R = asg_usage.shape
    plan = drf_share_plan(F, R)
    share = torch.empty(W, dtype=torch.int64, device=asg_usage.device)
    _launch("drf_share", [
        _ptr(topo["nominal"], torch.int64, "nominal"),
        _ptr(topo["offered"], torch.bool, "offered"),
        _ptr(topo["cq_root"], torch.int32, "cq_root"),
        _ptr(topo["cohort_lendable"], torch.int64, "cohort_lendable"),
        _ptr(topo["fair_weight"], torch.int64, "fair_weight"),
        _ptr(usage, torch.int64, "usage"),
        _ptr(asg_usage, torch.int64, "asg_usage"),
        _ptr(wl_cq, torch.int32, "wl_cq"),
        _ptr(share, torch.int64, "share"),
    ], [W, F, R, plan["lanes_per_head"], plan["passes"]], asg_usage.device)
    drf_share.launches += 1
    drf_share.last_plan = plan
    return share


drf_share.last_plan = None  # the last launch's drf_share_plan


def drf_share_tick(device, iters: int = 4096) -> dict:
    """drf_share's least steps in clock cycles (csrc/drf_share.cu
    drf_share_tick_kernel, one warp): a floor division on the
    double-precision path ("div_cycles") and a shuffle-add
    ("shuffle_cycles"), each the least of three runs."""
    div, shfl = [], []
    for _ in range(3):
        out = torch.zeros(3, dtype=torch.int64, device=device)
        _launch("drf_share", [out.data_ptr()], [iters, 1001], device,
                symbol="drf_share_tick_launch")
        o = out.tolist()
        div.append(o[0] / iters)
        shfl.append(o[1] / iters)
    return {"div_cycles": min(div), "shuffle_cycles": min(shfl)}


# ---------------------------------------------------------------------------
# order_csr: the admit order and the conflict-domain CSR
# ---------------------------------------------------------------------------
#
# Replaces kueue_tpu/solver/kernel.py:498-525, the lexsort of the admit
# order and the [L,D] order grid of solve_cycle_fused_impl. Output: a CSR
# offsets[D+1] / members[W] of each conflict domain's workloads in admit
# order, which phase_b walks: one stable sort on the composite key
# (domain, ~fit, borrows, share, -priority, timestamp, index); with
# with_order (cluster columns on, the oracles) also the global admit order
# (the lexsort itself), which score_cluster_columns scans. Bound on the
# H100: latency and the launch, ~70 KB in and out. Design (csrc/order.cu):
# each key packed into four 64-bit words whose unsigned order is the key's
# order, so a compare is one 256-bit subtraction. The staged form
# (`order_plan`: W <= ORDER_THREADS * ORDER_ILP, and the keys, the
# workloads, a histogram of the domains, the topology's cq_cohort and
# cohort_root and the block's workloads within ORDER_SMEM) is one launch:
# every block finds every workload's domain (the tables looked up in
# shared memory), scans the histogram into the offsets, lists the
# workloads in domain order and ranks its own slice against its domain's
# keys, loaded from global memory while its domains are small (the north
# star's ~8), else staged in shared memory (one big domain, or the global
# order, which counts against all keys). Above that, the global form packs
# the keys into a global scratch once and launches a counting rank over
# tiles of them and the offsets' lower bounds (three launches).

ORDER_THREADS = 512          # the staged form's block (csrc/order.cu)
ORDER_ILP = 8                # workloads a thread stages
ORDER_SMEM = 200 * 1024      # shared memory the staged form may take
ORDER_BLOCK_MINES = 16       # a staged block's workloads (more at ORDER_SMS)
ORDER_SMS = 132              # the H100's SMs: order_plan's default
ORDER_RANK_THREADS = 256     # the global form's rank block
ORDER_RANK_MINES = 32        # workloads a rank block ranks
# The staged form's chain (the latency bound's count), small domains: two
# dependent global round trips (the CQs with the topology's tables; the
# domain's keys) and its dependent block steps: the tables staged, the
# histogram, the scan's three barriers, the list in domain order, the
# rank's reduction.
ORDER_ROUND_TRIPS = 2
ORDER_STEPS = 7


def order_plan(W: int, D: int, with_order: bool = False,
               sms: int = None) -> dict:
    """order_csr's launch on W workloads over D domains (csrc/order.cu):
    the form ("staged" or "global"), its launches, blocks, threads,
    dynamic shared memory, workloads a block ranks and scratch bytes.
    Read at every call, so a test can shrink ORDER_SMEM to force the
    global form."""
    sms = ORDER_SMS if sms is None else sms
    blocks = max(1, min(sms, -(-W // ORDER_BLOCK_MINES)))
    mines = -(-W // blocks)
    smem = 36 * W + 4 * (D + 1) + 4 * D + 12 * mines
    if W <= ORDER_THREADS * ORDER_ILP and smem <= ORDER_SMEM:
        return {"form": "staged", "launches": 1, "blocks": blocks,
                "threads": ORDER_THREADS, "smem_bytes": smem,
                "mines_per_block": mines, "scratch_bytes": 0,
                "with_order": bool(with_order)}
    return {"form": "global", "launches": 3 if W else 1,
            "blocks": -(-W // ORDER_RANK_MINES),
            "threads": ORDER_RANK_THREADS,
            "smem_bytes": ORDER_RANK_THREADS * 36,
            "mines_per_block": ORDER_RANK_MINES, "scratch_bytes": 40 * W,
            "with_order": bool(with_order)}


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the smallest normal double: a timestamp of smaller magnitude (a
# subnormal, or -0.0) orders as 0.0
MIN_NORMAL_F64 = 2.2250738585072014e-308


def admit_order(fit, borrows, priority, timestamp, share=None):
    """Stable lexsort on (timestamp, -priority, share, borrows, ~fit), the
    last key most significant (kueue_tpu/solver/kernel.py:498-501;
    reference: entryOrdering.Less, scheduler.go:643-672): one stable
    sort per key, least significant first. share is zero with fair
    sharing off. Subnormal timestamps compare as 0.0, as in the JAX
    package, whose CPU backend flushes subnormal doubles to zero."""
    if share is None:
        share = torch.zeros_like(priority)
    timestamp = torch.where(timestamp.abs() < MIN_NORMAL_F64,
                            torch.zeros_like(timestamp), timestamp)
    order = torch.sort(timestamp, stable=True).indices
    for key in (-priority, share, borrows.to(torch.int32),
                (~fit).to(torch.int32)):
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def _domains(topo, wl_cq):
    """Conflict domain of each workload: its root cohort, or C + q for a
    CQ with no cohort (kueue_tpu/solver/kernel.py:503-508)."""
    C = topo["cohort_subtree"].shape[0]
    q = wl_cq.long()
    cohort_of = topo["cq_cohort"][q].long()
    root_of = topo["cohort_root"][cohort_of.clamp_min(0)].long()
    return torch.where(cohort_of >= 0, root_of, C + q)


def domain_csr(topo, wl_cq, order):
    """The admit order as a CSR over conflict domains: offsets[D+1] and
    members[W], each domain's members in admit order."""
    D = topo["cohort_subtree"].shape[0] + topo["cq_cohort"].shape[0]
    domain = _domains(topo, wl_cq)
    perm = torch.sort(domain[order], stable=True).indices
    members = order[perm].to(torch.int32)
    counts = torch.bincount(domain, minlength=D)
    offsets = torch.zeros(D + 1, dtype=torch.int32, device=wl_cq.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets, members


def order_csr_plain(topo, fit, borrows, priority, timestamp, wl_cq,
                    share=None, with_order: bool = False):
    """The torch chain: five stable sorts, a stable sort by domain, a
    histogram and a scan. Returns (offsets[D+1] int32, members[W] int32,
    order[W] int32): order is the global admit order with with_order,
    else None."""
    order = admit_order(fit, borrows, priority, timestamp, share)
    offsets, members = domain_csr(topo, wl_cq, order)
    return offsets, members, order.to(torch.int32) if with_order else None


def order_csr(topo, fit, borrows, priority, timestamp, wl_cq, share=None,
              with_order: bool = False):
    if _is_cpu(fit):
        return order_csr_plain(topo, fit, borrows, priority, timestamp,
                               wl_cq, share, with_order)
    W = fit.shape[0]
    C = topo["cohort_subtree"].shape[0]
    D = C + topo["cq_cohort"].shape[0]
    dev = fit.device
    plan = order_plan(W, D, with_order, _sm_count(dev.index))
    offsets = torch.empty(D + 1, dtype=torch.int32, device=dev)
    members = torch.empty(W, dtype=torch.int32, device=dev)
    order = torch.empty(W, dtype=torch.int32, device=dev) if with_order \
        else None
    scratch = torch.empty(plan["scratch_bytes"], dtype=torch.uint8,
                          device=dev) if plan["scratch_bytes"] else None
    _launch("order", [
        _ptr(topo["cq_cohort"], torch.int32, "cq_cohort"),
        _ptr(topo["cohort_root"], torch.int32, "cohort_root"),
        _ptr(fit, torch.bool, "fit"),
        _ptr(borrows, torch.bool, "borrows"),
        0 if share is None else _ptr(share, torch.int64, "share"),
        _ptr(priority, torch.int64, "priority"),
        _ptr(timestamp, torch.float64, "timestamp"),
        _ptr(wl_cq, torch.int32, "wl_cq"),
        _ptr(offsets, torch.int32, "offsets"),
        _ptr(members, torch.int32, "members"),
        0 if order is None else _ptr(order, torch.int32, "order"),
        0 if scratch is None else scratch.data_ptr(),
    ], [W, C, D, 0 if plan["form"] == "staged" else 1, plan["blocks"],
        plan["mines_per_block"], plan["smem_bytes"]], dev)
    order_csr.launches += 1
    order_csr.last_plan = plan
    return offsets, members, order


order_csr.last_plan = None  # the last launch's order_plan


def order_tick(device, iters: int = 4096) -> float:
    """Clock cycles of one of the staged form's dependent block steps (a
    shared load and a __syncthreads at ORDER_THREADS threads; csrc/order.cu
    kq_step_kernel), the least of three runs."""
    best = None
    for _ in range(3):
        out = torch.zeros(2, dtype=torch.int64, device=device)
        _launch("order", [out.data_ptr(), 0], [2, iters], device,
                symbol="order_tick_launch")
        cycles = out[0].item() / iters
        best = cycles if best is None else min(best, cycles)
    return best


def launch_floor_fns(device) -> dict:
    """The card's launch floor, as two launchers to time: "empty" (a kernel
    with an empty body, kq_empty_kernel) and "load_store" (one load and one
    store, kq_load_store_kernel), both in csrc/order.cu."""
    src = torch.ones(1, dtype=torch.int32, device=device)
    out = torch.zeros(1, dtype=torch.int32, device=device)
    return {"empty": lambda: _launch("order", [0, 0], [0, 0], device,
                                     symbol="order_tick_launch"),
            "load_store": lambda: _launch(
                "order", [out.data_ptr(), src.data_ptr()], [1, 0], device,
                symbol="order_tick_launch")}


# ---------------------------------------------------------------------------
# phase_b: the cohort-parallel admit
# ---------------------------------------------------------------------------
#
# Replaces kueue_tpu/solver/kernel.py:420 solve_phase_b_domains_impl with
# :82 _chain_avail and :106 _chain_add_usage. Bound on the H100:
# latency — each domain is a chain of dependent steps (one per member
# workload: availability walk, still-fits vote, usage update up the
# cohort chain); the bytes are small. Design (csrc/phase_b.cu): one block
# per conflict domain. Domains touch disjoint usage state
# (kueue_tpu/solver/kernel.py:396-403), so blocks never wait on each
# other. A block stages its domain's rows (the CQs and cohorts of the
# topology's domain tables: usage and the folded quota constants) and its
# members' entries and assignment rows in shared memory, so no global
# load sits on the chain of steps; one warp walks the members where
# FR <= PHASE_B_WARP_FR, a step's nonzero columns one a lane and a warp
# vote (the other warps stage the next chunk of members), the whole
# block with __syncthreads_and above it. A domain whose rows exceed the
# launch's shared state keeps its CQs' constants in the topology (the
# hybrid form) or every row in a global scratch (`phase_b_plan`). The
# TPU's dense [L,D] grid is not built: the kernel reads the CSR from
# order_csr. usage/cohort_usage are written back, once, into copies of
# the inputs. Without `cols` the launch has one block per root cohort and
# per CQ with no cohort (the domains that can hold members), and over a
# CSR of every workload (order_csr's, not the grid's of fitting heads)
# the kernel writes every admitted bit; with `cols` (the sharded cycle's
# planner columns, kueue_tpu/parallel/mesh.py:314-318) one block per
# column, and a padding column (D or -1) or a cohort below a root is a
# no-op.

PHASE_B_THREADS = 256
PHASE_B_WARP_FR = 256            # one warp walks up to this FR
PHASE_B_SMEM = 200 * 1024        # shared memory a block may take
PHASE_B_ASG_BYTES = 32 * 1024    # the two chunk buffers of members
PHASE_B_CHUNK = 32               # members staged a chunk


def phase_b_plan(FR: int, DC: int, SQ: int, SC: int) -> dict:
    """The launch's shared-memory plan for FR columns, chains of DC
    cohorts and domains of at most SQ CQs and SC cohorts
    (csrc/phase_b.cu): the vote ("warp" up to PHASE_B_WARP_FR, else
    "block"); the members a chunk, whose two buffers (entries with the
    walked members, and the members' nonzero columns compacted, or in the
    block form their rows whole, when staged) take about
    PHASE_B_ASG_BYTES; the shared bytes of rows a block holds (state_cap:
    24·FR bytes a row in the shared form, 8·FR a CQ row and 24·FR a
    cohort row in the hybrid one, after the warp form's header of a bit
    an element and an id a row); the block's shared bytes; and whether
    the global scratch (Q·FR + 3·C·FR int64) may be needed.
    `phase_b_forms` says which form each domain takes."""
    return _phase_b_plan(FR, DC, SQ, SC, PHASE_B_SMEM, PHASE_B_ASG_BYTES)


@functools.lru_cache(maxsize=64)
def _phase_b_plan(FR: int, DC: int, SQ: int, SC: int, smem_cap: int,
                  asg_bytes: int) -> dict:
    warp = FR <= PHASE_B_WARP_FR
    FRp = 32 * -(-FR // 32)
    if warp:
        chunk = max(1, min(PHASE_B_CHUNK, asg_bytes // (24 * FRp)))
        stage_asg = True
    else:
        chunk = min(PHASE_B_CHUNK, asg_bytes // (16 * FR))
        stage_asg = chunk >= 1
        if not stage_asg:
            chunk = PHASE_B_CHUNK
    # the entries, with the walked members
    entries = -(-chunk * (6 + DC) * 4 // 16) * 16
    chunk_bytes = entries + (chunk * FRp * 12 if warp
                             else chunk * FR * 8 if stage_asg else 0)
    unit = 8 * FR
    rows = SQ + SC
    head = _lazy_head(rows, FR) if warp else 0
    room = max(0, smem_cap - 2 * chunk_bytes) // 16 * 16
    state_cap = min(head + 3 * rows * unit, room)
    return {"vote": "warp" if warp else "block", "chunk": chunk,
            "stage_asg": stage_asg, "state_cap": state_cap,
            "smem": state_cap + 2 * chunk_bytes,
            "scratch": head + (SQ + 3 * SC) * unit > state_cap,
            "threads": PHASE_B_THREADS}


def _lazy_head(rows, FR):
    """Bytes of the warp form's header (csrc/phase_b.cu pb_lazy_bytes): a
    bit an element of `rows` rows of FR columns and an id a row, 16-aligned
    (numpy arrays or ints)."""
    return -(-(-(-rows * FR // 32) * 4 + rows * 4) // 16) * 16


def phase_b_forms(topo, plan: dict, FR: int) -> dict:
    """{form: domains} of a launch of `plan` over the topology's domains
    (the roots, and the CQs with no cohort), as csrc/phase_b.cu picks:
    "shared" where the rows with the CQs' constants fit state_cap (after
    the warp form's header), else "lazy" (the warp form) or "hybrid" (the
    block form) where the rows without them do, else "global"."""
    def host(t):
        return (t.cpu().numpy() if isinstance(t, torch.Tensor)
                else np.asarray(t)).astype(np.int64)
    nq, nc = host(topo["dom_nq"]), host(topo["dom_nc"])
    n_solo = int(topo["dom_solo"].shape[0])
    nq = np.concatenate([nq, np.ones(n_solo, np.int64)])
    nc = np.concatenate([nc, np.zeros(n_solo, np.int64)])
    head = _lazy_head(nq + nc, FR) if plan["vote"] == "warp" else 0
    cap = plan["state_cap"]
    form = np.where(head + 3 * (nq + nc) * 8 * FR <= cap, "shared",
                    np.where(head + (nq + 3 * nc) * 8 * FR <= cap,
                             "lazy" if plan["vote"] == "warp" else "hybrid",
                             "global"))
    names, counts = np.unique(form, return_counts=True)
    return {str(n): int(c) for n, c in zip(names, counts)}


def _selected(counts, cols):
    """counts[D] with the domains outside cols (int [d_cols]; entries
    outside [0, D) are padding) set to 0."""
    D = counts.shape[0]
    c = cols.long()
    keep = torch.zeros(D, dtype=torch.bool, device=counts.device)
    keep[c[(c >= 0) & (c < D)]] = True
    return torch.where(keep, counts, 0)


def phase_b_plain(topo, usage, cohort_usage, asg_usage, fit, wl_cq,
                  offsets, members, cols=None):
    """Returns (admitted[W], usage', cohort_usage'). Steps the l-th member
    of every domain at once, l = 0, 1, ... (the JAX package's grid rows);
    with cols, of the listed domains only."""
    W = fit.shape[0]
    usage = usage.clone()
    cohort = cohort_usage.clone()
    admitted = torch.zeros(W, dtype=torch.bool, device=fit.device)
    counts = (offsets[1:] - offsets[:-1]).long()
    if cols is not None:
        counts = _selected(counts, cols)
    L = int(counts.max()) if counts.numel() else 0
    chain_all = topo["cq_chain"]
    for lvl in range(L):
        dom = torch.nonzero(counts > lvl).flatten()
        w = members[offsets[dom].long() + lvl].long()
        q = wl_cq[w].long()
        chain = chain_all[q]
        has_cohort = topo["cq_cohort"][q] >= 0
        au = asg_usage[w]
        nominal_q = topo["nominal"][q]
        guar_q = topo["guaranteed"][q]
        usage_q = usage[q]
        parent = _chain_avail(topo, cohort, chain)
        avail_q = torch.where(
            has_cohort[:, None, None],
            _avail_level(nominal_q, guar_q, topo["borrow_limit"][q], usage_q,
                         parent),
            nominal_q - usage_q)
        still_fits = ((au == 0) | (au <= avail_q)).flatten(1).all(dim=1)
        admit = fit[w] & still_fits
        add = torch.where(admit[:, None, None], au, 0)
        new_usage_q = usage_q + add
        usage.index_add_(0, q, add)  # one lane per domain: distinct CQs
        delta = torch.where((has_cohort & admit)[:, None, None],
                            (new_usage_q - guar_q).clamp_min(0)
                            - (usage_q - guar_q).clamp_min(0), 0)
        for d in range(chain.shape[1]):
            c = chain[:, d].long()
            valid = c >= 0
            c_ = c.clamp_min(0)
            add_c = torch.where(valid[:, None, None], delta, 0)
            old = cohort[c_]
            new = old + add_c
            cohort.index_add_(0, c_, add_c)
            g = topo["cohort_guaranteed"][c_]
            delta = torch.where(valid[:, None, None],
                                (new - g).clamp_min(0) - (old - g).clamp_min(0),
                                0)
        admitted[w] = admit
    return admitted, usage, cohort


def phase_b(topo, usage, cohort_usage, asg_usage, fit, wl_cq, offsets,
            members, cols=None):
    if _is_cpu(fit):
        return phase_b_plain(topo, usage, cohort_usage, asg_usage, fit,
                             wl_cq, offsets, members, cols)
    missing = [n for n in DOMAIN_FIELDS if n not in topo]
    if missing:
        raise KeyError(f"phase_b: the topology lacks the domain tables "
                       f"{missing} (build it with topo_to_device)")
    W = fit.shape[0]
    Q, F, R = usage.shape
    C = cohort_usage.shape[0]
    FR, DC = F * R, topo["cq_chain"].shape[1]
    D = offsets.shape[0] - 1
    NR = topo["dom_roots"].shape[0]
    SQ, SC = topo["dom_cqs"].shape[1], topo["dom_cohorts"].shape[1]
    plan = phase_b_plan(FR, DC, SQ, SC)
    dev = fit.device
    usage_out = usage.clone()
    cohort_out = cohort_usage.clone()
    # the kernel writes every member's bit: without cols, over a CSR of
    # every workload (order_csr's), no bit is left unwritten
    admitted = (torch.empty if cols is None and members.shape[0] == W
                else torch.zeros)(W, dtype=torch.bool, device=dev)
    scratch = torch.empty(((Q + 3 * C) * FR if plan["scratch"] else 0,),
                          dtype=torch.int64, device=dev)
    n_blocks = NR + topo["dom_solo"].shape[0] if cols is None \
        else cols.shape[0]
    _launch("phase_b", [
        _ptr(topo["nominal"], torch.int64, "nominal"),
        _ptr(topo["guaranteed"], torch.int64, "guaranteed"),
        _ptr(topo["borrow_limit"], torch.int64, "borrow_limit"),
        _ptr(topo["cohort_subtree"], torch.int64, "cohort_subtree"),
        _ptr(topo["cohort_guaranteed"], torch.int64, "cohort_guaranteed"),
        _ptr(topo["cohort_borrow_limit"], torch.int64, "cohort_borrow_limit"),
        _ptr(topo["cq_chain"], torch.int32, "cq_chain"),
        *(_ptr(topo[n], torch.int32, n) for n in DOMAIN_FIELDS),
        _ptr(usage_out, torch.int64, "usage"),
        _ptr(cohort_out, torch.int64, "cohort_usage"),
        scratch.data_ptr() if plan["scratch"] else 0,
        _ptr(asg_usage, torch.int64, "asg_usage"),
        _ptr(fit, torch.bool, "fit"),
        _ptr(wl_cq, torch.int32, "wl_cq"),
        _ptr(offsets, torch.int32, "offsets"),
        _ptr(members, torch.int32, "members"),
        0 if cols is None else _ptr(cols, torch.int32, "cols"),
        _ptr(admitted, torch.bool, "admitted"),
    ], [D, NR, n_blocks, Q, C, FR, DC, SQ, SC, plan["chunk"],
        int(plan["stage_asg"]), plan["state_cap"], plan["smem"],
        int(plan["vote"] == "warp")], dev)
    phase_b.launches += 1
    phase_b.last_plan = plan
    return admitted, usage_out, cohort_out


phase_b.last_plan = None  # the last launch's phase_b_plan


def phase_b_tick(device, depth: int, iters: int = 4096) -> dict:
    """phase_b's least step in clock cycles (csrc/phase_b.cu
    phase_b_tick_kernel: a member `depth` cohorts deep, 0 to 4, over rows
    in shared memory: the fetch, the walk, the warp vote, the bubble-up),
    one dependent global load read past L1 in cycles, each the least of
    three runs, and the SM clock in kHz."""
    steps, loads = [], []
    for _ in range(3):
        out = torch.zeros(5, dtype=torch.int64, device=device)
        chase = torch.empty(1 << 16, dtype=torch.int32, device=device)
        _launch("phase_b", [out.data_ptr(), chase.data_ptr()],
                [chase.numel(), iters, depth], device,
                symbol="phase_b_tick_launch")
        o = out.tolist()
        steps.append(o[0] / iters)
        loads.append(o[2] / iters)
    return {"step_cycles": min(steps), "load_cycles": min(loads),
            "clock_khz": o[4]}


# ---------------------------------------------------------------------------
# global_scan: the global W-step admit scan (the cycle's test oracle)
# ---------------------------------------------------------------------------
#
# Replaces the lax.scan of kueue_tpu/solver/kernel.py:250
# solve_cycle_impl: admit_step (:279-303) with :82 _chain_avail and :106
# _chain_add_usage, one step per workload of the global admit order. It
# is the semantic oracle the cohort-parallel cycle (phase_b over the
# conflict-domain CSR) is held to, so it shares no code with phase_b.cu:
# the step follows admit_step, one head at a time across every domain.
# Bound on the H100: latency — a dependent step a fit workload; the bytes
# are small. Only usage and cohort_usage depend on earlier steps, so the
# design (csrc/global_scan.cu) takes everything else off the chain: one
# thread block, a thread per (f,r) lane (a lane only ever touches its own
# column, so the lanes share nothing but the step's vote); a prologue in
# the same launch compacts the fit steps of the order, with their CQ and
# chain, into a scratch list (`global_scan_steps` is its model);
# cohort_usage in shared memory for the walk where it fits (the "shared"
# form, else "global"); in the register form (F*R <= 256, chains of at
# most 8 levels) a thread a lane walks, holding the next step's constants
# and usage[q] in registers, loaded while the current step runs (the value
# forwarded when the next step's CQ repeats), voting with __all_sync for
# one warp, else a barrier's AND over the walking warps, a step without
# branches so that the next step's loads interleave with its chain; past
# it every thread walks, a column at a time, voting with
# __syncthreads_and.
# usage/cohort_usage are updated on copies of the inputs.

GLOBAL_SCAN_SMEM = 200 * 1024      # shared memory the shared form may take
GLOBAL_SCAN_THREADS = 256          # the register form's block (its prologue)
GLOBAL_SCAN_REGISTER_DC = (1, 2, 4, 8)  # its compiled chain depths
GLOBAL_SCAN_FORMS = ("shared", "global")


def global_scan_plan(W: int, C: int, FR: int, DC: int,
                     form: str = None) -> dict:
    """global_scan's launch for W steps, C cohorts, F*R lanes and chains
    of DC: the form ("shared": cohort_usage's C*FR*8 bytes in shared
    memory, where they fit GLOBAL_SCAN_SMEM; "global"; `form` forces one),
    the register form's compiled chain depth (`register_dc`; 0 for the
    looping form, past F*R = GLOBAL_SCAN_THREADS or 8 levels), the
    threads, the vote (__all_sync for one warp of lanes, else a barrier's
    AND), the dynamic shared memory and the scratch list's ints."""
    state = C * FR * 8
    if form is None:
        form = "shared" if state <= GLOBAL_SCAN_SMEM else "global"
    if form not in GLOBAL_SCAN_FORMS:
        raise ValueError(f"global_scan: unknown form {form!r}")
    if form == "shared" and state > GLOBAL_SCAN_SMEM:
        raise ValueError(f"global_scan: cohort_usage's {state} bytes do not "
                         f"fit the shared form's {GLOBAL_SCAN_SMEM}")
    lanes = min(max(-(-FR // 32) * 32, 32), 1024)
    dct = next((d for d in GLOBAL_SCAN_REGISTER_DC if d >= DC), 0) \
        if FR <= GLOBAL_SCAN_THREADS else 0
    return {"form": form, "register_dc": dct,
            "threads": GLOBAL_SCAN_THREADS if dct else lanes,
            "vote": "warp" if lanes == 32 else "block",
            "smem": state if form == "shared" else 0,
            "scratch_ints": W * (3 + DC)}


def global_scan_steps(fit, wl_cq, order, cq_cohort):
    """The prologue's list (csrc/global_scan.cu kq_scan_prologue) as
    plain tensors: the fit steps of `order` in its order, w and q (int64)
    with has_cohort and repeat (bool); repeat marks a step whose CQ is the
    previous fit step's (the register form forwards its usage)."""
    w = order.long()[fit[order.long()]]
    q = wl_cq.long()[w]
    repeat = torch.zeros_like(q, dtype=torch.bool)
    repeat[1:] = q[1:] == q[:-1]
    return w, q, cq_cohort.long()[q] >= 0, repeat


def global_scan_plain(topo, usage, cohort_usage, asg_usage, fit, wl_cq,
                      order):
    """Returns (admitted[W], usage', cohort_usage'): admit_step over
    `order`, one workload a step, with tensors of one (f,r) row each."""
    W = fit.shape[0]
    usage = usage.clone()
    cohort = cohort_usage.clone()
    admitted = torch.zeros(W, dtype=torch.bool, device=fit.device)
    q_of = wl_cq.tolist()
    has_cohort = (topo["cq_cohort"] >= 0).tolist()
    chains = topo["cq_chain"].tolist()
    subtree, c_guar = topo["cohort_subtree"], topo["cohort_guaranteed"]
    c_limit = topo["cohort_borrow_limit"]
    for w in order.tolist():
        q = q_of[w]
        au = asg_usage[w]                                     # [F,R]
        nominal_q, guar_q = topo["nominal"][q], topo["guaranteed"][q]
        usage_q = usage[q]
        chain = [c for c in chains[q] if c >= 0]
        if has_cohort[q]:
            # _chain_avail: the root first, then each level down
            parent = subtree[chain[-1]] - cohort[chain[-1]]
            for c in reversed(chain[:-1]):
                parent = _avail_level(subtree[c], c_guar[c], c_limit[c],
                                      cohort[c], parent)
            avail_q = _avail_level(nominal_q, guar_q, topo["borrow_limit"][q],
                                   usage_q, parent)
        else:
            avail_q = nominal_q - usage_q
        still_fits = ((au == 0) | (au <= avail_q)).all()
        admit = fit[w] & still_fits
        new_usage_q = usage_q + torch.where(admit, au, 0)
        delta = (new_usage_q - guar_q).clamp_min(0) - \
            (usage_q - guar_q).clamp_min(0)
        usage[q] = new_usage_q
        if has_cohort[q]:
            # _chain_add_usage: each level absorbs up to its guaranteed
            for c in chain:
                old = cohort[c].clone()
                new = old + delta
                cohort[c] = new
                delta = (new - c_guar[c]).clamp_min(0) - \
                    (old - c_guar[c]).clamp_min(0)
        admitted[w] = admit
    return admitted, usage, cohort


def global_scan(topo, usage, cohort_usage, asg_usage, fit, wl_cq, order,
                form: str = None):
    """`form` forces global_scan_plan's form ("shared" or "global")."""
    if _is_cpu(fit):
        return global_scan_plain(topo, usage, cohort_usage, asg_usage, fit,
                                 wl_cq, order)
    W = order.shape[0]
    Q, F, R = usage.shape
    C = cohort_usage.shape[0]
    DC = topo["cq_chain"].shape[1]
    plan = global_scan_plan(W, C, F * R, DC, form)
    usage_out = usage.clone()
    cohort_out = cohort_usage.clone()
    admitted = torch.zeros(fit.shape[0], dtype=torch.bool, device=fit.device)
    steps = torch.empty(plan["scratch_ints"], dtype=torch.int32,
                        device=fit.device)
    _launch("global_scan", [
        _ptr(topo["cq_cohort"], torch.int32, "cq_cohort"),
        _ptr(topo["cq_chain"], torch.int32, "cq_chain"),
        _ptr(topo["nominal"], torch.int64, "nominal"),
        _ptr(topo["guaranteed"], torch.int64, "guaranteed"),
        _ptr(topo["borrow_limit"], torch.int64, "borrow_limit"),
        _ptr(topo["cohort_subtree"], torch.int64, "cohort_subtree"),
        _ptr(topo["cohort_guaranteed"], torch.int64, "cohort_guaranteed"),
        _ptr(topo["cohort_borrow_limit"], torch.int64, "cohort_borrow_limit"),
        _ptr(usage_out, torch.int64, "usage"),
        _ptr(cohort_out, torch.int64, "cohort_usage"),
        _ptr(asg_usage, torch.int64, "asg_usage"),
        _ptr(fit, torch.bool, "fit"),
        _ptr(wl_cq, torch.int32, "wl_cq"),
        _ptr(order, torch.int32, "order"),
        _ptr(admitted, torch.bool, "admitted"),
        steps.data_ptr(),
    ], [W, F * R, DC, C, int(plan["form"] == "shared"), plan["register_dc"],
        plan["threads"], plan["smem"]], fit.device)
    global_scan.launches += 1
    global_scan.last_plan = plan
    return admitted, usage_out, cohort_out


global_scan.last_plan = None  # the last launch's global_scan_plan


# ---------------------------------------------------------------------------
# pack: the compact decision wire format
# ---------------------------------------------------------------------------
#
# Replaces kueue_tpu/solver/kernel.py:359 _pack_bits and :372
# pack_decisions_impl. dec_pr uint8 [W,P*R] = (chosen+1) |
# (chosen_borrow << 7); dec_bits uint8 [3, ceil(W/8)], little-endian
# bit planes of fit/admitted/borrows. Bound on the H100: bytes (~5 bytes
# read per output byte). Design: one thread per output byte.

def _pack_bits(rows):
    N, W = rows.shape
    pad = (-W) % 8
    if pad:
        rows = torch.cat([rows, rows.new_zeros((N, pad))], dim=1)
    grouped = rows.reshape(N, -1, 8).to(torch.uint8)
    weights = torch.tensor([1 << k for k in range(8)], dtype=torch.uint8,
                           device=rows.device)
    return (grouped * weights).sum(dim=2).to(torch.uint8)


def pack_plain(chosen, chosen_borrow, fit, admitted, borrows):
    W = chosen.shape[0]
    pr = (chosen + 1).to(torch.uint8).reshape(W, -1) | \
        (chosen_borrow.reshape(W, -1).to(torch.uint8) << 7)
    bits = _pack_bits(torch.stack([fit, admitted, borrows]))
    return pr, bits


def pack(chosen, chosen_borrow, fit, admitted, borrows):
    if _is_cpu(chosen):
        return pack_plain(chosen, chosen_borrow, fit, admitted, borrows)
    W = chosen.shape[0]
    PR = chosen[0].numel() if W else 0
    NB = (W + 7) // 8
    dec_pr = torch.empty((W, PR), dtype=torch.uint8, device=chosen.device)
    dec_bits = torch.empty((3, NB), dtype=torch.uint8, device=chosen.device)
    _launch("pack", [
        _ptr(chosen, torch.int32, "chosen"),
        _ptr(chosen_borrow, torch.bool, "chosen_borrow"),
        _ptr(fit, torch.bool, "fit"),
        _ptr(admitted, torch.bool, "admitted"),
        _ptr(borrows, torch.bool, "borrows"),
        _ptr(dec_pr, torch.uint8, "dec_pr"),
        _ptr(dec_bits, torch.uint8, "dec_bits"),
    ], [W, PR, NB], chosen.device)
    pack.launches += 1
    return dec_pr, dec_bits


# ---------------------------------------------------------------------------
# apply_state_deltas: sparse usage corrections on the resident state
# ---------------------------------------------------------------------------
#
# Replaces kueue_tpu/solver/kernel.py:765 apply_state_deltas_impl. The
# usage a bound solver keeps on the card between cycles is corrected by
# the cache journal's net deltas (finishes, evictions, reverted
# admissions): D unique (q,f,r) coords with their deltas, bubbled up the
# cohort chain as a difference of clamps past each level's guaranteed
# quota; per level, several children may feed one cohort coord, so the
# level's delta is a segment sum. Bound on the H100: latency — a
# production tuple has D <= 512 coords (a few KB); the chain is the
# coords, the values at them, then one segment sum a level. Design
# (csrc/deltas.cu, `deltas_plan`): the register form (D <= 1024, L <= 4),
# one block, a thread a row of every level: one round trip for every
# index, a second for every value at them (usage, guaranteed, cohort
# usage and guaranteed, cohort_multilevel), then a level is a barrier,
# the row's segment sum (shared atomics into two buffers that take turns,
# each zeroed where it is read: a sum in three 32-bit words, native
# atomics, where a 64-bit add is a compare-and-swap loop) and the clamp
# difference; a
# cohort that can sit at two levels of a tuple (the chain table
# cohort_multilevel) is read again at its level, after the earlier
# level's add, as the JAX program reads it. Past that, the staged form:
# one block of 1024 threads walks each level's rows, the sums in shared
# memory (opted in past 48 KB) or, past DELTAS_SMEM, in a global scratch.
# usage/cohort_usage are updated IN PLACE (the JAX program returns new
# arrays; in place is the torch form).

DELTAS_REGISTER_ROWS = 1024   # the register form's rows: a thread each
DELTAS_REGISTER_LEVELS = (1, 2, 4)  # its compiled level counts
DELTAS_SMEM = 200 * 1024      # shared memory the staged form may take


def deltas_plan(D: int, L: int) -> dict:
    """The delta prologue's launch for D rows and L levels: "register"
    (threads = D rounded up to a warp, `levels` compiled, two sum buffers
    of three uint32 words a row in shared memory), "shared" (1024 threads,
    the two [D] int64 sum buffers in shared memory) or "global" (the sums
    in a global scratch of 2 * D int64)."""
    sums = 2 * D * 8
    if D <= DELTAS_REGISTER_ROWS and L <= DELTAS_REGISTER_LEVELS[-1]:
        return {"form": "register", "threads": -(-D // 32) * 32,
                "levels": next(n for n in DELTAS_REGISTER_LEVELS if n >= L),
                "smem": 2 * 3 * D * 4}
    if sums <= DELTAS_SMEM:
        return {"form": "shared", "threads": 1024, "levels": L, "smem": sums}
    return {"form": "global", "threads": 1024, "levels": L, "smem": 0,
            "scratch_bytes": sums}


def apply_state_deltas_plain(topo, usage, cohort_usage, dq, df, dr, dv,
                             lvl_c, lvl_seg):
    """In place on usage[Q,F,R] and cohort_usage[C,F,R] (int64)."""
    valid = dq >= 0
    dqs, dfs, drs = (x.clamp_min(0).long() for x in (dq, df, dr))
    dv = torch.where(valid, dv, 0)
    old = usage[dqs, dfs, drs]
    usage.index_put_((dqs, dfs, drs), dv, accumulate=True)  # pads add 0
    g = topo["guaranteed"][dqs, dfs, drs]
    dover = (old + dv - g).clamp_min(0) - (old - g).clamp_min(0)
    D = dq.shape[0]
    for lvl in range(lvl_c.shape[0]):
        seg = lvl_seg[lvl]
        delta_l = torch.zeros(D, dtype=torch.int64, device=usage.device)
        delta_l.index_add_(0, seg.clamp_min(0).long(),
                           torch.where(seg >= 0, dover, 0))
        c = lvl_c[lvl, :, 0]
        cs, fs, rs = (lvl_c[lvl, :, k].clamp_min(0).long() for k in range(3))
        delta_l = torch.where(c >= 0, delta_l, 0)
        oldc = cohort_usage[cs, fs, rs]
        cohort_usage.index_put_((cs, fs, rs), delta_l, accumulate=True)
        gc = topo["cohort_guaranteed"][cs, fs, rs]
        dover = (oldc + delta_l - gc).clamp_min(0) - (oldc - gc).clamp_min(0)


def apply_state_deltas(topo, usage, cohort_usage, dq, df, dr, dv, lvl_c,
                       lvl_seg):
    if _is_cpu(usage):
        return apply_state_deltas_plain(topo, usage, cohort_usage, dq, df,
                                        dr, dv, lvl_c, lvl_seg)
    if "cohort_multilevel" not in topo:
        raise KeyError("apply_state_deltas: the topology dict lacks the "
                       "chain table cohort_multilevel (build it with "
                       "topo_to_device)")
    D, L = dq.shape[0], lvl_c.shape[0]
    _, F, R = usage.shape
    plan = deltas_plan(D, L)
    scratch = torch.empty(2 * D if plan["form"] == "global" else 0,
                          dtype=torch.int64, device=usage.device)
    _launch("deltas", [
        _ptr(topo["guaranteed"], torch.int64, "guaranteed"),
        _ptr(topo["cohort_guaranteed"], torch.int64, "cohort_guaranteed"),
        _ptr(usage, torch.int64, "usage"),
        _ptr(cohort_usage, torch.int64, "cohort_usage"),
        _ptr(dq, torch.int32, "dq"),
        _ptr(df, torch.int32, "df"),
        _ptr(dr, torch.int32, "dr"),
        _ptr(dv, torch.int64, "dv"),
        _ptr(lvl_c, torch.int32, "lvl_c"),
        _ptr(lvl_seg, torch.int32, "lvl_seg"),
        _ptr(topo["cohort_multilevel"], torch.bool, "cohort_multilevel"),
        scratch.data_ptr(),
    ], [D, L, F, R, ("register", "shared", "global").index(plan["form"]),
        plan["levels"], plan["smem"]], usage.device)
    apply_state_deltas.launches += 1
    apply_state_deltas.last_plan = plan


apply_state_deltas.last_plan = None  # the last launch's deltas_plan


def deltas_tick(device, threads: int = 512, iters: int = 4096) -> float:
    """Clock cycles of one level step of the delta prologue (csrc/deltas.cu
    deltas_tick_kernel, one block of `threads`: a row's sum taken from its
    three shared words and zeroed, three 32-bit shared atomic adds, a
    barrier), the least of three runs."""
    best = None
    for _ in range(3):
        out = torch.zeros(2, dtype=torch.int64, device=device)
        _launch("deltas", [out.data_ptr()], [threads, iters], device,
                symbol="deltas_tick_launch")
        cycles = out[0].item() / iters
        best = cycles if best is None else min(best, cycles)
    return best


# ---------------------------------------------------------------------------
# The encode arena's device twin: changed-row scatter and per-cycle gather
# ---------------------------------------------------------------------------
#
# Replace kueue_tpu/solver/kernel.py:863 scatter_arena_rows_impl (and its
# donated form, :888) and :892 gather_arena_impl, with their index rules:
# the scatter wraps a slot in [-cap, 0) to row cap + slot and drops any
# other slot outside [0, cap); the gather reads row min(slot, cap - 1)
# for a slot >= 0 and gives a zero row for a slot < 0. The twin holds
# the ARENA_FIELDS rows of every arena slot; bools are bytes. Bound on
# the H100: latency — a row (217 B at P=4, F=32, R=2) is read once and
# written once, but at <= 512 scattered rows and 2048 gathered rows the
# launch and two dependent global round trips (the slot, then the
# fields) are the time. Both kernels are csrc/arena.cuh's one copy
# kernel: a warp a row (a warp a pass of 32 vectors for a wider row),
# every field's loads before any store, each field in the widest vector
# that divides its row bytes and the alignment of its source and
# destination (`arena_copy_plan`); a dropped scatter slot returns before
# any load, a gather padding row is zeroed without one.

ARENA_DTYPES = {"requests": torch.int64, "podset_active": torch.bool,
                "wl_cq": torch.int32, "priority": torch.int64,
                "timestamp": torch.float64, "eligible": torch.bool,
                "solvable": torch.bool}


def _row_bytes(t: torch.Tensor) -> int:
    return math.prod(t.shape[1:]) * t.element_size()


def scatter_arena_rows_plain(arena: dict, upd_slots, upd_rows: dict) -> None:
    """In place: arena[f][slot] = upd_rows[f][d] for every field, under
    JAX's `.at[upd_slots].set(mode="drop")` index rule: a slot in [-cap,
    0) writes row cap + slot, a slot in [0, cap) its row, and any other
    slot (the padding, which is `cap`) is dropped. Two slots that reach
    one row write it in no set order (XLA leaves it unspecified;
    production sends distinct slots)."""
    cap = arena["wl_cq"].shape[0]
    keep = (upd_slots >= -cap) & (upd_slots < cap)
    idx = upd_slots[keep].long() % max(cap, 1)
    for name in ARENA_FIELDS:
        arena[name][idx] = upd_rows[name][keep]


def scatter_arena_rows(arena: dict, upd_slots, upd_rows: dict) -> None:
    if _is_cpu(upd_slots):
        return scatter_arena_rows_plain(arena, upd_slots, upd_rows)
    cap = arena["wl_cq"].shape[0]
    D = upd_slots.shape[0]
    srcs, dsts, sizes = [], [], []
    for name in ARENA_FIELDS:
        dst, src = arena[name], upd_rows[name]
        if dst.shape[1:] != src.shape[1:] or src.shape[0] != D:
            raise ValueError(f"{name}: rows {tuple(src.shape)} do not fit "
                             f"the twin {tuple(dst.shape)}")
        srcs.append(_ptr(src, ARENA_DTYPES[name], f"rows.{name}"))
        dsts.append(_ptr(dst, ARENA_DTYPES[name], f"arena.{name}"))
        sizes.append(_row_bytes(dst))
    plan = arena_copy_plan(sizes, srcs, dsts)
    lgs = [v.bit_length() - 1 for v in plan["vec_bytes"]]
    _launch("arena_scatter", [_ptr(upd_slots, torch.int32, "upd_slots"),
                              *srcs, *dsts], [D, cap, *sizes, *lgs],
            upd_slots.device)
    scatter_arena_rows.launches += 1
    scatter_arena_rows.last_plan = plan


scatter_arena_rows.last_plan = None  # the last launch's arena_copy_plan


def gather_arena_plain(arena: dict, slots) -> tuple:
    """[W] slots (-1 = padding) -> the batch tensors (requests,
    podset_active, wl_cq, priority, timestamp, eligible, solvable), under
    JAX's gather rule: a slot < 0 gives a row of zeros / False, a slot >=
    0 reads row min(slot, cap - 1)."""
    cap = arena["wl_cq"].shape[0]
    valid = slots >= 0
    s = slots.long().clamp(0, max(cap - 1, 0))
    requests = torch.where(valid[:, None, None], arena["requests"][s], 0)
    podset_active = arena["podset_active"][s] & valid[:, None]
    wl_cq = torch.where(valid, arena["wl_cq"][s], 0)
    priority = torch.where(valid, arena["priority"][s], 0)
    timestamp = torch.where(valid, arena["timestamp"][s], 0.0)
    eligible = arena["eligible"][s] & valid[:, None, None]
    solvable = arena["solvable"][s] & valid
    return (requests, podset_active, wl_cq, priority, timestamp, eligible,
            solvable)


ARENA_COPY_WARPS = 8  # warps of a copy block (csrc/arena.cuh)
# the vector widths (bytes) csrc/arena.cuh has instances for, by field,
# widest first: the bool fields 16, 4 or 1; the others their dtype's size
# (requests also 16)
ARENA_COPY_WIDTHS = {"requests": (16, 8), "podset_active": (16, 4, 1),
                     "wl_cq": (4,), "priority": (8,), "timestamp": (8,),
                     "eligible": (16, 4, 1), "solvable": (1,)}


def arena_copy_plan(row_bytes, src_ptrs, dst_ptrs) -> dict:
    """The arena copy's launch (scatter and gather alike) over the fields'
    (ARENA_FIELDS order) row bytes and base addresses, as csrc/arena.cuh's
    launcher derives it: each field's vector bytes (the widest of its
    ARENA_COPY_WIDTHS dividing its row bytes and both addresses), the
    passes a row takes (a lane a vector, 32 a pass), the warps a row takes
    (its passes, rounded up to 1, 2, 4 or 8) and the rows a block copies."""
    vec = []
    for name, rb, src, dst in zip(ARENA_FIELDS, row_bytes, src_ptrs,
                                  dst_ptrs):
        vec.append(next(v for v in ARENA_COPY_WIDTHS[name]
                        if rb % v == 0 and src % v == 0 and dst % v == 0))
    most = max((rb // v for rb, v in zip(row_bytes, vec)), default=0)
    passes = -(-most // 32)
    warps = next(w for w in (1, 2, 4, 8) if w >= min(passes, 8))
    return {"vec_bytes": vec, "passes": passes, "warps_per_row": warps,
            "rows_per_block": ARENA_COPY_WARPS // warps}


def gather_arena(arena: dict, slots) -> tuple:
    if _is_cpu(slots):
        return gather_arena_plain(arena, slots)
    cap = arena["wl_cq"].shape[0]
    W = slots.shape[0]
    outs, srcs, dsts, sizes = [], [], [], []
    for name in ARENA_FIELDS:  # the batch order of the outputs
        src = arena[name]
        out = torch.empty((W,) + tuple(src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        outs.append(out)
        srcs.append(_ptr(src, ARENA_DTYPES[name], f"arena.{name}"))
        dsts.append(_ptr(out, ARENA_DTYPES[name], name))
        sizes.append(_row_bytes(src))
    plan = arena_copy_plan(sizes, srcs, dsts)
    lgs = [v.bit_length() - 1 for v in plan["vec_bytes"]]
    _launch("arena_gather", [_ptr(slots, torch.int32, "slots"), *srcs,
                             *dsts], [W, cap, *sizes, *lgs], slots.device)
    gather_arena.launches += 1
    gather_arena.last_plan = plan
    return tuple(outs)


gather_arena.last_plan = None  # the last launch's arena_copy_plan


# ---------------------------------------------------------------------------
# solve_preempt: batched minimal preemption
# ---------------------------------------------------------------------------
#
# Replaces kueue_tpu/solver/preempt.py:598 solve_preempt_impl (jit :758)
# with make_problem_sim :307, _avail_cq0_prefix :425, _fits_prefix :468,
# _own_cq_cumsum :481, _chain_flows_fwd :500 and _fillback_ok :539. Per
# problem (solver/preempt.py encodes them; PREEMPT.md §2 of the JAX
# package derives the closed forms): the do-mask of the dynamic
# cq-still-borrowing skip as a per-CQ exclusive prefix sum, the
# borrowWithinCohort threshold flip as a running OR, each candidate's
# removal routed up the cohort tree by node depth, the fit check of every
# candidate prefix at once, the first fitting prefix k*, then the
# fill-back auction rounds squeezing a lower and an upper bound of the
# returned set onto the reverse greedy's fixpoint. All against the usage
# from before the cycle. Outputs: targets[B,K] bool, feasible[B] bool,
# stats[B,4] int32 = (candidates, k*+1 or 0, fill-back rounds, returned).
# Bound on the H100: latency. Each problem is a chain of dependent
# block-wide passes: 2 sorts, 2 + DC scans forward, 1 + DC scans per
# fill-back evaluation (1 + 2 (rounds - 1) of them), each scan two
# barriers a group of slots; the bytes it must move (the problem arrays
# and outputs, the candidate-table rows and the quota elements it
# gathers) bound it far lower (0.005 ms at the reclaim cell's batch).
# Design (csrc/solve_preempt.cu): a persistent grid of blocks, one
# problem at a time each; a problem's slots compacted to its active ones
# (a request or a needs-preemption flag: no other slot changes an
# output), at most `active_slots` (default RF; preempt.PreemptArgs
# carries the batch's, counted from the host encode), in register groups
# of 2, 4 or 8; every keyed prefix sum, over all keys and a group of
# slots at once,
# as one segmented scan over the candidates sorted by key (local CQ once
# a problem, cohort node once per depth, reused by every auction round);
# 3 blocks an SM by registers; candidate indices and sort keys 16-bit up
# to PREEMPT_NARROW_K candidates a problem, 32-bit above (any K); the
# problem's rows, sort tables and quota
# planes in dynamic shared memory when they fit a block (the "shared"
# rule), else in a per-block slice of global scratch (the "global"
# rule), chosen by csrc's solve_preempt_plan, which also sizes the grid
# by occupancy; a problem with no valid candidate writes its outputs at
# once. With `slots` (the sharded solve's planner-assigned problems,
# kueue_tpu/parallel/mesh.py:335-364), the blocks walk the slots in
# place of 0..B and each writes its problem's outputs at the problem's
# row of zero-initialised outputs; a padding slot (B or -1) writes
# nothing.

PREEMPT_NOLIM = 2**61  # kueue_tpu/solver/preempt.py:317 (not NO_LIMIT)
# problems the plain version solves at once (bounds its [b,CL,K,RF] temps)
PREEMPT_PLAIN_CHUNK = 256


def _rows_at(t, idx):
    """t[b, idx[b, ...]] for a per-problem table t[b,N,...]."""
    b = torch.arange(t.shape[0], device=t.device).view(
        -1, *([1] * (idx.dim() - 1)))
    return t[b, idx]


def _own_cq_cumsum(cand_q, vals, QL: int, reverse: bool = False):
    """Per-candidate exclusive same-CQ running sum of vals[b,K,RF]
    (reverse: suffix sums); candidates with cand_q < 0 get 0."""
    out = torch.zeros_like(vals)
    for q in range(QL):
        m = (cand_q == q)[:, :, None]
        vm = torch.where(m, vals, 0)
        cs = (vm.flip(1).cumsum(1).flip(1) if reverse else vm.cumsum(1))
        out = torch.where(m, cs - vm, out)
    return out


def _avail_cq0_prefix(sim, has_cohort, u0row_k, cu_k):
    """Availability of local CQ 0 (the preemptor's) for every prefix:
    u0row_k[b,K,RF], cu_k[b,CL,K,RF] (resource_node.go:89-104)."""
    chain0 = sim["chain"][:, 0, :]                           # [b,DC]
    DC = chain0.shape[1]
    lim = PREEMPT_NOLIM // 4
    parent = torch.zeros_like(u0row_k)
    started = torch.zeros(u0row_k.shape[0], dtype=torch.bool,
                          device=u0row_k.device)
    for d in range(DC - 1, -1, -1):
        c = chain0[:, d]
        ok = c >= 0
        cs = c.clamp_min(0)
        cuc = _rows_at(cu_k, cs[:, None])[:, 0]              # [b,K,RF]
        sub = _rows_at(sim["c_subtree"], cs[:, None])        # [b,1,RF]
        gua = _rows_at(sim["c_guar"], cs[:, None])
        bl = _rows_at(sim["c_bl"], cs[:, None])
        root_avail = sub - cuc
        local = (gua - cuc).clamp_min(0)
        cap = (sub - gua) - (cuc - gua).clamp_min(0) + bl.clamp_max(lim)
        child = local + torch.minimum(parent, cap)
        new = torch.where(started[:, None, None], child, root_avail)
        parent = torch.where(ok[:, None, None], new, parent)
        started = started | ok
    nom0 = sim["nominal"][:, 0:1]                            # [b,1,RF]
    guar0 = sim["guaranteed"][:, 0:1]
    bl0 = sim["borrow_limit"][:, 0:1]
    local0 = (guar0 - u0row_k).clamp_min(0)
    cap0 = (nom0 - guar0) - (u0row_k - guar0).clamp_min(0) + \
        bl0.clamp_max(lim)
    with_cohort = local0 + torch.minimum(parent, cap0)
    return torch.where(has_cohort[:, None, None], with_cohort,
                       nom0 - u0row_k)


def _fits_prefix(sim, has_cohort, req, u0row_k, cu_k, ab_k):
    """workload_fits (preemption.go:576-585) for every prefix: [b,K]."""
    nom0 = sim["nominal"][:, 0:1]
    has_req = (req > 0)[:, None, :]
    avail = _avail_cq0_prefix(sim, has_cohort, u0row_k, cu_k)
    borrow_ok = ab_k | (~has_req | (u0row_k + req[:, None, :] <= nom0)).all(2)
    return borrow_ok & (~has_req | (req[:, None, :] <= avail)).all(2)


def _chain_flows_fwd(sim, cand_chain, dep_of_local, ed, delta0):
    """IN[b,CL,K,RF]: arrivals at each local cohort over every candidate
    prefix, each removal's marginal clamped against its node's running
    state and routed up the tree by node depth, deepest first."""
    CL = sim["c_guar"].shape[1]
    DC = cand_chain.shape[2]
    s0 = sim["cu0"] - sim["c_guar"]                          # [b,CL,RF]
    IN = torch.zeros(delta0.shape[0], CL, *delta0.shape[1:],
                     dtype=torch.int64, device=delta0.device)
    flow = delta0
    arange_cl = torch.arange(CL, device=delta0.device)
    for dlt in range(DC - 1, -1, -1):
        pos = ed - dlt
        act = (pos >= 0) & (ed >= 0)
        node = torch.gather(cand_chain, 2,
                            pos.clamp(0, DC - 1)[:, :, None])[:, :, 0]
        act = act & (node >= 0)
        noh = (node[:, None, :] == arange_cl[None, :, None]) & act[:, None, :]
        inm = torch.where(noh[..., None], flow[:, None], 0)  # [b,CL,K,RF]
        cs = inm.cumsum(2)
        excl = cs - inm
        out = torch.minimum(inm, (s0[:, :, None, :] - excl).clamp_min(0))
        IN = torch.where((dep_of_local == dlt)[:, :, None, None], cs, IN)
        flow = torch.where(act[:, :, None],
                           torch.where(noh[..., None], out, 0).sum(1), flow)
    return IN


def _fillback_ok(sim, cand_chain, dep_of_local, ed, elig, members, v,
                 cand_q, q_safe, u_fwd, cu_fwd, guar_k, req, has_cohort,
                 ab_fb, QL: int):
    """One auction round: for every eligible candidate j, would the
    reverse greedy take it back given that exactly `members` (the
    candidates after it) came back before it? Returns ok[b,K]."""
    CL = sim["c_guar"].shape[1]
    DC = cand_chain.shape[2]
    c_guar = sim["c_guar"]
    arange_cl = torch.arange(CL, device=v.device)
    mv = torch.where(members[:, :, None], v, 0)
    rev_own = _own_cq_cumsum(cand_q, mv, QL, reverse=True)
    t_pre = _rows_at(u_fwd, q_safe) + rev_own - guar_k       # [b,K,RF]
    delta_add = (t_pre + v).clamp_min(0) - t_pre.clamp_min(0)
    shape = (v.shape[0], CL) + tuple(v.shape[1:])
    RIN = torch.zeros(shape, dtype=torch.int64, device=v.device)
    OWN = torch.zeros(shape, dtype=torch.int64, device=v.device)
    flow = delta_add
    for dlt in range(DC - 1, -1, -1):
        pos = ed - dlt
        act = (pos >= 0) & (ed >= 0) & elig
        node = torch.gather(cand_chain, 2,
                            pos.clamp(0, DC - 1)[:, :, None])[:, :, 0]
        act = act & (node >= 0)
        noh = (node[:, None, :] == arange_cl[None, :, None]) & act[:, None, :]
        inm = torch.where((noh & members[:, None, :])[..., None],
                          flow[:, None], 0)
        rcs = inm.flip(2).cumsum(2).flip(2)
        rexcl = rcs - inm
        RIN = torch.where((dep_of_local == dlt)[:, :, None, None], rexcl, RIN)
        OWN = torch.where(noh[..., None], flow[:, None], OWN)
        cu_pre = torch.where(noh[..., None],
                             cu_fwd[:, :, None, :] + rexcl, 0).sum(1)
        gguar = torch.where(noh[..., None], c_guar[:, :, None, :], 0).sum(1)
        local_c = (gguar - cu_pre).clamp_min(0)
        flow = torch.where(act[:, :, None], (flow - local_c).clamp_min(0),
                           flow)
    cu_hyp = cu_fwd[:, :, None, :] + RIN + OWN
    in0 = (cand_q == 0)[:, :, None]
    r0 = torch.where(members[:, :, None] & in0, v, 0)
    r0_excl = r0.flip(1).cumsum(1).flip(1) - r0
    u0row_hyp = u_fwd[:, 0:1] + r0_excl + torch.where(in0, v, 0)
    ok = _fits_prefix(sim, has_cohort, req, u0row_hyp, cu_hyp,
                      ab_fb[:, None])
    return elig & ok


def _solve_preempt_chunk(topo, usage, cohort_usage, gq, gf, gr, gc,
                         chain_local, requests, frs_np, cand_idx, cand_ql,
                         cand_usage_table, cand_prio_table, ab0, th_act, th,
                         has_cohort):
    dev = usage.device
    b = gq.shape[0]
    QL = gq.shape[1]
    K = cand_ql.shape[1]
    valid_fr = gf >= 0                                       # [b,RF]
    gf_s = gf.clamp_min(0).long()[:, None, :]
    gr_l = gr.long()[:, None, :]
    q_s = gq.clamp_min(0).long()[:, :, None]                 # [b,QL,1]
    c_s = gc.clamp_min(0).long()[:, :, None]                 # [b,CL,1]
    valid_c = (gc >= 0)[:, :, None] & valid_fr[:, None, :]

    def plane(t, fill=0):
        return torch.where(valid_fr[:, None, :], t[q_s, gf_s, gr_l], fill)

    def cplane(t, fill=0):
        return torch.where(valid_c, t[c_s, gf_s, gr_l], fill)

    sim = {"nominal": plane(topo["nominal"]),
           "guaranteed": plane(topo["guaranteed"]),
           "borrow_limit": plane(topo["borrow_limit"], PREEMPT_NOLIM),
           "c_subtree": cplane(topo["cohort_subtree"]),
           "c_guar": cplane(topo["cohort_guaranteed"]),
           "c_bl": cplane(topo["cohort_borrow_limit"], PREEMPT_NOLIM),
           "cu0": cplane(cohort_usage), "chain": chain_local.long()}
    nominal, guaranteed = sim["nominal"], sim["guaranteed"]
    u0, cu0 = plane(usage), sim["cu0"]

    cand_q = cand_ql.long()                                  # [b,K]
    idx = cand_idx.long()
    cand_usage = cand_usage_table[idx]                       # [b,K,RF]
    cand_prio = cand_prio_table[idx].long()                  # [b,K]
    arange_k = torch.arange(K, device=dev)[None, :]
    valid = cand_q >= 0
    q_safe = cand_q.clamp_min(0)
    in_cq = cand_q == 0
    v = torch.where(valid[:, :, None], cand_usage, 0)
    u0_k = _rows_at(u0, q_safe)
    nom_k = _rows_at(nominal, q_safe)
    guar_k = _rows_at(guaranteed, q_safe)

    # the do-mask: the dynamic skip, closed form (the over-subtraction of
    # skipped same-CQ candidates is exact: the condition is monotone)
    own_all_excl = _own_cq_cumsum(cand_q, v, QL)
    borrowing_before = (frs_np[:, None, :]
                        & (u0_k - own_all_excl > nom_k)).any(2)
    do = valid & (in_cq | borrowing_before)
    # the borrowWithinCohort threshold flip, inclusive of the candidate's
    at_or_above = th_act[:, None] & ~in_cq & (cand_prio >= th[:, None])
    ab_k = ab0[:, None] & ~((do & at_or_above).long().cumsum(1) > 0)

    own_rm_excl = _own_cq_cumsum(cand_q, torch.where(do[:, :, None], v, 0),
                                 QL)
    delta0 = torch.where(
        do[:, :, None],
        torch.minimum(v, (u0_k - guar_k - own_rm_excl).clamp_min(0)), 0)
    cand_chain = _rows_at(sim["chain"], q_safe)              # [b,K,DC]
    dep_of_local = torch.where(
        gc >= 0, topo["cohort_depth"].long()[gc.clamp_min(0).long()], -1)
    first = cand_chain[:, :, 0]
    ed = torch.where((first >= 0) & do,
                     torch.gather(dep_of_local, 1, first.clamp_min(0)), -1)
    IN = _chain_flows_fwd(sim, cand_chain, dep_of_local, ed, delta0)
    cu_k = cu0[:, :, None, :] - IN
    v0 = torch.where((do & in_cq)[:, :, None], v, 0)
    u0row_k = u0[:, 0:1] - v0.cumsum(1)

    fit_k = _fits_prefix(sim, has_cohort, requests, u0row_k, cu_k, ab_k)
    cond = do & fit_k
    done = cond.any(1)
    k_star = torch.where(done, torch.where(cond, arange_k, K).amin(1), 0)
    targets_fwd = do & (arange_k <= k_star[:, None]) & done[:, None]
    ab_fb = torch.where(done, torch.gather(ab_k, 1, k_star[:, None])[:, 0],
                        ab0)

    # the fill-back auction (fillBackWorkloads)
    elig = targets_fwd & (arange_k != k_star[:, None])
    removed = (do & (arange_k <= k_star[:, None]))[:, :, None]
    u_fwd = u0 - torch.stack(
        [torch.where(removed & (cand_q == q)[:, :, None], v, 0).sum(1)
         for q in range(QL)], dim=1)
    in_star = _rows_at(IN.transpose(1, 2), k_star[:, None])[:, 0]  # [b,CL,RF]
    cu_fwd = torch.where(done[:, None, None], cu0 - in_star, cu0)
    u_fwd = torch.where(done[:, None, None], u_fwd, u0)
    ed_fb = torch.where(elig, ed, -1)

    def ok_fn(members):
        return _fillback_ok(sim, cand_chain, dep_of_local, ed_fb, elig,
                            members, v, cand_q, q_safe, u_fwd, cu_fwd,
                            guar_k, requests, has_cohort, ab_fb, QL)

    hi = elig
    lo = ok_fn(hi)
    rounds = torch.ones(b, dtype=torch.int32, device=dev)
    while True:
        active = (lo != hi).any(1) & (rounds < K + 2)
        if not bool(active.any()):
            break
        hi2 = ok_fn(lo)
        lo2 = ok_fn(hi2)
        lo = torch.where(active[:, None], lo2, lo)
        hi = torch.where(active[:, None], hi2, hi)
        rounds = rounds + active.to(torch.int32)
    targets = targets_fwd & ~lo
    stats = torch.stack([valid.sum(1).to(torch.int32),
                         torch.where(done, k_star + 1, 0).to(torch.int32),
                         rounds, lo.sum(1).to(torch.int32)], dim=1)
    return targets, done, stats


def solve_preempt_plain(topo, usage, cohort_usage, gq, gf, gr, gc,
                        chain_local, requests, frs_np, cand_idx, cand_ql,
                        cand_usage_table, cand_prio_table, allow_borrowing,
                        threshold_active, threshold, has_cohort, slots=None):
    """The vmap of kueue_tpu/solver/preempt.py:598 written out as a batch
    dimension, PREEMPT_PLAIN_CHUNK problems at a time; the fill-back
    loop freezes each problem once its bounds meet, as the vmapped
    while_loop does. Returns (targets[B,K] bool, feasible[B] bool,
    stats[B,4] int32); with slots, only the slots' problems are solved
    and every other row stays zero."""
    B, K = cand_ql.shape
    dev = usage.device
    targets = torch.zeros((B, K), dtype=torch.bool, device=dev)
    feasible = torch.zeros(B, dtype=torch.bool, device=dev)
    stats = torch.zeros((B, 4), dtype=torch.int32, device=dev)
    per_problem = (gq, gf, gr, gc, chain_local, requests, frs_np, cand_idx,
                   cand_ql)
    flags = (allow_borrowing, threshold_active, threshold, has_cohort)
    if slots is not None:
        s = slots.long()
        rows = s[(s >= 0) & (s < B)]
        out = solve_preempt_plain(
            topo, usage, cohort_usage, *(a[rows] for a in per_problem),
            cand_usage_table, cand_prio_table, *(a[rows] for a in flags))
        for full, part in zip((targets, feasible, stats), out):
            full[rows] = part
        return targets, feasible, stats
    for s in range(0, B, PREEMPT_PLAIN_CHUNK):
        e = min(B, s + PREEMPT_PLAIN_CHUNK)
        t, f, st = _solve_preempt_chunk(
            topo, usage, cohort_usage, *(a[s:e] for a in per_problem),
            cand_usage_table, cand_prio_table, *(a[s:e] for a in flags))
        targets[s:e], feasible[s:e], stats[s:e] = t, f, st
    return targets, feasible, stats


# the most candidates a problem for which the K9 kernel keeps candidate
# indices and sort keys in 16 bits (csrc SP_NARROW_K; encode's K buckets
# reach 32768 at 8193 to 32768 candidates); above it they are 32-bit
PREEMPT_NARROW_K = 32768


def preempt_plan(n_slots: int, K: int, QL: int, RFA: int, CL: int,
                 DC: int) -> dict:
    """solve_preempt's launch plan on the current card (csrc's
    solve_preempt_plan, host calls only): threads a block, the arena's
    bytes a block, its rule ("shared": dynamic shared memory; "global": a
    per-block slice of global scratch), blocks an SM by occupancy, the
    persistent grid, the kernel's registers and local bytes a thread,
    the row stride (RFA rounded up to the group width), the group width
    the kernel is compiled for (2, 4 or 8 slots in registers) and the
    width of its candidate indices and sort keys (16 bits up to
    PREEMPT_NARROW_K candidates, else 32)."""
    out = (ctypes.c_longlong * 10)()
    fn = _build.entry("solve_preempt", 1, 6, "solve_preempt_plan")
    rc = fn(ctypes.cast(out, ctypes.c_void_p), *(ctypes.c_longlong(x) for x in
            (n_slots, K, QL, RFA, CL, DC)), None)
    if rc != 0:
        raise RuntimeError(f"solve_preempt_plan failed: CUDA error {rc}")
    return {"threads": out[0], "arena_bytes": out[1],
            "rule": "shared" if out[2] else "global", "blocks_per_sm": out[3],
            "grid": out[4], "registers": out[5], "local_bytes": out[6],
            "row_slots": out[7], "group_slots": out[8],
            "index_bits": out[9], "active_slots": RFA}


def solve_preempt(topo, usage, cohort_usage, gq, gf, gr, gc, chain_local,
                  requests, frs_np, cand_idx, cand_ql, cand_usage_table,
                  cand_prio_table, allow_borrowing, threshold_active,
                  threshold, has_cohort, slots=None, active_slots=None):
    """K9. active_slots bounds every problem's active slots (requests > 0
    or frs_np; preempt.active_slot_count, which preempt.PreemptArgs
    carries): the kernel's rows and scans run over that many; None takes
    RF. A problem with more writes stats of -1, on which
    service.preempt_aux raises. The plain version takes every slot. Any
    K: the kernel's candidate indices are 16-bit up to PREEMPT_NARROW_K
    and 32-bit above (`solve_preempt.last_plan["index_bits"]`)."""
    if _is_cpu(usage):
        return solve_preempt_plain(
            topo, usage, cohort_usage, gq, gf, gr, gc, chain_local, requests,
            frs_np, cand_idx, cand_ql, cand_usage_table, cand_prio_table,
            allow_borrowing, threshold_active, threshold, has_cohort, slots)
    B, QL = gq.shape
    RF = gf.shape[1]
    CL = gc.shape[1]
    K = cand_ql.shape[1]
    DC = chain_local.shape[2]
    if chain_local.shape[:2] != (B, QL) or cand_idx.shape != (B, K) \
            or cand_usage_table.shape[1] != RF:
        raise ValueError("solve_preempt: inconsistent problem shapes")
    RFA = RF if active_slots is None else int(active_slots)
    if not 0 <= RFA <= RF:
        raise ValueError(f"solve_preempt: active_slots {RFA} outside "
                         f"0..{RF}")
    RFA = max(RFA, 1)
    dev = usage.device
    n_slots = B if slots is None else slots.shape[0]
    # with slots, the rows of the other ranks' problems stay zero
    alloc = torch.empty if slots is None else torch.zeros
    targets = alloc((B, K), dtype=torch.bool, device=dev)
    feasible = alloc(B, dtype=torch.bool, device=dev)
    stats = alloc((B, 4), dtype=torch.int32, device=dev)
    plan = preempt_plan(max(n_slots, 1), K, QL, RFA, CL, DC)
    # the global rule's arena: a slice per block of the persistent grid
    scratch = torch.empty(plan["grid"] * plan["arena_bytes"]
                          if plan["rule"] == "global" else 16,
                          dtype=torch.uint8, device=dev)
    _launch("solve_preempt", [
        _ptr(topo["nominal"], torch.int64, "nominal"),
        _ptr(topo["guaranteed"], torch.int64, "guaranteed"),
        _ptr(topo["borrow_limit"], torch.int64, "borrow_limit"),
        _ptr(topo["cohort_subtree"], torch.int64, "cohort_subtree"),
        _ptr(topo["cohort_guaranteed"], torch.int64, "cohort_guaranteed"),
        _ptr(topo["cohort_borrow_limit"], torch.int64, "cohort_borrow_limit"),
        _ptr(topo["cohort_depth"], torch.int32, "cohort_depth"),
        _ptr(usage, torch.int64, "usage"),
        _ptr(cohort_usage, torch.int64, "cohort_usage"),
        _ptr(gq, torch.int32, "gq"),
        _ptr(gf, torch.int32, "gf"),
        _ptr(gr, torch.int32, "gr"),
        _ptr(gc, torch.int32, "gc"),
        _ptr(chain_local, torch.int32, "chain_local"),
        _ptr(requests, torch.int64, "requests"),
        _ptr(frs_np, torch.bool, "frs_np"),
        _ptr(cand_idx, torch.int32, "cand_idx"),
        _ptr(cand_ql, torch.int16, "cand_ql"),
        _ptr(cand_usage_table, torch.int64, "cand_usage"),
        _ptr(cand_prio_table, torch.int32, "cand_prio"),
        _ptr(allow_borrowing, torch.bool, "allow_borrowing"),
        _ptr(threshold_active, torch.bool, "threshold_active"),
        _ptr(threshold, torch.int64, "threshold"),
        _ptr(has_cohort, torch.bool, "has_cohort"),
        _ptr(scratch, torch.uint8, "scratch"),
        _ptr(targets, torch.bool, "targets"),
        _ptr(feasible, torch.bool, "feasible"),
        _ptr(stats, torch.int32, "stats"),
        0 if slots is None else _ptr(slots, torch.int32, "slots"),
    ], [n_slots, B, K, QL, RF, CL, DC, usage.shape[1], usage.shape[2], RFA,
        plan["grid"], plan["threads"], plan["arena_bytes"],
        int(plan["rule"] == "shared")], dev)
    solve_preempt.launches += 1
    solve_preempt.last_plan = plan
    return targets, feasible, stats


solve_preempt.last_plan = None  # the last launch's preempt_plan


# ---------------------------------------------------------------------------
# solve_fair: batched fair-sharing preemption
# ---------------------------------------------------------------------------
#
# Replaces kueue_tpu/solver/fairpreempt.py:210 solve_fair_impl with
# make_problem_sim's fits, remove_usage and add_usage
# (kueue_tpu/solver/preempt.py:307-421). Per problem (solver/fairpreempt.py
# encodes them), fairPreemptions (preemption.go:312-437): pop the eligible
# local CQ of the largest share (ties: its first candidate's position,
# then the lowest slot), take its next candidate by rank, remove it when
# it is the preemptor's own, under the borrowWithinCohort threshold, or
# when the first strategy holds, and update that CQ's share; stop when the
# preemptor fits. Then the retry pass with the second strategy (shares
# fixed at its entry, each CQ's first refused candidate), then fill-back
# in reverse removal order, skipping the last removal. All against the
# usage from before the cycle. Outputs: targets[B,K] bool, feasible[B]
# bool, reasons[B,K] int8 (0 own CQ, 1 strategy, 2 threshold only),
# stats[B,4] int32 = (candidates, pops, fill-back iterations, filled
# back). Bound on the H100: latency — each problem is a chain of
# dependent pops, each a reduction over its CQs and a walk of a cohort
# chain; the bytes are small. Design (csrc/solve_fair.cu): a block of one
# warp per problem, the problem staged once into an arena (its rows, share
# and slot constants, the (CQ, rank) -> candidate table, the removal log
# and the candidate rows) in shared memory, or past FAIR_SMEM in global
# scratch (fair_form); the initial shares a lane a CQ; for QL <= 32 each
# CQ's heap state in its lane's registers and the pick four warp
# reductions; lanes over the slots for a share, the usage updates and the
# fit.

# the share of a CQ of fair weight 0 (kueue_tpu/solver/fairpreempt.py:54)
MAXSHARE = 2**62
# "no first candidate" in cq_order, and the retry pass's empty rank
FAIR_NONE = 2**30


def _share_rows(u, nom, base, floor, fany, weight, lendable, valid_fr,
                same_res):
    """dominantResourceShare (clusterqueue.go:503-564) of each row:
    u/nom/base [b,N,RF], floor/fany/weight [b,N] -> [b,N] int64. Both
    divisions floor, as JAX's //: the ratio is -1 where nothing is lent
    or borrowed, so drs can be -1."""
    borrow_fr = torch.where(valid_fr[:, None, :], (u - nom).clamp_min(0), 0)
    borrow_res = torch.where(same_res[:, None, :, :], borrow_fr[:, :, None, :],
                             0).sum(3) + base
    lend = lendable[:, None, :]
    ratio = torch.where((borrow_res > 0) & (lend > 0),
                        torch.div(borrow_res * 1000, lend.clamp_min(1),
                                  rounding_mode="floor"), -1)
    drs = torch.maximum(ratio.amax(2), floor)
    any_b = (borrow_res > 0).any(2) | fany
    share = torch.where(any_b, torch.div(drs * 1000, weight.clamp_min(1),
                                         rounding_mode="floor"), 0)
    return torch.where(weight == 0, MAXSHARE, share)


class _FairSim:
    """make_problem_sim (kueue_tpu/solver/preempt.py:307) for a chunk of
    problems: the quota planes gathered on the problems' slots, and the
    fit check and the usage bubbling of the reference's resource_node
    math (resource_node.go:89-143), each for one CQ row per problem."""

    def __init__(self, topo, usage, cohort_usage, gq, gf, gr, gc,
                 chain_local, requests, has_cohort):
        self.valid_fr = gf >= 0                              # [b,RF]
        gf_s = gf.clamp_min(0).long()[:, None, :]
        gr_l = gr.long()[:, None, :]
        q_s = gq.clamp_min(0).long()[:, :, None]
        c_s = gc.clamp_min(0).long()[:, :, None]
        valid_c = (gc >= 0)[:, :, None] & self.valid_fr[:, None, :]

        def plane(t, fill=0):
            return torch.where(self.valid_fr[:, None, :], t[q_s, gf_s, gr_l],
                               fill)

        def cplane(t, fill=0):
            return torch.where(valid_c, t[c_s, gf_s, gr_l], fill)

        self.sim = {"nominal": plane(topo["nominal"]),
                    "guaranteed": plane(topo["guaranteed"]),
                    "borrow_limit": plane(topo["borrow_limit"],
                                          PREEMPT_NOLIM),
                    "c_subtree": cplane(topo["cohort_subtree"]),
                    "c_guar": cplane(topo["cohort_guaranteed"]),
                    "c_bl": cplane(topo["cohort_borrow_limit"],
                                   PREEMPT_NOLIM),
                    "chain": chain_local.long()}
        self.u0 = plane(usage)
        self.cu0 = cplane(cohort_usage)
        self.req = requests
        self.has_cohort = has_cohort
        self.ar = torch.arange(gq.shape[0], device=gq.device)
        self.CL = gc.shape[1]

    def fits(self, u, cu):
        """workload_fits with borrowing allowed (preemption.go:576-585):
        the preemptor's request within CQ 0's availability. [b]."""
        avail = _avail_cq0_prefix(self.sim, self.has_cohort, u[:, 0:1],
                                  cu[:, :, None, :])[:, 0]
        return ((self.req <= 0) | (self.req <= avail)).all(1)

    def _chain(self, q):
        return self.sim["chain"][self.ar, q]                 # [b,DC]

    def _cl_oh(self, c):
        return (torch.arange(self.CL, device=c.device)[None, :]
                == c[:, None]) & (c >= 0)[:, None]           # [b,CL]

    def remove_usage(self, u, cu, q, val):
        """removeUsage (resource_node.go:133-143) of val[b,RF] from CQ
        q[b], bubbled up its chain while any part of it is above
        guaranteed quota."""
        guar_q = self.sim["guaranteed"][self.ar, q]
        stored = u[self.ar, q] - guar_q
        q_oh = torch.arange(u.shape[1], device=q.device)[None, :] == q[:, None]
        u = u - torch.where(q_oh[:, :, None], val[:, None, :], 0)
        delta = torch.minimum(val, stored.clamp_min(0))
        chain = self._chain(q)
        for d in range(chain.shape[1]):
            c = chain[:, d]
            oh = self._cl_oh(c)
            cs = c.clamp_min(0)
            ok = (c >= 0) & (delta > 0).any(1)
            stored_c = torch.where(
                (c >= 0)[:, None],
                cu[self.ar, cs] - self.sim["c_guar"][self.ar, cs], 0)
            dd = torch.where(ok[:, None], delta, 0)
            cu = cu - torch.where(oh[:, :, None], dd[:, None, :], 0)
            delta = torch.minimum(dd, stored_c.clamp_min(0))
        return u, cu

    def add_usage(self, u, cu, q, val):
        """addUsage (resource_node.go:121-131) of val[b,RF] to CQ q[b]:
        what exceeds the CQ's unused guaranteed quota climbs the chain,
        each level taking what its own unused guaranteed quota holds."""
        guar_q = self.sim["guaranteed"][self.ar, q]
        local_avail = (guar_q - u[self.ar, q]).clamp_min(0)
        q_oh = torch.arange(u.shape[1], device=q.device)[None, :] == q[:, None]
        u = u + torch.where(q_oh[:, :, None], val[:, None, :], 0)
        delta = (val - local_avail).clamp_min(0)
        chain = self._chain(q)
        for d in range(chain.shape[1]):
            c = chain[:, d]
            oh = self._cl_oh(c)
            cs = c.clamp_min(0)
            ok = (c >= 0)[:, None]
            local_c = torch.where(
                ok, (self.sim["c_guar"][self.ar, cs] - cu[self.ar, cs])
                .clamp_min(0), 0)
            dd = torch.where(ok, delta, 0)
            cu = cu + torch.where(oh[:, :, None], dd[:, None, :], 0)
            delta = torch.where(ok, (dd - local_c).clamp_min(0), delta)
        return u, cu


def _solve_fair_chunk(topo, usage, cohort_usage, gq, gf, gr, gc,
                      chain_local, requests, frs_np, cand_idx, cand_ql,
                      cand_usage_table, cand_prio_table, th_act, th,
                      has_cohort, cand_rank, cq_count, cq_order, base_other,
                      floor_ratio, floor_any, weight, lendable, strat):
    s0_s2a, has_retry, s1_s2a = strat
    dev = usage.device
    b, QL = gq.shape
    K = cand_ql.shape[1]
    fs = _FairSim(topo, usage, cohort_usage, gq, gf, gr, gc, chain_local,
                  requests, has_cohort)
    ar = fs.ar
    nominal = fs.sim["nominal"]
    valid_fr = fs.valid_fr
    same_res = (gr[:, :, None] == gr[:, None, :]) & valid_fr[:, :, None]         & valid_fr[:, None, :]                               # [b,RF,RF]
    valid_q = gq >= 0
    count = cq_count.long()
    order = cq_order.long()
    cand_q = cand_ql.long()
    rank = cand_rank.long()
    idx = cand_idx.long()
    cand_usage = cand_usage_table[idx]                       # [b,K,RF]
    cand_prio = cand_prio_table[idx].long()                  # [b,K]
    arange_ql = torch.arange(QL, device=dev)[None, :]

    def share_of(rows, q):
        """The share of local CQ q[b] with usage row rows[b,RF]."""
        return _share_rows(rows[:, None], nominal[ar, q][:, None],
                           base_other[ar, q][:, None],
                           floor_ratio[ar, q][:, None],
                           floor_any[ar, q][:, None],
                           weight[ar, q][:, None], lendable, valid_fr,
                           same_res)[:, 0]

    def shares(u):
        return _share_rows(u, nominal, base_other, floor_ratio, floor_any,
                           weight, lendable, valid_fr, same_res)

    zero_q = torch.zeros(b, dtype=torch.long, device=dev)

    def nominated_share(u):
        """The preemptor CQ's share with its request added
        (dominant_resource_share_with, m=1)."""
        return share_of(u[:, 0] + requests, zero_q)

    def pick_cq(sh, elig):
        """The max-share eligible CQ; ties to the lowest cq_order, then
        the lowest slot; slot 0 when none is eligible."""
        m = torch.where(elig, sh, -MAXSHARE).amax(1)
        tie = torch.where(elig & (sh == m[:, None]), order, FAIR_NONE)
        first = torch.where(tie == tie.amin(1)[:, None], arange_ql, QL)
        return first.amin(1), elig.any(1)

    def row_of(k_oh, t):
        return torch.where(k_oh[:, :, None], t, 0).sum(1)

    # the forward DRF-heap loop; a problem freezes once it is done, its
    # heap is empty or it popped K times (the vmapped while_loop)
    u, cu = fs.u0, fs.cu0
    pos = torch.zeros((b, QL), dtype=torch.long, device=dev)
    active = torch.ones((b, QL), dtype=torch.bool, device=dev)
    retry = torch.zeros((b, K), dtype=torch.bool, device=dev)
    targets = torch.zeros((b, K), dtype=torch.bool, device=dev)
    reason = torch.zeros((b, K), dtype=torch.int8, device=dev)
    step_of = torch.full((b, K), -1, dtype=torch.long, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    sh = shares(u)
    nom_share = nominated_share(u)
    t = torch.zeros(b, dtype=torch.long, device=dev)
    while True:
        elig = active & valid_q & (pos < count)
        run = ~done & elig.any(1) & (t < K)
        if not bool(run.any()):
            break
        qstar, any_elig = pick_cq(sh, elig)
        any_elig &= ~done
        q_oh = arange_ql == qstar[:, None]
        k_oh = (cand_q == qstar[:, None]) & (rank == pos[ar, qstar][:, None])
        k_valid = k_oh.any(1) & any_elig
        cand_u = row_of(k_oh, cand_usage)
        cand_p = torch.where(k_oh, cand_prio, 0).sum(1)
        own = qstar == 0
        new_cand_share = share_of(u[ar, qstar] - cand_u, qstar)
        if s0_s2a:      # LessThanOrEqualToFinalShare (S2-a)
            strat_ok = nom_share <= new_cand_share
        else:           # LessThanInitialShare (S2-b)
            strat_ok = nom_share < sh[ar, qstar]
        passed = own | (th_act & (cand_p < th)) | strat_ok
        do = k_valid & passed
        u2, cu2 = fs.remove_usage(u, cu, qstar,
                                  torch.where(do[:, None], cand_u, 0))
        sh2 = torch.where(q_oh & do[:, None], new_cand_share[:, None], sh)
        nom2 = torch.where(own & do, nominated_share(u2), nom_share)
        sel = k_oh & do[:, None]
        code = torch.where(own, 0, torch.where(strat_ok, 1, 2)).to(torch.int8)
        reason2 = torch.where(sel, code[:, None], reason)
        step2 = torch.where(sel, t[:, None], step_of)
        retry2 = retry | (k_oh & (k_valid & ~passed)[:, None])
        pos2 = pos + (q_oh & k_valid[:, None]).long()
        exhausted = pos2[ar, qstar] >= count[ar, qstar]
        borrowing = (frs_np & (u2[ar, qstar] > nominal[ar, qstar])).any(1)
        keep = torch.where(own | ~do, ~exhausted, ~exhausted & borrowing)
        active2 = torch.where(q_oh & k_valid[:, None], keep[:, None], active)
        done2 = done | (do & fs.fits(u2, cu2))
        r1, r2, r3 = run[:, None], run[:, None, None], run
        u, cu = torch.where(r2, u2, u), torch.where(r2, cu2, cu)
        sh, nom_share = torch.where(r1, sh2, sh), torch.where(r3, nom2,
                                                               nom_share)
        targets = torch.where(r1, targets | sel, targets)
        reason, step_of = torch.where(r1, reason2, reason),             torch.where(r1, step2, step_of)
        retry, pos = torch.where(r1, retry2, retry), torch.where(r1, pos2, pos)
        active, done = torch.where(r1, active2, active),             torch.where(r3, done2, done)
        t = t + run.long()
    pops = t

    # the retry pass: the second strategy, each CQ's first refused
    # candidate, shares fixed at the pass's entry (preemption.go:412-431)
    if has_retry:
        sh_r = shares(u)
        nom_r = nominated_share(u)
        min_rank = torch.where(retry[:, :, None]
                               & (cand_q[:, :, None] == arange_ql[:, None, :]),
                               rank[:, :, None], FAIR_NONE).amin(1)  # [b,QL]
        has_retry_q = min_rank < FAIR_NONE
        processed = torch.zeros((b, QL), dtype=torch.bool, device=dev)
        for step in range(QL):
            elig = has_retry_q & ~processed & valid_q
            if not bool((elig.any(1) & ~done).any()):
                break  # every later step leaves every problem as it is
            qstar, any_elig = pick_cq(sh_r, elig)
            any_elig &= ~done
            k_oh = retry & (cand_q == qstar[:, None])                 & (rank == min_rank[ar, qstar][:, None])
            if s1_s2a:
                strat_ok = nom_r <= 0
            else:
                strat_ok = nom_r < sh_r[ar, qstar]
            do = any_elig & strat_ok & k_oh.any(1)
            u, cu = fs.remove_usage(u, cu, qstar, torch.where(
                do[:, None], row_of(k_oh, cand_usage), 0))
            sel = k_oh & do[:, None]
            targets = targets | sel
            reason = torch.where(sel, 1, reason).to(torch.int8)
            step_of = torch.where(sel, K + step, step_of)
            processed = processed | ((arange_ql == qstar[:, None])
                                     & any_elig[:, None])
            done = done | (do & fs.fits(u, cu))

    # no fit: no targets (preemption.go:433-436)
    feasible = done
    targets = targets & feasible[:, None]

    # fill-back in reverse removal order, skipping the fit-maker
    # (fill_back_workloads, preemption.go:445-457)
    last_step = torch.where(targets, step_of, -1).amax(1)
    s = last_step
    kept = torch.zeros((b, K), dtype=torch.bool, device=dev)
    fb_iters = torch.zeros(b, dtype=torch.long, device=dev)
    while bool((s >= 0).any()):
        run = s >= 0
        k_oh = targets & (step_of == s[:, None])
        consider = k_oh.any(1) & (s != last_step) & run
        cand_u = torch.where(consider[:, None], row_of(k_oh, cand_usage), 0)
        qstar = torch.where(k_oh, cand_q, 0).sum(1)
        u2, cu2 = fs.add_usage(u, cu, qstar, cand_u)
        keep_back = consider & fs.fits(u2, cu2)
        u = torch.where(keep_back[:, None, None], u2, u)
        cu = torch.where(keep_back[:, None, None], cu2, cu)
        kept = kept | (k_oh & keep_back[:, None])
        s_next = torch.where(targets & (step_of < s[:, None]), step_of,
                             -1).amax(1)
        s = torch.where(run, s_next, s)
        fb_iters = fb_iters + run.long()
    targets = targets & ~kept
    stats = torch.stack([(cand_q >= 0).sum(1), pops, fb_iters,
                         kept.sum(1)], dim=1).to(torch.int32)
    return targets, feasible, reason, stats


def solve_fair_plain(topo, usage, cohort_usage, gq, gf, gr, gc, chain_local,
                     requests, frs_np, cand_idx, cand_ql, cand_usage_table,
                     cand_prio_table, threshold_active, threshold,
                     has_cohort, cand_rank, cq_count, cq_order, base_other,
                     floor_ratio, floor_any, weight, lendable,
                     strat: tuple):
    """The vmap of kueue_tpu/solver/fairpreempt.py:210 written out as a
    batch dimension, PREEMPT_PLAIN_CHUNK problems at a time; each
    problem's forward loop and fill-back freeze once it has converged, as
    the vmapped while_loops do. strat = (strategy 0 is S2-a, a retry pass
    exists, strategy 1 is S2-a) (fairpreempt.strategy_flags). Returns
    (targets[B,K] bool, feasible[B] bool, reasons[B,K] int8, stats[B,4]
    int32)."""
    B, K = cand_ql.shape
    dev = usage.device
    targets = torch.zeros((B, K), dtype=torch.bool, device=dev)
    feasible = torch.zeros(B, dtype=torch.bool, device=dev)
    reasons = torch.zeros((B, K), dtype=torch.int8, device=dev)
    stats = torch.zeros((B, 4), dtype=torch.int32, device=dev)
    per_problem = (gq, gf, gr, gc, chain_local, requests, frs_np, cand_idx,
                   cand_ql)
    rest = (threshold_active, threshold, has_cohort, cand_rank, cq_count,
            cq_order, base_other, floor_ratio, floor_any, weight, lendable)
    for s in range(0, B, PREEMPT_PLAIN_CHUNK):
        e = min(B, s + PREEMPT_PLAIN_CHUNK)
        out = _solve_fair_chunk(
            topo, usage, cohort_usage, *(a[s:e] for a in per_problem),
            cand_usage_table, cand_prio_table, *(a[s:e] for a in rest),
            tuple(strat))
        targets[s:e], feasible[s:e], reasons[s:e], stats[s:e] = out
    return targets, feasible, reasons, stats


# The shared memory a solve_fair block may take for its problem's arena
# (read at each call, so a test can shrink it to force the global form);
# the H100 opts a block in to 227 KB.
FAIR_SMEM = 200 * 1024


def fair_arena_bytes(QL: int, RF: int, CL: int, DC: int, K: int,
                     stage: bool) -> int:
    """Bytes of one problem's arena in csrc/solve_fair.cu (sf_layout).
    int64: the usage, nominal, guaranteed and base_other rows of the local
    CQs, the usage, guaranteed, subtree and borrow-limit rows of the local
    cohorts, lendable, the request, the preemptor CQ's borrow limit, a
    delta row and lendable's multipliers, the fill-back's saved rows, the
    shares, weights, floors and the weights' multipliers, and with `stage`
    the candidates' usage rows; int32: each slot's flavor, resource,
    same-resource mask and multiplier shift, the CQs' global ids, the
    cohorts', the cohort chains, the table's CSR, each CQ's position, heap
    flag, first refused candidate, count, order and weight shift, the (CQ,
    rank) table, the removal log (candidate and CQ), the candidates' table
    rows and CQs, and with `stage` their priorities; bytes: the
    needs-preemption slots and floor_any; rounded up to 16."""
    w64 = 4 * QL * RF + 4 * CL * RF + 5 * RF + (1 + DC) * RF + 4 * QL \
        + (K * RF if stage else 0)
    w32 = 4 * RF + QL + CL + QL * DC + QL + 1 + 6 * QL + 5 * K \
        + (K if stage else 0)
    return -(-(8 * w64 + 4 * w32 + RF + QL) // 16) * 16


# csrc/solve_fair.cu's forms, by their codes
FAIR_FORMS = ("shared", "global")


def fair_form(QL: int, RF: int, CL: int, DC: int, K: int,
              smem: int = None) -> str:
    """The arena's place: "shared" (all of it, the candidate rows staged,
    in the block's shared memory) or "global" (a slice of global scratch a
    block, the candidate rows read in place from the table)."""
    smem = FAIR_SMEM if smem is None else smem
    if fair_arena_bytes(QL, RF, CL, DC, K, True) <= smem:
        return "shared"
    return "global"


def fair_grid(B: int, form: str, blocks_per_sm: int, sms: int) -> int:
    """Blocks of solve_fair's launch: one a problem (a block is one warp)
    with the arena in shared memory; the persistent grid the card holds
    at once with it in global scratch (a slice a block)."""
    if form == "shared":
        return B
    return max(1, min(B, max(blocks_per_sm, 1) * sms))


@functools.lru_cache(maxsize=64)
def _fair_plan_card(QL: int, RF: int, CL: int, DC: int, K: int,
                    form: int) -> tuple:
    """csrc's solve_fair_plan for a shape and form, once a process: (arena
    bytes, registers, local bytes, blocks an SM, the largest dynamic
    shared memory a block, 1 for the narrow instance)."""
    out = (ctypes.c_longlong * 6)()
    fn = _build.entry("solve_fair", 1, 6, "solve_fair_plan")
    rc = fn(ctypes.cast(out, ctypes.c_void_p), *(ctypes.c_longlong(x) for x in
            (QL, RF, CL, DC, K, form)), None)
    if rc != 0:
        raise RuntimeError(f"solve_fair_plan failed: CUDA error {rc}")
    return tuple(out)


def fair_plan(B: int, K: int, QL: int, RF: int, CL: int, DC: int,
              device=None) -> dict:
    """solve_fair's launch plan on the current card: the form, the arena's
    bytes (checked against csrc's sf_layout), the dynamic shared memory a
    block, blocks an SM by occupancy, the grid, the kernel's registers and
    local bytes a thread, and whether the lane-a-CQ instance runs (QL <=
    32)."""
    form = fair_form(QL, RF, CL, DC, K)
    in_smem = form == "shared"
    out = _fair_plan_card(QL, RF, CL, DC, K, FAIR_FORMS.index(form))
    arena = fair_arena_bytes(QL, RF, CL, DC, K, in_smem)
    if out[0] != arena:
        raise RuntimeError(f"solve_fair: csrc's arena of {out[0]} bytes "
                           f"differs from fair_arena_bytes' {arena}")
    if in_smem and arena > out[4]:
        raise RuntimeError(f"solve_fair: FAIR_SMEM {FAIR_SMEM} is above the "
                           f"card's {out[4]} bytes a block")
    sms = _sm_count(torch.cuda.current_device() if device is None
                    else device.index)
    return {"form": form, "arena_bytes": arena,
            "smem_bytes_per_block": arena if in_smem else 0,
            "blocks_per_sm": out[3], "grid": fair_grid(B, form, out[3], sms),
            "threads": 32, "registers": out[1], "local_bytes": out[2],
            "lane_per_cq": bool(out[5])}


def solve_fair(topo, usage, cohort_usage, gq, gf, gr, gc, chain_local,
               requests, frs_np, cand_idx, cand_ql, cand_usage_table,
               cand_prio_table, threshold_active, threshold, has_cohort,
               cand_rank, cq_count, cq_order, base_other, floor_ratio,
               floor_any, weight, lendable, strat: tuple):
    """K11: solve_fair_plain on the card (csrc/solve_fair.cu), in the form
    fair_plan picks (`solve_fair.last_plan`)."""
    args = (gq, gf, gr, gc, chain_local, requests, frs_np, cand_idx,
            cand_ql, cand_usage_table, cand_prio_table, threshold_active,
            threshold, has_cohort, cand_rank, cq_count, cq_order,
            base_other, floor_ratio, floor_any, weight, lendable)
    if _is_cpu(usage):
        return solve_fair_plain(topo, usage, cohort_usage, *args, strat)
    B, QL = gq.shape
    RF = gf.shape[1]
    CL = gc.shape[1]
    K = cand_ql.shape[1]
    DC = chain_local.shape[2]
    if chain_local.shape[:2] != (B, QL) or cand_idx.shape != (B, K) \
            or cand_rank.shape != (B, K) or base_other.shape != (B, QL, RF) \
            or cand_usage_table.shape[1] != RF or lendable.shape != (B, RF):
        raise ValueError("solve_fair: inconsistent problem shapes")
    s0, has_retry, s1 = (int(bool(x)) for x in strat)
    dev = usage.device
    # the outputs' defaults: what a padding problem or candidate keeps
    targets = torch.zeros((B, K), dtype=torch.bool, device=dev)
    feasible = torch.zeros(B, dtype=torch.bool, device=dev)
    reasons = torch.zeros((B, K), dtype=torch.int8, device=dev)
    stats = torch.zeros((B, 4), dtype=torch.int32, device=dev)
    plan = fair_plan(B, K, QL, RF, CL, DC, dev)
    scratch = torch.empty(plan["grid"] * plan["arena_bytes"]
                          if plan["form"] == "global" else 16,
                          dtype=torch.uint8, device=dev)
    _launch("solve_fair", [
        _ptr(topo["nominal"], torch.int64, "nominal"),
        _ptr(topo["guaranteed"], torch.int64, "guaranteed"),
        _ptr(topo["borrow_limit"], torch.int64, "borrow_limit"),
        _ptr(topo["cohort_subtree"], torch.int64, "cohort_subtree"),
        _ptr(topo["cohort_guaranteed"], torch.int64, "cohort_guaranteed"),
        _ptr(topo["cohort_borrow_limit"], torch.int64, "cohort_borrow_limit"),
        _ptr(usage, torch.int64, "usage"),
        _ptr(cohort_usage, torch.int64, "cohort_usage"),
        _ptr(gq, torch.int32, "gq"),
        _ptr(gf, torch.int32, "gf"),
        _ptr(gr, torch.int32, "gr"),
        _ptr(gc, torch.int32, "gc"),
        _ptr(chain_local, torch.int32, "chain_local"),
        _ptr(requests, torch.int64, "requests"),
        _ptr(frs_np, torch.bool, "frs_np"),
        _ptr(cand_idx, torch.int32, "cand_idx"),
        _ptr(cand_ql, torch.int16, "cand_ql"),
        _ptr(cand_usage_table, torch.int64, "cand_usage"),
        _ptr(cand_prio_table, torch.int32, "cand_prio"),
        _ptr(threshold_active, torch.bool, "threshold_active"),
        _ptr(threshold, torch.int64, "threshold"),
        _ptr(has_cohort, torch.bool, "has_cohort"),
        _ptr(cand_rank, torch.int32, "cand_rank"),
        _ptr(cq_count, torch.int32, "cq_count"),
        _ptr(cq_order, torch.int32, "cq_order"),
        _ptr(base_other, torch.int64, "base_other"),
        _ptr(floor_ratio, torch.int64, "floor_ratio"),
        _ptr(floor_any, torch.bool, "floor_any"),
        _ptr(weight, torch.int64, "weight"),
        _ptr(lendable, torch.int64, "lendable"),
        _ptr(scratch, torch.uint8, "scratch"),
        _ptr(targets, torch.bool, "targets"),
        _ptr(feasible, torch.bool, "feasible"),
        _ptr(reasons, torch.int8, "reasons"),
        _ptr(stats, torch.int32, "stats"),
    ], [B, K, QL, RF, CL, DC, usage.shape[1], usage.shape[2], s0,
        has_retry, s1, plan["grid"], FAIR_FORMS.index(plan["form"]),
        plan["arena_bytes"]], dev)
    solve_fair.launches += 1
    solve_fair.last_plan = plan
    return targets, feasible, reasons, stats


solve_fair.last_plan = None  # the last launch's fair_plan


def fair_tick(device, iters: int = 4096) -> float:
    """Clock cycles of a pop's least step (csrc/solve_fair.cu
    solve_fair_tick_kernel: the keyed pick's four reductions and a share's
    64-bit max, each on the last one's result), the least of three runs."""
    best = None
    for _ in range(3):
        out = torch.zeros(2, dtype=torch.int64, device=device)
        _launch("solve_fair", [out.data_ptr()], [iters], device,
                symbol="solve_fair_tick_launch")
        cycles = out[0].item() / iters
        best = cycles if best is None else min(best, cycles)
    return best


# ---------------------------------------------------------------------------
# score_cluster_columns: MultiKueue placement in the admit order
# ---------------------------------------------------------------------------
#
# Replaces kueue_tpu/solver/kernel.py:614 score_cluster_columns_impl.
# Remote worker clusters are capacity columns ccap [K,F,R] (coffer: the
# (flavor, resource) pairs a cluster offers; cactive: the reachable
# clusters; mk_cq: the CQs that carry a MultiKueue check). Walking the
# cycle's global admit order, each admitted row of such a CQ takes the
# first active cluster k with a flavor f whose remaining column covers
# its total request (the sum over active podsets) in every requested
# resource, offering at least one; the first such f is debited for later
# rows. Output mk_cluster [W] int32, -1 where nothing was placed. The
# host twin is encode.place_remote_dicts. Bound on the H100: latency —
# the placements chain, over a few KB. Design (csrc/cluster_cols.cu): a
# column-stage pipeline in one block. Each live column c = k*F + f is a
# stage holding its remaining amounts; the rows that take part flow
# through the stages in admit order and ascending c, and the first stage
# that fits an untaken row takes it, so the result is the sequential
# scan's. The stages are split among up to 32 warps (4 each, more when
# the warps run out); a warp tests a chunk of 32 rows against a stage
# with one ballot, takes the earliest that fits, tests the later ones
# again, and hands the chunk's untaken mask to the next warp: a chain of
# about S + N/32 chunk steps (S live columns, N rows) plus the takes. Any
# R and any K*F: the requests sit in registers for R <= 16 (R padded to
# 1, 2, 4, 8 or 16), else they are read from the block's arena, which is
# in shared memory when it fits and in global scratch otherwise
# (cluster_plan).

def score_cluster_columns_plain(ccap, coffer, cactive, mk_cq, requests,
                                podset_active, wl_cq, order, admitted):
    """The JAX scan, step by step over the rows that take part (admitted,
    of a MultiKueue CQ) in admit order: one masked fit test over [K,F,R]
    and one debit each. Returns mk_cluster [W] int32."""
    W = requests.shape[0]
    K, F, R = ccap.shape
    treq = torch.where(podset_active[:, :, None], requests, 0).sum(1)
    mk = mk_cq[wl_cq.long()] & admitted
    order = order.long()
    rem = ccap.clone().reshape(K * F, R)
    offer = coffer.reshape(K * F, R)
    active = cactive.repeat_interleave(F)
    out = torch.full((W,), -1, dtype=torch.int32, device=requests.device)
    for w in order[mk[order]].tolist():
        req = treq[w]
        has = req > 0
        fit = (((req <= rem) & offer) | ~has).all(1) & \
            (offer & has).any(1) & active                      # [K*F]
        c = torch.argmax(fit.to(torch.int32))
        place = fit[c]
        rem[c] -= torch.where(place, req, 0)
        out[w] = torch.where(place, c // F, -1).to(torch.int32)
    return out


# cluster_plan's results by (card, W, R, K, F): the plan's attribute
# queries took about a millisecond of host time a call on the H100, more
# than the kernel itself
_CLUSTER_PLANS: dict = {}


def cluster_plan(W: int, R: int, K: int, F: int) -> dict:
    """score_cluster_columns' launch plan on the current card (csrc's
    cluster_cols_plan, host calls only, kept per shape): threads of the
    one block, the arena's bytes, its rule ("shared": dynamic shared
    memory; "global": global scratch), the register form's R, padded to
    a power of two (0: the requests read from the arena), the kernel's
    registers and local bytes a thread, the SM clock in kHz, and the
    stages a warp of the pipeline owns (a constant of the source)."""
    key = (torch.cuda.current_device(), W, R, K, F)
    plan = _CLUSTER_PLANS.get(key)
    if plan is None:
        out = (ctypes.c_longlong * 8)()
        fn = _build.entry("cluster_cols", 1, 4, "cluster_cols_plan")
        rc = fn(ctypes.cast(out, ctypes.c_void_p),
                *(ctypes.c_longlong(x) for x in (W, R, K, F)), None)
        if rc != 0:
            raise RuntimeError(f"cluster_cols_plan failed: CUDA error {rc}")
        plan = _CLUSTER_PLANS[key] = {
            "threads": out[0], "arena_bytes": out[1],
            "rule": "shared" if out[2] else "global", "register_r": out[3],
            "registers": out[4], "local_bytes": out[5], "clock_khz": out[6],
            "warp_stages": out[7]}
    return plan


def score_cluster_columns(ccap, coffer, cactive, mk_cq, requests,
                          podset_active, wl_cq, order, admitted):
    """K12. On the card, `score_cluster_columns.last_plan` keeps the
    launch's cluster_plan and `last_stats` its device tensor (N, S, G,
    stages a warp): the rows in the pipeline, the live columns (the
    stages), the warps of stages and the most stages a warp holds."""
    if _is_cpu(requests):
        return score_cluster_columns_plain(ccap, coffer, cactive, mk_cq,
                                           requests, podset_active, wl_cq,
                                           order, admitted)
    W, P, R = requests.shape
    K, F, _ = ccap.shape
    dev = requests.device
    plan = cluster_plan(W, R, K, F)
    out = torch.empty(W, dtype=torch.int32, device=dev)
    stats = torch.empty(4, dtype=torch.int32, device=dev)
    scratch = torch.empty(plan["arena_bytes"] if plan["rule"] == "global"
                          else 16, dtype=torch.uint8, device=dev)
    _launch("cluster_cols", [
        _ptr(ccap, torch.int64, "ccap"),
        _ptr(coffer, torch.bool, "coffer"),
        _ptr(cactive, torch.bool, "cactive"),
        _ptr(mk_cq, torch.bool, "mk_cq"),
        _ptr(requests, torch.int64, "requests"),
        _ptr(podset_active, torch.bool, "podset_active"),
        _ptr(wl_cq, torch.int32, "wl_cq"),
        _ptr(order, torch.int32, "order"),
        _ptr(admitted, torch.bool, "admitted"),
        _ptr(out, torch.int32, "mk_cluster"),
        _ptr(scratch, torch.uint8, "scratch"),
        _ptr(stats, torch.int32, "stats"),
    ], [W, P, R, K, F, plan["threads"], plan["arena_bytes"],
        int(plan["rule"] == "shared")], dev)
    score_cluster_columns.launches += 1
    score_cluster_columns.last_plan = plan
    score_cluster_columns.last_stats = stats
    return out


score_cluster_columns.last_plan = None
score_cluster_columns.last_stats = None


# ---------------------------------------------------------------------------
# mesh_combine: the sharded cycle's reduction
# ---------------------------------------------------------------------------
#
# Replaces kueue_tpu/parallel/mesh.py:320-323. After Phase B over its own
# domain columns a rank packs one int64 buffer [W + Q*F*R + C*F*R] =
# (admitted as 0/1, usage_out - usage, cohort_out - cohort_usage), so
# that it makes one all-reduce and not three; after the sum over the
# mesh (the domains are disjoint, so every element has at most one
# rank's non-zero value) unpack gives admitted = buf[:W] > 0 and the
# deltas added to the pre-cycle usage. Bound on the H100: bytes, each
# element read and written once. Design (csrc/mesh_combine.cu): two
# entries, pack and unpack, one thread per buffer element in a
# grid-stride loop.

def combine_pack_plain(admitted, usage, usage_out, cohort_usage, cohort_out):
    """The torch chain: two subtracts, a cast and a cat. Returns the
    buffer [W + Q*F*R + C*F*R] int64."""
    return torch.cat([admitted.to(torch.int64),
                      (usage_out - usage).reshape(-1),
                      (cohort_out - cohort_usage).reshape(-1)])


def combine_pack(admitted, usage, usage_out, cohort_usage, cohort_out):
    if _is_cpu(usage):
        return combine_pack_plain(admitted, usage, usage_out, cohort_usage,
                                  cohort_out)
    W, NU, NC = admitted.shape[0], usage.numel(), cohort_usage.numel()
    if usage_out.shape != usage.shape \
            or cohort_out.shape != cohort_usage.shape:
        raise ValueError("mesh_combine: the usage outputs do not match the "
                         "inputs' shapes")
    buf = torch.empty(W + NU + NC, dtype=torch.int64, device=usage.device)
    _launch("mesh_combine", [
        _ptr(admitted, torch.bool, "admitted"),
        _ptr(usage, torch.int64, "usage"),
        _ptr(usage_out, torch.int64, "usage_out"),
        _ptr(cohort_usage, torch.int64, "cohort_usage"),
        _ptr(cohort_out, torch.int64, "cohort_out"),
        _ptr(buf, torch.int64, "buf"),
    ], [W, NU, NC], usage.device, "mesh_combine_pack_launch")
    combine_pack.launches += 1
    return buf


def combine_unpack_plain(buf, usage, cohort_usage):
    """Returns (admitted[W], usage', cohort_usage') from a summed
    buffer."""
    NU, NC = usage.numel(), cohort_usage.numel()
    W = buf.shape[0] - NU - NC
    return (buf[:W] > 0, usage + buf[W:W + NU].reshape(usage.shape),
            cohort_usage + buf[W + NU:].reshape(cohort_usage.shape))


def combine_unpack(buf, usage, cohort_usage):
    if _is_cpu(buf):
        return combine_unpack_plain(buf, usage, cohort_usage)
    NU, NC = usage.numel(), cohort_usage.numel()
    W = buf.shape[0] - NU - NC
    if W < 0:
        raise ValueError("mesh_combine: the buffer is shorter than the usage")
    dev = buf.device
    admitted = torch.empty(W, dtype=torch.bool, device=dev)
    usage_out = torch.empty_like(usage)
    cohort_out = torch.empty_like(cohort_usage)
    _launch("mesh_combine", [
        _ptr(buf, torch.int64, "buf"),
        _ptr(usage, torch.int64, "usage"),
        _ptr(cohort_usage, torch.int64, "cohort_usage"),
        _ptr(admitted, torch.bool, "admitted"),
        _ptr(usage_out, torch.int64, "usage_out"),
        _ptr(cohort_out, torch.int64, "cohort_out"),
    ], [W, NU, NC], dev, "mesh_combine_unpack_launch")
    combine_unpack.launches += 1
    return admitted, usage_out, cohort_out


# kernel name (solver/csrc/<name>.cu) -> its wrappers, one per entry
KERNEL_WRAPPERS = {"avail": (avail,), "phase_a": (phase_a,),
                   "drf_share": (drf_share,), "order": (order_csr,),
                   "phase_b": (phase_b,), "pack": (pack,),
                   "deltas": (apply_state_deltas,),
                   "arena_scatter": (scatter_arena_rows,),
                   "arena_gather": (gather_arena,),
                   "solve_preempt": (solve_preempt,),
                   "solve_fair": (solve_fair,),
                   "cluster_cols": (score_cluster_columns,),
                   "mesh_combine": (combine_pack, combine_unpack),
                   "global_scan": (global_scan,)}
reset_launch_counts()


# ---------------------------------------------------------------------------
# The fused cycle
# ---------------------------------------------------------------------------

def solve_cycle_fused(topo, usage, cohort_usage, requests, podset_active,
                      wl_cq, priority, timestamp, eligible, solvable,
                      num_podsets: int, max_rank: int = 0,
                      fair_sharing: bool = False, start_rank=None,
                      compact: bool = True, cluster_args=None) -> dict:
    """One fit-mode admission cycle, the port of
    kueue_tpu/solver/kernel.py:476 solve_cycle_fused_impl. With
    fair_sharing the admit order takes each head's DRF share (drf_share)
    as its third key; without, the share is 0. Returns
    admitted/chosen/borrows/chosen_borrow/fit/usage/cohort_usage, or
    dec_pr/dec_bits in place of the five decision arrays when compact.
    With cluster_args (ccap, coffer, cactive, mk_cq tensors,
    encode.cluster_args_device), also mk_cluster [W] int32: each admitted
    MultiKueue head's remote cluster column (score_cluster_columns), -1
    for none. max_rank is taken for signature parity and unused: the CSR
    of the order needs no per-domain bound."""
    del max_rank
    avail_q = avail(topo, usage, cohort_usage)
    fit, borrows, chosen, chosen_borrow, asg_usage = phase_a(
        topo, avail_q, usage, requests, podset_active, wl_cq, eligible,
        solvable, num_podsets, start_rank)
    share = drf_share(topo, usage, asg_usage, wl_cq) if fair_sharing \
        else None
    offsets, members, order = order_csr(
        topo, fit, borrows, priority, timestamp, wl_cq, share,
        with_order=cluster_args is not None)
    admitted, usage_out, cohort_out = phase_b(
        topo, usage, cohort_usage, asg_usage, fit, wl_cq, offsets, members)
    out = {"usage": usage_out, "cohort_usage": cohort_out}
    if cluster_args is not None:
        out["mk_cluster"] = score_cluster_columns(
            *cluster_args, requests, podset_active, wl_cq, order, admitted)
    if compact:
        out["dec_pr"], out["dec_bits"] = pack(chosen, chosen_borrow, fit,
                                              admitted, borrows)
    else:
        out.update(admitted=admitted, chosen=chosen, borrows=borrows,
                   chosen_borrow=chosen_borrow, fit=fit)
    return out


def solve_preemptions(topo, usage, cohort_usage, preempt_args=None,
                      fair_preempt_args=None, fs_strategies: tuple = ()):
    """K9 on preempt_args (over its active_slots when it is a
    preempt.PreemptArgs) and K11 on fair_preempt_args (each when given),
    launched back to back against the same usage, with no sync between
    them. Returns the dict of their outputs (preempt_targets,
    preempt_feasible, preempt_stats; fair_targets, fair_feasible,
    fair_reasons, fair_stats)."""
    out = {}
    if preempt_args is not None:
        (out["preempt_targets"], out["preempt_feasible"],
         out["preempt_stats"]) = solve_preempt(
             topo, usage, cohort_usage, *preempt_args,
             active_slots=getattr(preempt_args, "active_slots", None))
    if fair_preempt_args is not None:
        (out["fair_targets"], out["fair_feasible"], out["fair_reasons"],
         out["fair_stats"]) = solve_fair(topo, usage, cohort_usage,
                                         *fair_preempt_args,
                                         strat=fs_strategies)
    return out


def solve_cycle_with_preempt(topo, usage, cohort_usage, requests,
                             podset_active, wl_cq, priority, timestamp,
                             eligible, solvable, preempt_args,
                             num_podsets: int, max_rank: int = 0,
                             fair_sharing: bool = False, start_rank=None,
                             fair_preempt_args=None,
                             fs_strategies: tuple = (),
                             compact: bool = True,
                             cluster_args=None) -> dict:
    """The mixed admission and preemption cycle, the port of
    kueue_tpu/solver/kernel.py:547 solve_cycle_with_preempt_impl: the
    fused fit cycle (with its cluster_args) plus solve_preempt on
    preempt_args and solve_fair on fair_preempt_args (either may be None;
    fs_strategies are fairpreempt.strategy_flags), on the same input
    usage. Preemption simulates against the usage from before the cycle,
    as the reference's nominate-time GetTargets does
    (scheduler.go:404-441): it never sees the cycle's own admissions
    (phase_b writes copies), so they are independent. Adds
    preempt_targets, preempt_feasible, preempt_stats and fair_targets,
    fair_feasible, fair_reasons, fair_stats to the fused cycle's
    outputs."""
    out = solve_cycle_fused(topo, usage, cohort_usage, requests,
                            podset_active, wl_cq, priority, timestamp,
                            eligible, solvable, num_podsets=num_podsets,
                            max_rank=max_rank, fair_sharing=fair_sharing,
                            start_rank=start_rank, compact=compact,
                            cluster_args=cluster_args)
    out.update(solve_preemptions(topo, usage, cohort_usage, preempt_args,
                                 fair_preempt_args, fs_strategies))
    return out


def solve_cycle_resident(topo, usage, cohort_usage, deltas, requests,
                         podset_active, wl_cq, priority, timestamp, eligible,
                         solvable, num_podsets: int, max_rank: int = 0,
                         fair_sharing: bool = False, start_rank=None,
                         preempt_args=None, fair_preempt_args=None,
                         fs_strategies: tuple = (),
                         compact: bool = True, cluster_args=None) -> dict:
    """The device-resident cycle (kueue_tpu/solver/kernel.py:808
    solve_cycle_resident_impl): the sparse correction prologue, applied
    IN PLACE to the resident usage/cohort_usage, then the fused cycle
    (with preempt_args or fair_preempt_args, solve_cycle_with_preempt on
    the corrected usage), whose usage/cohort_usage outputs are the next
    cycle's resident state. deltas: None or the tensors (dq, df, dr, dv,
    lvl_c, lvl_seg)."""
    if deltas is not None:
        apply_state_deltas(topo, usage, cohort_usage, *deltas)
    kwargs = dict(num_podsets=num_podsets, max_rank=max_rank,
                  fair_sharing=fair_sharing, start_rank=start_rank,
                  compact=compact, cluster_args=cluster_args)
    batch = (requests, podset_active, wl_cq, priority, timestamp, eligible,
             solvable)
    if preempt_args is None and fair_preempt_args is None:
        return solve_cycle_fused(topo, usage, cohort_usage, *batch, **kwargs)
    return solve_cycle_with_preempt(topo, usage, cohort_usage, *batch,
                                    preempt_args,
                                    fair_preempt_args=fair_preempt_args,
                                    fs_strategies=fs_strategies, **kwargs)


def solve_cycle_resident_arena(topo, usage, cohort_usage, deltas, arena,
                               slots, num_podsets: int, max_rank: int = 0,
                               fair_sharing: bool = False, start_rank=None,
                               preempt_args=None, fair_preempt_args=None,
                               fs_strategies: tuple = (),
                               compact: bool = True,
                               cluster_args=None) -> dict:
    """The arena-resident cycle (kueue_tpu/solver/kernel.py:909
    solve_cycle_resident_arena_impl): gather the heads' rows from the
    device twin by slot (-1 = padding), then the resident cycle, whose
    cluster scan reads the gathered rows (padding is never admitted, so
    it never places)."""
    batch = gather_arena(arena, slots)
    return solve_cycle_resident(topo, usage, cohort_usage, deltas, *batch,
                                num_podsets=num_podsets, max_rank=max_rank,
                                fair_sharing=fair_sharing,
                                start_rank=start_rank,
                                preempt_args=preempt_args,
                                fair_preempt_args=fair_preempt_args,
                                fs_strategies=fs_strategies, compact=compact,
                                cluster_args=cluster_args)


def max_rank_bound(wl_cq, cq_cohort, cohort_root) -> int:
    """The JAX package's host-side bound on batch workloads per conflict
    domain, bucketed to a power of four (kueue_tpu/solver/kernel.py:653)."""
    wl_cq = np.asarray(wl_cq)
    cq_cohort = np.asarray(cq_cohort)
    cohort_of = cq_cohort[wl_cq]
    root_of = np.asarray(cohort_root)[np.maximum(cohort_of, 0)]
    C = len(np.asarray(cohort_root))
    domain = np.where(cohort_of >= 0, root_of, C + wl_cq)
    raw = int(np.bincount(domain).max()) if len(domain) else 1
    b = 8
    while b < raw:
        b *= 4
    return b


# ---------------------------------------------------------------------------
# Phase A alone, the order grid, Phase B over it, and the global scan
# ---------------------------------------------------------------------------
#
# The JAX package's remaining cycle programs: Phase A on its own
# (kueue_tpu/solver/kernel.py:405 solve_phase_a_impl, jit :471), the
# engine of batched partial admission; Phase B over a host-built [L,D]
# order grid (:420 solve_phase_b_domains_impl, jit :473, with
# build_order_grid :671) and the three-step cycle that composes them
# (:724 solve_cycle_cohort_parallel); and the global W-step scan (:250
# solve_cycle_impl, jit :313), the oracle the cohort-parallel cycles are
# held to. No new kernel but global_scan: the rest launch avail, phase_a,
# drf_share, order and phase_b.

def solve_phase_a(topo, usage, cohort_usage, requests, podset_active, wl_cq,
                  eligible, solvable, num_podsets: int,
                  fair_sharing: bool = False, start_rank=None) -> tuple:
    """Phase A only (kueue_tpu/solver/kernel.py:405): avail, phase_a and,
    with fair_sharing, drf_share. Returns (fit[W], borrows[W],
    chosen[W,NP,R], chosen_borrow[W,NP,R], asg_usage[W,F,R], share[W]),
    share zero with fair sharing off."""
    avail_q = avail(topo, usage, cohort_usage)
    fit, borrows, chosen, chosen_borrow, asg_usage = phase_a(
        topo, avail_q, usage, requests, podset_active, wl_cq, eligible,
        solvable, num_podsets, start_rank)
    share = drf_share(topo, usage, asg_usage, wl_cq) if fair_sharing else \
        torch.zeros(fit.shape[0], dtype=torch.int64, device=fit.device)
    return fit, borrows, chosen, chosen_borrow, asg_usage, share


def build_order_grid(fit, borrows, priority, timestamp, wl_cq, cq_cohort,
                     num_cohorts: int, cohort_root=None, share=None):
    """Host-side: global admit order -> [L,D] grid of workload indices
    (kueue_tpu/solver/kernel.py:671, numpy in both packages).

    Domain = root cohort (the whole tree is one capacity domain for
    hierarchical cohorts), or a synthetic per-CQ domain for cohortless
    CQs. Within each domain, workloads keep their global-order rank; rows
    pad with -1; workloads that did not fit are left out (they never
    admit). L is bucketed to a power of four from 8. Subnormal
    timestamps keep their order by value here: numpy does not flush
    them, in this package or the JAX one, unlike admit_order."""
    fit = np.asarray(fit)
    borrows = np.asarray(borrows)
    priority = np.asarray(priority)
    timestamp = np.asarray(timestamp)
    wl_cq = np.asarray(wl_cq)
    cq_cohort = np.asarray(cq_cohort)

    share = (np.zeros(len(wl_cq), np.int64) if share is None
             else np.asarray(share))
    order = np.lexsort((timestamp, -priority, share,
                        borrows.astype(np.int32), (~fit).astype(np.int32)))
    order = order[fit[order]]
    cohort_of_wl = cq_cohort[wl_cq]
    if cohort_root is not None:
        cohort_of_wl = np.where(
            cohort_of_wl >= 0,
            np.asarray(cohort_root)[np.maximum(cohort_of_wl, 0)], -1)
    # static domain space: all cohorts + one synthetic domain per CQ
    domain = np.where(cohort_of_wl >= 0, cohort_of_wl,
                      num_cohorts + wl_cq).astype(np.int64)
    D = num_cohorts + len(cq_cohort)
    # rank of each workload within its domain, in global order: stable
    # sort by domain, position minus segment start
    dom_of_sorted = domain[order]
    n = len(order)
    ranks = np.zeros(n, np.int64)
    if n:
        perm = np.argsort(dom_of_sorted, kind="stable")
        sd = dom_of_sorted[perm]
        pos = np.arange(n)
        first = np.r_[True, sd[1:] != sd[:-1]]
        seg_start = np.maximum.accumulate(np.where(first, pos, 0))
        ranks[perm] = pos - seg_start
    raw_l = max(1, int(ranks.max()) + 1) if n else 1
    L = 8
    while L < raw_l:
        L *= 4
    grid = np.full((L, D), -1, np.int32)
    grid[ranks, dom_of_sorted] = order.astype(np.int32)
    return grid


def grid_csr(grid):
    """An [L,D] order grid as the CSR phase_b walks: offsets[D+1] int32,
    and members int32, each column's valid rows (>= 0) in row order."""
    cols = grid.t()                                        # [D,L]
    valid = cols >= 0
    offsets = torch.zeros(cols.shape[0] + 1, dtype=torch.int32,
                          device=grid.device)
    offsets[1:] = torch.cumsum(valid.sum(dim=1), 0)
    return offsets, cols[valid].to(torch.int32)


def solve_phase_b_domains(topo, usage, cohort_usage, asg_usage, fit, wl_cq,
                          grid) -> tuple:
    """Phase B over an [L,D] order grid (kueue_tpu/solver/kernel.py:420):
    row l holds the l-th workload of every conflict domain, -1 padding.
    The grid becomes phase_b's CSR (grid_csr), so each domain's members
    keep their row order. Returns (admitted[W], usage', cohort_usage')."""
    if isinstance(grid, np.ndarray):
        grid = torch.from_numpy(grid)
    offsets, members = grid_csr(grid.to(fit.device))
    return phase_b(topo, usage, cohort_usage, asg_usage, fit, wl_cq,
                   offsets, members)


def _host_topo(topo_np, name: str) -> np.ndarray:
    a = topo_np[name] if isinstance(topo_np, dict) else getattr(topo_np, name)
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def solve_cycle_cohort_parallel(topo_dev, topo_np, usage, cohort_usage,
                                requests, podset_active, wl_cq, priority,
                                timestamp, eligible, solvable,
                                num_podsets: int, fair_sharing: bool = False,
                                start_rank=None) -> dict:
    """The three-step cycle (kueue_tpu/solver/kernel.py:724): Phase A on
    the device, the order grid on the host (topo_np: the encoded
    topology, an object or a dict of numpy arrays), Phase B on the
    device. The same outputs as solve_cycle. topo_np may also be the
    device dict itself (its arrays are copied to the host)."""
    fit, borrows, chosen, chosen_borrow, asg_usage, share = solve_phase_a(
        topo_dev, usage, cohort_usage, requests, podset_active, wl_cq,
        eligible, solvable, num_podsets, fair_sharing, start_rank)
    grid = build_order_grid(
        fit.cpu().numpy(), borrows.cpu().numpy(), priority.cpu().numpy(),
        timestamp.cpu().numpy(), wl_cq.cpu().numpy(),
        _host_topo(topo_np, "cq_cohort"),
        _host_topo(topo_np, "cohort_subtree").shape[0],
        cohort_root=_host_topo(topo_np, "cohort_root"),
        share=share.cpu().numpy() if fair_sharing else None)
    admitted, usage_out, cohort_out = solve_phase_b_domains(
        topo_dev, usage, cohort_usage, asg_usage, fit, wl_cq, grid)
    return {"admitted": admitted, "chosen": chosen, "borrows": borrows,
            "chosen_borrow": chosen_borrow, "fit": fit, "usage": usage_out,
            "cohort_usage": cohort_out}


def solve_cycle(topo, usage, cohort_usage, requests, podset_active, wl_cq,
                priority, timestamp, eligible, solvable, num_podsets: int,
                fair_sharing: bool = False, start_rank=None) -> dict:
    """One batched admission cycle by the global scan
    (kueue_tpu/solver/kernel.py:250 solve_cycle_impl): Phase A as
    solve_phase_a, the global admit order (order_csr's, with_order), then
    global_scan. Returns admitted/chosen/borrows/chosen_borrow/fit/usage/
    cohort_usage."""
    fit, borrows, chosen, chosen_borrow, asg_usage, share = solve_phase_a(
        topo, usage, cohort_usage, requests, podset_active, wl_cq, eligible,
        solvable, num_podsets, fair_sharing, start_rank)
    order = order_csr(topo, fit, borrows, priority, timestamp, wl_cq,
                      share if fair_sharing else None, with_order=True)[2]
    admitted, usage_out, cohort_out = global_scan(
        topo, usage, cohort_usage, asg_usage, fit, wl_cq, order)
    return {"admitted": admitted, "chosen": chosen, "borrows": borrows,
            "chosen_borrow": chosen_borrow, "fit": fit, "usage": usage_out,
            "cohort_usage": cohort_out}
