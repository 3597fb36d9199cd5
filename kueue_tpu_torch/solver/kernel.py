"""The fit-mode admission solve on the card: four hand-written CUDA
kernels and the library sort between them.

Counterpart of kueue_tpu/solver/kernel.py's `solve_cycle_fused_impl`
(the production single-chip program) with fair sharing, preemption,
device-resident state and MultiKueue columns left out. One cycle is:

1. `avail`   - availability of every CQ, walked down its cohort chain.
2. `phase_a` - flavor assignment for every head (vectorized over W).
3. the admit order - five stable `torch.sort` passes (library sort).
4. `phase_b` - the order-dependent admit with intra-cycle accounting,
   one thread block per conflict domain, reading a CSR of the order.
5. `pack`    - the compact decision wire format.

Each kernel has a wrapper, a plain PyTorch version in this module and a
launch counter (`<wrapper>.launches`, a plain int bumped once per
launch). A wrapper runs the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises. All quantities are
int64 (memory is in bytes) and decisions are bits, so the kernels and
the plain versions agree exactly.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from kueue_tpu_torch.solver import _build

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

# Widest resource axis phase_a keeps per podset in registers.
MAX_RESOURCES = 16


def topo_to_device(topo, device) -> dict:
    """Encoded topology (a `Topology` or a dict of numpy arrays, as either
    package's encoder or synth makes it) -> dict of tensors on `device`."""
    get = topo.get if isinstance(topo, dict) else (lambda k: getattr(topo, k))
    return {name: torch.from_numpy(np.ascontiguousarray(get(name))).to(device)
            for name in TOPO_FIELDS}


def state_to_device(usage, cohort_usage, device) -> tuple:
    """Encoded usage state (numpy int64 [Q,F,R], [C,F,R]) -> tensors."""
    return (torch.from_numpy(np.ascontiguousarray(usage)).to(device),
            torch.from_numpy(np.ascontiguousarray(cohort_usage)).to(device))


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


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


def _launch(name: str, ptrs: list, ints: list, device) -> None:
    fn = _build.entry(name, len(ptrs), len(ints))
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
# :221 _phase_a. Bound on the H100: bytes — the gathers of the head's CQ
# rows ([F,R] of nominal/avail/usage/offered) per podset and the
# [W,F,R] asg_usage write; the arithmetic is a few compares per (f,r).
# Design: one warp per workload, one lane per flavor (strided for
# F > 32), a serial loop over podsets. best_rank / best_rank_nb are warp
# min-reductions; the chosen flavor is the first (lowest-index) lane
# whose flavor is a candidate, as jnp.argmax on bool picks it.
# asg_usage accumulates in place per workload: each lane owns its
# flavors' entries.

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
    if R > MAX_RESOURCES:
        raise ValueError(f"phase_a kernel takes R <= {MAX_RESOURCES}, got {R}")
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
    return fit, borrows, chosen, chosen_borrow, asg_usage


# ---------------------------------------------------------------------------
# The admit order and the conflict-domain CSR (library sort + scan)
# ---------------------------------------------------------------------------

def admit_order(fit, borrows, priority, timestamp):
    """Stable lexsort on (timestamp, -priority, share, borrows, ~fit), the
    last key most significant (kueue_tpu/solver/kernel.py:498-501;
    reference: entryOrdering.Less, scheduler.go:643-672): one stable
    sort per key, least significant first. share is zero with fair
    sharing off."""
    share = torch.zeros_like(priority)
    order = torch.sort(timestamp, stable=True).indices
    for key in (-priority, share, borrows.to(torch.int32),
                (~fit).to(torch.int32)):
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def domain_csr(topo, wl_cq, order):
    """Conflict domains (root cohort, or C + q for a CQ with no cohort;
    kueue_tpu/solver/kernel.py:503-508) as a CSR of the admit order:
    offsets[D+1] and members[W], each domain's members in admit order."""
    C = topo["cohort_subtree"].shape[0]
    D = C + topo["cq_cohort"].shape[0]
    q = wl_cq.long()
    cohort_of = topo["cq_cohort"][q].long()
    root_of = topo["cohort_root"][cohort_of.clamp_min(0)].long()
    domain = torch.where(cohort_of >= 0, root_of, C + q)
    perm = torch.sort(domain[order], stable=True).indices
    members = order[perm].to(torch.int32)
    counts = torch.bincount(domain, minlength=D)
    offsets = torch.zeros(D + 1, dtype=torch.int32, device=wl_cq.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return offsets, members


# ---------------------------------------------------------------------------
# phase_b: the cohort-parallel admit
# ---------------------------------------------------------------------------
#
# Replaces kueue_tpu/solver/kernel.py:420 solve_phase_b_domains_impl with
# :82 _chain_avail and :106 _chain_add_usage. Bound on the H100:
# latency — each domain is a chain of dependent steps (one per member
# workload: availability walk, block-wide AND, usage update up the
# cohort chain); the bytes are small. Design: one thread block per
# conflict domain. Domains touch disjoint usage state
# (kueue_tpu/solver/kernel.py:396-403), so blocks never wait on each
# other; a block walks its own members in admit order with one thread
# per (f,r) (each thread only ever touches its own (f,r) column) and
# __syncthreads_and for still_fits. The TPU's dense [L,D] grid is not
# built: the kernel reads the CSR from domain_csr. usage/cohort_usage
# are updated in place on copies of the inputs.

def phase_b_plain(topo, usage, cohort_usage, asg_usage, fit, wl_cq,
                  offsets, members):
    """Returns (admitted[W], usage', cohort_usage'). Steps the l-th member
    of every domain at once, l = 0, 1, ... (the JAX package's grid rows)."""
    W = fit.shape[0]
    usage = usage.clone()
    cohort = cohort_usage.clone()
    admitted = torch.zeros(W, dtype=torch.bool, device=fit.device)
    counts = (offsets[1:] - offsets[:-1]).long()
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
            members):
    if _is_cpu(fit):
        return phase_b_plain(topo, usage, cohort_usage, asg_usage, fit,
                             wl_cq, offsets, members)
    W = fit.shape[0]
    Q, F, R = usage.shape
    D = offsets.shape[0] - 1
    usage_out = usage.clone()
    cohort_out = cohort_usage.clone()
    admitted = torch.zeros(W, dtype=torch.bool, device=fit.device)
    _launch("phase_b", [
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
        _ptr(offsets, torch.int32, "offsets"),
        _ptr(members, torch.int32, "members"),
        _ptr(admitted, torch.bool, "admitted"),
    ], [D, F * R, topo["cq_chain"].shape[1]], fit.device)
    phase_b.launches += 1
    return admitted, usage_out, cohort_out


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


KERNEL_WRAPPERS = (avail, phase_a, phase_b, pack)
reset_launch_counts()


# ---------------------------------------------------------------------------
# The fused cycle
# ---------------------------------------------------------------------------

def solve_cycle_fused(topo, usage, cohort_usage, requests, podset_active,
                      wl_cq, priority, timestamp, eligible, solvable,
                      num_podsets: int, max_rank: int = 0, start_rank=None,
                      compact: bool = True) -> dict:
    """One fit-mode admission cycle, the port of
    kueue_tpu/solver/kernel.py:476 solve_cycle_fused_impl with fair
    sharing and cluster columns off. Returns admitted/chosen/borrows/
    chosen_borrow/fit/usage/cohort_usage, or dec_pr/dec_bits in place of
    the five decision arrays when compact. max_rank is taken for
    signature parity and unused: the CSR of the order needs no
    per-domain bound."""
    del max_rank
    avail_q = avail(topo, usage, cohort_usage)
    fit, borrows, chosen, chosen_borrow, asg_usage = phase_a(
        topo, avail_q, usage, requests, podset_active, wl_cq, eligible,
        solvable, num_podsets, start_rank)
    order = admit_order(fit, borrows, priority, timestamp)
    offsets, members = domain_csr(topo, wl_cq, order)
    admitted, usage_out, cohort_out = phase_b(
        topo, usage, cohort_usage, asg_usage, fit, wl_cq, offsets, members)
    out = {"usage": usage_out, "cohort_usage": cohort_out}
    if compact:
        out["dec_pr"], out["dec_bits"] = pack(chosen, chosen_borrow, fit,
                                              admitted, borrows)
    else:
        out.update(admitted=admitted, chosen=chosen, borrows=borrows,
                   chosen_borrow=chosen_borrow, fit=fit)
    return out


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
