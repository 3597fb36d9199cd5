"""The conflict-domain planner: one layout decision for the mesh.

The port's own copy of kueue_tpu/parallel/domains.py (numpy only, no
kernel), giving the same arrays and fingerprints. It decides:

- **domain -> rank placement** for the sharded Phase B
  (parallel/mesh.solve_cycle_sharded hands each rank its planner-assigned
  domain columns);
- **preemption problem -> rank placement** (solve_preempt_sharded),
  weighted by candidate-pool size.

Partitioning is cost-balanced: a domain's weight is the sum over its
batch workloads of the CQ's flavor width (the Phase B scan cost of one
domain is one availability walk and fit check over the CQ's flavor rows
per member). The LPT (longest-processing-time greedy) assignment is
deterministic: ties break on domain id, then rank, so the plan
fingerprint is stable across process restarts.

Only occupied domains get columns. Padding columns are -1, which the
mesh path rewrites to the sentinel D (past the last domain), so a pad
lane is a no-op and the combined decisions equal the single-device
cycle's.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np


def _bucket(n: int, minimum: int = 8, factor: int = 2) -> int:
    """Power-of-`factor` bucketing of the per-rank column count (the
    JAX package buckets it for its compiled shapes; the port keeps the
    same buckets so that its plans and fingerprints are the same)."""
    b = minimum
    while b < n:
        b *= factor
    return b


def workload_domains(wl_cq, cq_cohort, cohort_root) -> np.ndarray:
    """[W] conflict-domain id per workload: the root cohort index, or a
    synthetic ``C + cq`` domain for cohortless CQs. The ONE definition
    of the domain mapping, the rule of kernel._domains and the order
    kernel (reference: fit/borrow math
    walks within one cohort tree, pkg/cache/resource_node.go)."""
    wl_cq = np.asarray(wl_cq)
    cq_cohort = np.asarray(cq_cohort)
    cohort_root = np.asarray(cohort_root)
    C = len(cohort_root)
    cohort_of = cq_cohort[wl_cq]
    if C == 0:  # cohortless topology: every CQ is its own domain
        return wl_cq.astype(np.int64)
    root_of = cohort_root[np.maximum(cohort_of, 0)]
    return np.where(cohort_of >= 0, root_of.astype(np.int64),
                    C + wl_cq.astype(np.int64))


def flavor_width(offered) -> np.ndarray:
    """[Q] per-CQ flavor width (>=1): the number of flavor rows a Phase B
    availability/fit evaluation touches for one of the CQ's workloads —
    the per-rank scan cost factor of the CQ's domain column."""
    offered = np.asarray(offered)
    return np.maximum(offered.any(axis=2).sum(axis=1), 1).astype(np.int64)


def balanced_partition(weights, n_bins: int):
    """Deterministic LPT greedy: items sorted by (-weight, index) land
    on the least-loaded bin (ties -> lowest bin id). Returns
    (bin_of_item [N] int32, loads [n_bins] int64). Guarantee: max load
    <= (4/3 - 1/(3*n_bins)) * optimal, vs. unbounded skew for naive
    round-robin when heavy items share a residue class."""
    import heapq
    weights = np.asarray(weights, np.int64)
    n = len(weights)
    bin_of = np.zeros(n, np.int32)
    loads = np.zeros(n_bins, np.int64)
    if n == 0 or n_bins <= 1:
        return bin_of, loads if n == 0 else _accumulate(weights, bin_of,
                                                        n_bins)
    order = np.lexsort((np.arange(n), -weights))
    heap = [(0, b) for b in range(n_bins)]  # (load, bin) — already a heap
    for i in order.tolist():
        load, b = heapq.heappop(heap)
        bin_of[i] = b
        load += int(weights[i])
        loads[b] = load
        heapq.heappush(heap, (load, b))
    return bin_of, loads


def _accumulate(weights, bin_of, n_bins):
    loads = np.zeros(n_bins, np.int64)
    np.add.at(loads, bin_of, weights)
    return loads


def round_robin_partition(weights, n_bins: int):
    """The round-robin layout (domain d -> rank d mod n), the baseline
    the LPT layout is compared with."""
    weights = np.asarray(weights, np.int64)
    bin_of = (np.arange(len(weights)) % max(n_bins, 1)).astype(np.int32)
    return bin_of, _accumulate(weights, bin_of, n_bins)


def imbalance_ratio(loads) -> float:
    """max/mean over LOADED devices (1.0 = perfectly balanced). Zero-load
    devices are excluded: with fewer occupied domains than devices the
    optimal
    layout necessarily idles some devices (LPT seeds the first
    ``min(items, bins)`` bins with distinct items, so a zero bin only
    appears in exactly that regime), and counting them would fail a
    layout that cannot be improved."""
    loads = np.asarray(loads, np.float64)
    loads = loads[loads > 0]
    if loads.size == 0:
        return 1.0
    return float(loads.max() / loads.mean())


@dataclass(frozen=True)
class DomainPlan:
    """Domain -> device layout for one cycle. ``columns[dev]`` lists the
    grid-column (domain) ids device `dev` scans, padded with -1; the
    mesh path rewrites -1 to its empty-column sentinel. The fingerprint
    is stable across processes (blake2b over the layout bytes, no
    ``hash()``/``id()``), so keys derived from it survive restarts."""

    n_devices: int
    columns: np.ndarray           # [n_devices, d_cols] int64, -1 pad
    loads: np.ndarray             # [n_devices] int64 weighted load
    occupied: int                 # distinct occupied domains
    imbalance: float
    fingerprint: str = field(default="")

    @property
    def d_cols(self) -> int:
        return int(self.columns.shape[1])


def _plan_fingerprint(n_devices: int, columns: np.ndarray) -> str:
    h = hashlib.blake2b(digest_size=8)
    h.update(np.int64(n_devices).tobytes())
    h.update(np.int64(columns.shape[1]).tobytes())
    h.update(np.ascontiguousarray(columns, np.int64).tobytes())
    return h.hexdigest()


def plan_domains(wl_cq, cq_cohort, cohort_root, offered,
                 n_devices: int, min_cols: int = 8) -> DomainPlan:
    """Cost-balanced domain -> device plan for one cycle's batch.

    wl_cq: [W] (the FULL padded batch — padding rows occupy grid slots
    and must map onto an assigned column, exactly like the fused
    single-chip grid). Weight of a domain = sum over its batch rows of
    the row's CQ flavor width.
    """
    wl_cq = np.asarray(wl_cq)
    dom = workload_domains(wl_cq, cq_cohort, cohort_root)
    D = len(np.asarray(cohort_root)) + len(np.asarray(cq_cohort))
    fw = flavor_width(offered)
    weights = np.bincount(dom, weights=fw[wl_cq].astype(np.float64),
                          minlength=D).astype(np.int64)
    occupied = np.flatnonzero(np.bincount(dom, minlength=D))
    n_devices = max(int(n_devices), 1)
    bin_of, loads = balanced_partition(weights[occupied], n_devices)
    counts = np.bincount(bin_of, minlength=n_devices) if len(occupied) \
        else np.zeros(n_devices, np.int64)
    d_cols = _bucket(max(int(counts.max()) if len(occupied) else 1, 1),
                     min_cols)
    columns = np.full((n_devices, d_cols), -1, np.int64)
    fill = np.zeros(n_devices, np.int64)
    # stable fill order (ascending domain id) — part of the fingerprint
    for d, b in zip(occupied.tolist(), bin_of.tolist()):
        columns[b, fill[b]] = d
        fill[b] += 1
    plan = DomainPlan(
        n_devices=n_devices, columns=columns, loads=loads,
        occupied=len(occupied), imbalance=imbalance_ratio(loads),
        fingerprint=_plan_fingerprint(n_devices, columns))
    return plan


def plan_problems(weights, n_devices: int, min_local: int = 1):
    """Preemption problem axis -> device placement, through the same
    planner. Returns (perm [n_devices * b_local] int64 padded with N,
    inv [N] int64, b_local): device k's slots are
    ``perm[k*b_local:(k+1)*b_local]``, a pad lane holds N (no problem);
    ``inv[i]`` is problem i's slot."""
    weights = np.asarray(weights, np.int64)
    n = len(weights)
    n_devices = max(int(n_devices), 1)
    bin_of, _loads = balanced_partition(weights, n_devices)
    counts = np.bincount(bin_of, minlength=n_devices) if n else \
        np.zeros(n_devices, np.int64)
    b_local = max(int(counts.max()) if n else 0, min_local)
    perm = np.full(n_devices * b_local, n, np.int64)
    inv = np.zeros(n, np.int64)
    fill = np.zeros(n_devices, np.int64)
    for i, b in enumerate(bin_of.tolist()):
        pos = b * b_local + int(fill[b])
        perm[pos] = i
        inv[i] = pos
        fill[b] += 1
    return perm, inv, b_local
