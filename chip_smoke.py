"""Smoke run of kueue_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Builds the solver's CUDA kernels from kueue_tpu_torch/solver/csrc, holds
each one against its plain PyTorch version on the card at the north-star
shape (2048 ClusterQueues, 256 cohorts, 32 flavors, 2 resources, 2048
heads, 4 podsets) and on a nested-cohort input (depth 3, 3 active
podsets), and times both; drf_share also on fair weights 0/500/1000/3000
with a root cohort lending nothing, and the admit order also with those
shares and with a mix of ties, negative shares and NO_LIMIT. Then it
drives the port's main paths end to end on a 2048-CQ cluster with
51,200 workloads pending in the port's queue Manager, each cycle's
decisions held against the same solve on the CPU with the plain
versions:

1. unbound: BatchSolver(device="cuda") re-encodes and uploads the state
   and the batch every cycle (1 warm-up and 3 timed cycles);
2. bound fill: the solver bound to the Cache and the Manager, usage
   resident on the card and the batch gathered from the encode arena's
   device twin, filling an empty cluster (1 + 10 cycles);
3. bound churn: the same on a cluster whose flavors are all full, where
   128 admitted workloads finish before each cycle, so the journal's
   corrections and the arena's changed rows reach the card as the
   sparse delta prologue and the row scatter (1 + 10 cycles). Every
   bound cycle's resident usage is also held against the host mirror
   and a fresh encode of the cache.
4. scheduler fair: the port's own Scheduler with fair sharing on, its
   BatchSolver(device="cuda") bound to the Cache and the Manager, on
   the JAX package's fair-sharing benchmark configuration (2048 CQs in
   256 cohorts, one flavor of 2 units per CQ, 4-unit workloads, 30,720
   pending; the last cycle's admissions finish before each cycle):
   1 + 10 cycles, every one on the device route with drf_share launched,
   each bound cycle's resident usage held against the mirror and a
   fresh encode; drf_share's inputs in the first timed cycle are kept
   and its shares there held against the plain version on the same card
   tensors, and again with a seeded usage and weights 0/500/1000/3000
   (the cell's own shares are uniform: every CQ has weight 1000 and
   starts the cycle empty); then the same cycles on the CPU
   (device="cpu") must admit the same workloads and leave the same
   usage per CQ.
5. scheduler preempt: the port's Scheduler with device preemption on
   the JAX package's preemption-heavy configuration (bench.py
   bench_preemption_reclaim: 2048 CQs, 256 child cohorts under 128
   roots, one flavor of 8 units per CQ, 64,512 admitted victims, one
   8-unit preemptor per CQ, every head in preempt mode): 1 warm-up and
   3 timed cycles, each the first cycle of a fresh build, every one on
   the device route with the work gate choosing the device and every
   preempt-mode head solved by the K9 kernel (solve_preempt) after the
   fit sync; its inputs in the first timed cycle are kept and held
   against the plain version, as is a synthetic nested input (depth 3,
   within-CQ, reclaim and threshold problems, padding); one traced
   cycle; then the same scenario with device="cpu" (the plain K9) and
   on the cpu-forced route (the CPU Preemptor) must evict the same
   workloads with the same reasons and admit the same workloads.
6. scheduler fair preempt: the port's Scheduler with fair sharing and
   device preemption on the JAX package's fair-sharing preemption
   configuration (bench.py bench_fair_preemption at 2048 CQs in 256
   cohorts: one flavor of 8 units per CQ, member 0 of each cohort idle
   with one 8-unit preemptor, the other 7 each holding 12 admitted
   victims, 21,504 in all): 1 warm-up and 3 timed cycles, each the
   first cycle of a fresh build, every one on the device route with the
   work gate choosing the device and 256 fair problems solved by the K11
   kernel (solve_fair) after the fit sync, with one sync for the
   preemption solves; its inputs in the first timed cycle are kept and
   held against the plain version, as is a synthetic nested input
   (depth 3, every strategy order, padding); one traced cycle; then the
   same scenario with device="cpu" (the plain K11, the same solve stats)
   and on the cpu-forced route (the CPU Preemptor) must evict the same
   workloads with the same reasons and admit the same workloads. Last, a
   cycle with a minimal and a fair problem (sim/northstar
   build_mixed_preemption) must launch K9 and K11 after one sync and
   evict as the CPU does.
7. scheduler multikueue: the port's Scheduler on a MultiKueue manager
   cluster (sim/northstar build_multikueue: the north star's 2048 CQs in
   256 cohorts, 32 flavors of 40 units, 51,200 pending 40-unit
   workloads, the MultiKueue check on every even CQ, five worker
   clusters w0..w4 bucketed to 8 columns, w2 lost, w1 lost from the
   sixth timed cycle on): 1 + 10 cycles, each on the device route with
   cluster_cols launched once in the bound cycle, the placements handed
   to on_placement never on a lost cluster and on at least three; its
   inputs in the first timed cycle are kept and held against the plain
   version and the host oracle (encode.place_remote_dicts walked in the
   global admit order, on the columns cut to the flavors and resources
   the topology knows), as is a synthetic batch (8 clusters, 32 flavors,
   2 resources, 2048 rows); one traced cycle; then the same cycles with
   device="cpu" must admit the same workloads and place them on the
   same clusters in the same order.
8. scheduler sharded: the sharded cycle (kueue_tpu_torch/parallel/mesh.py,
   K13) under the port's Scheduler, BatchSolver(mesh=make_mesh()): world
   size 1 over NCCL on the one card. (a) the north star's fill (2048 CQs
   in 256 cohorts, 32 flavors of 40 units, 51,200 pending): 1 + 10
   cycles; (b) the preemption reclaim configuration: 1 warm-up and 1
   timed fresh build, every preempt-mode head solved by K9 over its
   problem slots (solve_preempt_sharded); (c) the MultiKueue cell: 1 + 3
   cycles, K12 after the combine. Each launches its kernels, mesh_combine
   included, and equals the same builds on the single-device route
   (BatchSolver(device="cuda")): admissions and usage per CQ, evictions
   and reasons, placements. Then each rank's body of a 4-way plan in
   turn, on the card: on (a)'s first timed cycle, phase_a on the rank's
   slice, phase_b on its columns and the combine's pack, the four
   buffers summed and unpacked; on (b)'s K9 batch, K9 on each rank's
   slots, the outputs summed. Both must equal the single-device cycle and
   K9, and phase_b with columns, K9 with slots and mesh_combine their
   plain versions on the same tensors. The process group is destroyed at
   the end of the phase.

Every phase raises on failure; nothing is caught. The last lines are
the card's name and power limit, one JSON line with the kernels'
numbers, and {"ok": true, "device": {...}}. Without a CUDA device, or
without the kueue_tpu_torch package beside this file, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)

NORTH_STAR = dict(num_cqs=2048, num_cohorts=256, num_flavors=32,
                  num_resources=2, num_workloads=2048, num_podsets=4)
NESTED = dict(num_cqs=2048, num_leaf_cohorts=256, fanout=4, depth=3,
              num_flavors=32, num_resources=2, num_workloads=2048,
              num_podsets=3, no_cohort_every=16)
E2E_WAVES = 25          # 25 x 2048 = 51,200 pending workloads
E2E_WARMUP = 1
UNBOUND_TIMED = 3
BOUND_TIMED = 10
NOMINAL_UNITS = 40      # per flavor and CQ; workloads are one flavor's size
CHURN_FINISHES = 128    # admitted workloads finishing before a churn cycle
# The kernel phase's shapes for the resident kernels, as the churn gives
# them: each finish frees a (cq, flavor) of cpu and memory, and about as
# many arena rows change; the twin holds the slots the bound phases reach.
DELTA_COORDS = 2 * CHURN_FINISHES
SCATTER_ROWS = CHURN_FINISHES
ARENA_SLOTS = 4096

REPLACES = {
    "avail": "kueue_tpu/solver/kernel.py:50",
    "phase_a": "kueue_tpu/solver/kernel.py:221",
    "drf_share": "kueue_tpu/solver/kernel.py:197",
    "order": "kueue_tpu/solver/kernel.py:498",
    "phase_b": "kueue_tpu/solver/kernel.py:420",
    "pack": "kueue_tpu/solver/kernel.py:372",
    "deltas": "kueue_tpu/solver/kernel.py:765",
    "arena_scatter": "kueue_tpu/solver/kernel.py:863",
    "arena_gather": "kueue_tpu/solver/kernel.py:892",
    "solve_preempt": "kueue_tpu/solver/preempt.py:598",
    "solve_fair": "kueue_tpu/solver/fairpreempt.py:210",
    "cluster_cols": "kueue_tpu/solver/kernel.py:614",
    "mesh_combine": "kueue_tpu/parallel/mesh.py:320",
    "global_scan": "kueue_tpu/solver/kernel.py:250",
}
# the kernels each end-to-end phase must launch
PHASE_KERNELS = {
    # the oracles on the kernel inputs: solve_cycle (global_scan),
    # solve_cycle_cohort_parallel and solve_cycle_fused, fair sharing on
    # in one variant
    "oracles": ("avail", "phase_a", "drf_share", "order", "phase_b",
                "global_scan"),
    "unbound": ("avail", "phase_a", "order", "phase_b", "pack"),
    "bound_fill": ("arena_gather", "avail", "phase_a", "order", "phase_b",
                   "pack"),
    "bound_churn": tuple(k for k in REPLACES
                         if k not in ("drf_share", "solve_preempt",
                                      "solve_fair", "cluster_cols",
                                      "mesh_combine", "global_scan")),
    # the finishes free more than 512 (cq, resource) coords and replace
    # more than 512 arena rows each cycle: the state and the twin are
    # re-uploaded whole, so deltas and arena_scatter do not run here
    "scheduler_fair": ("arena_gather", "avail", "phase_a", "drf_share",
                       "order", "phase_b", "pack"),
    # a fresh build's first cycle: the state and the twin upload whole
    "scheduler_preempt": ("arena_gather", "avail", "phase_a", "order",
                          "phase_b", "pack", "solve_preempt"),
    # the same, with fair sharing: the DRF share orders the fit cycle and
    # every preempt-mode head has cohort candidates (fair problems only)
    "scheduler_fair_preempt": ("arena_gather", "avail", "phase_a",
                               "drf_share", "order", "phase_b", "pack",
                               "solve_fair"),
    # the cluster columns ride the bound cycle (the finishes re-upload
    # the state and the twin whole, as in the fair phase)
    "scheduler_multikueue": ("arena_gather", "avail", "phase_a", "order",
                             "phase_b", "pack", "cluster_cols"),
    # the bound fit cycle, then avail and phase_a once per search round
    # (the finishes re-upload the state and the twin whole)
    "scheduler_partial": ("arena_gather", "avail", "phase_a", "order",
                          "phase_b", "pack"),
}
# The sharded cycle's sub-phases and the kernels each must launch: under a
# mesh the cycle is unbound (no arena twin, no resident state), K9 runs over
# its problem slots and K12 after the combine.
SHARDED_KERNELS = {
    "fill": ("avail", "phase_a", "order", "phase_b", "mesh_combine", "pack"),
    "preempt": ("avail", "phase_a", "order", "phase_b", "mesh_combine",
                "pack", "solve_preempt"),
    "multikueue": ("avail", "phase_a", "order", "phase_b", "mesh_combine",
                   "pack", "cluster_cols"),
}
PHASE_KERNELS["scheduler_sharded"] = SHARDED_KERNELS["preempt"] + (
    "cluster_cols",)
SHARDED_TIMED = {"fill": 10, "preempt": 1, "multikueue": 3}
SHARDED_RANKS = 4  # the rank check's plan, each rank's body run in turn
# The fair-sharing benchmark configuration (bench.py bench_fair_sharing,
# builders bench.py:107-214): every admission borrows, 1024 per cycle.
FAIR = dict(num_cqs=2048, num_cohorts=256, nominal_units=2, cpu_units=4)
FAIR_TIMED = 10
FAIR_WAVES = 15         # cycles + 4, as the bench stages: 30,720 pending
# The preemption-heavy configuration (bench.py bench_preemption_reclaim,
# bench.py:1807-1850; sim/northstar.build_preempt_reclaim).
PREEMPT = dict(num_roots=128, children_per_root=2, cqs_per_child=8,
               victims_per_borrower=36)
PREEMPT_TIMED = 3
# K9's synthetic check: trees 3 deep (CQs attached at two depths),
# within-CQ, reclaim and threshold problems, 124 padding rows
PREEMPT_NESTED = dict(num_problems=900, max_candidates=120,
                      max_local_cqs=12, depth=3, num_cqs=2048,
                      num_leaf_cohorts=256, fanout=4, num_flavors=4,
                      num_resources=2, table_rows=4096, seed=17)
# The fair-sharing preemption configuration (bench.py
# bench_fair_preemption, bench.py:1727-1775; sim/northstar
# build_fair_preemption) at the north star's 2048 CQs.
FAIR_PREEMPT = dict(num_cqs=2048, num_cohorts=256, victims_per_cq=12)
FAIR_PREEMPT_TIMED = 3
# K11's synthetic check: trees 3 deep (CQs attached at two depths), two
# flavors per problem, weight 0, roots lending nothing, thresholds, 124
# padding rows, under every strategy order
FAIR_NESTED = dict(num_problems=900, max_candidates=120, max_local_cqs=12,
                   depth=3, num_cqs=2048, num_leaf_cohorts=256, fanout=4,
                   num_flavors=4, num_resources=2, table_rows=4096, seed=19)
FAIR_STRATS = ((True, True, False), (True, False, False),
               (False, False, False), (False, True, True))
# the shared-sync measurement: rounds of calls of each form, in turns
SYNC_ROUNDS = 4
SYNC_CALLS = 25
# the order kernel's check with non-zero shares: mixed values and ties,
# negative shares (a root lending nothing) and NO_LIMIT (weight 0)
MIXED_SHARES = (-2, -1, 0, 0, 125, 125, 333, 2**62)
# The MultiKueue manager cluster (sim/northstar build_multikueue) on the
# north star: w1 is lost from the sixth timed cycle on.
MK = dict(num_cqs=2048, num_cohorts=256, num_flavors=32, nominal_units=40,
          cpu_units=40, waves=25)
MK_TIMED = 10
MK_LOST = ("w1", E2E_WARMUP + 5)
# K12's synthetic check: lost clusters, partial offers, capacity that runs
# out mid-scan
MK_SYNTH = dict(num_clusters=8, num_flavors=32, num_resources=2,
                num_workloads=2048, num_podsets=4, num_cqs=2048, seed=23)
# collect's copy per key against one copy of all keys: calls of each, in
# turns
FETCH_REPS = 200
# Elastic Jobs under PartialAdmission on the north star (sim/northstar
# build_partial_admission): the CQs of cohorts 0-127 queue Jobs of 512
# pods of 1 unit that may run with 64, more than the 320 units a cohort
# of 8 CQs holds in a flavor; the rest queue the north star's workloads.
PARTIAL = dict(num_cqs=2048, num_cohorts=256, num_flavors=32,
               nominal_units=40, cpu_units=40, partial_cohorts=128,
               count=512, min_count=64)
PARTIAL_TIMED = 5
PARTIAL_WAVES = E2E_WARMUP + PARTIAL_TIMED + 2  # a head on every CQ


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def percentile(values: list, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=float), q))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def time_cuda(fn, iters: int, warmup: int = 3) -> float:
    """Milliseconds per call: CUDA events around `iters` calls after a
    warm-up, then a synchronize."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(event, self_only: bool = False) -> float:
    """Device microseconds of a profiler key_averages() row."""
    prefix = "self_" if self_only else ""
    value = getattr(event, f"{prefix}device_time_total", None)
    return value if value is not None else getattr(event, f"{prefix}cuda_time_total")


@contextlib.contextmanager
def fetch_timing(solver, out: dict):
    """Within the block, solver.collect keeps the arguments it is called
    with. After it, on the block's first decision outputs (the device
    tensors collect fetched), collect's copy per key (each array by its
    own .cpu()) and the one copy of solver._fetch are timed in turns,
    FETCH_REPS calls of each; `out` gets their p50 and the bytes."""
    calls, real = [], solver.collect

    def record(plan, result, keys, snapshot):
        calls.append((result, tuple(keys)))
        return real(plan, result, keys, snapshot)
    solver.collect = record
    try:
        yield
    finally:
        del solver.collect
    result, keys = calls[0]
    ways = {"one_copy": lambda: solver._fetch(result, keys),
            "per_key": lambda: {k: result[k].cpu().numpy() for k in keys}}
    times = {w: [] for w in ways}
    for i in range(FETCH_REPS):
        for w in (ways if i % 2 else reversed(list(ways))):
            t0 = time.perf_counter()
            ways[w]()
            times[w].append(time.perf_counter() - t0)
    out.update({f"{w}_p50_ms": percentile(v, 50) * 1e3
                for w, v in times.items()}, keys=list(keys),
               bytes=sum(result[k].numel() * result[k].element_size()
                         for k in keys))


class GcClock:
    """Wall time spent in the cyclic garbage collector (gc.callbacks)."""

    def __init__(self):
        self.total = 0.0
        self._start = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.total += time.perf_counter() - self._start
            self._start = None


def profiled_device_ms(fn, iters: int, kernel_name: str):
    """Mean device time per call of the CUDA kernels whose names start
    with `<kernel_name>_`, from a torch.profiler trace of `iters` calls
    (device activity only, then, if that trace kept no record of them,
    host and device activity, as the traced cycles record); None when
    neither holds device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for activities in ([ProfilerActivity.CUDA],
                       [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profile(activities=activities) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(device_us(e) for e in prof.key_averages()
                    if e.key.startswith(f"{kernel_name}_")
                    and str(e.device_type).endswith("CUDA"))
        if total:
            return total / iters / 1e3
    return None


def compare(names, got, want) -> float:
    """Raises unless a kernel's outputs equal its plain version's element
    by element; returns the largest difference, which is then 0."""
    import torch
    for name, a, b in zip(names, got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: {a.shape}/{a.dtype} vs "
                                 f"{b.shape}/{b.dtype}")
        if torch.equal(a, b):
            continue
        wide = torch.float64 if a.dtype.is_floating_point else torch.int64
        diff = (a.to(wide) - b.to(wide)).abs().max().item()
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version by up to {diff}")
    return 0.0


def phase_a_bytes(topo, wl, num_podsets: int, start_rank, outs) -> int:
    """Bytes phase_a must move on these inputs: per head, its request,
    flags and eligibility rows; of the [Q,F,R] inputs (nominal, offered,
    avail, usage) only the elements of the heads' CQs in a flavor of the
    requested resource's group; of the per-CQ rows only the heads' CQs;
    every output once."""
    import torch
    q = wl["wl_cq"].long()
    req = wl["requests"][:, :num_podsets]                    # [W,NP,R]
    gid = topo["group_id"][q]                                 # [W,R]
    rel = (((req > 0) & (gid[:, None, :] >= 0))[:, :, None, :]
           & (topo["flavor_group"][q][:, None, :, None]
              == gid[:, None, None, :]))                      # [W,NP,F,R]
    touched = torch.zeros(topo["nominal"].shape, dtype=torch.int32,
                          device=q.device)
    touched.index_add_(0, q, rel.any(1).to(torch.int32))
    F, R = topo["nominal"].shape[1:]
    moved = int((touched > 0).sum()) * (8 + 1 + 8 + 8)
    moved += int(torch.unique(q).numel()) * (R * 4 + 2 * F * 4 + 1)
    moved += int(rel.any(3).sum())                            # eligible
    moved += nbytes(req, wl["podset_active"], wl["wl_cq"], wl["solvable"],
                    *outs)
    if start_rank is not None:
        moved += nbytes(start_rank[:, :num_podsets])
    return moved


def phase_b_bytes(topo, usage, cohort_usage, asg, fit, wl_cq, offsets,
                  members, outs) -> int:
    """Bytes phase_b must move on these inputs: the CSR and per-head
    flags; the assignment rows of fitting heads; the CQ quota and usage
    elements those rows touch, and the cohort elements up their chains;
    the usage and cohort-usage elements that change, written once; the
    admitted flags."""
    import torch
    admitted, usage_out, cohort_out = outs
    w = torch.nonzero(fit).flatten()
    q = wl_cq[w].long()
    touched = torch.zeros(usage.shape, dtype=torch.int32, device=fit.device)
    touched.index_add_(0, q, (asg[w] != 0).to(torch.int32))
    touched = touched > 0
    has_cohort = topo["cq_cohort"] >= 0
    chain = topo["cq_chain"].long()
    up = torch.zeros(cohort_usage.shape, dtype=torch.int32, device=fit.device)
    for d in range(chain.shape[1]):
        on = has_cohort & (chain[:, d] >= 0)
        up.index_add_(0, chain[on, d], touched[on].to(torch.int32))
    qs = torch.unique(q)
    FR = usage[0].numel()
    moved = int(touched.sum()) * 8 * 4      # nominal, guaranteed, limit, usage
    moved += int((up > 0).sum()) * 8 * 4    # subtree, guaranteed, limit, usage
    moved += int((usage_out != usage).sum() + (cohort_out != cohort_usage)
                 .sum()) * 8
    moved += int(qs.numel()) * 4 + int(has_cohort[qs].sum()) * chain.shape[1] * 4
    moved += int(w.numel()) * FR * 8
    return moved + nbytes(fit, wl_cq, offsets, members, admitted)


def order_bytes(topo, fit, borrows, priority, timestamp, wl_cq,
                outs) -> int:
    """Bytes the order must move: every head's key fields once, the
    cohort of each heads' CQ and the root of each such cohort, the CSR
    written once."""
    import torch
    qs = torch.unique(wl_cq.long())
    cohorts = topo["cq_cohort"][qs]
    return nbytes(fit, borrows, priority, timestamp, wl_cq, *outs) + \
        4 * int(qs.numel()) + 4 * int(torch.unique(cohorts[cohorts >= 0])
                                      .numel())


def drf_share_bytes(topo, asg, wl_cq) -> int:
    """Bytes drf_share must move: every head's assignment row and CQ
    index, the nominal, offered and usage rows and the cohort and weight
    of the heads' CQs, the root and lendable row of their cohorts, the
    shares written once."""
    import torch
    qs = torch.unique(wl_cq.long())
    F, R = asg.shape[1:]
    cohorts = topo["cq_cohort"][qs]
    cohorts = torch.unique(cohorts[cohorts >= 0].long())
    roots = torch.unique(topo["cohort_root"][cohorts])
    return nbytes(asg, wl_cq) + int(qs.numel()) * (F * R * (8 + 1 + 8)
                                                  + 4 + 8) + \
        4 * int(cohorts.numel()) + 8 * R * int(roots.numel()) + \
        8 * wl_cq.shape[0]


def combine_bytes(admitted, usage, usage_out, cohort_usage,
                  cohort_out) -> int:
    """Bytes mesh_combine's two entries must move: pack reads the admitted
    flags and the four usage arrays and writes the int64 buffer; unpack
    reads the buffer (after the all-reduce) and the two pre-cycle usage
    arrays and writes the flags and the two usage arrays."""
    buf = (admitted.numel() + usage.numel() + cohort_usage.numel()) * 8
    state = nbytes(usage, cohort_usage)
    return (nbytes(admitted) + 2 * state + buf) + \
        (buf + state + nbytes(admitted) + state)


def deltas_bytes(deltas) -> int:
    """Bytes the delta prologue must move: the coord arrays once, and for
    each real (q,f,r) and cohort coord its usage element read and written
    and its guaranteed quota read."""
    dq, _, _, _, lvl_c, _ = deltas
    coords = int((dq >= 0).sum()) + int((lvl_c[..., 0] >= 0).sum())
    return nbytes(*deltas) + coords * 3 * 8


def row_bytes(twin: dict) -> int:
    """Bytes of one arena row over every field."""
    return sum(t[0].numel() * t.element_size() for t in twin.values())


def kernel_inputs(kind: str, device) -> dict:
    import numpy as np
    import torch
    from kueue_tpu_torch.solver import kernel, synth
    from kueue_tpu_torch.solver.arena import ARENA_FIELDS
    if kind == "north_star":
        topo, usage, cu, wl = synth.synth_solver_inputs(seed=42, **NORTH_STAR)
        start_rank = None
    else:
        topo, usage, cu, wl = synth.synth_nested_inputs(seed=7, **NESTED)
        rng = np.random.default_rng(7)
        W, P, R = wl["requests"].shape
        wl["podset_active"][:] = True
        wl["requests"] = rng.integers(1, 20, size=(W, P, R)).astype(np.int64) * 1000
        start_rank = synth.synth_start_rank(wl, NESTED["num_flavors"], seed=7)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # The encode arena's twin at the bound phases' capacity, filled with
    # heads' rows; SCATTER_ROWS changed rows padded to the 512 bucket
    # with the out-of-range slot; a gather of W slots, the last 16 padding.
    rng = np.random.default_rng(11)
    W = wl["wl_cq"].shape[0]
    twin = {k: dev(wl[k][rng.integers(0, W, size=ARENA_SLOTS)])
            for k in ARENA_FIELDS}
    upd_rows = {k: dev(wl[k][rng.integers(0, W, size=512)])
                for k in ARENA_FIELDS}
    upd_slots = np.full(512, ARENA_SLOTS, np.int32)
    upd_slots[:SCATTER_ROWS] = rng.choice(ARENA_SLOTS, SCATTER_ROWS,
                                          replace=False)
    slots = rng.choice(ARENA_SLOTS, W, replace=False).astype(np.int32)
    slots[-16:] = -1
    usage_d, cu_d = kernel.state_to_device(usage, cu, device)
    # fair weights 0/500/1000/3000, the first root cohort lending nothing
    # (its borrowers' ratio is -1, their share -1000 // weight, floored)
    fair = dict(topo)
    fair["fair_weight"] = np.array([0, 500, 1000, 3000], np.int64)[
        rng.integers(0, 4, size=topo["cq_cohort"].shape[0])]
    fair["cohort_lendable"] = topo["cohort_lendable"].copy()
    roots = topo["cohort_root"][topo["cq_cohort"][topo["cq_cohort"] >= 0]]
    fair["cohort_lendable"][roots.min()] = 0
    return {
        "topo": kernel.topo_to_device(topo, device), "usage": usage_d,
        "fair_topo": kernel.topo_to_device(fair, device),
        "mixed_shares": dev(rng.choice(np.array(MIXED_SHARES, np.int64),
                                       size=W)),
        "cu": cu_d, "wl": {k: dev(v) for k, v in wl.items()},
        "start_rank": None if start_rank is None else dev(start_rank),
        "deltas": tuple(dev(a) for a in synth.synth_deltas(
            topo, usage, DELTA_COORDS, seed=5)),
        "twin": twin, "upd_rows": upd_rows, "upd_slots": dev(upd_slots),
        "slots": dev(slots)}


def kernel_phase(kind: str, device, results: dict) -> None:
    """Each kernel against its plain version on the same inputs on the
    card, and both timed, with the library calls that compute the same
    function where there are such calls."""
    import torch
    from kueue_tpu_torch.solver import kernel as k
    from kueue_tpu_torch.solver.arena import ARENA_FIELDS
    inp = kernel_inputs(kind, device)
    topo, usage, cu, wl, sr = (inp[n] for n in ("topo", "usage", "cu", "wl",
                                                "start_rank"))
    W, P, R = wl["requests"].shape
    F = wl["eligible"].shape[2]
    rows = {}  # name -> (max_abs_err, kernel, plain, bytes, library)

    v_args = (topo, usage, cu)
    ref_avail = k.avail_plain(*v_args)
    rows["avail"] = (
        compare(("avail",), (k.avail(*v_args),), (ref_avail,)),
        lambda: k.avail(*v_args), lambda: k.avail_plain(*v_args),
        nbytes(topo["cq_cohort"], topo["cq_chain"], topo["nominal"],
               topo["guaranteed"], topo["borrow_limit"], usage,
               topo["cohort_subtree"], topo["cohort_guaranteed"],
               topo["cohort_borrow_limit"], cu, ref_avail), None)

    a_args = (topo, ref_avail, usage, wl["requests"], wl["podset_active"],
              wl["wl_cq"], wl["eligible"], wl["solvable"], P, sr)
    ref_a = k.phase_a_plain(*a_args)
    rows["phase_a"] = (
        compare(("fit", "borrows", "chosen", "chosen_borrow", "asg_usage"),
                k.phase_a(*a_args), ref_a),
        lambda: k.phase_a(*a_args), lambda: k.phase_a_plain(*a_args),
        phase_a_bytes(topo, wl, P, sr, ref_a), None)

    fit, borrows, chosen, chosen_borrow, asg = ref_a
    ftopo = inp["fair_topo"]
    s_args = (ftopo, usage, asg, wl["wl_cq"])
    ref_s = k.drf_share_plain(*s_args)
    floor_topo = dict(ftopo, fair_weight=torch.full_like(
        ftopo["fair_weight"], 3000), cohort_lendable=torch.zeros_like(
        ftopo["cohort_lendable"]))
    floor_args = (floor_topo, usage, asg, wl["wl_cq"])
    ref_floor = k.drf_share_plain(*floor_args)
    for what, want in (("fair", ref_s), ("floor", ref_floor)):
        # the inputs reach the branches the floor division guards
        if not ((want < 0).any() and (want != 0).any()):
            raise AssertionError(f"drf_share {what} inputs have no "
                                 "negative share")
    if not (ref_floor == -1).any():
        raise AssertionError("drf_share floor inputs: no -1000 // 3000")
    rows["drf_share"] = (
        compare(("share", "floor share"),
                (k.drf_share(*s_args), k.drf_share(*floor_args)),
                (ref_s, ref_floor)),
        lambda: k.drf_share(*s_args), lambda: k.drf_share_plain(*s_args),
        drf_share_bytes(ftopo, asg, wl["wl_cq"]), None)
    shares = {"none": None, "drf": ref_s, "mixed": inp["mixed_shares"]}
    share_counts = {n: (0 if v is None else int((v != 0).sum()),
                        0 if v is None else int((v < 0).sum()))
                    for n, v in shares.items()}
    for name, share in shares.items():
        args = (topo, fit, borrows, wl["priority"], wl["timestamp"],
                wl["wl_cq"], share)
        compare((f"offsets ({name} shares)", f"members ({name} shares)"),
                k.order_csr(*args), k.order_csr_plain(*args))
    o_args = (topo, fit, borrows, wl["priority"], wl["timestamp"],
              wl["wl_cq"])
    ref_o = k.order_csr_plain(*o_args)
    # the plain version is the library chain (five stable torch.sort
    # passes, a stable sort by domain, a bincount and a cumsum): its time
    # is the row's library time as well
    rows["order"] = (
        compare(("offsets", "members"), k.order_csr(*o_args), ref_o),
        lambda: k.order_csr(*o_args), lambda: k.order_csr_plain(*o_args),
        order_bytes(*o_args, ref_o[:2]), "plain")

    offsets, members, _ = ref_o
    b_args = (topo, usage, cu, asg, fit, wl["wl_cq"], offsets, members)
    ref_b = k.phase_b_plain(*b_args)
    steps = int((offsets[1:] - offsets[:-1]).max().item())
    rows["phase_b"] = (
        compare(("admitted", "usage", "cohort_usage"), k.phase_b(*b_args),
                ref_b),
        lambda: k.phase_b(*b_args), lambda: k.phase_b_plain(*b_args),
        phase_b_bytes(topo, usage, cu, asg, fit, wl["wl_cq"], offsets,
                      members, ref_b), None)

    p_args = (chosen, chosen_borrow, fit, ref_b[0], borrows)
    ref_p = k.pack_plain(*p_args)
    rows["pack"] = (
        compare(("dec_pr", "dec_bits"), k.pack(*p_args), ref_p),
        lambda: k.pack(*p_args), lambda: k.pack_plain(*p_args),
        nbytes(*p_args, *ref_p), None)

    # the combine of a world-size-1 mesh on this cycle's Phase B outputs:
    # pack, (the all-reduce), unpack
    c_args = (ref_b[0], usage, ref_b[1], cu, ref_b[2])
    ref_c = k.combine_pack_plain(*c_args)
    got_c = k.combine_pack(*c_args)

    def combine():
        return k.combine_unpack(k.combine_pack(*c_args), usage, cu)

    def combine_plain():
        return k.combine_unpack_plain(k.combine_pack_plain(*c_args), usage, cu)
    # the plain version is the torch chain the kernel replaces (two
    # subtracts, a cast and a cat; two adds and a compare): the row's
    # library time as well
    rows["mesh_combine"] = (
        compare(("buf", "admitted", "usage", "cohort_usage"),
                (got_c, *k.combine_unpack(got_c, usage, cu)),
                (ref_c, *k.combine_unpack_plain(ref_c, usage, cu))),
        combine, combine_plain, combine_bytes(*c_args), "plain")

    # in place: each version on its own copy of the resident state
    deltas = inp["deltas"]
    got_d, want_d = (usage.clone(), cu.clone()), (usage.clone(), cu.clone())
    k.apply_state_deltas(topo, *got_d, *deltas)
    k.apply_state_deltas_plain(topo, *want_d, *deltas)
    rows["deltas"] = (
        compare(("usage", "cohort_usage"), got_d, want_d),
        lambda: k.apply_state_deltas(topo, *got_d, *deltas),
        lambda: k.apply_state_deltas_plain(topo, *want_d, *deltas),
        deltas_bytes(deltas), None)

    twin, upd_slots, upd_rows = inp["twin"], inp["upd_slots"], inp["upd_rows"]
    got_t = {n: t.clone() for n, t in twin.items()}
    want_t = {n: t.clone() for n, t in twin.items()}
    lib_t = {n: t.clone() for n, t in twin.items()}
    k.scatter_arena_rows(got_t, upd_slots, upd_rows)
    k.scatter_arena_rows_plain(want_t, upd_slots, upd_rows)
    real = upd_slots[:SCATTER_ROWS].long()

    def scatter_library():
        for n in ARENA_FIELDS:
            lib_t[n].index_copy_(0, real, upd_rows[n][:SCATTER_ROWS])
    rows["arena_scatter"] = (
        compare(ARENA_FIELDS, [got_t[n] for n in ARENA_FIELDS],
                [want_t[n] for n in ARENA_FIELDS]),
        lambda: k.scatter_arena_rows(got_t, upd_slots, upd_rows),
        lambda: k.scatter_arena_rows_plain(want_t, upd_slots, upd_rows),
        nbytes(upd_slots) + 2 * SCATTER_ROWS * row_bytes(twin),
        scatter_library)

    slots = inp["slots"]
    clamped = slots.long().clamp_min(0)
    n_real = int((slots >= 0).sum())
    rows["arena_gather"] = (
        compare(ARENA_FIELDS, k.gather_arena(twin, slots),
                k.gather_arena_plain(twin, slots)),
        lambda: k.gather_arena(twin, slots),
        lambda: k.gather_arena_plain(twin, slots),
        nbytes(slots) + (n_real + W) * row_bytes(twin),
        lambda: [twin[n].index_select(0, clamped) for n in ARENA_FIELDS])

    log(f"[kernels:{kind}] order equal to plain with shares (non-zero, "
        f"negative) {json.dumps(share_counts)}; drf_share shares "
        f"{int((ref_s != 0).sum())} non-zero, {int((ref_s < 0).sum())} "
        f"negative, {int((ref_s == k.NO_LIMIT).sum())} NO_LIMIT; floor "
        f"case {int((ref_floor == -1).sum())} x -1")
    log(f"[kernels:{kind}] W={W} P={P} F={F} R={R} "
        f"Q={usage.shape[0]} C={cu.shape[0]} DC={topo['cq_chain'].shape[1]} "
        f"fit={int(fit.sum())} admitted={int(ref_b[0].sum())} "
        f"phase_b dependent steps={steps} deltas D={deltas[0].shape[0]} "
        f"(coords {int((deltas[0] >= 0).sum())}, levels "
        f"{deltas[4].shape[0]}) arena slots={ARENA_SLOTS} "
        f"scatter rows={SCATTER_ROWS}/512")
    for name, (err, run_kernel, run_plain, moved, library) in rows.items():
        # call_ms: back-to-back wrapper calls between CUDA events, bounded
        # by the host's enqueue rate; ms: the kernel's own device time
        # from a profiler trace (call_ms when the trace shows none)
        torch.cuda.synchronize()
        call_ms = time_cuda(run_kernel, iters=50)
        plain_ms = time_cuda(run_plain, iters=10 if name == "phase_b" else 50)
        kernel_ms = profiled_device_ms(run_kernel, 50, name)
        ms, source = (kernel_ms, "profiler") if kernel_ms is not None \
            else (call_ms, "events")
        library_ms = None
        if library == "plain":
            library_ms = plain_ms
        elif library is not None:
            library_ms = time_cuda(library, iters=50)
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        log(f"[kernels:{kind}] {name}: equal to plain (max_abs_err {err}) "
            f"ms={ms:.5f} ({source}) call_ms={call_ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={library_ms} "
            f"bound_ms={bound_ms:.6f} ({moved} bytes / 3.35 TB/s)"
            + (f"; latency-bound: {steps} dependent steps"
               if name == "phase_b" else ""))
        results.setdefault(kind, {})[name] = {
            "max_abs_err": err, "ms": ms, "ms_source": source,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bytes": moved,
            **({"dependent_steps": steps} if name == "phase_b" else {})}


def normalize(decisions: dict) -> dict:
    out = {}
    for i, (a, admitted) in decisions.items():
        out[i] = (admitted, a.borrowing,
                  [sorted((r, fl.name, fl.tried_flavor_idx)
                          for r, fl in ps.flavors.items())
                   for ps in a.pod_sets],
                  a.last_state.last_tried_flavor_idx)
    return out


def check_resident(solver, cache, topo, host_admitted=()) -> None:
    """The resident usage fetched from the card equals the host mirror,
    and the mirror equals a fresh encode of the cache. host_admitted:
    the workloads the last cycle admitted on the host (not on the card),
    whose usage reaches the mirror through the cache journal only at the
    next cycle's reconcile, so the cache is taken without them."""
    import numpy as np
    from kueue_tpu_torch.core.resources import FlavorResource
    from kueue_tpu_torch.solver import encode
    rs = solver.resident
    if rs.device_backlog:
        raise AssertionError("corrections left unshipped after a cycle")
    truth = encode.encode_state(cache.snapshot(), topo)
    corr = {}
    for wl in host_admitted:
        adm = wl.status.admission
        for psa in adm.pod_set_assignments:
            for r, v in psa.resource_usage.items():
                key = (adm.cluster_queue, FlavorResource(psa.flavors[r], r))
                corr[key] = corr.get(key, 0) - v
    deltas = encode.encode_deltas(corr, topo) if corr else None
    if deltas is not None:
        encode.apply_deltas_np(topo, truth.usage, truth.cohort_usage, deltas)
    for name, got, want in (
            ("usage", rs.usage_dev.cpu().numpy(), rs.mirror_usage),
            ("cohort_usage", rs.cohort_dev.cpu().numpy(), rs.mirror_cohort),
            ("mirror usage", rs.mirror_usage, truth.usage),
            ("mirror cohort_usage", rs.mirror_cohort, truth.cohort_usage)):
        if not np.array_equal(got, want):
            raise AssertionError(f"resident {name} differs from the host")


def e2e_phase(device, phase: str) -> dict:
    """One main path, cycle after cycle: heads from the Manager, a cache
    snapshot, BatchSolver(device), the admissions applied as the
    scheduler applies them. Every cycle's decisions are held against the
    CPU plain path on the same snapshot and heads, outside the timed
    window."""
    from collections import deque

    from kueue_tpu_torch.api import kueue as api
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import BatchSolver, encode, kernel
    bound, churn = phase != "unbound", phase == "bound_churn"
    timed = BOUND_TIMED if bound else UNBOUND_TIMED
    num_cqs, num_cohorts = NORTH_STAR["num_cqs"], NORTH_STAR["num_cohorts"]
    flavors = [f"f{i}" for i in range(NORTH_STAR["num_flavors"])]
    t_phase = time.perf_counter()
    # StrictFIFO in the churn keeps a requeued head at its queue's front,
    # so the heads that do not fit come back unchanged every cycle.
    cache, queues = ns.build_cluster(
        num_cqs, num_cohorts, flavors, NOMINAL_UNITS,
        api.STRICT_FIFO if churn else api.BEST_EFFORT_FIFO)
    admitted = deque() if churn else None
    if churn:  # every flavor of every CQ full, oldest first by flavor
        for f in flavors:
            for i in range(num_cqs):
                wl = ns.admitted_workload(f"pre-{f}-{i}", f"cq{i}", f,
                                          NOMINAL_UNITS, 0.0)
                cache.assume_workload(wl)
                admitted.append(wl)
    staged = ns.stage_waves(queues, E2E_WAVES, num_cqs, NOMINAL_UNITS)
    log(f"[{phase}] cluster: {num_cqs} CQs, {num_cohorts} cohorts, "
        f"{len(flavors)} flavors x {NOMINAL_UNITS} units; "
        f"{len(admitted or ())} admitted and {staged} pending staged in "
        f"{time.perf_counter() - t_phase:.1f} s")
    solver = BatchSolver(device=device)
    if bound:
        solver.bind_cache(cache)
        solver.bind_queues(queues)
    reference = BatchSolver(device="cpu")
    topo = encode.encode_topology(cache.snapshot())
    keys = ("heads", "snapshot", "encode", "upload", "device",
            "fetch", "decode", "admit", "gc", "cycle", "upload_bytes")
    phases = {p: [] for p in keys}
    admitted_timed = 0
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)

    def check() -> None:
        if bound:
            check_resident(solver, cache, topo)

    def run_cycle(cycle: int, check_first: bool = True) -> dict:
        """One main-path cycle. Untimed: the check of the previous
        cycle's resident state, the finishes, the CPU reference solve and
        a full collection after it, which takes the reference's garbage (a
        second encode and decode of every head) out of the timed phases."""
        if check_first and cycle > 0:
            check()
        finished = ns.finish_admitted(cache, admitted, CHURN_FINISHES) \
            if churn else 0
        g0, t0 = gc_clock.total, time.perf_counter()
        heads = queues.heads_nonblocking()
        t1 = time.perf_counter()
        snapshot = cache.snapshot()
        t2 = time.perf_counter()
        decisions = solver.solve(snapshot, heads)
        g3, t3 = gc_clock.total, time.perf_counter()
        expected = reference.solve(snapshot, heads)
        if normalize(decisions) != normalize(expected):
            raise AssertionError(f"{phase} cycle {cycle}: CUDA decisions "
                                 "differ from the CPU plain path")
        del expected
        gc.collect()
        g4, t4 = gc_clock.total, time.perf_counter()
        n = ns.apply_decisions(cache, queues, solver if bound else None,
                               heads, decisions, 1000.0 + cycle, admitted)
        g5, t5 = gc_clock.total, time.perf_counter()
        row = {"heads": t1 - t0, "snapshot": t2 - t1, **solver.last_phase_s,
               "admit": t5 - t4, "gc": (g3 - g0) + (g5 - g4),
               "cycle": (t3 - t0) + (t5 - t4),
               "upload_bytes": solver.last_upload_bytes}
        depth = sorted({ps.flavors["cpu"].name for a, ok in decisions.values()
                        if ok for ps in a.pod_sets})
        arena = solver.arena
        log(f"[{phase}] cycle {cycle}"
            f"{' (warm-up)' if cycle < E2E_WARMUP else ''}: finished="
            f"{finished} heads={len(heads)} fit={len(decisions)} admitted="
            f"{n} flavors={depth if len(depth) < 4 else len(depth)} "
            f"pending={queues.pending_total()} cycle_ms="
            f"{row['cycle'] * 1e3:.1f} gc_ms={row['gc'] * 1e3:.1f} "
            f"untimed_gc_ms={(g4 - g3) * 1e3:.1f} upload_bytes="
            f"{row['upload_bytes']} arena full_uploads={arena.full_uploads} "
            f"row_uploads={arena.row_uploads} resident_cycles="
            f"{solver.counters['resident_cycles']} ms="
            + json.dumps({k: round(row[k] * 1e3, 3) for k in keys
                          if k not in ("gc", "cycle", "upload_bytes")}))
        row["admitted"] = n
        return row

    fetch = {}
    kernel.reset_launch_counts()
    for cycle in range(E2E_WARMUP + timed):
        with fetch_timing(solver, fetch) if cycle == E2E_WARMUP \
                else contextlib.nullcontext():
            row = run_cycle(cycle)
        if cycle < E2E_WARMUP:
            continue
        admitted_timed += row["admitted"]
        for k in keys:
            phases[k].append(row[k])
    launches = kernel.launch_counts()
    for name in PHASE_KERNELS[phase]:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{phase} path")
    summary = {k: {"p50_ms": percentile(v, 50) * 1e3,
                   "max_ms": max(v) * 1e3}
               for k, v in phases.items() if k != "upload_bytes"}
    summary["upload_bytes"] = {"p50": percentile(phases["upload_bytes"], 50),
                               "max": max(phases["upload_bytes"])}
    summary["admitted_per_s"] = admitted_timed / sum(phases["cycle"])
    summary["admitted_timed"] = admitted_timed
    summary["launches"] = launches
    summary["counters"] = dict(solver.counters)
    summary["fetch_timing"] = fetch
    arena = solver.arena
    summary["arena"] = {"cap": arena.cap, "full_uploads": arena.full_uploads,
                        "row_uploads": arena.row_uploads,
                        "encoded_rows": arena.encoded_rows}
    check()
    summary["traced_cycle"] = traced_cycle(phase, run_cycle,
                                           E2E_WARMUP + timed)
    check()
    gc.callbacks.remove(gc_clock)
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[{phase}] " + json.dumps(summary))
    return summary


SCHED_PHASES = ("heads", "snapshot", "nominate", "encode",
                "upload", "device", "fetch", "decode", "apply", "requeue")


def fair_env(device):
    """The fair-sharing configuration through the port's Scheduler, its
    solver on `device`. Returns (scheduler, cache, queues, client)."""
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import BatchSolver
    env = ns.build_scheduler(FAIR["num_cqs"], FAIR["num_cohorts"], ["f0"],
                             FAIR["nominal_units"],
                             solver=BatchSolver(device=device),
                             fair_sharing=True)
    ns.stage_waves(env[2], FAIR_WAVES, FAIR["num_cqs"], FAIR["cpu_units"])
    return env


def cycle_record(client, cache) -> tuple:
    """What a cycle left: the workloads it admitted, in order."""
    return tuple(wl.metadata.name for wl in client.new_applied)


def usage_by_cq(cache) -> list:
    return [sorted(cache.usage_for_cluster_queue(f"cq{i}")[0].items())
            for i in range(FAIR["num_cqs"])]


def scheduler_phase(device) -> dict:
    """The port's Scheduler with fair sharing, cycle after cycle, on the
    card: before each cycle the last cycle's admissions finish (outside
    the timed window, with the check of the resident state and a full
    collection); the cycle is one schedule() call. Then the same cycles
    with device="cpu" must admit the same workloads in the same order
    and leave the same usage per CQ."""
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import encode, kernel
    phase = "scheduler_fair"
    t_phase = time.perf_counter()
    sched, cache, queues, client = fair_env(device)
    solver = sched.solver
    log(f"[{phase}] cluster: {FAIR['num_cqs']} CQs, {FAIR['num_cohorts']} "
        f"cohorts, 1 flavor x {FAIR['nominal_units']} units, workloads of "
        f"{FAIR['cpu_units']} units; {queues.pending_total()} pending staged "
        f"in {time.perf_counter() - t_phase:.1f} s")
    topo = encode.encode_topology(cache.snapshot())
    keys = SCHED_PHASES + ("gc", "other", "cycle")
    phases = {p: [] for p in keys}
    records = []
    admitted_timed = 0
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)

    def run_cycle(cycle: int, check_first: bool = True) -> dict:
        if check_first and cycle > 0:
            check_resident(solver, cache, topo)
        t0 = time.perf_counter()
        finished = ns.finish_applied(cache, queues, client)
        t_finish = time.perf_counter() - t0
        gc.collect()
        before = client.admitted
        g0, t0 = gc_clock.total, time.perf_counter()
        sched.schedule(timeout=0)
        g1, t1 = gc_clock.total, time.perf_counter()
        if sched.last_route != "device":
            raise AssertionError(f"{phase} cycle {cycle} took the "
                                 f"{sched.last_route!r} route")
        records.append(cycle_record(client, cache))
        row = {**sched.last_phase_s, **solver.last_phase_s,
               "gc": g1 - g0, "cycle": t1 - t0}
        row["other"] = row["cycle"] - sum(row[p] for p in SCHED_PHASES)
        row["admitted"] = client.admitted - before
        log(f"[{phase}] cycle {cycle}"
            f"{' (warm-up)' if cycle < E2E_WARMUP else ''}: finished="
            f"{finished} (finish_ms={t_finish * 1e3:.1f}) admitted="
            f"{row['admitted']} pending={queues.pending_total()} cycle_ms="
            f"{row['cycle'] * 1e3:.1f} upload_bytes="
            f"{solver.last_upload_bytes} ms="
            + json.dumps({p: round(row[p] * 1e3, 3) for p in keys
                          if p != "cycle"}))
        return row

    captured = Captured(kernel, "drf_share")
    kernel.reset_launch_counts()
    for cycle in range(E2E_WARMUP + FAIR_TIMED):
        if cycle == E2E_WARMUP:
            # the first timed cycle keeps drf_share's inputs and output
            with captured:
                row = run_cycle(cycle)
        else:
            row = run_cycle(cycle)
        if cycle < E2E_WARMUP:
            continue
        admitted_timed += row["admitted"]
        for p in keys:
            phases[p].append(row[p])
    launches = kernel.launch_counts()
    for name in PHASE_KERNELS[phase]:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{phase} path")
    summary = {p: {"p50_ms": percentile(v, 50) * 1e3, "max_ms": max(v) * 1e3}
               for p, v in phases.items()}
    summary["admitted_per_s"] = admitted_timed / sum(phases["cycle"])
    summary["admitted_timed"] = admitted_timed
    summary["launches"] = launches
    summary["counters"] = dict(solver.counters)
    summary["cycle_counts"] = dict(sched.cycle_counts)
    summary["drf_share_check"] = check_captured_share(captured, kernel)
    check_resident(solver, cache, topo)
    summary["traced_cycle"] = traced_cycle(
        phase, run_cycle, E2E_WARMUP + FAIR_TIMED, kernel="drf_share")
    check_resident(solver, cache, topo)
    gc.callbacks.remove(gc_clock)
    # the same cycles on the CPU, with the kernels' plain versions
    t_cpu = time.perf_counter()
    c_sched, c_cache, c_queues, c_client = fair_env("cpu")
    for cycle, want in enumerate(records):
        ns.finish_applied(c_cache, c_queues, c_client)
        c_sched.schedule(timeout=0)
        if cycle_record(c_client, c_cache) != want:
            raise AssertionError(f"{phase} cycle {cycle}: the card admitted "
                                 "other workloads than the CPU")
    if c_client.admitted != client.admitted \
            or usage_by_cq(c_cache) != usage_by_cq(cache):
        raise AssertionError(f"{phase}: admitted totals or usage per CQ "
                             "differ between the card and the CPU")
    summary["cpu_check_s"] = time.perf_counter() - t_cpu
    summary["admitted_total"] = client.admitted
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[{phase}] equal to the CPU run: {len(records)} cycles, "
        f"{client.admitted} admitted, usage of {FAIR['num_cqs']} CQs")
    log(f"[{phase}] " + json.dumps(summary))
    return summary


class Captured:
    """Within the block, `module.name` keeps the arguments (tensors and
    dicts of them cloned before the call, the rest as they are) and the
    result of its last call, and calls through. The
    wrapper bumps its launch count on its own module-level name, which
    is this object inside the block: `launches` reads and writes the
    registered wrapper's count, so the count stays where it was."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.real = getattr(module, name)
        self.args = self.out = None
        self.kwargs = {}

    @property
    def launches(self) -> int:
        return self.real.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.real.launches = n

    def __call__(self, *args, **kwargs):
        self.args = tuple({k: v.clone() for k, v in a.items()}
                          if isinstance(a, dict) else
                          a.clone() if hasattr(a, "clone") else a
                          for a in args)
        self.kwargs = dict(kwargs)
        self.out = self.real(*args, **kwargs)
        return self.out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def check_captured_share(captured: Captured, k) -> dict:
    """drf_share on the main path's own inputs: the shares the captured
    cycle ordered by must equal the plain version's on the same card
    tensors. The fair cell's shares are uniform (every CQ at weight 1000
    starts the cycle empty and every head borrows alike), so the kernel
    is also held against its plain version on the same heads, CQs and
    assignments with a seeded usage and weights 0/500/1000/3000, which
    must give more than two distinct shares. Runs after the phase's
    launch counts are read."""
    import numpy as np
    import torch
    if captured.args is None:
        raise AssertionError("drf_share was not called in the captured "
                             "cycle")
    topo, usage, asg, wl_cq = captured.args
    compare(("share (main path)",), (captured.out,),
            (k.drf_share_plain(*captured.args),))
    rng = np.random.default_rng(13)
    nominal = topo["nominal"].cpu().numpy()
    weights = np.array([0, 500, 1000, 3000], np.int64)[
        rng.integers(0, 4, size=nominal.shape[0])]
    varied_topo = dict(topo, fair_weight=torch.from_numpy(weights).to(
        usage.device))
    varied_usage = torch.from_numpy(
        rng.integers(0, 2 * nominal + 1)).to(usage.device)
    v_args = (varied_topo, varied_usage, asg, wl_cq)
    want = k.drf_share_plain(*v_args)
    compare(("share (varied usage and weights)",), (k.drf_share(*v_args),),
            (want,))
    distinct = int(torch.unique(want).numel())
    if distinct <= 2:
        raise AssertionError(f"drf_share varied inputs give only {distinct} "
                             "distinct shares")
    out = {"heads": int(asg.shape[0]), "shape": list(asg.shape),
           "main_path_distinct": sorted(
               int(v) for v in torch.unique(captured.out).cpu())[:16],
           "varied_distinct": distinct, "max_abs_err": 0}
    log("[scheduler_fair] drf_share equal to plain on the captured cycle's "
        "inputs and on them with varied usage and weights: "
        + json.dumps(out))
    return out


PREEMPT_PHASES = ("heads", "snapshot", "nominate", "encode", "upload",
                  "device", "fetch", "decode", "preempt-plan", "preempt",
                  "decode-targets", "apply", "requeue")


def preempt_env(device, samples=()):
    """The preemption-heavy configuration, its Scheduler's solver on
    `device` (None: no solver, the cpu-forced route); `samples` carry
    the solver's measured sync floor across fresh builds, as the JAX
    package's _run_preempt_pair does. Returns (scheduler, cache, queues,
    client)."""
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import BatchSolver
    solver = None if device is None else BatchSolver(device=device)
    env = ns.build_preempt_reclaim(**PREEMPT, solver=solver)
    if solver is not None and samples:
        solver._sync_samples = list(samples)
    return env


def preempt_expected() -> tuple:
    """(preempt-mode heads, problems): every CQ's preemptor; a borrower's
    gives one problem (its own CQ), a lender's two (the reclaim, then its
    own CQ's, empty)."""
    children = PREEMPT["num_roots"] * PREEMPT["children_per_root"]
    cqs = children * PREEMPT["cqs_per_child"]
    return cqs, (cqs - children) + 2 * children


def cycle_outcome(client) -> tuple:
    """What a cycle did: its evictions (workload, Preempted reason) in
    issue order and the workloads it admitted."""
    return (tuple(client.evictions),
            tuple(sorted(wl.metadata.name for wl in client.new_applied)))


def preempt_bytes(args, outs, usage) -> int:
    """Bytes solve_preempt must move on these inputs: every problem array
    and output once, each candidate-table row a valid candidate points
    at, and each quota element the problems gather (nominal, guaranteed,
    borrow limit and usage of a (CQ, flavor, resource); subtree,
    guaranteed, borrow limit and usage of a (cohort, flavor, resource),
    and the cohort's depth), once."""
    import torch
    (gq, gf, gr, gc, chain, req, frs, cidx, cql, tab_u, tab_p, ab, tha, th,
     hc) = args
    F, R = usage.shape[1:]
    moved = nbytes(gq, gf, gr, gc, chain, req, frs, cidx, cql, ab, tha, th,
                   hc, *outs)
    rows = torch.unique(cidx[cql >= 0].long())
    moved += int(rows.numel()) * (tab_u.shape[1] * 8 + 4)
    vf = (gf >= 0)[:, None, :]
    fr = gf.long().clamp_min(0)[:, None, :] * R + gr.long()[:, None, :]
    for idx in (gq, gc):
        coord = idx.long()[:, :, None] * (F * R) + fr
        moved += int(torch.unique(coord[(idx >= 0)[:, :, None] & vf])
                     .numel()) * 4 * 8
    moved += int(torch.unique(gc[gc >= 0]).numel()) * 4
    return moved


def preempt_kernel_check(label: str, k, args: tuple, got, n_real: int,
                         timed: bool) -> dict:
    """solve_preempt's outputs `got` against the plain version on the
    same card tensors (all three equal); with `timed`, the kernel's
    device time (profiler), its time per call and the plain version's
    (CUDA events), and its byte bound."""
    import torch
    want = k.solve_preempt_plain(*args)
    compare(("targets", "feasible", "stats"), got, want)
    stats = want[2][:n_real].cpu()
    feasible = want[1][:n_real].cpu()
    rounds = stats[:, 2]
    row = {"max_abs_err": 0.0, "problems": n_real,
           "shape_B_K_QL_RF_CL_DC": [args[3].shape[0], args[11].shape[1],
                                     args[3].shape[1], args[4].shape[1],
                                     args[6].shape[1], args[7].shape[2]],
           "feasible": int(feasible.sum()),
           "targets": int(want[0].sum()),
           "filled_back": int(stats[:, 3].sum()),
           "rounds_max": int(rounds.max()),
           "rounds_mean": float(rounds.float().mean())}
    if timed:
        def run_kernel():
            return k.solve_preempt(*args)

        def run_plain():
            return k.solve_preempt_plain(*args)
        torch.cuda.synchronize()
        row["call_ms"] = time_cuda(run_kernel, iters=10)
        row["plain_ms"] = time_cuda(run_plain, iters=2, warmup=1)
        kernel_ms = profiled_device_ms(run_kernel, 10, "solve_preempt")
        row["ms"], row["ms_source"] = (kernel_ms, "profiler") \
            if kernel_ms is not None else (row["call_ms"], "events")
        row["bytes"] = preempt_bytes(args[3:], want, args[1])
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        # the fill-back rounds are dependent block-wide passes: one
        # forward pass, then 1 + 2 (rounds - 1) fill-back evaluations
        row["dependent_steps"] = 2 * row["rounds_max"]
        row["library_ms"] = None
    log(f"[kernels:solve_preempt:{label}] equal to plain: "
        + json.dumps(row))
    return row


def scheduler_preempt_phase(device) -> dict:
    """The port's Scheduler with device preemption on the preemption-
    heavy configuration: each cycle is the first schedule() of a fresh
    build (the build, outside the timed window), 1 warm-up and
    PREEMPT_TIMED timed; every one must take the device route, the work
    gate must choose the device and every preempt-mode head must be
    solved there. solve_preempt's inputs in the first timed cycle are
    kept and held against the plain version; then the same scenario with
    device="cpu" and on the cpu-forced route must evict the same
    workloads with the same reasons and admit the same workloads."""
    import torch
    from kueue_tpu_torch.solver import kernel, synth
    phase = "scheduler_preempt"
    heads_n, problems_n = preempt_expected()
    keys = PREEMPT_PHASES + ("gc", "other", "cycle")
    phases = {p: [] for p in keys}
    outcomes, plans = [], []
    evicted_timed = 0
    samples: list = []
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    t_phase = time.perf_counter()

    def run_cycle(cycle: int, check_first: bool = True) -> dict:
        t0 = time.perf_counter()
        sched, cache, queues, client = preempt_env(device, samples)
        pending = []
        stage = sched._stage_preempt

        def counted(entries, *a, **kw):
            pending.append(len(entries))
            return stage(entries, *a, **kw)
        sched._stage_preempt = counted
        t_build = time.perf_counter() - t0
        gc.collect()
        g0, t0 = gc_clock.total, time.perf_counter()
        sched.schedule(timeout=0)
        g1, t1 = gc_clock.total, time.perf_counter()
        samples[:] = sched.solver._sync_samples
        plan = sched.last_preempt_plan.get("minimal", {})
        if sched.last_route != "device" or sched.last_preempt_gate != "device":
            raise AssertionError(f"{phase} cycle {cycle}: route "
                                 f"{sched.last_route!r}, preemption gate "
                                 f"{sched.last_preempt_gate!r}")
        if pending != [heads_n] or plan.get("problems") != problems_n:
            raise AssertionError(f"{phase} cycle {cycle}: {pending} "
                                 f"preempt-mode heads and {plan} problems, "
                                 f"not {heads_n} and {problems_n}")
        row = {**sched.last_phase_s, **sched.solver.last_phase_s,
               "gc": g1 - g0, "cycle": t1 - t0}
        row["other"] = row["cycle"] - sum(row[p] for p in PREEMPT_PHASES)
        row["evicted"] = client.evicted
        row["outcome"] = cycle_outcome(client)
        row["plan"] = plan
        log(f"[{phase}] cycle {cycle}"
            f"{' (warm-up)' if cycle < E2E_WARMUP else ''}: build_s="
            f"{t_build:.1f} evicted={client.evicted} admitted="
            f"{client.admitted} plan={json.dumps(plan)} cycle_ms="
            f"{row['cycle'] * 1e3:.1f} upload_bytes="
            f"{sched.solver.last_upload_bytes} ms="
            + json.dumps({p: round(row[p] * 1e3, 3) for p in keys
                          if p != "cycle"}))
        return row

    captured = Captured(kernel, "solve_preempt")
    kernel.reset_launch_counts()
    for cycle in range(E2E_WARMUP + PREEMPT_TIMED):
        if cycle == E2E_WARMUP:
            with captured:
                row = run_cycle(cycle)
        else:
            row = run_cycle(cycle)
        if cycle < E2E_WARMUP:
            continue
        evicted_timed += row["evicted"]
        outcomes.append(row["outcome"])
        plans.append(row["plan"])
        for p in keys:
            phases[p].append(row[p])
    launches = kernel.launch_counts()
    for name in PHASE_KERNELS[phase]:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{phase} path")
    if len(set(outcomes)) != 1 or not outcomes[0][0]:
        raise AssertionError(f"{phase}: the fresh builds' cycles evicted "
                             "differently, or nothing")
    summary = {p: {"p50_ms": percentile(v, 50) * 1e3, "max_ms": max(v) * 1e3}
               for p, v in phases.items()}
    summary["evicted_per_cycle"] = evicted_timed / PREEMPT_TIMED
    summary["evicted_per_s"] = evicted_timed / sum(phases["cycle"])
    summary["admitted_per_cycle"] = len(outcomes[0][1])
    summary["reasons"] = sorted({r for _, r in outcomes[0][0]})
    summary["preempt_plan"] = plans[-1]
    summary["launches"] = launches
    if captured.args is None:
        raise AssertionError("solve_preempt was not called in the captured "
                             "cycle")
    summary["kernel_rows"] = {"captured": preempt_kernel_check(
        "captured", kernel, captured.args, captured.out, problems_n, True)}
    topo, usage, cu, args = synth.synth_preempt_inputs(**PREEMPT_NESTED)
    dev_args = (kernel.topo_to_device(topo, device),
                *kernel.state_to_device(usage, cu, device),
                *(torch.from_numpy(a).to(device) for a in args))
    summary["kernel_rows"]["nested"] = preempt_kernel_check(
        "nested", kernel, dev_args, kernel.solve_preempt(*dev_args),
        PREEMPT_NESTED["num_problems"], True)
    summary["traced_cycle"] = traced_cycle(
        phase, run_cycle, E2E_WARMUP + PREEMPT_TIMED, kernel="solve_preempt")
    gc.callbacks.remove(gc_clock)
    # the same scenario on the CPU: the plain K9, then the CPU Preemptor
    t_cpu = time.perf_counter()
    for dev, route in (("cpu", "device"), (None, "cpu-forced")):
        sched, cache, queues, client = preempt_env(dev)
        sched.schedule(timeout=0)
        if sched.last_route != route or (
                dev is not None and sched.last_preempt_gate != "device"):
            raise AssertionError(f"{phase}: the CPU run took the "
                                 f"{sched.last_route!r} route")
        if cycle_outcome(client) != outcomes[0]:
            raise AssertionError(f"{phase}: the card evicted or admitted "
                                 f"other workloads than the {route} route "
                                 "on the CPU")
        if dev is not None and sched.last_preempt_plan["minimal"] \
                != plans[0]:
            raise AssertionError(f"{phase}: the solve stats differ between "
                                 "the card and the CPU")
    summary["cpu_check_s"] = time.perf_counter() - t_cpu
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[{phase}] equal to the device=\"cpu\" and cpu-forced runs: "
        f"{len(outcomes[0][0])} evictions ({', '.join(summary['reasons'])}),"
        f" {len(outcomes[0][1])} admitted")
    log(f"[{phase}] " + json.dumps(
        {k: v for k, v in summary.items() if k != "kernel_rows"}))
    return summary


def fair_preempt_env(device, samples=()):
    """The fair-sharing preemption configuration, its Scheduler's solver
    on `device` (None: no solver, the cpu-forced route); `samples` carry
    the solver's measured sync floor across fresh builds. Returns
    (scheduler, cache, queues, client)."""
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import BatchSolver
    solver = None if device is None else BatchSolver(device=device)
    env = ns.build_fair_preemption(**FAIR_PREEMPT, solver=solver)
    if solver is not None and samples:
        solver._sync_samples = list(samples)
    return env


def count_preemption_syncs(solver, calls: list) -> None:
    """Record (the solves run, syncs made) of each solve_preemptions of
    `solver`."""
    real = solver.solve_preemptions

    def counted(*a, **kw):
        before = solver.counters["syncs"]
        aux = real(*a, **kw)
        calls.append((sorted(aux or ()), solver.counters["syncs"] - before))
        return aux
    solver.solve_preemptions = counted


def fair_bytes(args, outs, usage) -> int:
    """Bytes solve_fair must move on these inputs: every problem array
    and output once, each candidate-table row a valid candidate points
    at, and each quota element the problems gather once: usage, nominal
    and guaranteed of a (CQ, flavor, resource) (and the preemptor CQ's
    borrow limit), usage, guaranteed, subtree and borrow limit of a
    (cohort, flavor, resource)."""
    import torch
    (gq, gf, gr, gc, chain, req, frs, cidx, cql, tab_u, tab_p, tha, th, hc,
     rank, count, order, base, floor_r, floor_a, weight, lend) = args
    F, R = usage.shape[1:]
    moved = nbytes(gq, gf, gr, gc, chain, req, frs, cidx, cql, tha, th, hc,
                   rank, count, order, base, floor_r, floor_a, weight, lend,
                   *outs)
    rows = torch.unique(cidx[cql >= 0].long())
    moved += int(rows.numel()) * (tab_u.shape[1] * 8 + 4)
    vf = (gf >= 0)[:, None, :]
    fr = gf.long().clamp_min(0)[:, None, :] * R + gr.long()[:, None, :]
    for idx, words in ((gq, 3), (gq[:, :1], 1), (gc, 4)):
        coord = idx.long()[:, :, None] * (F * R) + fr
        moved += int(torch.unique(coord[(idx >= 0)[:, :, None] & vf])
                     .numel()) * words * 8
    return moved


def fair_kernel_check(label: str, k, args: tuple, kwargs: dict, got,
                      n_real: int, timed: bool) -> dict:
    """solve_fair's outputs `got` against the plain version on the same
    card tensors (all four equal); with `timed`, the kernel's device
    time (profiler), its time per call and the plain version's (CUDA
    events), its byte bound and its chain of dependent steps."""
    import torch
    want = k.solve_fair_plain(*args, **kwargs)
    compare(("targets", "feasible", "reasons", "stats"), got, want)
    stats = want[3][:n_real].cpu()
    feasible = want[1][:n_real].cpu()
    strat = kwargs["strat"]
    QL = args[3].shape[1]
    # the forward pops, the retry pass's QL steps (with a second
    # strategy) and the fill-back iterations are one dependent chain
    steps = int((stats[:, 1] + stats[:, 2]).max()) + (QL if strat[1] else 0)
    row = {"max_abs_err": 0.0, "problems": n_real, "strat": list(strat),
           "shape_B_K_QL_RF_CL_DC": [args[3].shape[0], args[11].shape[1],
                                     QL, args[4].shape[1], args[6].shape[1],
                                     args[7].shape[2]],
           "feasible": int(feasible.sum()),
           "targets": int(want[0].sum()),
           "reasons": [int((want[2][want[0]] == c).sum()) for c in range(3)],
           "pops_max": int(stats[:, 1].max()),
           "pops_mean": float(stats[:, 1].float().mean()),
           "fillback_max": int(stats[:, 2].max()),
           "filled_back": int(stats[:, 3].sum()),
           "dependent_steps": steps}
    if timed:
        def run_kernel():
            return k.solve_fair(*args, **kwargs)

        def run_plain():
            return k.solve_fair_plain(*args, **kwargs)
        torch.cuda.synchronize()
        row["call_ms"] = time_cuda(run_kernel, iters=10)
        row["plain_ms"] = time_cuda(run_plain, iters=2, warmup=1)
        kernel_ms = profiled_device_ms(run_kernel, 10, "solve_fair")
        row["ms"], row["ms_source"] = (kernel_ms, "profiler") \
            if kernel_ms is not None else (row["call_ms"], "events")
        row["bytes"] = fair_bytes(args[3:], want, args[1])
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        row["library_ms"] = None
    log(f"[kernels:solve_fair:{label}] equal to plain: " + json.dumps(row))
    return row


def mixed_cycle_check(device) -> dict:
    """A fair-sharing cycle with a minimal and a fair problem
    (sim/northstar build_mixed_preemption) on the card and on the CPU:
    K9 and K11 launched after one sync on the card, the same evictions
    and solve stats on both. Then what the shared sync saves: the
    cycle's two batches through solve_preemptions together (one upload,
    one sync, one fetch) and each alone (two of each, as a second launch
    would be), in turns, host clock per call."""
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import BatchSolver, kernel
    rows, calls, batches = [], [], []
    before = kernel.launch_counts()
    for dev in (device, "cpu"):
        sched, cache, queues, client = ns.build_mixed_preemption(
            solver=BatchSolver(device=dev))
        sched.solver_sync_floor_ms = 0.0
        real = sched.solver.solve_preemptions

        def keep(*a, real=real):
            batches.append(a)
            return real(*a)
        sched.solver.solve_preemptions = keep
        count_preemption_syncs(sched.solver, calls)
        sched.schedule(timeout=0)
        rows.append((tuple(client.evictions), sched.last_preempt_plan))
        if dev == device:
            card_solver = sched.solver
    after = kernel.launch_counts()
    want = ["fair", "fair_stats", "preempt", "preempt_stats"]
    if rows[0] != rows[1] or sorted(rows[0][1]) != ["fair", "minimal"] \
            or calls != [(want, 1), (want, 1)] or not rows[0][0]:
        raise AssertionError(f"mixed cycle: {rows} {calls}")
    for name in ("solve_preempt", "solve_fair"):
        if after[name] != before[name] + 1:
            raise AssertionError(f"mixed cycle: {name} not launched once")
    pb, fb, flags = batches[0]
    shared, apart = [], []

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    for _ in range(SYNC_ROUNDS):
        for _ in range(SYNC_CALLS):
            shared.append(timed(lambda: card_solver.solve_preemptions(
                pb, fb, flags)))
        for _ in range(SYNC_CALLS):
            apart.append(timed(lambda: (
                card_solver.solve_preemptions(pb, None, flags),
                card_solver.solve_preemptions(None, fb, flags))))
    out = {"evictions": len(rows[0][0]), "plan": rows[0][1],
           "syncs_for_k9_and_k11": calls[0][1],
           "reasons": sorted({r for _, r in rows[0][0]}),
           "one_sync_ms_p50": percentile(shared, 50),
           "two_syncs_ms_p50": percentile(apart, 50),
           "second_sync_ms_p50": percentile(apart, 50)
           - percentile(shared, 50),
           "calls": len(shared),
           "estimated_sync_ms": card_solver.estimated_sync_ms()}
    log("[scheduler_fair_preempt] mixed cycle: " + json.dumps(out))
    return out


def scheduler_fair_preempt_phase(device) -> dict:
    """The port's Scheduler with fair sharing and device preemption on
    the fair-sharing preemption configuration: each cycle is the first
    schedule() of a fresh build (the build, outside the timed window), 1
    warm-up and FAIR_PREEMPT_TIMED timed; every one must take the device
    route, the work gate must choose the device, every preempt-mode head
    must be a fair problem solved there and the preemption solves must
    make one sync. solve_fair's inputs in the first timed cycle are kept
    and held against the plain version; then the same scenario with
    device="cpu" and on the cpu-forced route must evict the same
    workloads with the same reasons and admit the same workloads."""
    import torch
    from kueue_tpu_torch.solver import kernel, synth
    phase = "scheduler_fair_preempt"
    heads_n = FAIR_PREEMPT["num_cohorts"]
    keys = PREEMPT_PHASES + ("gc", "other", "cycle")
    phases = {p: [] for p in keys}
    outcomes, plans = [], []
    evicted_timed = 0
    samples: list = []
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    t_phase = time.perf_counter()

    def run_cycle(cycle: int, check_first: bool = True) -> dict:
        t0 = time.perf_counter()
        sched, cache, queues, client = fair_preempt_env(device, samples)
        pending, calls = [], []
        stage = sched._stage_preempt

        def counted(entries, *a, **kw):
            pending.append(len(entries))
            return stage(entries, *a, **kw)
        sched._stage_preempt = counted
        count_preemption_syncs(sched.solver, calls)
        t_build = time.perf_counter() - t0
        gc.collect()
        g0, t0 = gc_clock.total, time.perf_counter()
        sched.schedule(timeout=0)
        g1, t1 = gc_clock.total, time.perf_counter()
        samples[:] = sched.solver._sync_samples
        plan = sched.last_preempt_plan
        if sched.last_route != "device" or sched.last_preempt_gate != "device":
            raise AssertionError(f"{phase} cycle {cycle}: route "
                                 f"{sched.last_route!r}, preemption gate "
                                 f"{sched.last_preempt_gate!r}")
        if pending != [heads_n] or set(plan) != {"fair"} \
                or plan["fair"]["problems"] != heads_n:
            raise AssertionError(f"{phase} cycle {cycle}: {pending} "
                                 f"preempt-mode heads and {plan} problems, "
                                 f"not {heads_n} fair ones")
        if calls != [(["fair", "fair_stats"], 1)]:
            raise AssertionError(f"{phase} cycle {cycle}: preemption solves "
                                 f"and syncs {calls}")
        row = {**sched.last_phase_s, **sched.solver.last_phase_s,
               "gc": g1 - g0, "cycle": t1 - t0}
        row["other"] = row["cycle"] - sum(row[p] for p in PREEMPT_PHASES)
        row["evicted"] = client.evicted
        row["outcome"] = cycle_outcome(client)
        row["plan"] = plan["fair"]
        log(f"[{phase}] cycle {cycle}"
            f"{' (warm-up)' if cycle < E2E_WARMUP else ''}: build_s="
            f"{t_build:.1f} evicted={client.evicted} admitted="
            f"{client.admitted} plan={json.dumps(plan)} cycle_ms="
            f"{row['cycle'] * 1e3:.1f} upload_bytes="
            f"{sched.solver.last_upload_bytes} ms="
            + json.dumps({p: round(row[p] * 1e3, 3) for p in keys
                          if p != "cycle"}))
        return row

    captured = Captured(kernel, "solve_fair")
    kernel.reset_launch_counts()
    for cycle in range(E2E_WARMUP + FAIR_PREEMPT_TIMED):
        if cycle == E2E_WARMUP:
            with captured:
                row = run_cycle(cycle)
        else:
            row = run_cycle(cycle)
        if cycle < E2E_WARMUP:
            continue
        evicted_timed += row["evicted"]
        outcomes.append(row["outcome"])
        plans.append(row["plan"])
        for p in keys:
            phases[p].append(row[p])
    launches = kernel.launch_counts()
    for name in PHASE_KERNELS[phase]:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{phase} path")
    if launches["solve_fair"] != E2E_WARMUP + FAIR_PREEMPT_TIMED:
        raise AssertionError(f"{phase}: solve_fair launched "
                             f"{launches['solve_fair']} times")
    if len(set(outcomes)) != 1 or not outcomes[0][0]:
        raise AssertionError(f"{phase}: the fresh builds' cycles evicted "
                             "differently, or nothing")
    summary = {p: {"p50_ms": percentile(v, 50) * 1e3, "max_ms": max(v) * 1e3}
               for p, v in phases.items()}
    summary["evicted_per_cycle"] = evicted_timed / FAIR_PREEMPT_TIMED
    summary["evicted_per_s"] = evicted_timed / sum(phases["cycle"])
    summary["admitted_per_cycle"] = len(outcomes[0][1])
    summary["reasons"] = sorted({r for _, r in outcomes[0][0]})
    summary["preempt_plan"] = plans[-1]
    summary["launches"] = launches
    if captured.args is None:
        raise AssertionError("solve_fair was not called in the captured "
                             "cycle")
    summary["kernel_rows"] = {"captured": fair_kernel_check(
        "captured", kernel, captured.args, captured.kwargs, captured.out,
        heads_n, True)}
    topo, usage, cu, args = synth.synth_fair_inputs(**FAIR_NESTED)
    dev_args = (kernel.topo_to_device(topo, device),
                *kernel.state_to_device(usage, cu, device),
                *(torch.from_numpy(a).to(device) for a in args))
    for strat in FAIR_STRATS:
        kw = {"strat": strat}
        summary["kernel_rows"][f"nested {strat}"] = fair_kernel_check(
            f"nested {strat}", kernel, dev_args, kw,
            kernel.solve_fair(*dev_args, **kw), FAIR_NESTED["num_problems"],
            strat == FAIR_STRATS[0])
    summary["kernel_rows"]["nested"] = \
        summary["kernel_rows"][f"nested {FAIR_STRATS[0]}"]
    summary["traced_cycle"] = traced_cycle(
        phase, run_cycle, E2E_WARMUP + FAIR_PREEMPT_TIMED, kernel="solve_fair")
    gc.callbacks.remove(gc_clock)
    # the same scenario on the CPU: the plain K11, then the CPU Preemptor
    t_cpu = time.perf_counter()
    for dev, route in (("cpu", "device"), (None, "cpu-forced")):
        sched, cache, queues, client = fair_preempt_env(dev)
        sched.schedule(timeout=0)
        if sched.last_route != route or (
                dev is not None and sched.last_preempt_gate != "device"):
            raise AssertionError(f"{phase}: the CPU run took the "
                                 f"{sched.last_route!r} route")
        if cycle_outcome(client) != outcomes[0]:
            raise AssertionError(f"{phase}: the card evicted or admitted "
                                 f"other workloads than the {route} route "
                                 "on the CPU")
        if dev is not None and sched.last_preempt_plan["fair"] != plans[0]:
            raise AssertionError(f"{phase}: the solve stats differ between "
                                 "the card and the CPU")
    summary["cpu_check_s"] = time.perf_counter() - t_cpu
    summary["mixed_cycle"] = mixed_cycle_check(device)
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[{phase}] equal to the device=\"cpu\" and cpu-forced runs: "
        f"{len(outcomes[0][0])} evictions ({', '.join(summary['reasons'])}),"
        f" {len(outcomes[0][1])} admitted")
    log(f"[{phase}] " + json.dumps(
        {k: v for k, v in summary.items() if k != "kernel_rows"}))
    return summary


def mk_env(device):
    """The MultiKueue cell, its Scheduler's solver on `device`. Returns
    (scheduler, cache, queues, client, remote capacity)."""
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import BatchSolver
    return ns.build_multikueue(**MK, solver=BatchSolver(device=device))


def mk_lose(remote, cycle: int) -> None:
    if cycle >= MK_LOST[1]:
        remote.lost.add(MK_LOST[0])


def cluster_bytes(args, out) -> int:
    """Bytes cluster_cols must move on these inputs: the columns and the
    order once, the admitted flags, the CQ of each admitted row and the
    check flag of each such CQ, the podset flags of the rows that take
    part and the requests of their active podsets only, mk_cluster
    written once."""
    import torch
    ccap, coffer, cactive, mk_cq, requests, podset_active, wl_cq, order, \
        admitted = args
    _, P, R = requests.shape
    q = wl_cq[admitted].long()
    rows = admitted.nonzero().squeeze(1)[mk_cq[q]]
    active = int(podset_active[rows].sum())
    return nbytes(ccap, coffer, cactive, order, admitted, out) + \
        4 * int(q.numel()) + int(torch.unique(q).numel()) + \
        int(rows.numel()) * P + active * R * 8


def cluster_kernel_check(label: str, k, args: tuple, got, cols: tuple,
                         resources: list, timed: bool) -> dict:
    """cluster_cols' output `got` against the plain version on the same
    card tensors and against the host oracle (synth.cluster_oracle: the
    rows walked in the global admit order through place_remote_dicts on
    `cols`); with `timed`, the kernel's device time (profiler), its time
    per call and the plain version's (CUDA events), its byte bound and
    its chain of dependent steps (one per placed row)."""
    import numpy as np
    import torch
    from kueue_tpu_torch.solver import synth
    want = k.score_cluster_columns_plain(*args)
    compare(("mk_cluster",), (got,), (want,))
    host = [a.cpu().numpy() for a in args]
    oracle = synth.cluster_oracle(cols, resources, host[4], host[5], host[6],
                                  host[7], host[8], host[3])
    mkc = got.cpu().numpy()
    if not np.array_equal(mkc, oracle):
        bad = int((mkc != oracle).sum())
        raise AssertionError(f"cluster_cols ({label}) differs from the host "
                             f"oracle on {bad} rows")
    part = host[8] & host[3][host[6]]
    placed = int((mkc >= 0).sum())
    row = {"max_abs_err": 0.0, "rows": int(part.sum()), "placed": placed,
           "unplaced": int(part.sum()) - placed,
           "shape_K_F_R_W_P": [*args[0].shape, *args[4].shape[:2]],
           "active_clusters": int(host[2].sum()),
           "by_column": np.bincount(mkc[mkc >= 0],
                                    minlength=args[0].shape[0]).tolist(),
           "dependent_steps": placed, "oracle_equal": True}
    if timed:
        def run_kernel():
            return k.score_cluster_columns(*args)

        def run_plain():
            return k.score_cluster_columns_plain(*args)
        torch.cuda.synchronize()
        row["call_ms"] = time_cuda(run_kernel, iters=20)
        row["plain_ms"] = time_cuda(run_plain, iters=2, warmup=1)
        kernel_ms = profiled_device_ms(run_kernel, 20, "cluster_cols")
        row["ms"], row["ms_source"] = (kernel_ms, "profiler") \
            if kernel_ms is not None else (row["call_ms"], "events")
        row["bytes"] = cluster_bytes(args, got)
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        # no one PyTorch call runs the sequential scan
        row["library_ms"] = None
    log(f"[kernels:cluster_cols:{label}] equal to plain and to the host "
        "oracle: " + json.dumps(row))
    return row


def scheduler_multikueue_phase(device) -> dict:
    """The port's Scheduler on the MultiKueue cell, cycle after cycle, on
    the card: before each cycle the last cycle's admissions finish (their
    remote capacity credited back), outside the timed window with the
    check of the resident state and a full collection; the cycle is one
    schedule() call, which must take the device route and launch
    cluster_cols once. Placements (on_placement) never land on a lost
    cluster and land on at least three. cluster_cols' inputs in the first
    timed cycle are kept and held against the plain version and the host
    oracle, as is a synthetic batch; then the same cycles with
    device="cpu" must admit the same workloads and make the same
    placements in the same order."""
    from collections import Counter

    import torch
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import encode, kernel, synth
    phase = "scheduler_multikueue"
    t_phase = time.perf_counter()
    sched, cache, queues, client, remote = mk_env(device)
    solver = sched.solver
    snap = cache.snapshot()
    topo = encode.encode_topology(snap)
    mk_cqs = {n for n, cq in snap.cluster_queues.items()
              if ns.MK_CHECK in cq.admission_checks}
    log(f"[{phase}] cluster: {MK['num_cqs']} CQs ({len(mk_cqs)} with "
        f"{ns.MK_CHECK}), {MK['num_cohorts']} cohorts, {MK['num_flavors']} "
        f"flavors x {MK['nominal_units']} units; {queues.pending_total()} "
        f"pending staged; clusters {sorted(remote.free)} (lost "
        f"{sorted(remote.lost)}; {MK_LOST[0]} from cycle {MK_LOST[1]}) in "
        f"{time.perf_counter() - t_phase:.1f} s")
    keys = SCHED_PHASES + ("gc", "other", "cycle")
    phases = {p: [] for p in keys}
    records, cols_by_cycle, rows_mk = [], {}, []
    admitted_timed = 0
    wrapper = kernel.KERNEL_WRAPPERS["cluster_cols"][0]
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)

    def run_cycle(cycle: int, check_first: bool = True) -> dict:
        if check_first and cycle > 0:
            check_resident(solver, cache, topo)
        mk_lose(remote, cycle)
        t0 = time.perf_counter()
        finished = ns.finish_applied(cache, queues, client, remote)
        t_finish = time.perf_counter() - t0
        gc.collect()
        start, lost = len(remote.placements), set(remote.lost)
        cols_by_cycle[cycle] = remote.capacity_columns()[0]
        before, k_before = client.admitted, wrapper.launches
        g0, t0 = gc_clock.total, time.perf_counter()
        sched.schedule(timeout=0)
        g1, t1 = gc_clock.total, time.perf_counter()
        if sched.last_route != "device":
            raise AssertionError(f"{phase} cycle {cycle} took the "
                                 f"{sched.last_route!r} route")
        placements = tuple(remote.placements[start:])
        on_lost = [c for _, c in placements if c in lost]
        if on_lost:
            raise AssertionError(f"{phase} cycle {cycle}: placements on "
                                 f"lost clusters {sorted(set(on_lost))}")
        records.append((cycle_record(client, cache), placements))
        mk_admitted = sum(1 for wl in client.new_applied
                          if wl.status.admission.cluster_queue in mk_cqs)
        row = {**sched.last_phase_s, **solver.last_phase_s,
               "gc": g1 - g0, "cycle": t1 - t0}
        row["other"] = row["cycle"] - sum(row[p] for p in SCHED_PHASES)
        row["admitted"] = client.admitted - before
        mk = {"launches": wrapper.launches - k_before,
              "mk_admitted": mk_admitted,
              "device_placed": len(solver.last_placements),
              "unplaced": mk_admitted - len(solver.last_placements),
              "placements": len(placements),
              "by_cluster": dict(sorted(Counter(
                  c for _, c in placements).items())),
              "upload_bytes": solver.last_upload_bytes}
        row["mk"] = mk
        log(f"[{phase}] cycle {cycle}"
            f"{' (warm-up)' if cycle < E2E_WARMUP else ''}: finished="
            f"{finished} (finish_ms={t_finish * 1e3:.1f}) admitted="
            f"{row['admitted']} lost={sorted(lost)} mk={json.dumps(mk)} "
            f"pending={queues.pending_total()} cycle_ms="
            f"{row['cycle'] * 1e3:.1f} ms="
            + json.dumps({p: round(row[p] * 1e3, 3) for p in keys
                          if p != "cycle"}))
        return row

    captured = Captured(kernel, "score_cluster_columns")
    fetch = {}
    kernel.reset_launch_counts()
    for cycle in range(E2E_WARMUP + MK_TIMED):
        if cycle == E2E_WARMUP:
            with captured, fetch_timing(solver, fetch):
                row = run_cycle(cycle)
        else:
            row = run_cycle(cycle)
        mk = row["mk"]
        if mk["launches"] != 1:
            raise AssertionError(f"{phase} cycle {cycle}: cluster_cols "
                                 f"launched {mk['launches']} times")
        if len(mk["by_cluster"]) < 3:
            raise AssertionError(f"{phase} cycle {cycle}: placements on "
                                 f"{sorted(mk['by_cluster'])} only")
        if mk["unplaced"] < 0.05 * mk["mk_admitted"]:
            raise AssertionError(f"{phase} cycle {cycle}: {mk['unplaced']} "
                                 f"of {mk['mk_admitted']} rows unplaced, "
                                 "under 5%")
        if cycle < E2E_WARMUP:
            continue
        rows_mk.append(mk)
        admitted_timed += row["admitted"]
        for p in keys:
            phases[p].append(row[p])
    launches = kernel.launch_counts()
    for name in PHASE_KERNELS[phase]:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{phase} path")
    summary = {p: {"p50_ms": percentile(v, 50) * 1e3, "max_ms": max(v) * 1e3}
               for p, v in phases.items()}
    summary["admitted_per_s"] = admitted_timed / sum(phases["cycle"])
    summary["admitted_timed"] = admitted_timed
    for name in ("upload_bytes", "mk_admitted", "device_placed", "unplaced",
                 "placements"):
        summary[name] = {"p50": percentile([m[name] for m in rows_mk], 50),
                         "min": min(m[name] for m in rows_mk),
                         "max": max(m[name] for m in rows_mk)}
    summary["by_cluster_total"] = dict(sorted(sum(
        (Counter(m["by_cluster"]) for m in rows_mk), Counter()).items()))
    summary["launches"] = launches
    summary["counters"] = dict(solver.counters)
    summary["fetch_timing"] = fetch
    if captured.args is None:
        raise AssertionError("cluster_cols was not called in the captured "
                             "cycle")
    cut = synth.known_columns(cols_by_cycle[E2E_WARMUP], topo.flavor_index,
                              topo.resource_index)
    summary["kernel_rows"] = {"captured": cluster_kernel_check(
        "captured", kernel, captured.args, captured.out, cut, topo.resources,
        True)}
    cols, _, resources, args = synth.synth_cluster_inputs(**MK_SYNTH)
    dev_args = tuple(torch.from_numpy(a).to(device) for a in args)
    summary["kernel_rows"]["synthetic"] = cluster_kernel_check(
        "synthetic", kernel, dev_args, kernel.score_cluster_columns(*dev_args),
        cols, resources, True)
    check_resident(solver, cache, topo)
    summary["traced_cycle"] = traced_cycle(
        phase, run_cycle, E2E_WARMUP + MK_TIMED, kernel="cluster_cols")
    check_resident(solver, cache, topo)
    gc.callbacks.remove(gc_clock)
    # the same cycles on the CPU: the plain cluster_cols, the same flush
    t_cpu = time.perf_counter()
    c_sched, c_cache, c_queues, c_client, c_remote = mk_env("cpu")
    for cycle, want in enumerate(records):
        mk_lose(c_remote, cycle)
        ns.finish_applied(c_cache, c_queues, c_client, c_remote)
        start = len(c_remote.placements)
        c_sched.schedule(timeout=0)
        got = (cycle_record(c_client, c_cache),
               tuple(c_remote.placements[start:]))
        if got[0] != want[0]:
            raise AssertionError(f"{phase} cycle {cycle}: the card admitted "
                                 "other workloads than the CPU")
        if got[1] != want[1]:
            raise AssertionError(f"{phase} cycle {cycle}: the card placed "
                                 "other workloads or clusters than the CPU")
    summary["cpu_check_s"] = time.perf_counter() - t_cpu
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[{phase}] equal to the CPU run: {len(records)} cycles, "
        f"{client.admitted} admitted, {len(remote.placements)} placements")
    log(f"[{phase}] " + json.dumps(
        {k: v for k, v in summary.items() if k != "kernel_rows"}))
    return summary


def sharded_env(kind: str, solver):
    """The sharded phase's cells, the Scheduler's solver `solver`:
    (scheduler, cache, queues, client, remote capacity or None)."""
    from kueue_tpu_torch.sim import northstar as ns
    if kind == "fill":
        env = ns.build_scheduler(
            NORTH_STAR["num_cqs"], NORTH_STAR["num_cohorts"],
            [f"f{i}" for i in range(NORTH_STAR["num_flavors"])],
            NOMINAL_UNITS, solver=solver)
        ns.stage_waves(env[2], E2E_WAVES, NORTH_STAR["num_cqs"],
                       NOMINAL_UNITS)
        return env + (None,)
    if kind == "preempt":
        return ns.build_preempt_reclaim(**PREEMPT, solver=solver) + (None,)
    return ns.build_multikueue(**MK, solver=solver)


def sharded_step(kind: str, env, cycle: int, mesh=None,
                 log_rows: bool = False, capture=None) -> dict:
    """One cycle of the sharded phase's cell `kind` on `env` (fill,
    multikueue: the last cycle's admissions finish first, outside the
    timed window). It must take the device route (preempt: every
    preempt-mode head solved on the device). Returns its record
    (admissions and usage per CQ; evictions and the solve stats;
    admissions and placements) and, with log_rows, its phase times.
    `capture` (a Captured) is entered around the schedule() call."""
    from kueue_tpu_torch.sim import northstar as ns
    heads_n, problems_n = preempt_expected()
    keys = (PREEMPT_PHASES if kind == "preempt" else SCHED_PHASES) + (
        "plan",)
    sched, cache, queues, client, remote = env
    pending = []
    if kind == "preempt":
        stage = sched._stage_preempt

        def counted(entries, *a, **kw):
            pending.append(len(entries))
            return stage(entries, *a, **kw)
        sched._stage_preempt = counted
    ns.finish_applied(cache, queues, client, remote)
    start = 0 if remote is None else len(remote.placements)
    gc.collect()
    before = 0 if mesh is None else mesh.collectives
    with capture or contextlib.nullcontext():
        t0 = time.perf_counter()
        sched.schedule(timeout=0)
        t1 = time.perf_counter()
    if sched.last_route != "device":
        raise AssertionError(f"sharded {kind} cycle {cycle} took the "
                             f"{sched.last_route!r} route")
    if kind == "preempt":
        plan = sched.last_preempt_plan.get("minimal", {})
        if sched.last_preempt_gate != "device" or pending != [heads_n] \
                or plan.get("problems") != problems_n:
            raise AssertionError(
                f"sharded preempt cycle {cycle}: gate "
                f"{sched.last_preempt_gate!r}, {pending} preempt-mode "
                f"heads, {plan}")
        record = (cycle_outcome(client), plan)
    elif kind == "fill":
        record = (cycle_record(client, cache), usage_by_cq(cache))
    else:
        record = (cycle_record(client, cache),
                  tuple(remote.placements[start:]))
    row = {"record": record}
    if log_rows:
        solver = sched.solver
        row.update({**sched.last_phase_s, **solver.last_phase_s,
                    "cycle": t1 - t0,
                    "upload_bytes": solver.last_upload_bytes})
        row["other"] = row["cycle"] - sum(row[p] for p in keys)
        dplan = solver.last_domain_plan
        row["mesh"] = {"collectives": mesh.collectives - before,
                       "occupied": dplan.occupied, "d_cols": dplan.d_cols,
                       "imbalance": dplan.imbalance,
                       "fingerprint": dplan.fingerprint}
        log(f"[scheduler_sharded:{kind}] cycle {cycle}"
            f"{' (warm-up)' if cycle < E2E_WARMUP else ''}: admitted="
            f"{client.admitted} evicted={client.evicted} cycle_ms="
            f"{row['cycle'] * 1e3:.1f} upload_bytes="
            f"{solver.last_upload_bytes} mesh={json.dumps(row['mesh'])} ms="
            + json.dumps({p: round(row[p] * 1e3, 3)
                          for p in keys + ("other",)}))
    return row


def sharded_cycles(kind: str, make_solver, cycles: int, mesh=None,
                   log_rows: bool = False, capture=None) -> tuple:
    """`cycles` sharded_step cycles of the cell `kind` on the solvers
    `make_solver()` gives: one environment stepped cycle after cycle, or
    (preempt) a fresh build's first cycle each; `capture` is entered for
    the first timed cycle. Returns (rows, the last environment)."""
    env, rows = None, []
    for cycle in range(cycles):
        if env is None or kind == "preempt":
            env = None
            gc.collect()
            env = sharded_env(kind, make_solver())
        rows.append(sharded_step(kind, env, cycle, mesh, log_rows,
                                 capture if cycle == E2E_WARMUP else None))
    return rows, env


def sharded_cycle_check(captured, k) -> dict:
    """Each rank's body of a SHARDED_RANKS-way plan, in turn on the card,
    on the inputs of the captured world-size-1 cycle: phase_a on the
    rank's slice, phase_b on its columns, the combine's pack; the
    buffers summed and unpacked must equal the single-device cycle
    (solve_cycle_fused) and the main path's own usage outputs; each
    rank's phase_b and pack, and the unpack, equal to their plain
    versions on the same tensors. Then phase_b over the world-size-1
    plan's columns and over rank 0's of the 4-way plan, and the combine,
    timed against their plain versions."""
    import numpy as np
    import torch
    from kueue_tpu_torch.parallel.domains import plan_domains
    if captured.args is None:
        raise AssertionError("solve_cycle_sharded was not called in the "
                             "captured cycle")
    _, topo, usage, cu, *batch = captured.args
    kw = captured.kwargs
    requests, podset_active, wl_cq, priority, timestamp, eligible, \
        solvable = batch
    P, fair, sr = kw["num_podsets"], kw["fair_sharing"], kw["start_rank"]
    n, W = SHARDED_RANKS, requests.shape[0]
    want = k.solve_cycle_fused(topo, usage, cu, *batch, num_podsets=P,
                               fair_sharing=fair, start_rank=sr,
                               compact=False)
    host = {name: topo[name].cpu().numpy()
            for name in ("cq_cohort", "cohort_root", "offered")}
    plan = plan_domains(wl_cq.cpu().numpy(), host["cq_cohort"],
                        host["cohort_root"], host["offered"], n)
    avail_q = k.avail(topo, usage, cu)
    w_local = -(-W // n)
    if w_local * n != W:
        raise AssertionError(f"W={W} does not split into {n} slices")
    parts = []
    for r in range(n):
        rows = slice(r * w_local, (r + 1) * w_local)
        parts.append(k.phase_a(
            topo, avail_q, usage, requests[rows], podset_active[rows],
            wl_cq[rows], eligible[rows], solvable[rows], P,
            None if sr is None else sr[rows]))
    fit, borrows, chosen, chosen_borrow, asg = (
        torch.cat([p[i] for p in parts]) for i in range(5))
    share = k.drf_share(topo, usage, asg, wl_cq) if fair else None
    offsets, members, _ = k.order_csr(topo, fit, borrows, priority,
                                      timestamp, wl_cq, share)
    D = offsets.shape[0] - 1

    def columns(row):
        return torch.from_numpy(np.where(row >= 0, row, D).astype(
            np.int32)).to(usage.device)
    b_args = (topo, usage, cu, asg, fit, wl_cq, offsets, members)
    bufs, per_rank = [], []
    for r in range(n):
        cols = columns(plan.columns[r])
        got = k.phase_b(*b_args, cols)
        compare((f"rank {r} admitted", f"rank {r} usage",
                 f"rank {r} cohort_usage"), got, k.phase_b_plain(*b_args,
                                                                  cols))
        buf = k.combine_pack(got[0], usage, got[1], cu, got[2])
        compare((f"rank {r} buffer",), (buf,), (k.combine_pack_plain(
            got[0], usage, got[1], cu, got[2]),))
        bufs.append(buf)
        per_rank.append({"columns": int((plan.columns[r] >= 0).sum()),
                         "admitted": int(got[0].sum())})
    total = torch.stack(bufs).sum(0)
    merged = k.combine_unpack(total, usage, cu)
    compare(("unpack admitted", "unpack usage", "unpack cohort_usage"),
            merged, k.combine_unpack_plain(total, usage, cu))
    compare(("fit", "borrows", "chosen", "chosen_borrow", "admitted",
             "usage", "cohort_usage"),
            (fit, borrows, chosen, chosen_borrow, *merged),
            tuple(want[key] for key in ("fit", "borrows", "chosen",
                                        "chosen_borrow", "admitted", "usage",
                                        "cohort_usage")))
    compare(("main path usage", "main path cohort_usage"),
            (captured.out["usage"], captured.out["cohort_usage"]),
            (want["usage"], want["cohort_usage"]))
    out = {"ranks": n, "W": W, "occupied": plan.occupied,
           "d_cols": plan.d_cols, "imbalance": plan.imbalance,
           "per_rank": per_rank, "admitted": int(merged[0].sum()),
           "max_abs_err": 0.0}
    # the column variant's times: the world-size-1 plan (every occupied
    # domain) and rank 0's of the 4-way plan
    for label, row in (("cols_ws1", kw["plan"].columns[0]),
                       (f"cols_{n}way_rank0", plan.columns[0])):
        cols = columns(row)
        torch.cuda.synchronize()
        ms = profiled_device_ms(lambda: k.phase_b(*b_args, cols), 20,
                                "phase_b")
        out[f"phase_b_{label}"] = {
            "blocks": int(cols.numel()), "ms": ms,
            "call_ms": time_cuda(lambda: k.phase_b(*b_args, cols), 20),
            "plain_ms": time_cuda(lambda: k.phase_b_plain(*b_args, cols), 3,
                                  warmup=1)}
    log("[scheduler_sharded] 4-way rank check of the fill cycle: equal to "
        "the single-device cycle: " + json.dumps(out))
    return out


def sharded_preempt_check(captured, k) -> dict:
    """K9 on each rank's slots of a SHARDED_RANKS-way problem plan, in turn
    on the card, on the captured world-size-1 K9 batch: each equal to the
    plain version with the same slots, their sum equal to one
    single-device launch and to the main path's outputs; rank 0's slots
    timed against the plain version."""
    import torch
    from kueue_tpu_torch.parallel.domains import plan_problems
    if captured.args is None:
        raise AssertionError("solve_preempt_sharded was not called in the "
                             "captured cycle")
    _, topo, usage, cu, pargs, weights = captured.args
    whole = k.solve_preempt(topo, usage, cu, *pargs)
    compare(("main path targets", "main path feasible", "main path stats"),
            captured.out, whole)
    n = SHARDED_RANKS
    perm, _, b_local = plan_problems(weights, n)
    B = pargs[7].shape[0]
    sums = [torch.zeros_like(t) for t in whole]
    slots0, per_rank = None, []
    for r in range(n):
        mine = perm[r * b_local:(r + 1) * b_local].astype("int32")
        slots = torch.from_numpy(mine).to(usage.device)
        slots0 = slots if r == 0 else slots0
        got = k.solve_preempt(topo, usage, cu, *pargs, slots=slots)
        compare((f"rank {r} targets", f"rank {r} feasible",
                 f"rank {r} stats"), got,
                k.solve_preempt_plain(topo, usage, cu, *pargs, slots=slots))
        for acc, part in zip(sums, got):
            acc += part
        per_rank.append({"slots": int((mine < B).sum()),
                         "weight": int(weights[mine[mine < B]].sum())})
    compare(("summed targets", "summed feasible", "summed stats"), sums,
            whole)
    # the world-size-1 plan's slots: every problem, in the plan's order
    perm1, _, _ = plan_problems(weights, 1)
    slots1 = torch.from_numpy(perm1.astype("int32")).to(usage.device)
    compare(("ws1 targets", "ws1 feasible", "ws1 stats"),
            k.solve_preempt(topo, usage, cu, *pargs, slots=slots1), whole)
    torch.cuda.synchronize()
    out = {"ranks": n, "B": B, "b_local": b_local, "per_rank": per_rank,
           "max_abs_err": 0.0,
           "slots_ws1": {
               "ms": profiled_device_ms(lambda: k.solve_preempt(
                   topo, usage, cu, *pargs, slots=slots1), 5,
                   "solve_preempt"),
               "call_ms": time_cuda(lambda: k.solve_preempt(
                   topo, usage, cu, *pargs, slots=slots1), 5)},
           "slots_rank0": {
               "ms": profiled_device_ms(lambda: k.solve_preempt(
                   topo, usage, cu, *pargs, slots=slots0), 5,
                   "solve_preempt"),
               "call_ms": time_cuda(lambda: k.solve_preempt(
                   topo, usage, cu, *pargs, slots=slots0), 5),
               "plain_ms": time_cuda(lambda: k.solve_preempt_plain(
                   topo, usage, cu, *pargs, slots=slots0), 1, warmup=1)}}
    log("[scheduler_sharded] 4-way rank check of K9: equal to the "
        "single-device K9: " + json.dumps(out))
    return out


def scheduler_sharded_phase(device) -> dict:
    """The sharded cycle under the port's Scheduler at world size 1 over
    NCCL: the fill, preempt and multikueue cells (a warm-up, then
    SHARDED_TIMED cycles), each launching SHARDED_KERNELS and equal to
    the same cells on the single-device route; the 4-way rank checks on
    the fill's and the preempt cell's first timed cycle. The mesh's
    process group is destroyed at the end."""
    from kueue_tpu_torch.parallel import mesh as meshpkg
    from kueue_tpu_torch.solver import BatchSolver, kernel
    t_phase = time.perf_counter()
    mesh = meshpkg.make_mesh(device)
    summary = {"mesh": {"rank": mesh.rank, "size": mesh.size,
                        "backend": "nccl", "device": str(mesh.device)},
               "launches": dict.fromkeys(kernel.launch_counts(), 0)}
    captures = {"fill": Captured(meshpkg, "solve_cycle_sharded"),
                "preempt": Captured(meshpkg, "solve_preempt_sharded")}
    try:
        for kind, want in SHARDED_KERNELS.items():
            t_sub = time.perf_counter()
            cycles = E2E_WARMUP + SHARDED_TIMED[kind]
            kernel.reset_launch_counts()
            rows, env = sharded_cycles(kind, lambda: BatchSolver(mesh=mesh),
                                       cycles, mesh, log_rows=True,
                                       capture=captures.get(kind))
            launches = kernel.launch_counts()
            exact = {"mesh_combine": 2 * cycles}
            exact.update({"solve_preempt": cycles} if kind == "preempt"
                         else {"cluster_cols": cycles}
                         if kind == "multikueue" else {})
            for name in want:
                if launches[name] <= 0 or launches[name] != exact.get(
                        name, launches[name]):
                    raise AssertionError(f"sharded {kind}: {name} launched "
                                         f"{launches[name]} times in "
                                         f"{cycles} cycles")
            for name, count in launches.items():
                summary["launches"][name] += count
            trace = None
            if kind == "fill":
                # one more cycle under the profiler, outside the count;
                # its record is checked with the others
                def traced_step(cycle, check_first, kind=kind, env=env):
                    rows.append(sharded_step(kind, env, cycle, mesh, True))
                    return rows[-1]
                trace = traced_cycle("scheduler_sharded", traced_step,
                                     cycles, kernel="mesh_combine",
                                     kernels=want)
            env = None
            # the same cells on the single-device route (a fresh build's
            # first cycle is the same every time: one does)
            t_ref = time.perf_counter()
            ref, _ = sharded_cycles(kind, lambda: BatchSolver(device=device),
                                    1 if kind == "preempt" else len(rows))
            for cycle, row in enumerate(rows):
                if row["record"] != ref[min(cycle, len(ref) - 1)]["record"]:
                    raise AssertionError(
                        f"sharded {kind} cycle {cycle}: the mesh route "
                        "admitted, evicted or placed other workloads than "
                        "the single-device route")
            timed = rows[E2E_WARMUP:cycles]
            keys = (PREEMPT_PHASES if kind == "preempt" else SCHED_PHASES) \
                + ("plan", "other", "cycle")
            sub = {p: {"p50_ms": percentile([r[p] for r in timed], 50) * 1e3,
                       "max_ms": max(r[p] for r in timed) * 1e3}
                   for p in keys}
            sub["mesh"] = timed[-1]["mesh"]
            sub["launches"] = launches
            sub["upload_bytes"] = timed[-1]["upload_bytes"]
            if trace is not None:
                sub["traced_cycle"] = trace
            sub["ref_check_s"] = time.perf_counter() - t_ref
            if kind == "fill":
                sub["admitted_per_cycle"] = [len(r["record"][0])
                                             for r in timed]
                sub["rank_check"] = sharded_cycle_check(captures[kind],
                                                        kernel)
            elif kind == "preempt":
                outcome, plan = timed[0]["record"]
                sub.update(evicted_per_cycle=len(outcome[0]),
                           admitted_per_cycle=len(outcome[1]),
                           reasons=sorted({r for _, r in outcome[0]}),
                           preempt_plan=plan)
                sub["rank_check"] = sharded_preempt_check(captures[kind],
                                                          kernel)
            else:
                sub["admitted_per_cycle"] = [len(r["record"][0])
                                             for r in timed]
                sub["placements_per_cycle"] = [len(r["record"][1])
                                               for r in timed]
            sub["wall_s"] = time.perf_counter() - t_sub
            log(f"[scheduler_sharded:{kind}] equal to the single-device "
                f"route; " + json.dumps(sub))
            summary[kind] = sub
    finally:
        mesh.close()
    summary["wall_s"] = time.perf_counter() - t_phase
    return summary


ORACLE_KEYS = ("admitted", "fit", "borrows", "chosen", "chosen_borrow",
               "usage", "cohort_usage")


def oracle_phase(device) -> dict:
    """The cycle's oracles on the card, on the north-star and the nested
    kernel inputs (kernel_inputs): with fair sharing off, on with the
    mixed weights of fair_topo, and (nested) with the flavor-resume
    ranks. Each variant drives solve_cycle (Phase A, the global order,
    global_scan), solve_cycle_cohort_parallel (Phase A, the host grid,
    phase_b over it) and solve_cycle_fused, between a reset and a read of
    the launch counts, and holds their seven outputs equal. Then, outside
    the count, global_scan against global_scan_plain on the same card
    tensors; with fair sharing off, global_scan's device ms, call ms,
    plain ms and bound beside phase_b's ms on the same Phase A and order
    (their ratio: the speed-up of the cohort-parallel Phase B over the
    global scan)."""
    import torch
    from kueue_tpu_torch.solver import kernel as k
    phase = "oracles"
    t_phase = time.perf_counter()
    launches = {}
    rows, checks = {}, []
    for kind in ("north_star", "nested"):
        inp = kernel_inputs(kind, device)
        usage, cu, wl = inp["usage"], inp["cu"], inp["wl"]
        W, P, _ = wl["requests"].shape
        batch = [wl[n] for n in ("requests", "podset_active", "wl_cq",
                                 "priority", "timestamp", "eligible",
                                 "solvable")]
        variants = ("plain", "fair") + (("start_rank",) if kind == "nested"
                                        else ())
        for variant in variants:
            topo = inp["fair_topo"] if variant == "fair" else inp["topo"]
            fair = variant == "fair"
            kw = dict(num_podsets=P, fair_sharing=fair,
                      start_rank=inp["start_rank"]
                      if variant == "start_rank" else None)
            torch.cuda.synchronize()
            k.reset_launch_counts()
            t0 = time.perf_counter()
            seq = k.solve_cycle(topo, usage, cu, *batch, **kw)
            par = k.solve_cycle_cohort_parallel(topo, topo, usage, cu,
                                                *batch, **kw)
            fused = k.solve_cycle_fused(topo, usage, cu, *batch,
                                        compact=False, **kw)
            torch.cuda.synchronize()
            drive_s = time.perf_counter() - t0
            for name, n in k.launch_counts().items():
                launches[name] = launches.get(name, 0) + n
            for other, label in ((par, "cohort_parallel"), (fused, "fused")):
                compare([f"{kind}/{variant} {label} {key}"
                         for key in ORACLE_KEYS],
                        [other[key] for key in ORACLE_KEYS],
                        [seq[key] for key in ORACLE_KEYS])
            # global_scan against its plain version on the cycle's own
            # Phase A and global order
            fit, borrows, _, _, asg, share = k.solve_phase_a(
                topo, usage, cu, *batch[:3], *batch[5:], **kw)
            offsets, members, order = k.order_csr(
                topo, fit, borrows, wl["priority"], wl["timestamp"],
                wl["wl_cq"], share if fair else None, with_order=True)
            s_args = (topo, usage, cu, asg, fit, wl["wl_cq"], order)
            t0 = time.perf_counter()
            want = k.global_scan_plain(*s_args)
            plain_once_s = time.perf_counter() - t0
            err = compare([f"{kind}/{variant} global_scan {key}" for key in
                           ("admitted", "usage", "cohort_usage")],
                          k.global_scan(*s_args), want)
            admitted = int(seq["admitted"].sum())
            fits = int(seq["fit"].sum())
            if not 0 < admitted < fits:
                raise AssertionError(f"{phase} {kind}/{variant}: {admitted} "
                                     f"of {fits} fitting heads admitted; the "
                                     "scan's re-check is not exercised")
            check = {"kind": kind, "variant": variant, "W": W, "fit": fits,
                     "admitted": admitted, "drive_ms": drive_s * 1e3,
                     "plain_once_ms": plain_once_s * 1e3,
                     "max_abs_err": err}
            checks.append(check)
            log(f"[{phase}] {kind}/{variant}: solve_cycle == "
                "solve_cycle_cohort_parallel == solve_cycle_fused on 7 "
                "outputs; global_scan equal to plain; " + json.dumps(check))
            if variant != "plain":
                continue
            b_args = (topo, usage, cu, asg, fit, wl["wl_cq"], offsets,
                      members)
            torch.cuda.synchronize()
            call_ms = time_cuda(lambda: k.global_scan(*s_args), iters=20)
            plain_ms = time_cuda(lambda: k.global_scan_plain(*s_args),
                                 iters=1, warmup=1)
            kernel_ms = profiled_device_ms(lambda: k.global_scan(*s_args),
                                           10, "global_scan")
            ms, source = (kernel_ms, "profiler") if kernel_ms is not None \
                else (call_ms, "events")
            pb_ms = profiled_device_ms(lambda: k.phase_b(*b_args), 20,
                                       "phase_b") \
                or time_cuda(lambda: k.phase_b(*b_args), iters=20)
            moved = phase_b_bytes(topo, usage, cu, asg, fit, wl["wl_cq"],
                                  order, None, want)
            steps = int((offsets[1:] - offsets[:-1]).max().item())
            rows[kind] = {
                "max_abs_err": err, "ms": ms, "ms_source": source,
                "call_ms": call_ms, "plain_ms": plain_ms,
                "library_ms": None, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                "bytes": moved, "dependent_steps": W, "fit_steps": fits,
                "phase_b_ms": pb_ms, "phase_b_dependent_steps": steps,
                "global_over_phase_b": ms / pb_ms}
            log(f"[{phase}] {kind} global_scan: ms={ms:.5f} ({source}) "
                f"call_ms={call_ms:.4f} plain_ms={plain_ms:.2f} bound_ms="
                f"{rows[kind]['bound_ms']:.6f} ({moved} bytes / 3.35 TB/s); "
                f"latency-bound: {W} dependent steps ({fits} fit); "
                f"phase_b on the same inputs {pb_ms:.5f} ms ({steps} steps): "
                f"global scan / cohort-parallel = "
                f"{rows[kind]['global_over_phase_b']:.1f}x")
    for name in PHASE_KERNELS[phase]:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{phase} path")
    summary = {"launches": launches, "checks": checks, "kernel_rows": rows,
               "wall_s": time.perf_counter() - t_phase}
    log(f"[{phase}] " + json.dumps(
        {k_: v for k_, v in summary.items() if k_ != "kernel_rows"}))
    return summary


def partial_env(device):
    """The partial-admission cell (sim/northstar build_partial_admission),
    its Scheduler's solver on `device` (None: no solver, the cpu-forced
    route and its sequential PodSetReducer). Every requeue's (key,
    status, message) is kept in the returned list."""
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import BatchSolver
    env = ns.build_partial_admission(
        waves=PARTIAL_WAVES, **PARTIAL,
        solver=None if device is None else BatchSolver(device=device))
    sched, msgs = env[0], []
    real = sched.requeue_and_update

    def requeue(e):
        real(e)
        msgs.append((e.info.key, e.status, e.inadmissible_msg))
    sched.requeue_and_update = requeue
    return env, msgs


def partial_record(client, msgs: list) -> tuple:
    """What a partial cycle left: the workloads it admitted in order with
    their pod counts, and the requeues' messages."""
    return (tuple((wl.metadata.name,
                   tuple(p.count for p in wl.status.admission
                         .pod_set_assignments))
                  for wl in client.new_applied), tuple(sorted(msgs)))


def scheduler_partial_phase(device) -> dict:
    """The port's Scheduler on the partial-admission cell, cycle after
    cycle, on the card: before each cycle the last cycle's admissions
    finish (outside the timed window, with the check of the resident
    state and a full collection); the cycle is one schedule() call on the
    device route, in which the elastic heads the fit cycle did not fit
    search their counts, avail and phase_a launched once per round.
    Then the same cycles with device="cpu" must make the same admissions
    with the same counts and the same Pending messages, and the first two
    with no solver (the sequential PodSetReducer) the same admissions."""
    from kueue_tpu_torch.core import workload as wlpkg
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import encode, kernel
    phase = "scheduler_partial"
    t_phase = time.perf_counter()
    (sched, cache, queues, client), msgs = partial_env(device)
    solver = sched.solver
    topo = encode.encode_topology(cache.snapshot())
    log(f"[{phase}] cluster: {PARTIAL['num_cqs']} CQs, "
        f"{PARTIAL['num_cohorts']} cohorts, {PARTIAL['num_flavors']} flavors "
        f"x {PARTIAL['nominal_units']} units; cohorts 0-"
        f"{PARTIAL['partial_cohorts'] - 1} queue Jobs of {PARTIAL['count']} "
        f"pods (min {PARTIAL['min_count']}) of 1 unit, the rest one-pod "
        f"workloads of {PARTIAL['cpu_units']} units; "
        f"{queues.pending_total()} pending staged in "
        f"{time.perf_counter() - t_phase:.1f} s")
    keys = SCHED_PHASES + ("partial", "gc", "other", "cycle")
    phases = {p: [] for p in keys}
    records, per_cycle = [], []
    admitted_timed = 0
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)

    def host_admitted() -> list:
        """The last cycle's admissions the card did not decide: the
        reduced Jobs, assigned on the host at their found counts."""
        return [wl for wl in client.new_applied
                if wlpkg.key(wl) not in solver.resident.pending]

    def run_cycle(cycle: int, check_first: bool = True) -> dict:
        if check_first and cycle > 0:
            check_resident(solver, cache, topo, host_admitted())
        finished = ns.finish_applied(cache, queues, client)
        gc.collect()
        msgs.clear()
        before, syncs = client.admitted, solver.counters["syncs"]
        g0, t0 = gc_clock.total, time.perf_counter()
        sched.schedule(timeout=0)
        g1, t1 = gc_clock.total, time.perf_counter()
        if sched.last_route != "device":
            raise AssertionError(f"{phase} cycle {cycle} took the "
                                 f"{sched.last_route!r} route")
        records.append(partial_record(client, msgs))
        row = {**sched.last_phase_s, **solver.last_phase_s,
               "gc": g1 - g0, "cycle": t1 - t0}
        row["other"] = row["cycle"] - sum(row[p] for p in SCHED_PHASES) \
            - row["partial"]
        stats = {"admitted": client.admitted - before,
                 "full": sum(1 for n, _ in records[-1][0]
                             if n.startswith("w")),
                 "reduced": sum(1 for n, c in records[-1][0]
                                if n.startswith("p")),
                 "reduced_pods": sorted({c[0] for n, c in records[-1][0]
                                         if n.startswith("p")}),
                 "rounds": solver.last_partial_rounds,
                 "syncs": solver.counters["syncs"] - syncs,
                 "upload_bytes": solver.last_upload_bytes,
                 "partial_share": row["partial"] / row["cycle"]}
        row["stats"] = stats
        log(f"[{phase}] cycle {cycle}"
            f"{' (warm-up)' if cycle < E2E_WARMUP else ''}: finished="
            f"{finished} {json.dumps(stats)} pending="
            f"{queues.pending_total()} cycle_ms={row['cycle'] * 1e3:.1f} ms="
            + json.dumps({p: round(row[p] * 1e3, 3) for p in keys
                          if p != "cycle"}))
        return row

    kernel.reset_launch_counts()
    rounds_total = 0
    for cycle in range(E2E_WARMUP + PARTIAL_TIMED):
        row = run_cycle(cycle)
        stats = row["stats"]
        rounds_total += stats["rounds"]
        if stats["rounds"] <= 0 or stats["reduced"] <= 0:
            raise AssertionError(f"{phase} cycle {cycle}: no search or no "
                                 f"reduced admission ({stats})")
        if cycle < E2E_WARMUP:
            continue
        per_cycle.append(stats)
        admitted_timed += stats["admitted"]
        for p in keys:
            phases[p].append(row[p])
    launches = kernel.launch_counts()
    for name in PHASE_KERNELS[phase]:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{phase} path")
    cycles = E2E_WARMUP + PARTIAL_TIMED
    for name in ("avail", "phase_a"):
        if launches[name] != cycles + rounds_total:
            raise AssertionError(f"{phase}: {name} launched "
                                 f"{launches[name]} times, not once a cycle "
                                 f"and once a round ({cycles} + "
                                 f"{rounds_total})")
    summary = {p: {"p50_ms": percentile(v, 50) * 1e3, "max_ms": max(v) * 1e3}
               for p, v in phases.items()}
    summary["admitted_per_s"] = admitted_timed / sum(phases["cycle"])
    summary["admitted_timed"] = admitted_timed
    for name in ("admitted", "full", "reduced", "rounds", "syncs",
                 "upload_bytes", "partial_share"):
        values = [s[name] for s in per_cycle]
        summary[name] = {"p50": percentile(values, 50), "min": min(values),
                         "max": max(values)}
    summary["reduced_pods"] = sorted({c for s in per_cycle
                                      for c in s["reduced_pods"]})
    summary["launches"] = launches
    summary["counters"] = dict(solver.counters)
    check_resident(solver, cache, topo, host_admitted())
    summary["traced_cycle"] = traced_cycle(
        phase, run_cycle, E2E_WARMUP + PARTIAL_TIMED)
    check_resident(solver, cache, topo, host_admitted())
    gc.callbacks.remove(gc_clock)
    # the same cycles on the CPU, with the plain kernels
    t_cpu = time.perf_counter()
    (c_sched, c_cache, c_queues, c_client), c_msgs = partial_env("cpu")
    for cycle, want in enumerate(records):
        ns.finish_applied(c_cache, c_queues, c_client)
        c_msgs.clear()
        c_sched.schedule(timeout=0)
        got = partial_record(c_client, c_msgs)
        if got[0] != want[0]:
            raise AssertionError(f"{phase} cycle {cycle}: the card admitted "
                                 "other workloads or counts than the CPU")
        if got[1] != want[1]:
            raise AssertionError(f"{phase} cycle {cycle}: the Pending "
                                 "messages differ from the CPU's")
    summary["cpu_check_s"] = time.perf_counter() - t_cpu
    # the sequential PodSetReducer (no solver: the cpu-forced route)
    t_cpu = time.perf_counter()
    (r_sched, r_cache, r_queues, r_client), r_msgs = partial_env(None)
    for cycle in range(E2E_WARMUP + 1):
        ns.finish_applied(r_cache, r_queues, r_client)
        t0 = time.perf_counter()
        r_sched.schedule(timeout=0)
        cycle_s = time.perf_counter() - t0
        if r_sched.last_route != "cpu-forced":
            raise AssertionError(f"{phase}: the reducer run took the "
                                 f"{r_sched.last_route!r} route")
        got = sorted(partial_record(r_client, r_msgs)[0])
        if got != sorted(records[cycle][0]):
            raise AssertionError(f"{phase} cycle {cycle}: the card admitted "
                                 "other workloads or counts than the "
                                 "sequential PodSetReducer")
    summary["reducer_first_timed_cycle_ms"] = cycle_s * 1e3
    summary["reducer_nominate_ms"] = r_sched.last_phase_s["nominate"] * 1e3
    summary["reducer_check_s"] = time.perf_counter() - t_cpu
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[{phase}] equal to the CPU run ({len(records)} cycles: "
        f"admissions, counts, Pending messages) and to the sequential "
        f"PodSetReducer (cycles 0-{E2E_WARMUP}); {client.admitted} admitted")
    log(f"[{phase}] " + json.dumps(summary))
    return summary


def traced_cycle(phase: str, run_cycle, cycle: int,
                 kernel: str = None, kernels: tuple = None) -> dict:
    """One more main-path cycle under torch.profiler (after the timed
    ones, outside the launch count, its resident-state check made before
    the trace starts): device busy time by kernel, the card's idle
    share of the cycle's wall time, and `kernel`'s device time. The
    trace should hold `kernels` (default: the phase's)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cycle_s = run_cycle(cycle, check_first=False)["cycle"]
    # device-side rows only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched
    rows = sorted(((e.key, device_us(e, self_only=True))
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")),
                  key=lambda r: -r[1])
    busy_us = sum(us for _, us in rows)
    out = {"wall_ms": cycle_s * 1e3, "device_busy_ms": busy_us / 1e3,
           "idle_share": 1.0 - busy_us / 1e3 / (cycle_s * 1e3),
           "top_device_ms": {k[:60]: us / 1e3 for k, us in rows[:12] if us}}
    if kernel is not None:
        out[f"{kernel}_device_ms"] = sum(
            us for k, us in rows if k.startswith(f"{kernel}_")) / 1e3
    # the phase's kernels that launched in the cycle but of which the
    # trace kept no record (the busy time then reads low)
    out["missing_from_trace"] = [
        name for name in (kernels or PHASE_KERNELS[phase])
        if not any(k.startswith(f"{name}_") for k, _ in rows)]
    log(f"[trace:{phase}] " + json.dumps(out))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "kueue_tpu_torch" / "solver" / "csrc").is_dir():
        print("chip_smoke: kueue_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    from kueue_tpu_torch.solver import _build

    t_start = time.perf_counter()
    device = torch.device("cuda")
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"capability {cap} count {torch.cuda.device_count()}; {smi}")
    if cap != (9, 0):
        raise AssertionError(f"expected an sm_90 device, got capability {cap}")

    seconds = _build.build_all()
    log(f"[build] {len(_build.KERNELS)} kernels built in {seconds:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name in _build.KERNELS:
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    results: dict = {}
    for kind in ("north_star", "nested"):
        t0 = time.perf_counter()
        kernel_phase(kind, device, results)
        log(f"[kernels:{kind}] wall {time.perf_counter() - t0:.1f} s")
    runners = {"oracles": oracle_phase,
               "scheduler_partial": scheduler_partial_phase,
               "scheduler_fair": scheduler_phase,
               "scheduler_preempt": scheduler_preempt_phase,
               "scheduler_fair_preempt": scheduler_fair_preempt_phase,
               "scheduler_multikueue": scheduler_multikueue_phase,
               "scheduler_sharded": scheduler_sharded_phase}
    e2e = {phase: runners[phase](device) if phase in runners
           else e2e_phase(device, phase) for phase in PHASE_KERNELS}
    for phase, summary in e2e.items():
        # the cluster columns ride only the MultiKueue cells' cycles, the
        # combine only the mesh's
        if phase not in ("scheduler_multikueue", "scheduler_sharded") \
                and summary["launches"]["cluster_cols"]:
            raise AssertionError(f"cluster_cols launched on the {phase} "
                                 "path")
        if phase != "scheduler_sharded" \
                and summary["launches"]["mesh_combine"]:
            raise AssertionError(f"mesh_combine launched on the {phase} "
                                 "path")
        # the global scan is the oracle's alone
        if phase != "oracles" and summary["launches"]["global_scan"]:
            raise AssertionError(f"global_scan launched on the {phase} "
                                 "path")
    # K9's rows: the main path's captured inputs and the synthetic nested
    results["north_star"]["solve_preempt"] = \
        e2e["scheduler_preempt"]["kernel_rows"]["captured"]
    results["nested"]["solve_preempt"] = \
        e2e["scheduler_preempt"]["kernel_rows"]["nested"]
    # K11's: the fair-preempt phase's captured inputs and the nested
    results["north_star"]["solve_fair"] = \
        e2e["scheduler_fair_preempt"]["kernel_rows"]["captured"]
    results["nested"]["solve_fair"] = \
        e2e["scheduler_fair_preempt"]["kernel_rows"]["nested"]
    # K12's: the MultiKueue phase's captured inputs and the synthetic batch
    results["north_star"]["cluster_cols"] = \
        e2e["scheduler_multikueue"]["kernel_rows"]["captured"]
    results["nested"]["cluster_cols"] = \
        e2e["scheduler_multikueue"]["kernel_rows"]["synthetic"]
    # K14's: the oracle phase's, on the north-star and nested inputs
    for kind in ("north_star", "nested"):
        results[kind]["global_scan"] = e2e["oracles"]["kernel_rows"][kind]

    sharded = e2e["scheduler_sharded"]
    kernels = []
    for name in _build.KERNELS:
        row = results["north_star"][name]
        by_phase = {p: e2e[p]["launches"][name] for p in e2e}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"kueue_tpu_torch/solver/csrc/{name}.cu",
            "replaces": REPLACES[name],
            # every main path, each counted from its own reset
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": max(results[k][name]["max_abs_err"]
                               for k in results),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "bound_bytes": row["bytes"], "library_ms": row["library_ms"],
            "ms_source": row["ms_source"], "call_ms": row["call_ms"],
            "nested": {k: v for k, v in results["nested"][name].items()
                       if k in ("ms", "call_ms", "plain_ms", "library_ms",
                                "bound_ms", "dependent_steps",
                                "rounds_max", "rounds_mean", "pops_max",
                                "fillback_max", "phase_b_ms",
                                "global_over_phase_b")},
            # phase_b's, solve_preempt's, solve_fair's and cluster_cols'
            # real limit is a serial chain, which a byte or operation
            # count does not capture
            **({"latency_bound": f"{row['dependent_steps']} dependent steps",
                "dependent_steps": row["dependent_steps"]}
               if name in ("phase_b", "solve_preempt", "solve_fair",
                           "cluster_cols", "global_scan") else {}),
            **({"inputs": "the oracle phase's north-star kernel inputs, "
                          "fair sharing off",
                "fit_steps": row["fit_steps"], "phase_b_ms": row["phase_b_ms"],
                "global_over_phase_b": row["global_over_phase_b"]}
               if name == "global_scan" else {}),
            **({"inputs": "the scheduler multikueue phase's first timed "
                          "cycle",
                "rows": row["rows"], "placed": row["placed"],
                "unplaced": row["unplaced"]}
               if name == "cluster_cols" else {}),
            **({"inputs": "the scheduler preempt phase's first timed cycle",
                "rounds_max": row["rounds_max"],
                "rounds_mean": row["rounds_mean"]}
               if name == "solve_preempt" else {}),
            **({"inputs": "the scheduler fair preempt phase's first timed "
                          "cycle",
                "pops_max": row["pops_max"], "pops_mean": row["pops_mean"],
                "fillback_max": row["fillback_max"]}
               if name == "solve_fair" else {}),
            # the sharded cycle's variants, on its captured inputs
            **({"sharded": {k: v for k, v in sharded["fill"]["rank_check"]
                            .items() if k.startswith("phase_b_")}}
               if name == "phase_b" else {}),
            **({"sharded": {k: v for k, v in sharded["preempt"]
                            ["rank_check"].items() if k.startswith("slots")}}
               if name == "solve_preempt" else {}),
            **({"entries": ["pack", "unpack"],
                "inputs": "the north-star kernel inputs' Phase B outputs"}
               if name == "mesh_combine" else {})})
    log(f"[wall] {time.perf_counter() - t_start:.1f} s, phases "
        + json.dumps({p: round(e2e[p]["wall_s"], 1) for p in e2e}))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
