"""Smoke run of kueue_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Builds the solver's CUDA kernels from kueue_tpu_torch/solver/csrc, holds
each one against its plain PyTorch version on the card at the north-star
shape (2048 ClusterQueues, 256 cohorts, 32 flavors, 2 resources, 2048
heads, 4 podsets) and on a nested-cohort input (depth 3, 3 active
podsets), and times both; drf_share also on fair weights 0/500/1000/3000
with a root cohort lending nothing, and the admit order also with those
shares and with a mix of ties, negative shares and NO_LIMIT. phase_a and
phase_b also report the form their launch took (phase_b: each domain's)
and a latency bound in ms: their least step or reduction and a global
round trip, measured in clock cycles on the card by their tick kernels;
phase_b is also timed over a column list of the occupied domains on the
same inputs. The admit order (K4) and the arena gather (K7b) report
their form (order_plan's; the gather's vector widths) and a latency
bound (K4: four global round trips and its block steps, K7b: two round
trips), drf_share and deltas report their form (drf_share_plan's lanes
a head; deltas_plan's) and a latency bound (a head's three round trips,
two floor divisions and its shuffles; two round trips and a level step
a level, each measured in clock cycles by their tick kernels), and every
kernel's row the launch floor (an empty kernel's device time, measured
first). Then, on
the shapes the first kernels raised on, solve_preempt with a problem of
exactly 131,072 candidates (32-bit candidate indices), phase_a at the
north star's widths with 32 and with 17 resources, and cluster_cols at
64 clusters x 32 flavors x 16 resources and, at the synthetic batch's
8 x 32 x 2048 rows, at 8, 16 and 32 resources, the admit order at one
domain of 2048 workloads, at W one above its staged form's limit, at W =
65,536 over 65,792 domains and on the edge keys (+-0.0, NaNs of both
signs, subnormals, INT64_MIN and INT64_MAX priorities, NO_LIMIT shares),
the global order off and on, the arena gather on a twin of odd row
bytes and on sources sliced off a 16-byte boundary, and the decision
pack at W not a multiple of 32 or 8, odd P * R and sources off a 16-byte
boundary, drf_share at F = 1, 32 and 33 by R = 1, 2, 3, 17 and 32 and
with quantities past 2^53 and past int64, and deltas on a tree with CQs
attached at two depths (a cohort coord at levels 0 and 1 of the tuple),
at 2049 and 16,384 coords there (D = 8192 and 32,768: opted-in shared
memory and the global form), with no cohort level and 10 levels deep,
each equal to its plain version (cluster_cols also to the host oracle)
and timed. The pack's row reports a latency bound of one global
round trip.
cluster_cols' rows are timed by CUDA events over back-to-back launches
and report the pipeline's rows, live columns (its stages), warps and
chunk steps, and its latency bound: (stages + chunks of 32 rows - 1)
ticks of the least tick (one shared load, R compares, one shuffle),
measured in clock cycles on the card, beside a row-a-tick pipeline's
(rows + stages) ticks; the takes, one at a time a stage, are not in
that chain. Then it
drives the port's main paths end to end on a 2048-CQ cluster with
51,200 workloads pending in the port's queue Manager, each cycle's
decisions held against the same solve on the CPU with the plain
versions:

1. unbound: BatchSolver(device="cuda") re-encodes and uploads the state
   and the batch every cycle (1 warm-up and 2 timed cycles);
2. bound fill: the solver bound to the Cache and the Manager, usage
   resident on the card and the batch gathered from the encode arena's
   device twin, filling an empty cluster (1 + 2 cycles);
3. bound churn: the same on a cluster whose flavors are all full, where
   128 admitted workloads finish before each cycle, so the journal's
   corrections and the arena's changed rows reach the card as the
   sparse delta prologue and the row scatter (1 + 2 cycles). Every
   bound cycle's resident usage is also held against the host mirror
   and a fresh encode of the cache.
4. scheduler fair: the port's own Scheduler with fair sharing on, its
   BatchSolver(device="cuda") bound to the Cache and the Manager, on
   the JAX package's fair-sharing benchmark configuration (2048 CQs in
   256 cohorts, one flavor of 2 units per CQ, 4-unit workloads, 30,720
   pending; the last cycle's admissions finish before each cycle):
   1 + 2 cycles, every one on the device route with drf_share launched,
   each bound cycle's resident usage held against the mirror and a
   fresh encode; drf_share's inputs in the first timed cycle are kept
   and its shares there held against the plain version on the same card
   tensors and timed, and again with a seeded usage and weights 0/500/1000/3000
   (the cell's own shares are uniform: every CQ has weight 1000 and
   starts the cycle empty); then the same cycles on the CPU
   (device="cpu") must admit the same workloads and leave the same
   usage per CQ.
5. scheduler preempt: the port's Scheduler with device preemption on
   the JAX package's preemption-heavy configuration (bench.py
   bench_preemption_reclaim: 2048 CQs, 256 child cohorts under 128
   roots, one flavor of 8 units per CQ, 64,512 admitted victims, one
   8-unit preemptor per CQ, every head in preempt mode): 1 timed
   cycle, each the first cycle of a fresh build, every one on
   the device route with the work gate choosing the device and every
   preempt-mode head solved by the K9 kernel (solve_preempt) after the
   fit sync; its inputs in the first timed cycle are kept and held
   against the plain version (the kernel's arena in shared memory), as
   are a synthetic nested input (depth 3, within-CQ, reclaim and
   threshold problems, padding) and a K = 2048 input with every slot
   active (the arena in global scratch); one traced cycle; then the
   same scenario with device="cpu" (the plain K9) and on the
   cpu-forced route (the CPU Preemptor) must evict the same workloads
   with the same reasons and admit the same workloads.
6. scheduler fair preempt: the port's Scheduler with fair sharing and
   device preemption on the JAX package's fair-sharing preemption
   configuration (bench.py bench_fair_preemption at 2048 CQs in 256
   cohorts: one flavor of 8 units per CQ, member 0 of each cohort idle
   with one 8-unit preemptor, the other 7 each holding 12 admitted
   victims, 21,504 in all): 1 timed cycle, the
   first cycle of a fresh build, every one on the device route with the
   work gate choosing the device and 256 fair problems solved by the K11
   kernel (solve_fair) after the fit sync, with one sync for the
   preemption solves; its inputs in the first timed cycle are kept and
   held against the plain version, as is a synthetic nested input
   (depth 3, every strategy order, padding); the captured inputs and
   the nested batch also with the arena in global scratch (the form past
   shared memory), and a batch past 32 local CQs (K11's general
   instance), each row with K11's launch plan (form, arena bytes, blocks
   an SM, registers, ptxas's spills) and its latency bound (a global
   round trip and the chain's steps, each a keyed pick and a share's
   64-bit max measured in clock cycles); one traced cycle; then the
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
   second timed cycle on): 1 + 2 cycles, each on the device route with
   cluster_cols launched once in the bound cycle, the placements handed
   to on_placement never on a lost cluster and on at least three; its
   inputs in the first timed cycle are kept and held against the plain
   version and the host oracle (encode.place_remote_dicts walked in the
   global admit order, on the columns cut to the flavors and resources
   the topology knows), as is a synthetic batch (8 clusters, 32 flavors,
   2 resources, 2048 rows); the admit order's inputs in that cycle (with
   the global order) are kept, held against the plain version and timed;
   one traced cycle; then the same cycles with
   device="cpu" must admit the same workloads and place them on the
   same clusters in the same order.
8. scheduler sharded: the sharded cycle (kueue_tpu_torch/parallel/mesh.py,
   K13) under the port's Scheduler, BatchSolver(mesh=make_mesh()): world
   size 1 over NCCL on the one card. (a) the north star's fill (2048 CQs
   in 256 cohorts, 32 flavors of 40 units, 51,200 pending): 1 + 1
   cycles; (b) the preemption reclaim configuration: 1 timed fresh
   build, every preempt-mode head solved by K9 over its
   problem slots (solve_preempt_sharded); (c) the MultiKueue cell: 1 + 1
   cycles, K12 after the combine. Each launches its kernels, mesh_combine
   included, and equals the same builds on the single-device route
   (BatchSolver(device="cuda"); for (b) and (c) the scheduler preempt
   and multikueue phases' own cycles on those builds): admissions and
   usage per CQ, evictions and reasons, placements. Then each rank's body of a 4-way plan in
   turn, on the card: on (a)'s first timed cycle, phase_a on the rank's
   slice, phase_b on its columns and the combine's pack, the four
   buffers summed and unpacked; on (b)'s K9 batch, K9 on each rank's
   slots, the outputs summed. Both must equal the single-device cycle and
   K9, and phase_b with columns, K9 with slots and mesh_combine their
   plain versions on the same tensors. The process group is destroyed at
   the end of the phase.
9. scheduler faults: device-fault containment (kueue_tpu_torch/
   resilience under the port's Scheduler, its solver bound to the card)
   on the north star's fill, then six trickle steps (128 admitted
   workloads finish and 128 new ones are staged a step: the arena
   scatter's and the delta prologue's traffic), in fresh builds of the
   same step schedule: R with no injector; A with one fault at a time:
   (a) a dispatch raise, whose cycle finishes on the CPU; (b) three in a
   row, the breaker opens, the next cycle routes cpu-breaker, the clock
   passes the backoff and a half-open probe on the card closes it; (c) a
   corrupt collect, caught by the decisions' checks; (e) a journal-
   replay raise; (f) a dispatch hang past the supervised deadline (a
   SupervisedTimeout, the hang not sat out); (g) a collect delay past
   the watchdog's deadline (a DispatchTimeout from the event poll); (d)
   on the first trickle step a scrambled arena scatter, which K7a writes
   and collect raises as an InjectedFault, the next step re-establishing
   residency; every step of A admits what R's does and A ends with R's
   usage per CQ; H with a seeded FaultInjector.scripted burst over every
   site through the fill and the trickle, then quiet steps until
   settled, with R's admissions and usage per CQ. Each step prints its
   route, fault counts and breaker state.
10. scheduler pipelined: the speculative pipeline (the port's Scheduler
   with pipeline_enabled, its solver bound to the card, the default
   watchdog; the router's Phase A on the card against the host mirror,
   the decisions' fetch started at dispatch) on the faults phase's
   traffic (the north star's fill, the trickle, then quiet steps until
   settled), steps 1-5 timed: (a) depth 1 and (b) depth 2, each with a
   workload of the cycle in flight updated after step 8 (an arena-slots
   abort) and a mis-speculation injected at SITE_SPECULATION; (c) the
   same traffic under the synchronous Scheduler must give the same
   admitted set and usage per CQ, and no run reserves a workload twice;
   (d) a mixed north star (mixed_env: one eighth of the CQs
   LowerPriority and full, with priority-10 heads),
   where the predicted non-fit heads ride the pipelined dispatch as a
   K9 batch and their evictions issue at collect: each step's
   admissions, evictions and reasons equal the same Scheduler's on the
   CPU. Each part prints its step p50 and max, the router's ms, the hit
   rate, the aborts by reason, the collect's device phase read from the
   CUDA events, and the Cache's live handouts after the drain (0).
11. scheduler observed: the faults phase's traffic under the JAX
   package's production wiring (ObservedRun: adaptive routing, the
   pipeline at depth 1, a CompileGovernor started before the first
   cycle, a FlightRecorder, a metrics Registry, a JourneyLedger on the
   Manager's journey listener, the manager's aging monitors but the
   WAL's, a QueryPlane read by a thread during the run, and a
   leader_check flip at the first trickle step): the governor is warm
   from its start (nothing on the card is compiled per shape), so no
   cycle runs cpu-warmup and no mid-traffic compile is counted, each
   engine has two fit samples or more, the device cycles launch the
   faults phase's kernels, the flip abandons its cycle in flight, and
   the run reaches the faults phase's run R (admitted set and usage
   per CQ), nothing admitted twice; the traces' phase_sums equal the
   histograms, every admission sealed its journey, live_handouts ends
   at what the query plane holds, no aging verdict fails. It prints the
   routes, the governor's status, the router's median admitted/s per
   engine and regime and each traced phase's p50.
12. manager: the control plane's main path, the port's
   KueueManager(cfg, solver=BatchSolver()) at the production defaults
   (the pipeline at depth 2, adaptive routing, the watchdog, the
   breaker, supervised dispatch, journeys, the query plane, the warm
   governor started) on the north star's 2048 CQs in 256 cohorts with
   16 flavors of cpu and memory in one resource group (the webhook's
   limit a group) and 4,096 batch/v1 Jobs, two a CQ, their pod counts
   from --seed (cut from the north star: the backlog, 4,096 Jobs and
   not 51,200), every object created through the manager's store:
   cycles until settled, 1,024 Jobs marked Complete, settled again.
   Every admitted Workload's Job is unsuspended and every pending one's
   suspended, nothing is admitted twice, each CQ's reservation and
   usage are its Workloads' requests within its quota, borrowing limit
   and cohort, the bound cycle's kernels launch, and every kernel call
   of the run, kept with its inputs, equals its plain version on them;
   then a 256-CQ copy on a FakeClock, on the card (which must take a
   device route) and with solver=None, must end in the same store
   state. It prints the intake Jobs/s, each route's schedule() p50 and
   max, the creation-to-admission wait from the journey ledger's
   histograms, the settle times and its wall.
13. manager multikueue: the same manager, with the synchronous cycle,
   on 256 CQs carrying the MultiKueue check, three worker
   KueueManagers with no solver (one 768-core ClusterQueue each), 1,024
   Jobs: K12 launches from the MultiKueueController's capacity columns
   and every launch equals its plain version and the host oracle on
   the columns of its cycle, as every other kernel call does its plain
   version; every placement is mirrored and reserved on its worker and
   on no other, the admitted Workloads are the placed ones, and every
   worker takes placements.

`python3 chip_smoke.py --phase NAME` (repeatable) runs the build and the
named main-path phases alone, without the kernels line; `--seed` draws
the manager phases' Jobs.

The bound and Scheduler phases print their snapshot_stats and the
snapshot phase's p50: the Cache takes incremental snapshots by default,
and bound fill, bound churn and scheduler fair must take the
incremental path on every timed cycle and hold the last one's handout
equal to a rebuild of the same cache (usage per CQ and cohort, workload
keys, epochs). Bound churn runs its first 1 + 1 cycles once more with
Cache(incremental_snapshots=False), which must decide the same; both
snapshot p50s are printed. Every Scheduler phase but the faults and
pipelined phases must see no device fault, its breaker closed and every
cycle on the device route; the pipelined phase sees no device fault.

Every phase raises on failure; nothing is caught. The last lines are
the card's name and power limit, one JSON line with the kernels'
numbers, and {"ok": true, "device": {...}}. Without a CUDA device, or
without the kueue_tpu_torch package beside this file, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
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
UNBOUND_TIMED = 2
BOUND_TIMED = 2
FULL_REBUILD_TIMED = 1  # bound churn's rerun with full snapshot rebuilds
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
# the faults phase: the fill, then the trickle's finishes (K6) and
# changed rows (K7a)
PHASE_KERNELS["scheduler_faults"] = ("arena_gather", "arena_scatter",
                                     "avail", "phase_a", "order", "phase_b",
                                     "pack", "deltas")
# the pipelined phase: the faults phase's traffic (the router's avail and
# phase_a beside the cycle's), and K9 riding the mixed cycle's dispatch
PHASE_KERNELS["scheduler_pipelined"] = PHASE_KERNELS["scheduler_faults"] \
    + ("solve_preempt",)
# the observed phase: the faults phase's traffic under the production
# wiring (adaptive routing, the pipeline, the governor)
PHASE_KERNELS["scheduler_observed"] = PHASE_KERNELS["scheduler_faults"]
SHARDED_TIMED = {"fill": 1, "preempt": 1, "multikueue": 1}
# the preempt cell's cycles are fresh builds' first: no warm-up build
SHARDED_WARMUP = {"fill": E2E_WARMUP, "preempt": 0,
                  "multikueue": E2E_WARMUP}
SHARDED_RANKS = 4  # the rank check's plan, each rank's body run in turn
# The fair-sharing benchmark configuration (bench.py bench_fair_sharing,
# builders bench.py:107-214): every admission borrows, 1024 per cycle.
FAIR = dict(num_cqs=2048, num_cohorts=256, nominal_units=2, cpu_units=4)
FAIR_TIMED = 2
FAIR_WAVES = 15         # cycles + 4, as the bench stages: 30,720 pending
# The preemption-heavy configuration (bench.py bench_preemption_reclaim,
# bench.py:1807-1850; sim/northstar.build_preempt_reclaim).
PREEMPT = dict(num_roots=128, children_per_root=2, cqs_per_child=8,
               victims_per_borrower=36)
# each preempt (and fair preempt) cycle is a fresh build's first: no
# warm-up build runs before the timed ones
PREEMPT_TIMED = 1
# K9's synthetic check: trees 3 deep (CQs attached at two depths),
# within-CQ, reclaim and threshold problems, 124 padding rows
PREEMPT_NESTED = dict(num_problems=900, max_candidates=120,
                      max_local_cqs=12, depth=3, num_cqs=2048,
                      num_leaf_cohorts=256, fanout=4, num_flavors=4,
                      num_resources=2, table_rows=4096, seed=17)
# ... and the global-scratch case: K = 2048 with every slot of every real
# problem active (synth.fill_inactive_slots), an arena past a block's
# shared memory
PREEMPT_GLOBAL = dict(num_problems=256, max_candidates=1500,
                      max_local_cqs=12, depth=2, num_cqs=2048,
                      num_leaf_cohorts=256, fanout=4, num_flavors=4,
                      num_resources=2, table_rows=4096, seed=29)
# The fair-sharing preemption configuration (bench.py
# bench_fair_preemption, bench.py:1727-1775; sim/northstar
# build_fair_preemption) at the north star's 2048 CQs.
FAIR_PREEMPT = dict(num_cqs=2048, num_cohorts=256, victims_per_cq=12)
FAIR_PREEMPT_TIMED = 1
# K11's synthetic check: trees 3 deep (CQs attached at two depths), two
# flavors per problem, weight 0, roots lending nothing, thresholds, 124
# padding rows, under every strategy order
FAIR_NESTED = dict(num_problems=900, max_candidates=120, max_local_cqs=12,
                   depth=3, num_cqs=2048, num_leaf_cohorts=256, fanout=4,
                   num_flavors=4, num_resources=2, table_rows=4096, seed=19)
FAIR_STRATS = ((True, True, False), (True, False, False),
               (False, False, False), (False, True, True))
# K11 past 32 local CQs (its general instance): 64 local CQs, K = 512
FAIR_QL64 = dict(num_problems=150, max_candidates=300, max_local_cqs=40,
                 depth=2, num_cqs=2048, num_leaf_cohorts=16, fanout=4,
                 num_flavors=4, num_resources=2, table_rows=512, seed=3)
# K11's time a launch on the fair cell's captured inputs before its
# redesign (PERF.md section 6): this script's reading, and the previous
# kernel's timed beside the new one in one call; printed beside the new
# time, never in the kernels line
K11_EARLIER_MS = 0.0458
K11_PARENT_MS = 0.0757
# the shared-sync measurement: rounds of calls of each form, in turns
SYNC_ROUNDS = 4
SYNC_CALLS = 25
# the order kernel's check with non-zero shares: mixed values and ties,
# negative shares (a root lending nothing) and NO_LIMIT (weight 0)
MIXED_SHARES = (-2, -1, 0, 0, 125, 125, 333, 2**62)
# The MultiKueue manager cluster (sim/northstar build_multikueue) on the
# north star: w1 is lost from the third timed cycle on.
MK = dict(num_cqs=2048, num_cohorts=256, num_flavors=32, nominal_units=40,
          cpu_units=40, waves=25)
MK_TIMED = 2
MK_LOST = ("w1", E2E_WARMUP + 1)
# K12's synthetic check: lost clusters, partial offers, capacity that runs
# out mid-scan
MK_SYNTH = dict(num_clusters=8, num_flavors=32, num_resources=2,
                num_workloads=2048, num_podsets=4, num_cqs=2048, seed=23)
# K12's time a launch before its redesign (the one-warp kernel at the
# captured cycle, PERF.md section 6); printed beside the new time, never
# in the kernels line
K12_EARLIER_MS = 0.884
# The shapes on which the first kernels raised (wide_phase): K9 with a
# problem of exactly 131,072 candidates; phase_a at the north star's
# widths with 32 resources (17 resource names bucket to 32) and with 17;
# K12 at 64 clusters x 32 flavors x 16 resources (270,336 B of columns),
# and at MK_SYNTH's clusters, flavors and rows with 8, 16 and 32 resources
# (the register form's widest two, then the arena form)
WIDE_K9 = dict(num_problems=3, K=131072, seed=5)
WIDE_PHASE_A = dict(num_cqs=2048, num_cohorts=256, num_flavors=32,
                    num_workloads=2048, num_podsets=4)
WIDE_K12 = {
    "k64_f32_r16": dict(num_clusters=64, num_flavors=32, num_resources=16,
                        num_workloads=2048, num_podsets=4, num_cqs=2048,
                        requested_share=0.15, seed=23),
    "k8_f32_r8": dict(num_clusters=8, num_flavors=32, num_resources=8,
                      num_workloads=2048, num_podsets=4, num_cqs=2048,
                      requested_share=0.3, seed=23),
    "k8_f32_r16": dict(num_clusters=8, num_flavors=32, num_resources=16,
                       num_workloads=2048, num_podsets=4, num_cqs=2048,
                       requested_share=0.15, seed=23),
    "k8_f32_r32": dict(num_clusters=8, num_flavors=32, num_resources=32,
                       num_workloads=2048, num_podsets=4, num_cqs=2048,
                       requested_share=0.1, seed=23)}
# K4 and K7b on the shapes their redesign splits on (wide_phase): one
# domain holding every workload (all CQs under one cohort tree), W one
# above the staged form's limit (ORDER_THREADS * ORDER_ILP = 4096), W =
# 65,536 over D = 65,536 + 256 (a solo CQ every 7th), and the edge keys
# (+-0.0, NaNs of both signs and several payloads, subnormals, INT64_MIN
# and INT64_MAX priorities, NO_LIMIT, INT64_MIN, INT64_MAX and negative
# shares); K7b on a twin of odd row bytes (P=3, F=5, R=3) and on sources
# sliced one element off a 16-byte boundary, W not a multiple of 8
WIDE_K4 = {
    "one_domain_2048": dict(num_cqs=2048, num_cohorts=64, num_workloads=2048,
                            one_domain=True, seed=7),
    "staged_limit_plus_1": dict(num_cqs=2048, num_cohorts=256,
                                num_workloads=4097, seed=9),
    "w65536": dict(num_cqs=65536, num_cohorts=256, num_workloads=65536,
                   solo_every=7, seed=11),
    "edge_keys": dict(num_cqs=2048, num_cohorts=256, num_workloads=2048,
                      edge=True, seed=6)}
WIDE_K7B = {
    "odd_p3_f5_r3": dict(slots=512, num_workloads=203, num_podsets=3,
                         num_flavors=5, num_resources=3, offset=0, seed=2),
    "misaligned": dict(slots=4096, num_workloads=2045, num_podsets=4,
                       num_flavors=32, num_resources=2, offset=1, seed=3)}
# K7a beside the churn's rows (wide_phase): odd row bytes, the rows and
# the twin one element off 16 bytes, and JAX's index rule: SCATTER_ROWS
# distinct targets, half written as slot - cap (-1 and -cap among them),
# the rest of the 512-row bucket padded with slots the scatter drops (cap,
# cap + 5, -cap - 1, -2 cap, the int32 ends) in place of `cap`
WIDE_K7A = {
    "odd_p3_f5_r3": dict(num_podsets=3, num_flavors=5, num_resources=3,
                         offset=0, out_of_range=False, seed=4),
    "misaligned": dict(num_podsets=4, num_flavors=32, num_resources=2,
                       offset=1, out_of_range=False, seed=5),
    "out_of_range": dict(num_podsets=4, num_flavors=32, num_resources=2,
                         offset=0, out_of_range=True, seed=6)}
# K8 at W not a multiple of 32 or 8, odd P * R, chosen and chosen_borrow
# one or three elements past a 16-byte boundary
WIDE_K8 = {"w1": (1, 1, 1, 0), "w31_p3_r1_off1": (31, 3, 1, 1),
           "w33_p3_r3_off1": (33, 3, 3, 1), "w2047_off1": (2047, 4, 2, 1),
           "w2049_p1_r5_off3": (2049, 1, 5, 3)}
# K3 and K6 beside their main shapes (wide_phase): drf_share at F = 1, 32
# and 33 flavors by R = 1, 2, 3, 17 and 32 resources, and with the
# quantities scaled past 2^53 (the int64 division) and past int64 (a
# wrapping product), on synth.synth_share_inputs' batches (weights
# 0/500/1000/3000, a root lending nothing, 2048 CQs and heads); deltas on
# the nested tree with every 3rd CQ attached one level up (a cohort coord
# at levels 0 and 1 of the tuple), at 2049 and 16,384 coords there (D =
# 8192, opted-in shared memory; D = 32,768, the global form), with no
# cohort level, and on trees 10 deep (past the register form's levels)
WIDE_K3 = tuple((F, R, 1) for F in (1, 32, 33) for R in (1, 2, 3, 17, 32)) \
    + ((32, 2, 2**33), (32, 2, 2**45))
WIDE_K6 = {"mixed_depth": 256, "mixed_2049": 2049, "mixed_16384": 16384,
           "zero_levels": 256, "deep10": 300}
ORDER_NAN_BITS = (0x7ff8000000000000, 0x7ff8000000000123, 0xfff8000000000000,
                  0xfff0000000000001, 0x7ff0000000000001)
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
PARTIAL_TIMED = 2
PARTIAL_WAVES = E2E_WARMUP + PARTIAL_TIMED + 2  # a head on every CQ
# The faults phase (scheduler_faults_phase): the north star's fill, then
# FAULTS_TRICKLE steps that finish 128 admitted workloads and stage 128
# new ones (the arena scatter's traffic); the chaos run goes on until
# FAULTS_SETTLE steps in a row admit nothing.
FAULTS_TRICKLE = 6
FAULTS_SETTLE = 3
FAULTS_STEPS = E2E_WAVES + FAULTS_TRICKLE
FAULTS_CLOCK_S = 0.25   # the FakeClock's advance a step (A and R)
FAULTS_CHAOS_CLOCK_S = 2.0  # the chaos run's, past doubled backoffs
FAULTS_CHAOS = dict(seed=1234, horizon=40, delay_s=0.2,
                    rates={"device_dispatch": 0.5, "device_collect": 0.3,
                           "arena_scatter": 0.4, "journal_replay": 0.2})
FAULTS_MAX_STEPS = 80
# The pipelined phase (scheduler_pipelined_phase): the faults phase's
# traffic at depth 1 and 2, steps 1-5 timed;
# a workload of the cycle in flight updated after step 8 (an
# arena-slots abort); a mis-speculation injected at the 25th validation
# at depth 1 and the 41st at depth 2 (a depth-2 step validates three
# times): in the fill's steady stretch. The
# mixed cycle's north star (mixed_env): 2 preemptors a class-0 CQ, 4
# waves of heads in classes 1-6, 1 + 3 steps, then the drain.
PIPELINE_TIMED = 5
PIPELINE_UPDATE_STEP = 8
PIPELINE_INJECT_HIT = {1: 24, 2: 40}
MIXED = dict(waves=4, preemptors=2, steps=4, max_steps=10)
# the faults phase's run R: its admitted names and usage per CQ at the
# end, which the observed phase's run must reach
FAULTS_R: dict = {}
# the observed phase: the trickle step (from the first) at which the
# leader check flips
OBSERVED_FLIP = 0


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


def time_cuda_queued(fn, iters: int, host_us: float = 300.0,
                     tries: int = 3) -> float:
    """Milliseconds of device time per call, by CUDA events: a sleep
    kernel holds the card while the host enqueues `iters` calls (host_us
    each, at most), so the calls run back to back between the events and
    the host's launch cost stays out of the reading. The start event,
    recorded just after the sleep, must still be pending once every call
    is enqueued; if it is not (the host took longer than host_us a call,
    so the reading could hold host gaps), the reading is taken again with
    a sleep four times as long, and after `tries` readings it raises."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(iters * host_us * 2e3))  # cycles, <= 2 GHz
        start.record()
        for _ in range(iters):
            fn()
        covered = not start.query()
        end.record()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / iters
        host_us *= 4
    raise RuntimeError(f"time_cuda_queued: the host took more than "
                       f"{host_us / 4:.0f} us a call to enqueue {iters} "
                       "calls; the card ran ahead of it")


def cluster_least_tick(device, R: int, iters: int = 4096) -> float:
    """Clock cycles of cluster_cols' least pipeline tick: one warp's
    dependent rounds of one shared load, R compares and one shuffle
    (csrc/cluster_cols.cu cluster_cols_tick_kernel), the least of three
    runs."""
    import torch
    from kueue_tpu_torch.solver import kernel as k
    best = None
    for _ in range(3):
        out = torch.zeros(2, dtype=torch.int64, device=device)
        k._launch("cluster_cols", [out.data_ptr()], [iters, R], device,
                  symbol="cluster_cols_tick_launch")
        torch.cuda.synchronize()
        cycles = out[0].item() / iters
        best = cycles if best is None else min(best, cycles)
    return best


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

    def record(inflight, snapshot):
        calls.append((inflight.result, tuple(inflight.keys)))
        return real(inflight, snapshot)
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


@contextlib.contextmanager
def collector_paused():
    """Set-up only (a decorator or a with block around an environment's
    build): the cyclic collector off while the build makes objects that
    all live on, since each collection it would trigger scans the whole
    heap for nothing; then one full collection, and the survivors
    frozen (gc.freeze), so that no later collection scans the build
    again: without it every full collection of a north-star run walked
    its 51,200 staged workloads, a 2-4 s pause every few steps. The
    previous build's objects are unfrozen first, so that what a closed
    run left is collected."""
    was = gc.isenabled()
    gc.unfreeze()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()
        gc.collect()
        gc.freeze()


def kernel_record(key: str, name: str) -> bool:
    """Whether a profiler row is kernel `name`'s: a CUDA function named
    `<name>_...`; a template's demangled name leads with its return
    type."""
    return key.removeprefix("void ").startswith(f"{name}_")


def profiled_device_ms(fn, iters: int, kernel_name: str):
    """Mean device time per call of kernel `kernel_name`'s CUDA kernels
    (kernel_record), from a torch.profiler trace of `iters` calls
    (device activity only, then, if that trace kept no record of them,
    host and device activity, as the traced cycles record); None when
    neither holds device time for them. A trace may keep fewer records
    than the calls launched (in a long run, about half of K11's): the
    time is then the mean record's times the launches a call (the
    records a call, rounded, at least one), not the total over `iters`,
    which would read low."""
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
        rows = [e for e in prof.key_averages()
                if kernel_record(e.key, kernel_name)
                and str(e.device_type).endswith("CUDA")]
        total = sum(device_us(e) for e in rows)
        if total:
            records = sum(e.count for e in rows)
            per_call = max(1, round(records / iters))
            if records != per_call * iters:
                log(f"[profile] {kernel_name}: the trace kept {records} "
                    f"records of {iters} calls")
            return total / records * per_call / 1e3
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


@functools.cache
def card_ticks(device) -> dict:
    """The least costs the K3 and K6 latency bounds count, measured once a
    run in clock cycles on the card: a dependent global load read past
    L1 and the SM clock (phase_b_tick), a floor division and a
    shuffle-add (drf_share_tick), a level step of the delta prologue
    (deltas_tick)."""
    from kueue_tpu_torch.solver import kernel as k
    b_tick = k.phase_b_tick(device, 1)
    return {"load_cycles": b_tick["load_cycles"],
            "sm_clock_khz": b_tick["clock_khz"], **k.drf_share_tick(device),
            "level_step_cycles": k.deltas_tick(device)}


def share_latency(plan: dict, ticks: dict) -> dict:
    """drf_share's latency bound: a head's three dependent global round
    trips (its CQ; the CQ's rows and root; the root's lendable row), its
    two floor divisions and the plan's shuffle steps."""
    cycles = (3 * ticks["load_cycles"] + 2 * ticks["div_cycles"]
              + plan["shuffles"] * ticks["shuffle_cycles"])
    return {"form": plan["form"], "plan": plan, "global_round_trips": 3,
            "divisions": 2, "shuffles": plan["shuffles"],
            **{key: ticks[key] for key in ("load_cycles", "div_cycles",
                                           "shuffle_cycles",
                                           "sm_clock_khz")},
            "latency_bound_ms": cycles / ticks["sm_clock_khz"]}


def deltas_latency(plan: dict, levels: int, ticks: dict) -> dict:
    """The delta prologue's latency bound: two dependent global round
    trips (the coords; the values at them), then a level step for the
    delta coords' sums and one for each cohort level."""
    steps = levels + 1 if levels else 0
    cycles = 2 * ticks["load_cycles"] + steps * ticks["level_step_cycles"]
    return {"form": plan["form"], "plan": plan, "global_round_trips": 2,
            "level_steps": steps,
            **{key: ticks[key] for key in ("load_cycles",
                                           "level_step_cycles",
                                           "sm_clock_khz")},
            "latency_bound_ms": cycles / ticks["sm_clock_khz"]}


def share_kernel_row(k, args: tuple, device) -> dict:
    """drf_share on `args` (topology, usage, assignment, wl_cq, on the
    card) against drf_share_plain on the same tensors, timed: the
    profiler's device time a launch, back-to-back calls, the plain
    version, the byte and latency bounds."""
    import torch
    row = {"max_abs_err": compare(("share",), (k.drf_share(*args),),
                                  (k.drf_share_plain(*args),)),
           "shape_W_F_R": list(args[2].shape)}
    torch.cuda.synchronize()
    row["call_ms"] = time_cuda(lambda: k.drf_share(*args), iters=50)
    row["plain_ms"] = time_cuda(lambda: k.drf_share_plain(*args), iters=20)
    kernel_ms = profiled_device_ms(lambda: k.drf_share(*args), 50,
                                   "drf_share")
    row["ms"], row["ms_source"] = (kernel_ms, "profiler") \
        if kernel_ms is not None else (row["call_ms"], "events")
    row["bytes"] = drf_share_bytes(args[0], args[2], args[3])
    row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
    row["library_ms"] = None
    row.update(share_latency(k.drf_share.last_plan, card_ticks(device)))
    return row


def deltas_kernel_row(k, topo, usage, cu, deltas, device) -> dict:
    """apply_state_deltas against its plain version on copies of the same
    card state, timed as share_kernel_row times drf_share (in place:
    the timed calls keep applying the tuple to one copy)."""
    import torch
    from kueue_tpu_torch.solver import synth
    got, want = (usage.clone(), cu.clone()), (usage.clone(), cu.clone())
    k.apply_state_deltas(topo, *got, *deltas)
    k.apply_state_deltas_plain(topo, *want, *deltas)
    lvl_c = deltas[4].cpu().numpy()
    row = {"max_abs_err": compare(("usage", "cohort_usage"), got, want),
           "D": int(deltas[0].shape[0]), "L": int(lvl_c.shape[0]),
           "coords": int((deltas[0] >= 0).sum()),
           "shared_level_coords": synth.shared_level_coords(lvl_c)}
    plan = dict(k.apply_state_deltas.last_plan)
    torch.cuda.synchronize()
    row["call_ms"] = time_cuda(lambda: k.apply_state_deltas(
        topo, *got, *deltas), iters=50)
    row["plain_ms"] = time_cuda(lambda: k.apply_state_deltas_plain(
        topo, *want, *deltas), iters=10)
    kernel_ms = profiled_device_ms(lambda: k.apply_state_deltas(
        topo, *got, *deltas), 50, "deltas")
    row["ms"], row["ms_source"] = (kernel_ms, "profiler") \
        if kernel_ms is not None else (row["call_ms"], "events")
    row["bytes"] = deltas_bytes(deltas)
    row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
    row["library_ms"] = None
    row.update(deltas_latency(plan, row["L"], card_ticks(device)))
    return row


def wide_share_rows(device) -> dict:
    """K3 on WIDE_K3's shapes and K6 on WIDE_K6's: equal to the plain
    versions, timed."""
    import numpy as np
    import torch
    from kueue_tpu_torch.solver import kernel as k, synth

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    rows = {}
    for F, R, scale in WIDE_K3:
        topo, usage, asg, wl_cq = synth.synth_share_inputs(
            F, R, num_cqs=2048, num_workloads=2048, scale=scale,
            seed=F * 100 + R)
        row = share_kernel_row(k, (k.topo_to_device(topo, device), dev(usage),
                                   dev(asg), dev(wl_cq)), device)
        label = f"f{F}_r{R}" + (f"_scale_2^{scale.bit_length() - 1}"
                                if scale > 1 else "")
        log(f"[kernels:drf_share:{label}] equal to plain: "
            + json.dumps(row))
        rows[f"drf_share_{label}"] = row
    mixed = synth.synth_nested_inputs(seed=7, attach_up_every=3, **NESTED)
    deep = synth.synth_nested_inputs(
        num_cqs=512, num_leaf_cohorts=512, fanout=2, depth=10,
        num_flavors=4, num_resources=2, num_workloads=8, attach_up_every=5,
        seed=3)
    for label, coords in WIDE_K6.items():
        topo, usage, cu, _ = deep if label == "deep10" else mixed
        deltas = synth.synth_deltas(topo, usage, coords, seed=coords,
                                    level_pairs=4 if label == "deep10"
                                    else 8)
        if label == "zero_levels":
            deltas = deltas[:4] + (deltas[4][:0], deltas[5][:0])
        row = deltas_kernel_row(k, k.topo_to_device(topo, device), dev(usage),
                                dev(cu), tuple(dev(a) for a in deltas),
                                device)
        if label.startswith("mixed") and not row["shared_level_coords"]:
            raise AssertionError(f"deltas {label}: no cohort coord at two "
                                 "levels")
        log(f"[kernels:deltas:{label}] equal to plain: " + json.dumps(row))
        rows[f"deltas_{label}"] = row
    return rows


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

    # the share empty domains take: phase_b over every domain that can
    # hold members against a column list of the occupied ones
    counts = offsets[1:] - offsets[:-1]
    occupied = torch.nonzero(counts > 0).flatten().to(torch.int32)
    compare(("admitted (occupied columns)", "usage (occupied columns)",
             "cohort_usage (occupied columns)"),
            k.phase_b(*b_args, occupied), k.phase_b_plain(*b_args, occupied))
    # the forms the launches took, and the least steps their latency
    # bounds are counted in
    k.phase_a(*a_args)
    a_plan = dict(k.phase_a.last_plan)
    k.phase_b(*b_args)
    b_plan = dict(k.phase_b.last_plan)
    k.order_csr(*o_args)
    o_plan = dict(k.order_csr.last_plan)
    k.gather_arena(inp["twin"], inp["slots"])
    g_plan = dict(k.gather_arena.last_plan)
    k.scatter_arena_rows({n: t.clone() for n, t in twin.items()}, upd_slots,
                         upd_rows)
    sc_plan = dict(k.scatter_arena_rows.last_plan)
    DC = topo["cq_chain"].shape[1]
    b_tick = k.phase_b_tick(device, min(DC, 4))
    k.drf_share(*s_args)
    s_plan = dict(k.drf_share.last_plan)
    k.apply_state_deltas(topo, usage.clone(), cu.clone(), *deltas)
    d_plan = dict(k.apply_state_deltas.last_plan)
    ticks = card_ticks(device)
    redux = k.phase_a_tick(device)
    o_step = k.order_tick(device)
    q = wl["wl_cq"].long()
    reqs = (wl["requests"][:, :P] > 0).flatten(1).sum(1)
    reductions = int((reqs * (1 + topo["prefer_no_borrow"][q].long())).max())
    clock = b_tick["clock_khz"]
    extra = {
        "phase_a": {"form": a_plan["form"],
                    "register_r": a_plan["register_r"],
                    "dependent_reductions": reductions,
                    "redux_cycles": redux,
                    "load_cycles": b_tick["load_cycles"],
                    "latency_bound_ms": (2 * b_tick["load_cycles"]
                                         + reductions * redux) / clock},
        "phase_b": {"form": b_plan["vote"], "plan": b_plan,
                    "domain_forms": k.phase_b_forms(topo, b_plan,
                                                    F * R),
                    "step_cycles": b_tick["step_cycles"],
                    "load_cycles": b_tick["load_cycles"],
                    "sm_clock_khz": clock,
                    "latency_bound_ms": (b_tick["load_cycles"] + steps
                                         * b_tick["step_cycles"]) / clock},
        # the staged form's chain: ORDER_ROUND_TRIPS dependent global
        # round trips (the CQ, its cohort, the root; the keys), then
        # ORDER_STEPS block steps
        "order": {"form": o_plan["form"], "plan": o_plan,
                  "global_round_trips": k.ORDER_ROUND_TRIPS,
                  "dependent_steps": k.ORDER_STEPS,
                  "step_cycles": o_step,
                  "load_cycles": b_tick["load_cycles"],
                  "sm_clock_khz": clock,
                  "latency_bound_ms": (k.ORDER_ROUND_TRIPS
                                       * b_tick["load_cycles"]
                                       + k.ORDER_STEPS * o_step) / clock},
        # a row's slot, then its fields: two round trips
        "arena_gather": {"form": "warp a row, vectors of "
                                 + "/".join(map(str, g_plan["vec_bytes"]))
                                 + " bytes",
                         "vec_bytes": g_plan["vec_bytes"],
                         "passes": g_plan["passes"],
                         "global_round_trips": 2,
                         "load_cycles": b_tick["load_cycles"],
                         "sm_clock_khz": clock,
                         "latency_bound_ms": 2 * b_tick["load_cycles"]
                         / clock},
        # the same copy kernel, its row's slot then its fields
        "arena_scatter": {"form": "warp a row, vectors of "
                                  + "/".join(map(str, sc_plan["vec_bytes"]))
                                  + " bytes",
                          "vec_bytes": sc_plan["vec_bytes"],
                          "passes": sc_plan["passes"],
                          "global_round_trips": 2,
                          "load_cycles": b_tick["load_cycles"],
                          "sm_clock_khz": clock,
                          "latency_bound_ms": 2 * b_tick["load_cycles"]
                          / clock},
        # the launch and one global round trip: no load depends on another
        # a head's three dependent round trips, two divisions, shuffles
        "drf_share": share_latency(s_plan, ticks),
        # two round trips, then a level step a level (and the first sums)
        "deltas": deltas_latency(d_plan, int(deltas[4].shape[0]), ticks),
        "pack": {"form": "a thread an output byte",
                 "global_round_trips": 1,
                 "load_cycles": b_tick["load_cycles"],
                 "sm_clock_khz": clock,
                 "latency_bound_ms": b_tick["load_cycles"] / clock}}

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
            **({"dependent_steps": steps} if name == "phase_b" else {}),
            **extra.get(name, {})}
        if name in extra:
            log(f"[kernels:{kind}] {name} form: " + json.dumps(extra[name]))
    # on the same inputs: every domain's block against the occupied
    # columns' (the column list the sharded cycle hands phase_b)
    occ_ms = profiled_device_ms(lambda: k.phase_b(*b_args, occupied), 50,
                                "phase_b")
    all_ms = profiled_device_ms(lambda: k.phase_b(*b_args), 50, "phase_b")
    results[kind]["phase_b"]["occupied_columns"] = {
        "blocks": int(occupied.numel()), "ms": occ_ms, "all_domains_ms": all_ms,
        "all_domain_blocks": int(topo["dom_roots"].shape[0]
                                 + topo["dom_solo"].shape[0])}
    log(f"[kernels:{kind}] phase_b on the same inputs: all domains "
        f"{all_ms} ms, the {int(occupied.numel())} occupied columns "
        f"{occ_ms} ms")


def check_healthy(phase: str, sched, cycle: int) -> None:
    """A card Scheduler's cycle outside the faults phase: on the device
    route, no device fault contained, the breaker closed, and no cycle
    of the run on another route."""
    if sched.last_route != "device" or sched.solver_faults \
            or sched.breaker.state != "closed" \
            or set(sched.cycle_counts) != {"device"}:
        raise AssertionError(
            f"{phase} cycle {cycle}: route {sched.last_route!r}, "
            f"{sched.solver_faults} device faults, breaker "
            f"{sched.breaker.state}, cycles {sched.cycle_counts}")


def check_handout(snap, cache, ctx: str) -> None:
    """A snapshot handout against a from-scratch build of the same cache
    (Cache._build_snapshot): every CQ's usage and workload keys, every
    cohort's usage, the epochs and the journal position."""
    want = cache._build_snapshot()
    got_e = (snap.cohort_epoch, snap.flavor_spec_epoch, snap.topology_epoch,
             snap.journal_seq)
    want_e = (want.cohort_epoch, want.flavor_spec_epoch,
              want.topology_epoch, want.journal_seq)
    if got_e != want_e or set(snap.cluster_queues) != set(want.cluster_queues):
        raise AssertionError(f"{ctx}: handout epochs {got_e} or CQs differ "
                             f"from a rebuild's {want_e}")
    cohorts = {}
    for name, cq in snap.cluster_queues.items():
        ref = want.cluster_queues[name]
        if cq.resource_node.usage != ref.resource_node.usage \
                or set(cq.workloads) != set(ref.workloads):
            raise AssertionError(f"{ctx}: CQ {name}'s usage or workloads "
                                 "differ from a rebuild's")
        if cq.cohort is not None:
            cohorts[cq.cohort.name] = (cq.cohort, ref.cohort)
    for name, (c, ref) in cohorts.items():
        if c.resource_node.usage != ref.resource_node.usage:
            raise AssertionError(f"{ctx}: cohort {name}'s usage differs "
                                 "from a rebuild's")


class HandoutCheck:
    """Within the block, every full snapshot the cache hands out is held
    against a rebuild (check_handout) as it is taken; `spent` is the
    seconds the checks took, for the caller to take out of its times."""

    def __init__(self, cache, ctx: str):
        self.cache, self.ctx = cache, ctx
        self.spent = 0.0
        self.checked = 0

    def __enter__(self):
        real = self.cache.snapshot

        def snapshot(light=False):
            snap = real(light=light)
            if not light:
                t0 = time.perf_counter()
                check_handout(snap, self.cache, self.ctx)
                self.spent += time.perf_counter() - t0
                self.checked += 1
            return snap
        self.cache.snapshot = snapshot
        return self

    def __exit__(self, *exc):
        del self.cache.snapshot


def snapshot_mode(stats: dict, before: dict) -> str:
    """Which path (full, incremental, partial, light) served the one
    snapshot taken between the two readings of cache.snapshot_stats."""
    moved = [m for m in stats if stats[m] != before[m]]
    return moved[0] if len(moved) == 1 else "+".join(moved)


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
    # a from-scratch build, not a handout: the incremental maintainer's
    # replay stays inside the next cycle's timed snapshot
    truth = encode.encode_state(cache._build_snapshot(), topo)
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


def e2e_phase(device, phase: str, incremental: bool = True,
              timed: int = None) -> dict:
    """One main path, cycle after cycle: heads from the Manager, a cache
    snapshot (incremental, as the Cache takes them by default, unless
    told otherwise), BatchSolver(device), the admissions applied as the
    scheduler applies them and the snapshot released. Every cycle's
    decisions are held against the CPU plain path on the same snapshot
    and heads, outside the timed window; the bound phases' timed
    snapshots must take the incremental path, and the last one's
    handout must equal a rebuild of the cache. With incremental False
    (a rerun of a phase with Cache(incremental_snapshots=False)) the
    CPU check, the fetch timing and the trace are left out: the caller
    holds its decisions to the incremental run's."""
    from collections import deque

    from kueue_tpu_torch.api import kueue as api
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import BatchSolver, encode, kernel
    bound, churn = phase != "unbound", phase == "bound_churn"
    if timed is None:
        timed = BOUND_TIMED if bound else UNBOUND_TIMED
    num_cqs, num_cohorts = NORTH_STAR["num_cqs"], NORTH_STAR["num_cohorts"]
    flavors = [f"f{i}" for i in range(NORTH_STAR["num_flavors"])]
    t_phase = time.perf_counter()
    # StrictFIFO in the churn keeps a requeued head at its queue's front,
    # so the heads that do not fit come back unchanged every cycle.
    with collector_paused():
        cache, queues = ns.build_cluster(
            num_cqs, num_cohorts, flavors, NOMINAL_UNITS,
            api.STRICT_FIFO if churn else api.BEST_EFFORT_FIFO,
            incremental_snapshots=incremental)
        admitted = deque() if churn else None
        if churn:  # every flavor of every CQ full, oldest first by flavor
            for f in flavors:
                for i in range(num_cqs):
                    wl = ns.admitted_workload(f"pre-{f}-{i}", f"cq{i}", f,
                                              NOMINAL_UNITS, 0.0)
                    cache.assume_workload(wl)
                    admitted.append(wl)
        staged = ns.stage_waves(queues, E2E_WAVES, num_cqs, NOMINAL_UNITS)
    label = phase if incremental else f"{phase} (full rebuild)"
    log(f"[{label}] cluster: {num_cqs} CQs, {num_cohorts} cohorts, "
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
    modes, decided = [], []
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
        stats0 = dict(cache.snapshot_stats)
        t1 = time.perf_counter()
        snapshot = cache.snapshot()
        t2 = time.perf_counter()
        decisions = solver.solve(snapshot, heads)
        g3, t3 = gc_clock.total, time.perf_counter()
        mode = snapshot_mode(cache.snapshot_stats, stats0)
        if cycle == E2E_WARMUP + timed - 1:
            check_handout(snapshot, cache, f"{label} cycle {cycle}")
        if incremental:
            expected = reference.solve(snapshot, heads)
            if normalize(decisions) != normalize(expected):
                raise AssertionError(f"{phase} cycle {cycle}: CUDA "
                                     "decisions differ from the CPU plain "
                                     "path")
            del expected
        decided.append(sorted((heads[i].key, a.pod_sets[0].flavors["cpu"]
                               .name, ok)
                              for i, (a, ok) in decisions.items()))
        gc.collect()
        g4, t4 = gc_clock.total, time.perf_counter()
        n = ns.apply_decisions(cache, queues, solver if bound else None,
                               heads, decisions, 1000.0 + cycle, admitted)
        cache.release_snapshot(snapshot)
        g5, t5 = gc_clock.total, time.perf_counter()
        row = {"heads": t1 - t0, "snapshot": t2 - t1, **solver.last_phase_s,
               "admit": t5 - t4, "gc": (g3 - g0) + (g5 - g4),
               "cycle": (t3 - t0) + (t5 - t4),
               "upload_bytes": solver.last_upload_bytes}
        depth = sorted({ps.flavors["cpu"].name for a, ok in decisions.values()
                        if ok for ps in a.pod_sets})
        arena = solver.arena
        log(f"[{label}] cycle {cycle}"
            f"{' (warm-up)' if cycle < E2E_WARMUP else ''}: finished="
            f"{finished} snapshot={mode} heads={len(heads)} "
            f"fit={len(decisions)} admitted="
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
        row["mode"] = mode
        return row

    fetch = {}
    kernel.reset_launch_counts()
    for cycle in range(E2E_WARMUP + timed):
        with fetch_timing(solver, fetch) \
                if cycle == E2E_WARMUP and incremental \
                else contextlib.nullcontext():
            row = run_cycle(cycle)
        if cycle < E2E_WARMUP:
            continue
        admitted_timed += row["admitted"]
        modes.append(row["mode"])
        for k in keys:
            phases[k].append(row[k])
    if bound and incremental and set(modes) != {"incremental"}:
        raise AssertionError(f"{phase}: the timed snapshots took {modes}, "
                             "not the incremental path")
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
    summary["snapshot_stats"] = dict(cache.snapshot_stats)
    summary["snapshot_modes"] = modes
    check()
    if incremental:
        summary["traced_cycle"] = traced_cycle(phase, run_cycle,
                                               E2E_WARMUP + timed)
        check()
    gc.callbacks.remove(gc_clock)
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[{label}] " + json.dumps(summary))
    summary["decided"] = decided
    return summary


SCHED_PHASES = ("heads", "snapshot", "nominate", "encode",
                "upload", "device", "fetch", "decode", "apply", "requeue")


@collector_paused()
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
    records, modes = [], []
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
        stats0 = dict(cache.snapshot_stats)
        # the last timed cycle's handout is held against a rebuild as it
        # is taken, its time taken out of the snapshot and the cycle
        with HandoutCheck(cache, f"{phase} cycle {cycle}") \
                if cycle == E2E_WARMUP + FAIR_TIMED - 1 \
                else contextlib.nullcontext() as handout:
            g0, t0 = gc_clock.total, time.perf_counter()
            sched.schedule(timeout=0)
            g1, t1 = gc_clock.total, time.perf_counter()
        spent = handout.spent if handout is not None else 0.0
        if handout is not None and handout.checked != 1:
            raise AssertionError(f"{phase} cycle {cycle} took "
                                 f"{handout.checked} full snapshots")
        mode = snapshot_mode(cache.snapshot_stats, stats0)
        check_healthy(phase, sched, cycle)
        records.append(cycle_record(client, cache))
        row = {**sched.last_phase_s, **solver.last_phase_s,
               "gc": g1 - g0, "cycle": t1 - t0 - spent}
        row["snapshot"] -= spent
        row["other"] = row["cycle"] - sum(row[p] for p in SCHED_PHASES)
        row["admitted"] = client.admitted - before
        row["mode"] = mode
        log(f"[{phase}] cycle {cycle}"
            f"{' (warm-up)' if cycle < E2E_WARMUP else ''}: finished="
            f"{finished} (finish_ms={t_finish * 1e3:.1f}) snapshot={mode} "
            f"admitted={row['admitted']} pending={queues.pending_total()} "
            f"cycle_ms="
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
        modes.append(row["mode"])
        for p in keys:
            phases[p].append(row[p])
    if set(modes) != {"incremental"}:
        raise AssertionError(f"{phase}: the timed snapshots took {modes}, "
                             "not the incremental path")
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
    summary["snapshot_stats"] = dict(cache.snapshot_stats)
    summary["snapshot_modes"] = modes
    summary["live_handouts"] = cache.live_handouts
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
           "varied_distinct": distinct, "max_abs_err": 0,
           # the main path's own inputs, timed beside the plain version
           "row": share_kernel_row(k, captured.args, usage.device)}
    log("[scheduler_fair] drf_share equal to plain on the captured cycle's "
        "inputs and on them with varied usage and weights: "
        + json.dumps(out))
    return out


PREEMPT_PHASES = ("heads", "snapshot", "nominate", "encode", "upload",
                  "device", "fetch", "decode", "preempt-plan", "preempt",
                  "decode-targets", "apply", "requeue")


@collector_paused()
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


def ptxas_report(name: str) -> dict:
    """Registers a thread and spill bytes (stores + loads) of kernel
    `name`'s library, from ptxas's -v report in this run's build log
    (empty when the library was not built in this run)."""
    import re
    from kueue_tpu_torch.solver import _build
    log_text = _build.BUILD_LOG.get(name, "")
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log_text)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log_text)]
    return {"ptxas_registers": max(regs) if regs else None,
            "ptxas_spill_bytes": max(spills) if spills else None}


PREEMPT_PLAN_KEYS = ("active_slots", "row_slots", "group_slots",
                     "index_bits", "rule",
                     "arena_bytes", "smem_bytes_per_block", "blocks_per_sm",
                     "grid", "registers", "local_bytes", "ptxas_registers",
                     "ptxas_spill_bytes")


def preempt_plan_row(k) -> dict:
    """The last solve_preempt launch's plan: active slots, the arena's
    rule and bytes a block (dynamic shared memory under the shared rule,
    global scratch under the global), blocks an SM, the grid, and the
    registers and local bytes a thread (runtime) beside ptxas's."""
    plan = dict(k.solve_preempt.last_plan)
    plan["smem_bytes_per_block"] = plan["arena_bytes"] \
        if plan["rule"] == "shared" else 0
    return {**plan, **ptxas_report("solve_preempt")}


def preempt_kernel_check(label: str, k, args: tuple, got, n_real: int,
                         timed: bool, kwargs: dict = None) -> dict:
    """solve_preempt's outputs `got` against the plain version on the
    same card tensors (all three equal); the launch plan (active slots,
    arena rule, blocks an SM, registers); with `timed`, the kernel's
    device time (profiler), its time per call and the plain version's
    (CUDA events), and its byte bound. kwargs: solve_preempt's
    (active_slots, slots)."""
    import torch
    kwargs = dict(kwargs or {})
    plain_kw = {"slots": kwargs.get("slots")}  # it computes every slot
    want = k.solve_preempt_plain(*args, **plain_kw)
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
    compare(("targets", "feasible", "stats"), k.solve_preempt(*args, **kwargs),
            want)
    row.update(preempt_plan_row(k))
    if timed:
        def run_kernel():
            return k.solve_preempt(*args, **kwargs)

        def run_plain():
            return k.solve_preempt_plain(*args, **plain_kw)
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
    build (the build, outside the timed window), PREEMPT_TIMED of
    them; every one must take the device route, the work
    gate must choose the device and every preempt-mode head must be
    solved there. solve_preempt's inputs in the first timed cycle are
    kept and held against the plain version; then the same scenario with
    device="cpu" and on the cpu-forced route must evict the same
    workloads with the same reasons and admit the same workloads."""
    import torch
    from kueue_tpu_torch.solver import kernel, synth
    from kueue_tpu_torch.solver.preempt import active_slot_count
    phase = "scheduler_preempt"
    heads_n, problems_n = preempt_expected()
    keys = PREEMPT_PHASES + ("gc", "other", "cycle")
    phases = {p: [] for p in keys}
    outcomes, plans = [], []
    evicted_timed = 0
    samples: list = []
    snap_stats: list = []  # each build's Cache's snapshot_stats
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    t_phase = time.perf_counter()

    def run_cycle(cycle: int, check_first: bool = True) -> dict:
        t0 = time.perf_counter()
        sched, cache, queues, client = preempt_env(device, samples)
        snap_stats.append(cache.snapshot_stats)
        pending = []
        stage = sched._stage_preempt

        def counted(entries, *a, **kw):
            pending.append(len(entries))
            return stage(entries, *a, **kw)
        sched._stage_preempt = counted
        t_build = time.perf_counter() - t0
        g0, t0 = gc_clock.total, time.perf_counter()
        sched.schedule(timeout=0)
        g1, t1 = gc_clock.total, time.perf_counter()
        samples[:] = sched.solver._sync_samples
        plan = sched.last_preempt_plan.get("minimal", {})
        check_healthy(phase, sched, cycle)
        if sched.last_preempt_gate != "device":
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
        log(f"[{phase}] cycle {cycle}: build_s={t_build:.1f} evicted="
            f"{client.evicted} admitted={client.admitted} plan="
            f"{json.dumps(plan)} cycle_ms={row['cycle'] * 1e3:.1f} "
            f"upload_bytes={sched.solver.last_upload_bytes} ms="
            + json.dumps({p: round(row[p] * 1e3, 3) for p in keys
                          if p != "cycle"}))
        return row

    captured = Captured(kernel, "solve_preempt")
    kernel.reset_launch_counts()
    for cycle in range(PREEMPT_TIMED):
        with captured if cycle == 0 else contextlib.nullcontext():
            row = run_cycle(cycle)
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
    summary["snapshot_stats"] = dict(snap_stats[-1])
    if captured.args is None:
        raise AssertionError("solve_preempt was not called in the captured "
                             "cycle")
    summary["kernel_rows"] = {"captured": preempt_kernel_check(
        "captured", kernel, captured.args, captured.out, problems_n, True,
        captured.kwargs)}
    if summary["kernel_rows"]["captured"]["rule"] != "shared":
        raise AssertionError(f"{phase}: K9 took the global-scratch rule on "
                             "the captured batch")
    for label, spec, every_slot in (("nested", PREEMPT_NESTED, False),
                                    ("global", PREEMPT_GLOBAL, True)):
        topo, usage, cu, args = synth.synth_preempt_inputs(**spec)
        if every_slot:
            args = synth.fill_inactive_slots(
                args, spec["num_flavors"], spec["num_resources"],
                seed=spec["seed"], every_slot=True)
        kw = {"active_slots": active_slot_count(args[5], args[6])}
        dev_args = (kernel.topo_to_device(topo, device),
                    *kernel.state_to_device(usage, cu, device),
                    *(torch.from_numpy(a).to(device) for a in args))
        summary["kernel_rows"][label] = preempt_kernel_check(
            label, kernel, dev_args, kernel.solve_preempt(*dev_args, **kw),
            spec["num_problems"], True, kw)
    if summary["kernel_rows"]["global"]["rule"] != "global":
        raise AssertionError(f"{phase}: K9's every-slot K = 2048 batch did "
                             "not take the global-scratch rule")
    summary["traced_cycle"] = traced_cycle(
        phase, run_cycle, PREEMPT_TIMED, kernel="solve_preempt")
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
    # the single-device record the sharded phase's preempt cell must equal
    summary["records"] = [(outcomes[0], plans[0])]
    return summary


@collector_paused()
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


FAIR_PLAN_KEYS = ("form", "arena_bytes", "smem_bytes_per_block",
                  "blocks_per_sm", "grid", "threads", "registers",
                  "local_bytes", "lane_per_cq")


_FAIR_COSTS = {}


def fair_step_costs(k, device) -> dict:
    """ptxas's registers and spills of solve_fair, and the cycles of a
    global round trip and of a pop's least step (the keyed pick and a
    share's 64-bit max, kernel.fair_tick) on this card, measured once a
    process."""
    if not _FAIR_COSTS:
        b_tick = k.phase_b_tick(device, 1)
        _FAIR_COSTS.update(ptxas_report("solve_fair"),
                           step_cycles=k.fair_tick(device),
                           load_cycles=b_tick["load_cycles"],
                           sm_clock_khz=b_tick["clock_khz"])
    return _FAIR_COSTS


def fair_kernel_check(label: str, k, args: tuple, kwargs: dict, got,
                      n_real: int, timed: bool, plain_ms=None) -> dict:
    """solve_fair's outputs `got` against the plain version on the same
    card tensors (all four equal); the launch plan (the arena's form and
    bytes, blocks an SM, registers at run time and ptxas's, spills) and
    the latency bound: one global round trip and the chain's dependent
    steps, each the least step (fair_step_costs) at the SM clock; with
    `timed`, the kernel's device time (profiler), its time per call and
    the plain version's (CUDA events; `plain_ms` where a row on the same
    inputs timed it) and its byte bound."""
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
    plan = k.fair_plan(*row["shape_B_K_QL_RF_CL_DC"], args[1].device)
    row.update({key: plan[key] for key in FAIR_PLAN_KEYS})
    row.update(fair_step_costs(k, args[1].device))
    row["latency_bound_ms"] = (row["load_cycles"]
                               + steps * row["step_cycles"]) \
        / row["sm_clock_khz"]
    if timed:
        def run_kernel():
            return k.solve_fair(*args, **kwargs)

        def run_plain():
            return k.solve_fair_plain(*args, **kwargs)
        torch.cuda.synchronize()
        row["call_ms"] = time_cuda(run_kernel, iters=10)
        row["plain_ms"] = time_cuda(run_plain, iters=2, warmup=1) \
            if plain_ms is None else plain_ms
        kernel_ms = profiled_device_ms(run_kernel, 10, "solve_fair")
        row["ms"], row["ms_source"] = (kernel_ms, "profiler") \
            if kernel_ms is not None else (row["call_ms"], "events")
        row["bytes"] = fair_bytes(args[3:], want, args[1])
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        row["library_ms"] = None
    log(f"[kernels:solve_fair:{label}] equal to plain: " + json.dumps(row)
        + (f"; before the redesign, K11 read {K11_EARLIER_MS} ms a launch "
           f"here on the captured cycle, and {K11_PARENT_MS} beside the new "
           "kernel in one call (PERF.md)" if label == "captured" else ""))
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
    schedule() of a fresh build (the build, outside the timed window),
    FAIR_PREEMPT_TIMED of them; every one must take the device
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
    snap_stats: list = []  # each build's Cache's snapshot_stats
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)
    t_phase = time.perf_counter()

    def run_cycle(cycle: int, check_first: bool = True) -> dict:
        t0 = time.perf_counter()
        sched, cache, queues, client = fair_preempt_env(device, samples)
        snap_stats.append(cache.snapshot_stats)
        pending, calls = [], []
        stage = sched._stage_preempt

        def counted(entries, *a, **kw):
            pending.append(len(entries))
            return stage(entries, *a, **kw)
        sched._stage_preempt = counted
        count_preemption_syncs(sched.solver, calls)
        t_build = time.perf_counter() - t0
        g0, t0 = gc_clock.total, time.perf_counter()
        sched.schedule(timeout=0)
        g1, t1 = gc_clock.total, time.perf_counter()
        samples[:] = sched.solver._sync_samples
        plan = sched.last_preempt_plan
        check_healthy(phase, sched, cycle)
        if sched.last_preempt_gate != "device":
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
        log(f"[{phase}] cycle {cycle}: build_s={t_build:.1f} evicted="
            f"{client.evicted} admitted={client.admitted} plan="
            f"{json.dumps(plan)} cycle_ms={row['cycle'] * 1e3:.1f} "
            f"upload_bytes={sched.solver.last_upload_bytes} ms="
            + json.dumps({p: round(row[p] * 1e3, 3) for p in keys
                          if p != "cycle"}))
        return row

    captured = Captured(kernel, "solve_fair")
    kernel.reset_launch_counts()
    for cycle in range(FAIR_PREEMPT_TIMED):
        with captured if cycle == 0 else contextlib.nullcontext():
            row = run_cycle(cycle)
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
    if launches["solve_fair"] != FAIR_PREEMPT_TIMED:
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
    summary["snapshot_stats"] = dict(snap_stats[-1])
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
    # the captured cycle and the nested batch with the arena in global
    # scratch (the form past shared memory), and a batch past 32 local CQs
    kw = {"strat": FAIR_STRATS[0]}
    smem = kernel.FAIR_SMEM
    kernel.FAIR_SMEM = 0
    try:
        for label, a, kwargs, n_real in (
                ("captured", captured.args, captured.kwargs, heads_n),
                ("nested", dev_args, kw, FAIR_NESTED["num_problems"])):
            row = fair_kernel_check(
                f"{label} global", kernel, a, kwargs,
                kernel.solve_fair(*a, **kwargs), n_real, True,
                plain_ms=summary["kernel_rows"][label]["plain_ms"])
            if row["form"] != "global":
                raise AssertionError("solve_fair: the global form took "
                                     f"{row['form']}")
            summary["kernel_rows"][f"{label} global"] = row
    finally:
        kernel.FAIR_SMEM = smem
    topo, usage, cu, args = synth.synth_fair_inputs(**FAIR_QL64)
    q_args = (kernel.topo_to_device(topo, device),
              *kernel.state_to_device(usage, cu, device),
              *(torch.from_numpy(a).to(device) for a in args))
    row = fair_kernel_check("ql64", kernel, q_args, kw,
                            kernel.solve_fair(*q_args, **kw),
                            FAIR_QL64["num_problems"], True)
    if row["lane_per_cq"] or row["shape_B_K_QL_RF_CL_DC"][2] <= 32:
        raise AssertionError("solve_fair: the QL > 32 batch took the "
                             "narrow instance")
    summary["kernel_rows"]["ql64"] = row
    summary["traced_cycle"] = traced_cycle(
        phase, run_cycle, FAIR_PREEMPT_TIMED, kernel="solve_fair")
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


@collector_paused()
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
    `cols`); with `timed`, the kernel's device time (CUDA events over
    back-to-back launches, time_cuda_queued), its time per call and the
    plain version's (CUDA events), its byte bound, and its pipeline's
    numbers and latency bounds (cluster_pipeline_row)."""
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
           "oracle_equal": True}
    if timed:
        def run_kernel():
            return k.score_cluster_columns(*args)

        def run_plain():
            return k.score_cluster_columns_plain(*args)
        torch.cuda.synchronize()
        row["call_ms"] = time_cuda(run_kernel, iters=20)
        row["plain_ms"] = time_cuda(run_plain, iters=2, warmup=1)
        # device time by CUDA events, the launches back to back
        row["ms"] = time_cuda_queued(run_kernel, iters=50)
        row["ms_source"] = "events"
        row["bytes"] = cluster_bytes(args, got)
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        # no one PyTorch call runs the sequential scan
        row["library_ms"] = None
        row.update(cluster_pipeline_row(k, args, device=got.device))
    log(f"[kernels:cluster_cols:{label}] equal to plain and to the host "
        "oracle: " + json.dumps(row)
        + (f"; before the redesign, the one-warp kernel took "
           f"{K12_EARLIER_MS} ms a launch on the captured cycle (PERF.md)"
           if timed else ""))
    return row


def cluster_pipeline_row(k, args: tuple, device) -> dict:
    """cluster_cols' pipeline on `args` (one more launch): the rows in the
    pipeline N, the live columns S (its stages), the warps of stages G and
    the stages a warp, its chunk steps (N/32 chunks + G - 1), the launch
    plan, ptxas's report, and two latency bounds in units of the least
    tick (one shared load, R compares, one shuffle; measured here in
    clock cycles) at the SM clock the runtime reports: the chunked
    pipeline's chain, S + N/32 - 1 ticks (chunk 0 through every stage,
    the last stage through every chunk; the takes, which run one at a
    time a stage, are left out), and a row-a-tick pipeline's, N + S
    ticks."""
    import torch
    k.score_cluster_columns(*args)
    torch.cuda.synchronize()
    n, s, g, per_warp = k.score_cluster_columns.last_stats.tolist()
    plan = k.score_cluster_columns.last_plan
    R = args[4].shape[2]
    tick = cluster_least_tick(device, R)
    chunks = -(-n // 32)
    return {"pipeline_rows": n, "live_stages": s, "stage_warps": g,
            "stages_per_warp": per_warp, "chunk_steps": chunks + g - 1,
            "least_tick_cycles": tick, "sm_clock_khz": plan["clock_khz"],
            "latency_bound_ms": (s + chunks - 1) * tick / plan["clock_khz"],
            "dependent_steps": s + chunks - 1,
            "row_pipeline_bound_ms": (n + s) * tick / plan["clock_khz"],
            **{f"plan_{key}": plan[key] for key in
               ("threads", "rule", "arena_bytes", "register_r",
                "registers", "local_bytes")},
            **ptxas_report("cluster_cols")}


def order_captured_row(captured: Captured, k) -> dict:
    """order_csr with the global order on the MultiKueue cycle's own
    inputs: the captured call's outputs against the plain version, then
    both timed."""
    if captured.args is None or not captured.kwargs.get("with_order"):
        raise AssertionError("order_csr was not called with the global "
                             "order in the captured cycle")
    args, kwargs = captured.args, captured.kwargs
    want = k.order_csr_plain(*args, **kwargs)
    row = {"max_abs_err": compare(("offsets (captured)", "members (captured)",
                                   "order (captured)"), captured.out, want),
           "W": int(args[1].shape[0])}
    k.order_csr(*args, **kwargs)
    row["form"] = k.order_csr.last_plan["form"]
    row["ms"] = profiled_device_ms(lambda: k.order_csr(*args, **kwargs), 50,
                                   "order")
    row["ms_source"] = "profiler"
    row["call_ms"] = time_cuda(lambda: k.order_csr(*args, **kwargs), 50)
    row["plain_ms"] = time_cuda(lambda: k.order_csr_plain(*args, **kwargs),
                                20)
    row["library_ms"] = row["plain_ms"]
    row["bytes"] = order_bytes(*args[:6], want) + nbytes(*args[6:7])
    row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
    log("[scheduler_multikueue] order_csr with the global order equal to "
        "plain on the captured cycle's inputs: " + json.dumps(row))
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
        check_healthy(phase, sched, cycle)
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
    captured_order = Captured(kernel, "order_csr")
    fetch = {}
    kernel.reset_launch_counts()
    for cycle in range(E2E_WARMUP + MK_TIMED):
        if cycle == E2E_WARMUP:
            with captured, captured_order, fetch_timing(solver, fetch):
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
    summary["snapshot_stats"] = dict(cache.snapshot_stats)
    summary["fetch_timing"] = fetch
    if captured.args is None:
        raise AssertionError("cluster_cols was not called in the captured "
                             "cycle")
    cut = synth.known_columns(cols_by_cycle[E2E_WARMUP], topo.flavor_index,
                              topo.resource_index)
    summary["kernel_rows"] = {"captured": cluster_kernel_check(
        "captured", kernel, captured.args, captured.out, cut, topo.resources,
        True)}
    summary["kernel_rows"]["order_with_order"] = order_captured_row(
        captured_order, kernel)
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
    # the single-device records the sharded phase's multikueue cell must
    # equal (the same build and cycles, before a cluster is lost)
    summary["records"] = records[:MK_LOST[1]]
    return summary


@collector_paused()
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
    check_healthy(f"sharded {kind}", sched, cycle)
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
                    "upload_bytes": solver.last_upload_bytes,
                    "snapshot_stats": dict(cache.snapshot_stats)})
        row["other"] = row["cycle"] - sum(row[p] for p in keys)
        dplan = solver.last_domain_plan
        row["mesh"] = {"collectives": mesh.collectives - before,
                       "occupied": dplan.occupied, "d_cols": dplan.d_cols,
                       "imbalance": dplan.imbalance,
                       "fingerprint": dplan.fingerprint}
        log(f"[scheduler_sharded:{kind}] cycle {cycle}"
            f"{' (warm-up)' if cycle < SHARDED_WARMUP[kind] else ''}: admitted="
            f"{client.admitted} evicted={client.evicted} cycle_ms="
            f"{row['cycle'] * 1e3:.1f} upload_bytes="
            f"{solver.last_upload_bytes} mesh={json.dumps(row['mesh'])} ms="
            + json.dumps({p: round(row[p] * 1e3, 3)
                          for p in keys + ("other",)}))
    return row


def sharded_cycles(kind: str, make_solver, cycles: int, mesh=None,
                   log_rows: bool = False, capture=None,
                   warmup: int = E2E_WARMUP) -> tuple:
    """`cycles` sharded_step cycles of the cell `kind` on the solvers
    `make_solver()` gives: one environment stepped cycle after cycle, or
    (preempt) a fresh build's first cycle each; `capture` is entered for
    the first cycle after `warmup`. Returns (rows, the last
    environment)."""
    env, rows = None, []
    for cycle in range(cycles):
        if env is None or kind == "preempt":
            env = None
            gc.collect()
            env = sharded_env(kind, make_solver())
        rows.append(sharded_step(kind, env, cycle, mesh, log_rows,
                                 capture if cycle == warmup else None))
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
    act = {"active_slots": getattr(pargs, "active_slots", None)}
    whole = k.solve_preempt(topo, usage, cu, *pargs, **act)
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
        got = k.solve_preempt(topo, usage, cu, *pargs, slots=slots, **act)
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
            k.solve_preempt(topo, usage, cu, *pargs, slots=slots1,
                            **act), whole)
    torch.cuda.synchronize()
    out = {"ranks": n, "B": B, "b_local": b_local, "per_rank": per_rank,
           "max_abs_err": 0.0,
           "slots_ws1": {
               "ms": profiled_device_ms(lambda: k.solve_preempt(
                   topo, usage, cu, *pargs, slots=slots1, **act), 5,
                   "solve_preempt"),
               "call_ms": time_cuda(lambda: k.solve_preempt(
                   topo, usage, cu, *pargs, slots=slots1, **act), 5)},
           "slots_rank0": {
               "ms": profiled_device_ms(lambda: k.solve_preempt(
                   topo, usage, cu, *pargs, slots=slots0, **act), 5,
                   "solve_preempt"),
               "call_ms": time_cuda(lambda: k.solve_preempt(
                   topo, usage, cu, *pargs, slots=slots0, **act), 5),
               "plain_ms": time_cuda(lambda: k.solve_preempt_plain(
                   topo, usage, cu, *pargs, slots=slots0), 1, warmup=1)}}
    log("[scheduler_sharded] 4-way rank check of K9: equal to the "
        "single-device K9: " + json.dumps(out))
    return out


def scheduler_sharded_phase(device, refs: dict) -> dict:
    """The sharded cycle under the port's Scheduler at world size 1 over
    NCCL: the fill, preempt and multikueue cells (SHARDED_WARMUP, then
    SHARDED_TIMED cycles), each launching SHARDED_KERNELS and equal to
    the same cells on the single-device route: run here for the fill;
    for the preempt and multikueue cells, the records `refs` gives (the
    scheduler preempt and multikueue phases' own cycles on the same
    builds; a preempt cycle is a fresh build's first, so every one is
    held to the one record). The 4-way rank checks on the fill's and the
    preempt cell's first timed cycle. The mesh's process group is
    destroyed at the end."""
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
            warmup = SHARDED_WARMUP[kind]
            cycles = warmup + SHARDED_TIMED[kind]
            kernel.reset_launch_counts()
            rows, env = sharded_cycles(kind, lambda: BatchSolver(mesh=mesh),
                                       cycles, mesh, log_rows=True,
                                       capture=captures.get(kind),
                                       warmup=warmup)
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
            # the same cells on the single-device route
            t_ref = time.perf_counter()
            if kind == "fill":
                ref = [r["record"] for r in sharded_cycles(
                    kind, lambda: BatchSolver(device=device), len(rows))[0]]
            else:
                ref = refs[kind]
            for cycle, row in enumerate(rows):
                if row["record"] != ref[0 if kind == "preempt" else cycle]:
                    raise AssertionError(
                        f"sharded {kind} cycle {cycle}: the mesh route "
                        "admitted, evicted or placed other workloads than "
                        "the single-device route")
            timed = rows[warmup:cycles]
            keys = (PREEMPT_PHASES if kind == "preempt" else SCHED_PHASES) \
                + ("plan", "other", "cycle")
            sub = {p: {"p50_ms": percentile([r[p] for r in timed], 50) * 1e3,
                       "max_ms": max(r[p] for r in timed) * 1e3}
                   for p in keys}
            sub["mesh"] = timed[-1]["mesh"]
            sub["launches"] = launches
            sub["upload_bytes"] = timed[-1]["upload_bytes"]
            sub["snapshot_stats"] = timed[-1]["snapshot_stats"]
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


def order_wide_inputs(device, num_cqs: int, num_cohorts: int,
                      num_workloads: int, seed: int, one_domain: bool = False,
                      edge: bool = False, solo_every: int = 0) -> tuple:
    """order_csr's arguments on the card (a topology of cq_cohort,
    cohort_root and C, and the heads' keys), from a seed: priorities and
    timestamps from a few values (ties), shares with negatives and
    NO_LIMIT; `edge` draws them from the edge values instead; with
    `one_domain` every cohort's root is cohort 0; a CQ every `solo_every`
    has no cohort (its own domain). Returns (topo, positional args,
    share)."""
    import numpy as np
    import torch
    from kueue_tpu_torch.solver import kernel as k
    rng = np.random.default_rng(seed)
    Q, C, W = num_cqs, num_cohorts, num_workloads
    cq_cohort = rng.integers(0, C, size=Q).astype(np.int32)
    if solo_every:
        cq_cohort[::solo_every] = -1
    cohort_root = np.zeros(C, np.int32) if one_domain else \
        np.arange(C, dtype=np.int32)
    i64 = np.iinfo(np.int64)
    if edge:
        prio = rng.choice(np.array([i64.min, i64.max, 0, 1, -1, i64.min + 1],
                                   np.int64), size=W)
        ts = rng.choice(np.concatenate([
            [0.0, -0.0, np.inf, -np.inf, 1.5, -1.5, 5e-324, -5e-324],
            np.array(ORDER_NAN_BITS, np.uint64).view(np.float64)]), size=W)
        share = rng.choice(np.array([k.NO_LIMIT, -1, -2, 0, i64.max, i64.min,
                                     7], np.int64), size=W)
    else:
        prio = rng.integers(0, 5, size=W).astype(np.int64)
        ts = rng.integers(0, 6, size=W).astype(np.float64)
        share = rng.choice(np.array(MIXED_SHARES, np.int64), size=W)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    topo = {"cq_cohort": dev(cq_cohort), "cohort_root": dev(cohort_root),
            "cohort_subtree": torch.zeros((C, 1, 1), dtype=torch.int64,
                                          device=device)}
    args = (dev(rng.random(W) < 0.7), dev(rng.random(W) < 0.3), dev(prio),
            dev(ts), dev(rng.integers(0, Q, size=W).astype(np.int32)))
    return topo, args, dev(share)


def gather_wide_inputs(device, slots: int, num_workloads: int,
                       num_podsets: int, num_flavors: int,
                       num_resources: int, offset: int, seed: int) -> tuple:
    """A twin of `slots` rows of every arena field from a seed, each field
    sliced `offset` elements into a larger buffer (8, 4 or 1 bytes off a
    16-byte boundary for offset 1), and a batch of slots with -1, -7,
    `slots` and `slots - 1` among them. Returns (twin, slots)."""
    import numpy as np
    import torch
    from kueue_tpu_torch.solver import kernel as k
    from kueue_tpu_torch.solver.arena import ARENA_FIELDS
    rng = np.random.default_rng(seed)
    P, F, R = num_podsets, num_flavors, num_resources
    shapes = {"requests": (P, R), "podset_active": (P,), "wl_cq": (),
              "priority": (), "timestamp": (), "eligible": (P, F),
              "solvable": ()}
    twin = {}
    for name in ARENA_FIELDS:
        shape = (slots,) + shapes[name]
        size = math.prod(shape)
        dtype = k.ARENA_DTYPES[name]
        if dtype == torch.bool:
            buf = torch.from_numpy(rng.random(size + 1) < 0.5)
        elif dtype == torch.float64:
            buf = torch.from_numpy(rng.random(size + 1))
        else:
            buf = torch.from_numpy(rng.integers(-1000, 1000, size=size + 1)
                                   ).to(dtype)
        twin[name] = buf.to(device)[offset:offset + size].view(shape)
    batch = rng.integers(-3, slots + 2, size=num_workloads).astype(np.int32)
    batch[:4] = (-1, -7, slots, slots - 1)
    return twin, torch.from_numpy(batch).to(device)


def scatter_wide_inputs(device, num_podsets: int, num_flavors: int,
                        num_resources: int, offset: int, out_of_range: bool,
                        seed: int) -> tuple:
    """A twin of ARENA_SLOTS rows and 512 update rows, each field sliced
    `offset` elements into a larger buffer, and the 512-row bucket of
    slots: SCATTER_ROWS distinct targets, then padding (WIDE_K7A).
    Returns (twin, upd_slots, upd_rows, targets)."""
    import numpy as np
    import torch
    twin, _ = gather_wide_inputs(device, ARENA_SLOTS, 4, num_podsets,
                                 num_flavors, num_resources, offset, seed)
    rows, _ = gather_wide_inputs(device, 512, 4, num_podsets, num_flavors,
                                 num_resources, offset, seed + 1)
    rng = np.random.default_rng(seed)
    S = ARENA_SLOTS
    # distinct targets, 0 and S - 1 kept for the first two
    targets = rng.choice(np.arange(1, S - 1), SCATTER_ROWS, replace=False)
    slots = np.full(512, S, np.int64)
    slots[:SCATTER_ROWS] = targets
    if out_of_range:
        targets[:2] = (S - 1, 0)
        slots[:SCATTER_ROWS] = np.where(rng.uniform(size=SCATTER_ROWS) < 0.5,
                                        targets, targets - S)
        slots[:2] = (-1, -S)
        slots[SCATTER_ROWS:] = rng.choice(
            np.array([S, S + 5, -S - 1, -2 * S, 2**31 - 1, -2**31]),
            512 - SCATTER_ROWS)
    return (twin, torch.from_numpy(slots.astype(np.int32)).to(device), rows,
            torch.from_numpy(targets).to(device))


def wide_scatter_rows(device) -> dict:
    """scatter_arena_rows on WIDE_K7A's twins against its plain version,
    each on its own copy, and timed."""
    import torch
    from kueue_tpu_torch.solver import kernel as k
    from kueue_tpu_torch.solver.arena import ARENA_FIELDS
    rows = {}
    for label, spec in WIDE_K7A.items():
        twin, slots, upd, targets = scatter_wide_inputs(device, **spec)
        got = {n: t.clone() for n, t in twin.items()}
        want = {n: t.clone() for n, t in twin.items()}
        lib = {n: t.clone() for n, t in twin.items()}
        k.scatter_arena_rows(got, slots, upd)
        k.scatter_arena_rows_plain(want, slots, upd)
        row = {"max_abs_err": compare(
            tuple(f"{n} ({label})" for n in ARENA_FIELDS),
            [got[n] for n in ARENA_FIELDS], [want[n] for n in ARENA_FIELDS]),
            "plan": dict(k.scatter_arena_rows.last_plan)}
        row["form"] = row["plan"]["vec_bytes"]
        torch.cuda.synchronize()
        row["ms"] = profiled_device_ms(
            lambda: k.scatter_arena_rows(got, slots, upd), 100,
            "arena_scatter")
        row["ms_source"] = "profiler"
        row["call_ms"] = time_cuda(
            lambda: k.scatter_arena_rows(got, slots, upd), 100)
        row["plain_ms"] = time_cuda(
            lambda: k.scatter_arena_rows_plain(want, slots, upd), 50)
        real = targets.long()

        def library():
            for n in ARENA_FIELDS:
                lib[n].index_copy_(0, real, upd[n][:SCATTER_ROWS])
        row["library_ms"] = time_cuda(library, 50)
        row["bytes"] = nbytes(slots) + 2 * SCATTER_ROWS * row_bytes(twin)
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"[kernels:arena_scatter:{label}] equal to plain: "
            + json.dumps(row))
        rows[f"arena_scatter_{label}"] = row
    return rows


def wide_order_rows(device) -> dict:
    """order_csr on WIDE_K4's shapes against its plain version run on the
    CPU (the order the JAX lexsort gives: torch.sort on the card puts NaNs
    with the sign bit set first; `card_plain_differs` says whether the
    plain version on the card gave another CSR or order), the global order
    off and on, and timed (its device time by the profiler, calls by CUDA
    events)."""
    import torch
    from kueue_tpu_torch.solver import kernel as k
    rows = {}
    for label, spec in WIDE_K4.items():
        topo, args, share = order_wide_inputs(device, **spec)
        host_topo = {n: v.cpu() for n, v in topo.items()}
        host = [a.cpu() for a in (*args, share)]
        row = {"W": spec["num_workloads"],
               "D": spec["num_cohorts"] + spec["num_cqs"],
               "card_plain_differs": False}
        for with_order in (False, True):
            got = [t for t in k.order_csr(topo, *args, share,
                                          with_order=with_order)
                   if t is not None]
            want = [t.to(device) for t in k.order_csr_plain(
                host_topo, *host, with_order=with_order) if t is not None]
            row["max_abs_err"] = compare(
                (f"offsets ({label})", f"members ({label})",
                 f"order ({label})"), got, want)
            card = [t for t in k.order_csr_plain(topo, *args, share,
                                                 with_order=with_order)
                    if t is not None]
            row["card_plain_differs"] |= not all(
                torch.equal(a, b) for a, b in zip(card, want))
        row["plan"] = dict(k.order_csr.last_plan)
        row["form"] = row["plan"]["form"]
        big = row["W"] > 10000
        torch.cuda.synchronize()
        for with_order, key in ((False, ""), (True, "with_order_")):
            def run(with_order=with_order):
                return k.order_csr(topo, *args, share, with_order=with_order)
            row[f"{key}ms"] = profiled_device_ms(run, 3 if big else 50,
                                                 "order")
            row[f"{key}call_ms"] = time_cuda(run, iters=3 if big else 50)
        row["ms_source"] = "profiler"
        row["plain_ms"] = time_cuda(
            lambda: k.order_csr_plain(topo, *args, share), iters=3 if big
            else 20, warmup=1)
        row["bytes"] = order_bytes(topo, *args, k.order_csr_plain(
            topo, *args, share)[:2]) + nbytes(share)
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        row["library_ms"] = row["plain_ms"]
        log(f"[kernels:order:{label}] equal to plain: " + json.dumps(row))
        rows[f"order_{label}"] = row
    return rows


def wide_gather_rows(device) -> dict:
    """gather_arena on WIDE_K7B's twins against its plain version, and
    timed."""
    import torch
    from kueue_tpu_torch.solver import kernel as k
    from kueue_tpu_torch.solver.arena import ARENA_FIELDS
    rows = {}
    for label, spec in WIDE_K7B.items():
        twin, slots = gather_wide_inputs(device, **spec)
        row = {"max_abs_err": compare(
            tuple(f"{n} ({label})" for n in ARENA_FIELDS),
            k.gather_arena(twin, slots), k.gather_arena_plain(twin, slots)),
            "plan": dict(k.gather_arena.last_plan)}
        row["form"] = row["plan"]["vec_bytes"]
        torch.cuda.synchronize()
        row["ms"] = profiled_device_ms(lambda: k.gather_arena(twin, slots),
                                       100, "arena_gather")
        row["ms_source"] = "profiler"
        row["call_ms"] = time_cuda(lambda: k.gather_arena(twin, slots), 100)
        row["plain_ms"] = time_cuda(
            lambda: k.gather_arena_plain(twin, slots), 50)
        clamped = slots.long().clamp(0, spec["slots"] - 1)
        row["library_ms"] = time_cuda(
            lambda: [twin[n].index_select(0, clamped) for n in ARENA_FIELDS],
            50)
        W = spec["num_workloads"]
        n_real = int((slots >= 0).sum())  # a slot past cap reads row cap - 1
        row["bytes"] = nbytes(slots) + (n_real + W) * row_bytes(twin)
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        log(f"[kernels:arena_gather:{label}] equal to plain: "
            + json.dumps(row))
        rows[f"arena_gather_{label}"] = row
    return rows


def wide_pack_rows(device) -> dict:
    """K8 on WIDE_K8's shapes: equal to pack_plain, timed."""
    import numpy as np
    import torch
    from kueue_tpu_torch.solver import kernel as k
    rows = {}
    for label, (W, P, R, off) in WIDE_K8.items():
        rng = np.random.default_rng(W + off)
        n = W * P * R
        c_all = torch.from_numpy(rng.integers(-1, 40, size=n + 8)
                                 .astype(np.int32)).to(device)
        b_all = torch.from_numpy(rng.random(n + 8) < 0.3).to(device)
        args = (c_all[off:off + n].view(W, P, R),
                b_all[off:off + n].view(W, P, R),
                *(torch.from_numpy(rng.random(W) < p).to(device)
                  for p in (0.7, 0.5, 0.3)))
        want = k.pack_plain(*args)
        row = {"max_abs_err": compare(("dec_pr", "dec_bits"), k.pack(*args),
                                      want), "W": W, "PR": P * R,
               "offset_elements": off}
        torch.cuda.synchronize()
        row["call_ms"] = time_cuda(lambda: k.pack(*args), iters=50)
        row["plain_ms"] = time_cuda(lambda: k.pack_plain(*args), iters=50)
        kernel_ms = profiled_device_ms(lambda: k.pack(*args), 50, "pack")
        row["ms"], row["ms_source"] = (kernel_ms, "profiler") \
            if kernel_ms is not None else (row["call_ms"], "events")
        row["bytes"] = nbytes(*args, *want)
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        row["library_ms"] = None
        log(f"[kernels:pack:{label}] equal to plain: " + json.dumps(row))
        rows[f"pack_{label}"] = row
    return rows


def wide_phase(device) -> dict:
    """The shapes on which the first card kernels raised, each kernel
    against its plain version on the same card tensors and timed, outside
    every main path's launch count: K9 with a problem of exactly 131,072
    candidates (32-bit candidate indices, the global rule); phase_a at
    the north star's widths with 32 resources and with 17 (the chosen
    flavors in shared memory); cluster_cols at 64 clusters x 32 flavors x
    16 resources (the arena in global scratch, several warps of stages)
    and at 8 x 32 with 8, 16 (the register form) and 32 resources (the
    requests read from the arena), equal to the host oracle too."""
    import numpy as np
    import torch
    from kueue_tpu_torch.solver import kernel as k, synth
    from kueue_tpu_torch.solver.preempt import active_slot_count
    t_phase = time.perf_counter()

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    rows = {}
    # K9
    topo, usage, cu, args = synth.synth_full_k_inputs(**WIDE_K9)
    p_args = (k.topo_to_device(topo, device),
              *k.state_to_device(usage, cu, device), *(dev(a) for a in args))
    kw = {"active_slots": active_slot_count(args[5], args[6])}
    row = preempt_kernel_check("k131072", k, p_args,
                               k.solve_preempt(*p_args, **kw),
                               WIDE_K9["num_problems"], True, kw)
    if row["index_bits"] != 32 or row["rule"] != "global":
        raise AssertionError(f"solve_preempt at K = {WIDE_K9['K']}: "
                             f"{row['index_bits']}-bit indices, "
                             f"{row['rule']} rule")
    rows["solve_preempt"] = row
    # phase_a
    for R in (32, 17):
        topo, usage, cu, wl = synth.synth_solver_inputs(
            num_resources=R, seed=42, **WIDE_PHASE_A)
        t_topo = k.topo_to_device(topo, device)
        usage_d, cu_d = k.state_to_device(usage, cu, device)
        wl = {key: dev(v) for key, v in wl.items()}
        P = WIDE_PHASE_A["num_podsets"]
        a_args = (t_topo, k.avail_plain(t_topo, usage_d, cu_d), usage_d,
                  wl["requests"], wl["podset_active"], wl["wl_cq"],
                  wl["eligible"], wl["solvable"], P, None)
        want = k.phase_a_plain(*a_args)
        row = {"max_abs_err": compare(
            ("fit", "borrows", "chosen", "chosen_borrow", "asg_usage"),
            k.phase_a(*a_args), want), "R": R, "fit": int(want[0].sum())}
        if not row["fit"]:
            raise AssertionError(f"phase_a at R = {R}: no head fits")
        torch.cuda.synchronize()
        row["call_ms"] = time_cuda(lambda: k.phase_a(*a_args), iters=20)
        row["ms"] = time_cuda_queued(lambda: k.phase_a(*a_args), iters=50)
        row["ms_source"] = "events"
        row["plain_ms"] = time_cuda(lambda: k.phase_a_plain(*a_args),
                                    iters=2, warmup=1)
        row["form"] = k.phase_a.last_plan["form"]
        row["bytes"] = phase_a_bytes(t_topo, wl, P, None, want)
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        row["library_ms"] = None
        log(f"[kernels:phase_a:r{R}] equal to plain: " + json.dumps(row))
        rows[f"phase_a_r{R}"] = row
    rows["phase_a"] = rows.pop("phase_a_r32")
    # cluster_cols
    for label, spec in WIDE_K12.items():
        cols, _, resources, args = synth.synth_cluster_inputs(**spec)
        c_args = tuple(dev(a) for a in args)
        rows[f"cluster_cols_{label}"] = cluster_kernel_check(
            label, k, c_args, k.score_cluster_columns(*c_args), cols,
            resources, True)
    rows.update(wide_order_rows(device))
    rows.update(wide_gather_rows(device))
    rows.update(wide_scatter_rows(device))
    rows.update(wide_pack_rows(device))
    rows.update(wide_share_rows(device))
    rows["wall_s"] = time.perf_counter() - t_phase
    log(f"[wide] wall {rows['wall_s']:.1f} s")
    return rows


ORACLE_KEYS = ("admitted", "fit", "borrows", "chosen", "chosen_borrow",
               "usage", "cohort_usage")
# global_scan's dependent global round trips before its first step
# (csrc/global_scan.cu): the prologue's count (order, fit) and its list
# (order, fit, wl_cq, the CQ's chain), the first entry and its constants
GLOBAL_SCAN_ROUND_TRIPS = 8


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
            plan = dict(k.global_scan.last_plan)
            for form in k.GLOBAL_SCAN_FORMS:
                compare([f"{kind}/{variant} global_scan ({form} form) {key}"
                         for key in ("admitted", "usage", "cohort_usage")],
                        k.global_scan(*s_args, form=form), want)
            admitted = int(seq["admitted"].sum())
            fits = int(seq["fit"].sum())
            if not 0 < admitted < fits:
                raise AssertionError(f"{phase} {kind}/{variant}: {admitted} "
                                     f"of {fits} fitting heads admitted; the "
                                     "scan's re-check is not exercised")
            check = {"kind": kind, "variant": variant, "W": W, "fit": fits,
                     "admitted": admitted, "drive_ms": drive_s * 1e3,
                     "plain_once_ms": plain_once_s * 1e3,
                     "max_abs_err": err, "plan": plan}
            checks.append(check)
            log(f"[{phase}] {kind}/{variant}: solve_cycle == "
                "solve_cycle_cohort_parallel == solve_cycle_fused on 7 "
                "outputs; global_scan equal to plain in both forms; "
                + json.dumps(check))
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
            forms = {}
            for form in k.GLOBAL_SCAN_FORMS:
                def run(form=form):
                    return k.global_scan(*s_args, form=form)
                forms[form] = {
                    "ms": profiled_device_ms(run, 10, "global_scan"),
                    "call_ms": time_cuda(run, iters=20)}
                run()
                forms[form]["plan"] = dict(k.global_scan.last_plan)
            # the code's least chain: the prologue's and the first step's
            # GLOBAL_SCAN_ROUND_TRIPS dependent global round trips, then a
            # step a fit workload, each at least phase_b's least step at
            # the chain's depth (the same walk of shared-memory state, a
            # vote and the writes)
            fit_steps = int(k.global_scan_steps(fit, wl["wl_cq"], order,
                                                topo["cq_cohort"])[0].numel())
            DC = topo["cq_chain"].shape[1]
            tick = k.phase_b_tick(device, min(DC, 4))
            rows[kind] = {
                "max_abs_err": err, "ms": ms, "ms_source": source,
                "call_ms": call_ms, "plain_ms": plain_ms,
                "library_ms": None, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                "bytes": moved, "dependent_steps": W, "fit_steps": fits,
                "phase_b_ms": pb_ms, "phase_b_dependent_steps": steps,
                "global_over_phase_b": ms / pb_ms,
                "form": plan["form"], "plan": plan, "forms": forms,
                "global_round_trips": GLOBAL_SCAN_ROUND_TRIPS,
                "step_cycles": tick["step_cycles"],
                "load_cycles": tick["load_cycles"],
                "sm_clock_khz": tick["clock_khz"],
                "latency_bound_ms": (GLOBAL_SCAN_ROUND_TRIPS
                                     * tick["load_cycles"] + fit_steps
                                     * tick["step_cycles"])
                / tick["clock_khz"]}
            log(f"[{phase}] {kind} global_scan: ms={ms:.5f} ({source}) "
                f"call_ms={call_ms:.4f} plain_ms={plain_ms:.2f} bound_ms="
                f"{rows[kind]['bound_ms']:.6f} ({moved} bytes / 3.35 TB/s); "
                f"latency bound {rows[kind]['latency_bound_ms']:.5f} ms "
                f"({W} steps, {fits} fit); forms {json.dumps(forms)}; "
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


@collector_paused()
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
        check_healthy(phase, sched, cycle)
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
    summary["snapshot_stats"] = dict(cache.snapshot_stats)
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


@collector_paused()
def faults_env(device):
    """The north star's fill (2048 CQs in 256 cohorts, 32 flavors of 40
    units, 51,200 pending) under the port's Scheduler, its solver bound
    to the card; the Scheduler's own breaker and watchdog."""
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import BatchSolver
    flavors = [f"f{i}" for i in range(NORTH_STAR["num_flavors"])]
    env = ns.build_scheduler(NORTH_STAR["num_cqs"], NORTH_STAR["num_cohorts"],
                             flavors, NOMINAL_UNITS,
                             solver=BatchSolver(device=device))
    ns.stage_waves(env[2], E2E_WAVES, NORTH_STAR["num_cqs"], NOMINAL_UNITS)
    return env


def wave_key(name: str) -> tuple:
    """The finishing order: the waves' workloads w{wave}-{cq} by wave
    and CQ, then the trickle's t{k}-{cq}."""
    n, cq = name[1:].split("-")
    return name[0] != "w", int(n), int(cq)


class FaultsRun:
    """One run of the faults phase's step schedule on a fresh build:
    E2E_WAVES fill steps, then FAULTS_TRICKLE steps that first finish
    the 128 oldest admitted workloads (wave_key) and stage one new
    workload in each of their CQs, then (the chaos run) quiet steps.
    A step may install a FaultInjector and set the watchdog for its
    cycle."""

    phase = "scheduler_faults"

    def __init__(self, device, label: str, clock_s: float):
        from kueue_tpu_torch.sim import northstar as ns
        self.ns = ns
        t0 = time.perf_counter()
        self.sched, self.cache, self.queues, self.client = \
            self.build_env(device)
        self.label, self.clock_s = label, clock_s
        self.admitted = {}   # name -> admitted workload
        self.records = []    # per step: sorted admitted names
        self.steps = []      # per step: the log row
        self.trickled = 0
        log(f"[{self.phase}] {label}: {NORTH_STAR['num_cqs']} CQs, "
            f"{self.queues.pending_total()} pending staged in "
            f"{time.perf_counter() - t0:.1f} s")

    def build_env(self, device):
        return faults_env(device)

    def trickle(self) -> None:
        ns = self.ns
        done = sorted(self.admitted, key=wave_key)[:CHURN_FINISHES]
        for name in done:
            wl = self.admitted.pop(name)
            self.cache.delete_workload(wl)
            self.queues.queue_associated_inadmissible_workloads_after(wl)
        for name in done:
            cq = int(name.split("-")[1])
            self.trickled += 1
            wl = ns.make_workload(f"t{self.trickled}-{cq}", f"lq{cq}",
                                  cpu_units=NOMINAL_UNITS,
                                  creation=1e6 + self.trickled)
            if not self.queues.add_or_update_workload(wl):
                raise AssertionError(f"no queue for {wl.metadata.name}")

    def step(self, n: int, injector=None, watchdog=None,
             case: str = "", quiet: bool = False) -> dict:
        from kueue_tpu_torch.resilience import faultinject
        from kueue_tpu_torch.resilience.watchdog import DispatchWatchdog
        from kueue_tpu_torch.solver import kernel
        sched, solver = self.sched, self.sched.solver
        if E2E_WAVES <= n < E2E_WAVES + FAULTS_TRICKLE:
            self.trickle()
        counts0 = dict(sched.cycle_counts)
        faults0, k0 = sched.solver_faults, kernel.launch_counts()
        if watchdog is not None:
            sched.watchdog = DispatchWatchdog(**watchdog)
        if injector is not None:
            faultinject.install(injector)
        t0 = time.perf_counter()
        try:
            sched.schedule(timeout=0)
        finally:
            wall = time.perf_counter() - t0
            faultinject.uninstall()
            if watchdog is not None:
                sched.watchdog = DispatchWatchdog()
        new = self.client.drain_applied()
        for wl in new:
            self.admitted[wl.metadata.name] = wl
        self.records.append(sorted(wl.metadata.name for wl in new))
        route = [r for r, c in sched.cycle_counts.items()
                 if c != counts0.get(r, 0)]
        b = sched.breaker
        launched = {k: v - k0[k] for k, v in kernel.launch_counts().items()
                    if v != k0[k]}
        row = {"step": n, "case": case, "route": route[0] if route else "",
               "faults": sched.solver_faults,
               "new_faults": sched.solver_faults - faults0,
               "breaker": b.state, "consecutive": b.consecutive_faults,
               "trips": b.trips, "recoveries": b.recoveries,
               "counters": {k: solver.counters[k] for k in (
                   "validation_faults", "scatter_faults",
                   "supervised_timeouts", "dispatch_timeouts",
                   "establishes", "collects")},
               "orphaned": solver._supervisor.orphaned,
               "admitted": len(new), "wall_ms": wall * 1e3,
               "launched": launched}
        if injector is not None:
            row["fired"] = {k: v for k, v in injector.fired.items() if v}
        self.steps.append(row)
        if not quiet:
            log(f"[scheduler_faults] {self.label} step {n}"
                f"{f' ({case})' if case else ''}: " + json.dumps(row))
        sched.clock.advance(self.clock_s)
        return row

    def settle(self, start: int, injector=None, inject_until: int = 0,
               case: str = "") -> int:
        """Steps from `start` (with `injector` before `inject_until`)
        until FAULTS_SETTLE in a row, past it, admit nothing; heads the
        cohorts' intra-cycle accounting skipped retry in them. Returns
        the steps run in all."""
        settled, n = 0, start
        while n < FAULTS_MAX_STEPS:
            injecting = n < inject_until
            row = self.step(n, injector if injecting else None,
                            case=case if injecting else "")
            settled = 0 if (injecting or row["admitted"]) else settled + 1
            n += 1
            if settled >= FAULTS_SETTLE:
                return n
        raise AssertionError(f"scheduler_faults {self.label} did not settle")

    def usage(self) -> list:
        return [sorted(self.cache.usage_for_cluster_queue(f"cq{i}")[0]
                       .items()) for i in range(NORTH_STAR["num_cqs"])]

    def close(self) -> list:
        """Drop the build and return its usage per CQ; the records,
        steps and admitted names stay."""
        usage = self.usage()
        self.sched.solver._supervisor.close(join_timeout=0.0)
        self.admitted = dict.fromkeys(self.admitted)
        self.sched = self.cache = self.queues = self.client = None
        return usage


def scheduler_faults_phase(device) -> dict:
    """Device-fault containment on the card (resilience/ under the
    port's Scheduler), on the north star's fill: R, the step schedule
    with no injector; A, the same steps with one injected fault at a
    time: (a) a dispatch raise, (b) three in a row (the breaker opens,
    a cpu-breaker cycle, the clock past the backoff, a half-open probe
    on the card closes it), (c) a corrupt collect, (e) a journal-replay
    raise, (f) a dispatch hang past the supervised deadline, (g) a
    collect delay past the watchdog's deadline, and, on the first
    trickle step, (d) a scrambled arena scatter (K7a launches on the
    mangled rows; collect raises the noted scramble; the next step
    re-establishes residency); every step of A admits what R's does.
    H: a seeded FaultInjector.scripted burst over every site through
    the fill and the trickle, then quiet steps until settled: the same
    admissions and usage per CQ as R."""
    from kueue_tpu_torch.resilience import faultinject as fi
    from kueue_tpu_torch.solver import encode, kernel
    phase = "scheduler_faults"
    t_phase = time.perf_counter()
    kernel.reset_launch_counts()
    ref = FaultsRun(device, "R", FAULTS_CLOCK_S)
    for n in range(FAULTS_STEPS):
        ref.step(n)
    steps = ref.settle(FAULTS_STEPS)
    for row in ref.steps:
        # a quiet step with no head takes no route
        if row["route"] not in ("device", "") or row["faults"]:
            raise AssertionError(f"{phase} R step {row['step']}: {row}")
    topo = encode.encode_topology(ref.cache.snapshot())
    check_resident(ref.sched.solver, ref.cache, topo)
    stats = {"R": dict(ref.cache.snapshot_stats)}
    ref_usage = ref.close()
    # run R's end state, which the observed phase must reach
    FAULTS_R.update(admitted=set(ref.admitted), usage=ref_usage)

    def one(site, action):
        return fi.FaultInjector({site: {0: action}})
    cases = {
        1: ("a", lambda: one(fi.SITE_DISPATCH, fi.RAISE), None),
        3: ("b", lambda: one(fi.SITE_DISPATCH, fi.RAISE), None),
        4: ("b", lambda: one(fi.SITE_DISPATCH, fi.RAISE), None),
        5: ("b", lambda: one(fi.SITE_DISPATCH, fi.RAISE), None),
        8: ("c", lambda: one(fi.SITE_COLLECT, fi.CORRUPT), None),
        10: ("e", lambda: one(fi.SITE_REPLAY, fi.RAISE), None),
        12: ("f", lambda: one(fi.SITE_DISPATCH, (fi.DELAY, 8.0)),
             dict(max_deadline_s=2.0)),
        14: ("g", lambda: one(fi.SITE_COLLECT, (fi.DELAY, 1.0)),
             dict(safety_factor=1.0, min_deadline_s=0.05,
                  max_deadline_s=0.5)),
        E2E_WAVES: ("d", lambda: one(fi.SITE_SCATTER, fi.CORRUPT), None),
    }
    run = FaultsRun(device, "A", FAULTS_CLOCK_S)
    sched = run.sched
    for n in range(steps):
        case, make, watchdog = cases.get(n, ("", None, None))
        if n == 7:
            sched.clock.advance(10.0)  # past the backoff: a probe is due
        row = run.step(n, make() if make else None, watchdog,
                       case or ("probe" if n == 7 else ""))
        if run.records[n] != ref.records[n]:
            raise AssertionError(f"{phase} A step {n} ({case}): admitted "
                                 "other workloads than R")
        want_route = "cpu-breaker" if n == 6 else ref.steps[n]["route"]
        want_new = 1 if case else 0
        if row["route"] != want_route or row["new_faults"] != want_new:
            raise AssertionError(f"{phase} A step {n} ({case}): {row}")
        if case == "b" and n == 5 and (row["breaker"] != "open"
                                       or row["trips"] != 1):
            raise AssertionError(f"{phase} (b): the breaker did not open")
        if n == 7 and (row["breaker"] != "closed" or row["recoveries"] != 1):
            raise AssertionError(f"{phase}: the probe did not close the "
                                 "breaker")
        if case == "f" and (row["counters"]["supervised_timeouts"] != 1
                            or row["wall_ms"] >= 8000.0):
            raise AssertionError(f"{phase} (f): no supervised timeout, or "
                                 "the cycle sat out the hang")
        if case == "g" and row["counters"]["dispatch_timeouts"] != 1:
            raise AssertionError(f"{phase} (g): no collect timeout")
        if case == "c" and row["counters"]["validation_faults"] != 1:
            raise AssertionError(f"{phase} (c): the corrupt collect was not "
                                 "caught")
        if case == "d" and (row["counters"]["scatter_faults"] != 1
                            or not row["launched"].get("arena_scatter")):
            raise AssertionError(f"{phase} (d): K7a did not launch on the "
                                 "scrambled rows, or they were not caught")
        if n == E2E_WAVES + 1 and row["counters"]["establishes"] \
                <= run.steps[-2]["counters"]["establishes"]:
            raise AssertionError(f"{phase}: residency was not re-established "
                                 "after (d)")
    if sched.breaker.state != "closed":
        raise AssertionError(f"{phase} A: the breaker is not closed")
    check_resident(sched.solver, run.cache, topo)
    check_handout(run.cache.snapshot(), run.cache, f"{phase} A")
    a_summary = {"faults": sched.solver_faults,
                 "cycle_counts": dict(sched.cycle_counts),
                 "breaker": sched.breaker.status(),
                 "orphaned": sched.solver._supervisor.orphaned}
    stats["A"] = dict(run.cache.snapshot_stats)
    if run.close() != ref_usage:
        raise AssertionError(f"{phase} A: usage per CQ differs from R")

    from kueue_tpu_torch.resilience.watchdog import DispatchWatchdog
    chaos = FaultsRun(device, "H", FAULTS_CHAOS_CLOCK_S)
    csched = chaos.sched
    # tests/test_chaos.py's watchdog: an injected 0.2 s collect delay
    # passes the warm deadline
    csched.watchdog = DispatchWatchdog(safety_factor=2.0, min_deadline_s=0.1,
                                       max_deadline_s=10.0)
    injector = fi.FaultInjector.scripted(**FAULTS_CHAOS)
    n = chaos.settle(0, injector, FAULTS_STEPS, "h")
    check_handout(chaos.cache.snapshot(), chaos.cache, f"{phase} H")
    if injector.total_fired == 0 or csched.solver_faults == 0:
        raise AssertionError(f"{phase} H: no fault fired")
    h_summary = {"steps": n, "fired": {k: v for k, v in
                                       injector.fired.items() if v},
                 "faults": csched.solver_faults,
                 "cycle_counts": dict(csched.cycle_counts),
                 "breaker": csched.breaker.status(),
                 "counters": dict(csched.solver.counters),
                 "steps_equal_to_R": sum(
                     chaos.records[i] == ref.records[i]
                     for i in range(FAULTS_STEPS))}
    stats["H"] = dict(chaos.cache.snapshot_stats)
    if set(chaos.admitted) != set(ref.admitted) \
            or chaos.close() != ref_usage:
        raise AssertionError(f"{phase} H: the burst settled to other "
                             "admissions or usage per CQ than R")
    launches = kernel.launch_counts()
    for name in PHASE_KERNELS[phase]:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{phase} path")
    contained = [r["wall_ms"] for r in run.steps if r["case"]
                 and r["case"] not in ("f", "g")]
    healthy = [r["wall_ms"] for r in ref.steps[E2E_WARMUP:E2E_WAVES]]
    summary = {
        "launches": launches,
        "cases": {r["case"] + str(r["step"]): {
            k: r[k] for k in ("route", "new_faults", "breaker", "counters",
                              "wall_ms", "launched")}
            for r in run.steps if r["case"]},
        "A": a_summary, "H": h_summary,
        "contained_cycle_ms": {"p50": percentile(contained, 50),
                               "max": max(contained)},
        "probe_cycle_ms": run.steps[7]["wall_ms"],
        "healthy_fill_cycle_ms": {"p50": percentile(healthy, 50),
                                  "max": max(healthy)},
        "hang_cycle_ms": run.steps[12]["wall_ms"],
        "collect_timeout_cycle_ms": run.steps[14]["wall_ms"],
        "snapshot_stats": stats,
        "admitted_total": len(run.admitted),
    }
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[{phase}] " + json.dumps(summary))
    return summary


class PipelineRun(FaultsRun):
    """The faults phase's step schedule (the north star's fill, then the
    trickle, then quiet steps until settled) under a Scheduler that
    pipelines at `depth` (0: the synchronous Scheduler), with the default
    watchdog. After step `update_step` one workload of the cycle just
    dispatched is updated (a new priority, the same creation), and
    `injector` is installed for every step. Each step's row is kept, not
    logged, and each device collect's launch span is read from the CUDA
    events the dispatch records around its launches: the pipelined
    collects' (the solver's own "device" phase there) and the
    synchronous ones' (where that phase reads the host clock from the
    first launch to the end of the wait)."""

    phase = "scheduler_pipelined"
    # the first replacement's number (FaultsRun counts them from 1)
    trickle_base = 0

    def __init__(self, device, label: str, depth: int):
        super().__init__(device, label, FAULTS_CLOCK_S)
        self.sched.pipeline_enabled = depth > 0
        self.sched.pipeline_depth = max(depth, 1)
        self.reserved = {}  # name -> admissions seen
        self.route_ms, self.collect_device_ms = [], []
        self.sync_device_ms = []  # the synchronous device cycles'
        self.events_ms = None  # the last collect's launch span
        solver = self.sched.solver
        await_device = solver._await_device

        def await_and_read(inflight):
            await_device(inflight)
            if inflight.start_event is not None:
                self.events_ms = inflight.start_event.elapsed_time(
                    inflight.event)
        solver._await_device = await_and_read
        # The trickle's finishes are fixed by name (the waves in
        # wave_key order), so that the traffic is the same whatever the
        # lag: a workload not admitted yet finishes at a later step, and
        # its replacement is named after its place in that order.
        self.finish_order = [f"w{w}-{c}" for w in range(E2E_WAVES)
                             for c in range(NORTH_STAR["num_cqs"])]
        self.to_finish, self.finish_next = [], 0
        self.t_start = time.perf_counter()
        self.wall_s = None

    def trickle(self) -> None:
        k = self.finish_next
        self.to_finish += self.finish_order[k:k + CHURN_FINISHES]
        self.finish_next = k + CHURN_FINISHES
        self.finish_due()

    def finish_due(self) -> None:
        ns = self.ns
        due = [n for n in self.to_finish if n in self.admitted]
        self.to_finish = [n for n in self.to_finish if n not in self.admitted]
        for name in due:
            wl = self.admitted.pop(name)
            self.cache.delete_workload(wl)
            self.queues.queue_associated_inadmissible_workloads_after(wl)
        for name in due:
            cq = int(name.split("-")[1])
            idx = self.finish_order.index(name) + self.trickle_base
            wl = ns.make_workload(f"t{idx}-{cq}", f"lq{cq}",
                                  cpu_units=NOMINAL_UNITS,
                                  creation=1e6 + idx)
            if not self.queues.add_or_update_workload(wl):
                raise AssertionError(f"no queue for {wl.metadata.name}")

    def run(self, update_step: int, update_name: str = None,
            injector=None) -> str:
        """Every step, the collector's time in each kept in its row
        ("gc_ms"); returns the updated workload's name (none is updated
        when update_step is not a step)."""
        gc_clock = GcClock()
        gc.callbacks.append(gc_clock)
        try:
            return self._run(update_step, update_name, injector, gc_clock)
        finally:
            gc.callbacks.remove(gc_clock)

    def _run(self, update_step, update_name, injector, gc_clock) -> str:
        sched, solver = self.sched, self.sched.solver
        n = settled = 0
        while n < FAULTS_MAX_STEPS:
            solver.last_phase_s["route"] = 0.0
            pipelined0 = sched.cycle_counts.get("device-pipelined", 0)
            if n >= FAULTS_STEPS and self.to_finish:
                self.finish_due()
            g0 = gc_clock.total
            self.events_ms = None
            row = self.step(n, injector, quiet=True)
            row["gc_ms"] = (gc_clock.total - g0) * 1e3
            if solver.last_phase_s["route"]:
                self.route_ms.append(solver.last_phase_s["route"] * 1e3)
            if sched.cycle_counts.get("device-pipelined", 0) > pipelined0:
                self.collect_device_ms.append(
                    solver.last_phase_s["device"] * 1e3)
            elif row["route"] == "device" and self.events_ms is not None:
                self.sync_device_ms.append(self.events_ms)
            for name in self.records[-1]:
                self.reserved[name] = self.reserved.get(name, 0) + 1
            if n == update_step:
                update_name = self.update(update_name)
            n += 1
            quiet = n > FAULTS_STEPS and not row["admitted"] \
                and sched._inflight is None and not self.to_finish
            settled = settled + 1 if quiet else 0
            if settled >= FAULTS_SETTLE:
                self.wall_s = time.perf_counter() - self.t_start
                return update_name
        raise AssertionError(f"scheduler_pipelined {self.label} did not "
                             "settle")

    def update(self, name: str = None) -> str:
        """Update `name`, or the first head of the cycle in flight: a
        priority of 9, the same creation time."""
        from kueue_tpu_torch.sim import northstar as ns
        if name is None:
            info = self.sched._inflight_q[-1].inflight.plan.batch.infos[0]
            name = info.obj.metadata.name
        cq = int(name.split("-")[1])
        wave = int(name[1:].split("-")[0])
        n = wave * NORTH_STAR["num_cqs"] + cq
        wl = ns.make_workload(name, f"lq{cq}", cpu_units=NOMINAL_UNITS,
                              priority=9, creation=float(n))
        if not self.queues.add_or_update_workload(wl):
            raise AssertionError(f"no queue for {name}")
        return name

    def summary(self, timed: range) -> dict:
        sched = self.sched
        cc = dict(sched.cycle_counts)
        walls = [self.steps[n]["wall_ms"] for n in timed]
        pipelined = cc.get("device-pipelined", 0)
        return {
            "step_ms": {"p50": percentile(walls, 50), "max": max(walls),
                        "timed": walls,
                        "gc_timed": [self.steps[n]["gc_ms"] for n in timed],
                        "gc_max": max(r["gc_ms"] for r in self.steps)},
            "route_ms": {"p50": percentile(self.route_ms, 50)
                         if self.route_ms else None,
                         "max": max(self.route_ms, default=None)},
            "collect_device_ms_from_events": {
                "p50": percentile(self.collect_device_ms, 50)
                if self.collect_device_ms else None,
                "max": max(self.collect_device_ms, default=None)},
            "sync_device_ms_from_events": {
                "p50": percentile(self.sync_device_ms, 50)
                if self.sync_device_ms else None,
                "max": max(self.sync_device_ms, default=None)},
            "hit_rate": pipelined / max(pipelined + cc.get("device", 0), 1),
            "speculation_hits": sched.speculation_hits,
            "speculation_aborts": sched.speculation_aborts,
            "abort_reasons": dict(sched.speculation_abort_reasons),
            "cycle_counts": cc, "steps": len(self.steps),
            "faults": sched.solver_faults,
            "live_handouts": self.cache.live_handouts,
            "wall_s": self.wall_s,
            "admitted": len(self.reserved),
            "reserved_twice": sorted(k for k, v in self.reserved.items()
                                     if v > 1)}


@collector_paused()
def mixed_env(device):
    """The north star's 2048 CQs in 256 cohorts, 32 flavors of 40 units,
    in eight classes by CQ index mod 8 (every cohort in one class). Class
    0 (256 CQs): LowerPriority within the CQ, every flavor held by a
    priority-0 workload, MIXED["preemptors"] priority-10 heads each;
    class 7: Never/Never, full, one head each (the device-NoFit
    shortcut); classes 1-6: Never/Never, empty, MIXED["waves"] heads
    each. At most a quarter of a cycle's heads are preempt rows, so K9
    rides the pipelined dispatch. Returns (the pipelined Scheduler,
    cache, queues, client, the prefilled workloads by name)."""
    from kueue_tpu_torch.api import kueue as api
    from kueue_tpu_torch.api.meta import FakeClock
    from kueue_tpu_torch.cache import Cache
    from kueue_tpu_torch.queue import Manager
    from kueue_tpu_torch.scheduler.scheduler import Scheduler
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import BatchSolver
    Q, C = NORTH_STAR["num_cqs"], NORTH_STAR["num_cohorts"]
    flavors = [f"f{i}" for i in range(NORTH_STAR["num_flavors"])]
    clock = FakeClock(1000.0)
    cache, queues = Cache(), Manager(clock=clock)
    for f in flavors:
        cache.add_or_update_resource_flavor(ns.make_flavor(f))
    lower = api.ClusterQueuePreemption(
        within_cluster_queue=api.PREEMPTION_LOWER_PRIORITY)
    held = {}
    for i in range(Q):
        cls = i % 8
        cq = ns.make_cq(f"cq{i}", f"cohort-{i % C}", flavors, NOMINAL_UNITS,
                        preemption=lower if cls == 0 else None)
        cache.add_cluster_queue(cq)
        queues.add_cluster_queue(cq)
        queues.add_local_queue(ns.make_local_queue(f"lq{i}", f"cq{i}"))
        if cls in (0, 7):
            for f in flavors:
                wl = ns.admitted_workload(f"v{i}-{f}", f"cq{i}", f,
                                          NOMINAL_UNITS, 0.0)
                cache.add_or_update_workload(wl)
                held[wl.metadata.name] = wl
    n = 0
    for wave in range(MIXED["waves"]):
        for i in range(Q):
            cls = i % 8
            if cls == 7 and wave or cls == 0 and wave >= MIXED["preemptors"]:
                continue
            wl = ns.make_workload(f"w{wave}-{i}", f"lq{i}",
                                  cpu_units=NOMINAL_UNITS,
                                  priority=10 if cls == 0 else n % 5,
                                  creation=float(n))
            queues.add_or_update_workload(wl)
            n += 1
    client = ns.SimClient()
    sched = Scheduler(queues, cache, client, clock=clock,
                      solver=BatchSolver(device=device), solver_min_heads=0)
    sched.pipeline_enabled = True
    return sched, cache, queues, client, held


def mixed_run(device) -> tuple:
    """MIXED["steps"] steps of mixed_env on `device`, then steps until the
    pipeline is empty; before each step the workloads evicted so far
    finish (the workload controller's delete). Returns (per step: the
    admitted names, the evictions with their reasons, the routes taken;
    the Scheduler's summary; the cycles' kernel launches on the card)."""
    from kueue_tpu_torch.solver import kernel
    t_run = time.perf_counter()
    sched, cache, queues, client, held = mixed_env(device)
    k0 = kernel.launch_counts()
    steps, finished, walls = [], set(), []
    for n in range(MIXED["max_steps"]):
        for name, _reason in client.evictions:
            if name not in finished:
                finished.add(name)
                wl = held[name]
                cache.delete_workload(wl)
                queues.queue_associated_inadmissible_workloads_after(wl)
        counts0, ev0 = dict(sched.cycle_counts), len(client.evictions)
        t0 = time.perf_counter()
        sched.schedule(timeout=0)
        walls.append((time.perf_counter() - t0) * 1e3)
        steps.append((sorted(wl.metadata.name
                             for wl in client.drain_applied()),
                      client.evictions[ev0:],
                      sorted(r for r, c in sched.cycle_counts.items()
                             if c != counts0.get(r, 0))))
        if n + 1 >= MIXED["steps"] and sched._inflight is None:
            break
    else:
        raise AssertionError("scheduler_pipelined mixed: the pipeline did "
                             "not drain")
    launched = {k: v - k0[k] for k, v in kernel.launch_counts().items()
                if v != k0[k]}
    summary = {"steps": len(steps), "step_ms": walls,
               "cycle_counts": dict(sched.cycle_counts),
               "speculation_hits": sched.speculation_hits,
               "abort_reasons": dict(sched.speculation_abort_reasons),
               "evicted": len(client.evictions),
               "preempt_plan": sched.last_preempt_plan,
               "faults": sched.solver_faults,
               "live_handouts": cache.live_handouts,
               "wall_s": time.perf_counter() - t_run}
    sched.solver._supervisor.close(join_timeout=0.0)
    return steps, summary, launched


def scheduler_pipelined_phase(device) -> dict:
    """The speculative pipeline on the card (the port's Scheduler with
    pipeline_enabled, its solver bound to the card, the default
    watchdog): (a) depth 1 and (b) depth 2 on the faults phase's traffic
    (the north star's fill, the trickle, quiet steps until settled), each
    with a workload of the cycle in flight updated after step
    PIPELINE_UPDATE_STEP (an arena-slots abort) and a mis-speculation
    injected at SITE_SPECULATION (PIPELINE_INJECT_HIT); (c) the same
    traffic under the synchronous Scheduler: the same admitted set and
    usage per CQ, nothing reserved twice; (d) a mixed cycle's north star
    (mixed_env), where K9 rides the pipelined dispatch, each step's
    admissions, evictions and reasons equal to the same Scheduler on the
    CPU. Steps 1-PIPELINE_TIMED are the timed ones; each step's
    collector time is kept. Each run is closed once its admitted set and
    usage per CQ are kept, so that one north star lives at a time."""
    import torch
    from kueue_tpu_torch.resilience import faultinject as fi
    from kueue_tpu_torch.solver import kernel
    phase = "scheduler_pipelined"
    t_phase = time.perf_counter()
    timed = range(E2E_WARMUP, E2E_WARMUP + PIPELINE_TIMED)
    kernel.reset_launch_counts()
    admitted = {}  # label -> (admitted set, usage per CQ)
    summary = {}
    name = None
    for label, depth in (("depth1", 1), ("depth2", 2)):
        gc.collect()
        run = PipelineRun(device, label, depth)
        name = run.run(PIPELINE_UPDATE_STEP, name, fi.FaultInjector(
            {fi.SITE_SPECULATION: {PIPELINE_INJECT_HIT[depth]: fi.RAISE}}))
        summary[label] = run.summary(timed)
        admitted[label] = (set(run.reserved), run.close())
        reasons = summary[label]["abort_reasons"]
        if not reasons.get("arena-slots") or not reasons.get("injected") \
                or summary[label]["live_handouts"] \
                or summary[label]["faults"] \
                or summary[label]["reserved_twice"]:
            raise AssertionError(f"{phase} {label}: {summary[label]}")
        log(f"[{phase}:{label}] " + json.dumps(summary[label]))
    mixed_steps, summary["mixed"], mixed_launched = mixed_run(device)
    launches = kernel.launch_counts()
    for name_k in PHASE_KERNELS[phase]:
        if launches[name_k] <= 0:
            raise AssertionError(f"kernel {name_k} never launched on the "
                                 f"{phase} path")
    summary["mixed"]["launched"] = mixed_launched
    cpu_steps, cpu_summary, _ = mixed_run(torch.device("cpu"))
    summary["mixed"]["cpu_wall_s"] = cpu_summary["wall_s"]
    if mixed_steps != cpu_steps:
        first = next(i for i, (a, b) in enumerate(zip(mixed_steps,
                                                       cpu_steps)) if a != b)
        raise AssertionError(f"{phase} mixed step {first}: the card "
                             "admitted or evicted otherwise than the CPU")
    m = summary["mixed"]
    if not m["cycle_counts"].get("pipelined-preempt") \
            or not mixed_launched.get("solve_preempt") or not m["evicted"] \
            or m["live_handouts"] or m["faults"] \
            or cpu_summary["cycle_counts"] != m["cycle_counts"]:
        raise AssertionError(f"{phase} mixed: {m}")
    log(f"[{phase}:mixed] equal to the CPU, step by step; "
        + json.dumps(m))
    gc.collect()
    sync = PipelineRun(device, "sync", 0)
    sync.run(PIPELINE_UPDATE_STEP, name)
    summary["sync"] = sync.summary(timed)
    if summary["sync"]["reserved_twice"] or summary["sync"]["faults"] \
            or set(summary["sync"]["cycle_counts"]) != {"device"}:
        raise AssertionError(f"{phase} sync: {summary['sync']}")
    ref = (set(sync.reserved), sync.close())
    for label, got in admitted.items():
        if got != ref:
            raise AssertionError(f"{phase} {label}: another admitted set or "
                                 "usage per CQ than the synchronous run")
    log(f"[{phase}:sync] " + json.dumps(summary["sync"]))
    summary["launches"] = launches
    summary["updated"] = name
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[{phase}] depth 1 and 2 admitted the synchronous run's set with "
        "its usage per CQ; " + json.dumps(
            {k: summary[k] for k in ("launches", "updated", "wall_s")}))
    return summary

def attach_observers(sched, cache, queues) -> tuple:
    """The JAX package's manager wiring of the observers onto a port
    Scheduler (kueue_tpu/manager.py:132-310): a metrics Registry, a
    JourneyLedger on the Manager's journey listener (attach it before
    workloads are queued, so that their arrivals open journeys), the
    manager's AgingWatch monitors but the WAL's, sampled at every seal,
    and a QueryPlane. The Scheduler's own FlightRecorder stays. Returns
    (ledger, plane)."""
    from kueue_tpu_torch import metrics as metricspkg
    from kueue_tpu_torch.obs import AgingWatch, JourneyLedger, QueryPlane
    from kueue_tpu_torch.obs.trend import rss_kb
    solver = sched.solver
    reg = metricspkg.Registry()
    sched.metrics = reg
    ledger = JourneyLedger(metrics=reg, clock=sched.clock,
                           generation_source=cache.generation_token)
    queues.add_journey_listener(ledger.note_queue_delta)
    sched.journeys = ledger
    watch = AgingWatch()
    watch.add("live_handouts", lambda: cache.live_handouts,
              slope_threshold=0.05)
    watch.add("requeue_amplification", lambda: ledger.requeues_per_admission,
              slope_threshold=0.02, window=32)
    watch.add("arena_occupied",
              lambda: solver._arena.size - len(solver._arena.free),
              slope_threshold=1.0, window=64)
    watch.add("mid_traffic_compiles",
              lambda: solver.counters["mid_traffic_compiles"],
              slope_threshold=0.01, window=16)
    watch.add("rss_kb", rss_kb, slope_threshold=1024.0, window=64,
              warmup=16)
    sched.aging = watch
    plane = QueryPlane(cache, queues, metrics=reg)
    sched.query_plane = plane
    return ledger, plane


class ObservedRun(PipelineRun):
    """The faults phase's traffic (PipelineRun, depth 1, no update, no
    injector) under the port's Scheduler in the JAX package's production
    wiring, as kueue_tpu/manager.py builds it: adaptive routing, the
    pipeline at depth 1, a FlightRecorder, a metrics Registry, a
    JourneyLedger on the Manager's journey listener (attached before the
    waves are staged), the manager's AgingWatch monitors but the WAL's,
    a QueryPlane, and a CompileGovernor started before the first cycle,
    with the manager's arguments (kueue_tpu/manager.py:361-372): on the
    card it is warm at once."""

    phase = "scheduler_observed"
    # the replacements named and timed as the faults phase's run R's
    trickle_base = 1

    @collector_paused()
    def build_env(self, device):
        from kueue_tpu_torch.scheduler.preemption import parse_strategies
        from kueue_tpu_torch.sim import northstar as ns
        from kueue_tpu_torch.solver import BatchSolver
        from kueue_tpu_torch.solver.fairpreempt import strategy_flags
        from kueue_tpu_torch.solver.warmgov import CompileGovernor
        flavors = [f"f{i}" for i in range(NORTH_STAR["num_flavors"])]
        sched, cache, queues, client = ns.build_scheduler(
            NORTH_STAR["num_cqs"], NORTH_STAR["num_cohorts"], flavors,
            NOMINAL_UNITS, solver=BatchSolver(device=device))
        self.ledger, self.plane = attach_observers(sched, cache, queues)
        solver = sched.solver
        sched.solver_routing = "adaptive"
        ns.stage_waves(queues, E2E_WAVES, NORTH_STAR["num_cqs"],
                       NOMINAL_UNITS)
        self.gov = CompileGovernor(
            solver, cache, metrics=sched.metrics, recorder=sched.recorder,
            max_width=NORTH_STAR["num_cqs"],
            fs_flags=strategy_flags(parse_strategies(None)))
        sched.warm_gov = self.gov
        self.gov.start()
        return sched, cache, queues, client


def observed_reader(plane, stop, out: dict) -> None:
    """A reader thread of the query plane during the run: acquire a
    sealed view, read a CQ's pending table and a workload's status,
    release; counts the reads a view answered."""
    n = 0
    while not stop.is_set():
        view = plane.acquire()
        if view is None:
            time.sleep(0.001)
            continue
        try:
            rows = plane.pending_cq(view, f"cq{n % NORTH_STAR['num_cqs']}",
                                    16, 0)
            plane.workload_status(view, "default", f"w0-{n % 64}")
            if [r.position_in_cluster_queue for r in rows] \
                    != list(range(len(rows))):
                out["errors"].append(f"torn table in view {view.cycle_id}")
            out["reads"] += 1
            out["cycles"].add(view.cycle_id)
        except Exception as exc:  # noqa: BLE001 — reported by the phase
            out["errors"].append(repr(exc))
        finally:
            plane.release(view)
        n += 1
        time.sleep(0.02)


def scheduler_observed_phase(device) -> dict:
    """Adaptive routing, the warm governor's route gate and the
    observability plane on the card (ObservedRun: the north star's fill,
    6 trickle steps, quiet steps until settled). Checks: the governor is
    warm before the first cycle (nothing on the card is compiled per
    shape: no bucket, no walk), so no cycle runs cpu-warmup and
    mid_traffic_compiles stays 0; each engine has 2 samples or more in
    the fit regime; the device cycles launch the faults phase's kernels;
    a leader_check flip at the OBSERVED_FLIP-th trickle step with a
    cycle in flight abandons it, and the run (one extra cycle past the
    flip, then until settled) reaches the faults phase's run R (the same
    admitted set and usage per CQ), nothing admitted twice; every
    trace's phase_sums equals the cycle_phase_seconds histograms; every
    admission sealed its journey and the retained ones are complete; a
    reader thread answered from sealed views; live_handouts ends at what
    the query plane holds; no aging verdict fails. Prints the routes,
    the governor's status, the router's median admitted/s per engine and
    regime and each traced phase's p50."""
    import threading

    from kueue_tpu_torch.obs import router_status
    from kueue_tpu_torch.solver import kernel
    from kueue_tpu_torch.solver.warmgov import GOV_WARM
    phase = "scheduler_observed"
    t_phase = time.perf_counter()
    kernel.reset_launch_counts()
    gc.collect()
    run = ObservedRun(device, "observed", 1)
    sched, solver, gov = run.sched, run.sched.solver, run.gov
    st = gov.status()
    failures = []  # every failed check, raised after the summary prints
    fail = failures.append
    if gov.state != GOV_WARM or st["buckets"] \
            or st["source"] not in ("fresh", "cache-hit"):
        fail(f"the governor on the card is not warm from its start: {st}")
    leader = {"on": True}
    sched.leader_check = lambda: leader["on"]
    stop = threading.Event()
    reads = {"reads": 0, "errors": [], "cycles": set()}
    reader = threading.Thread(target=observed_reader,
                              args=(run.plane, stop, reads), daemon=True)
    reader.start()
    routes = []
    flip = None
    n = settled = 0
    try:
        while n < FAULTS_MAX_STEPS:
            if n >= FAULTS_STEPS and run.to_finish:
                run.finish_due()
            trickle_k = n - E2E_WAVES
            flipping = (flip is None and trickle_k >= OBSERVED_FLIP
                        and n < FAULTS_STEPS and sched._inflight is not None)
            if flipping:
                flip = {"step": n, "inflight": len(sched._inflight_q)}
                leader["on"] = False
            try:
                row = run.step(n, quiet=True)
            finally:
                leader["on"] = True
            if flipping:
                flip.update(after=len(sched._inflight_q),
                            admitted=row["admitted"],
                            resident=solver.resident is not None)
            routes.append("non-leader" if flipping
                          else row["route"] or sched.last_route)
            for name in run.records[-1]:
                run.reserved[name] = run.reserved.get(name, 0) + 1
            n += 1
            quiet = (n > FAULTS_STEPS and not row["admitted"]
                     and sched._inflight is None and not run.to_finish
                     and (flip is None or n > flip["step"] + 1))
            settled = settled + 1 if quiet else 0
            if settled >= FAULTS_SETTLE:
                break
        else:
            raise AssertionError(f"{phase} did not settle")
    finally:
        stop.set()
        reader.join(timeout=10)
        gov.stop()
    launches = kernel.launch_counts()
    st = gov.status()
    if "cpu-warmup" in routes or gov.unwarm_routed or gov.warmup_faults \
            or st["buckets"]:
        fail(f"routes {routes}, governor {st}")
    if solver.counters["mid_traffic_compiles"]:
        notes = [a for t in sched.recorder.traces() for a in t.annotations
                 if a["kind"] == "compile"]
        fail(f"{solver.counters['mid_traffic_compiles']} mid-traffic "
             f"compiles on the card: {notes}")
    router = router_status(sched)
    for engine in ("device", "cpu"):
        if len(sched._route_stats.get((engine, "fit"), ())) < 2:
            fail(f"{engine} has fewer than 2 fit samples")
    for name in PHASE_KERNELS[phase]:
        if launches[name] <= 0:
            fail(f"kernel {name} never launched")
    if flip is None or not flip["inflight"] or flip["after"] \
            or flip["admitted"] or flip["resident"]:
        fail(f"the leader flip did not abandon a cycle in flight: {flip}")
    twice = sorted(k for k, v in run.reserved.items() if v > 1)
    if twice:
        fail(f"admitted twice: {twice[:8]}")
    traces = sched.recorder.traces()
    want: dict = {}
    for t in traces:
        for ph, secs in t.phase_sums().items():
            want[ph] = want.get(ph, 0.0) + secs
    h = sched.metrics.cycle_phase_seconds
    pi = h.label_names.index("phase")
    got: dict = {}
    for key, (_c, total, _n) in h.series.items():
        got[key[pi]] = got.get(key[pi], 0.0) + total
    if set(got) != set(want) or any(
            abs(got[p] - want[p]) > 1e-9 * max(1.0, want[p]) for p in want):
        fail(f"histograms {got} != traces {want}")
    led = run.ledger
    incomplete = [j.key for j in led.slowest()
                  if not j.timeline_complete()[0]]
    if led.journeys_completed != sum(run.reserved.values()) or incomplete:
        fail(f"journeys {led.status()}, incomplete {incomplete[:8]}")
    if not reads["reads"] or reads["errors"]:
        fail(f"the reader read {reads['reads']} views, errors "
             f"{reads['errors'][:4]}")
    held = 1 if run.plane.status()["holds_snapshot_handout"] else 0
    if run.cache.live_handouts != held:
        fail(f"live_handouts {run.cache.live_handouts}, the plane holds "
             f"{held}")
    gate = sched.aging.gate()
    if not gate["ok"]:
        fail(f"aging {gate}")
    run.plane.close()
    admitted = set(run.admitted)
    usage = run.close()
    if FAULTS_R and (admitted != FAULTS_R["admitted"]
                     or usage != FAULTS_R["usage"]):
        fail(
            f"another admitted set or usage per CQ than the faults phase's "
            f"run R: {len(admitted)} admitted against "
            f"{len(FAULTS_R['admitted'])}, only here "
            f"{sorted(admitted - FAULTS_R['admitted'])[:6]}, only in R "
            f"{sorted(FAULTS_R['admitted'] - admitted)[:6]}")
    by_phase: dict = {}
    for t in traces:
        for ph, secs in t.phase_sums().items():
            by_phase.setdefault(ph, []).append(secs * 1e3)
    rates = {k: v["median_rate_per_s"] for k, v in router["regimes"].items()}
    summary = {
        "routes": routes,
        "cycle_counts": dict(sched.cycle_counts),
        "governor": {k: st[k] for k in (
            "state", "source", "programs_warmed", "buckets",
            "unwarm_routed_cycles", "warmup_faults")},
        "median_admitted_per_s": rates,
        "route_samples": {f"{e}/{r}": len(v) for (e, r), v in
                          sched._route_stats.items()},
        "trace_p50_ms": {ph: percentile(v, 50)
                         for ph, v in sorted(by_phase.items())},
        "flip": flip,
        "reader": {"reads": reads["reads"],
                   "views": len(reads["cycles"])},
        "journeys": {k: led.status()[k] for k in (
            "started", "completed", "requeues_per_admission",
            "lru_evictions")},
        "aging": gate["verdicts"],
        "mid_traffic_compiles": solver.counters["mid_traffic_compiles"],
        "admitted": len(run.reserved),
        "steps": len(routes),
        "launches": launches,
    }
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[{phase}] {nvidia_smi()}; " + json.dumps(summary))
    if failures:
        raise AssertionError(f"{phase}: " + "; ".join(failures))
    return summary


# ---------------------------------------------------------------------------
# The control plane's main path: KueueManager on the card
# ---------------------------------------------------------------------------

# The manager phase (kueue_tpu_torch/manager.py): the north star's topology
# and cycle width (2048 CQs in 256 cohorts), 16 flavors of cpu and memory in
# one resource group (the webhook's limit a group; the north star's 32 would
# be refused) and 4,096 batch/v1 Jobs, two a CQ. Cut from the north star:
# the backlog, 4,096 Jobs and not 51,200 (intake through the controllers
# costs milliseconds a Job on the host). Each CQ owns two flavors of the 16
# (MANAGER_HOME_CPU cores each); the even CQs of a cohort borrow nothing,
# the odd ones up to MANAGER_BORROW cores a flavor. A Job runs 1-8 pods of
# one core and 2 GiB, drawn from --seed.
MANAGER = dict(num_cqs=2048, num_cohorts=256, num_flavors=16,
               jobs_per_cq=2, finishes=1024)
MANAGER_HOME_CPU = 8
MANAGER_BORROW = 8
MANAGER_MAX_POD = 8
# the paired equality run: a 256-CQ copy, on the card and with solver=None
MANAGER_PAIRED = dict(MANAGER, num_cqs=256, num_cohorts=32, finishes=128)
# the MultiKueue step: the manager's 256 CQs on the mk-check (2,048
# cores), three worker KueueManagers with no solver, 1,024 Jobs. A worker
# is one ClusterQueue, "pool", of MANAGER_WORKER_POOL cores on one flavor
# behind a LocalQueue for each of the manager's: the capacity column
# MultiKueueController reads off a worker (nominal minus usage, summed
# over its CQs) is then exactly what the worker can admit, so every Job
# the manager places fits its worker; three pools of 768 hold the
# manager's 2,048 cores and no two of them do, so every worker takes
# placements.
MANAGER_MK = dict(num_cqs=256, num_cohorts=32, num_flavors=16, jobs=1024,
                  workers=3)
MANAGER_WORKER_POOL = 768
MANAGER_MAX_CALLS = 80
MANAGER_SETTLE = 2     # quiet schedule() calls in a row that end a settle
SEED = 2026            # --seed
# what every manager run must launch: the bound cycle's kernels (the
# router's avail and phase_a beside the cycle's), K12 on the MultiKueue step
PHASE_KERNELS["manager"] = ("arena_gather", "avail", "phase_a", "order",
                            "phase_b", "pack")
PHASE_KERNELS["manager_multikueue"] = PHASE_KERNELS["manager"] + (
    "cluster_cols",)


def manager_cfg():
    """The production defaults (pipeline depth 2, adaptive routing, the
    watchdog, the breaker, supervised dispatch, journeys, the query
    plane), with the warm governor started by the manager."""
    from kueue_tpu_torch import config as cfgpkg
    cfg = cfgpkg.Configuration()
    cfg.solver.warmup_at_startup = True
    return cfg


def manager_cluster(store, spec: dict, home_cpu: int, borrow: int,
                    check: str = "") -> None:
    """Flavors, CQs in cohorts and a LocalQueue a CQ, through the store.
    Every CQ lists the 16 flavors in its one resource group, its home
    flavor f(2k) first (k = i mod 8, its place in the cohort), with
    `home_cpu` cores and 4 GiB a core there and nothing elsewhere; even
    CQs borrow nothing, odd ones up to `borrow` cores a flavor from the
    cohort."""
    from kueue_tpu_torch.api import kueue as api
    from kueue_tpu_torch.api.meta import LabelSelector, ObjectMeta
    flavors = [f"f{i}" for i in range(spec["num_flavors"])]
    for f in flavors:
        store.create(api.ResourceFlavor(
            metadata=ObjectMeta(name=f),
            spec=api.ResourceFlavorSpec(node_labels={"pool": f})))
    per_cohort = spec["num_cqs"] // spec["num_cohorts"]
    for i in range(spec["num_cqs"]):
        k = i % per_cohort
        home = flavors[(2 * k) % len(flavors)]
        lend = borrow if k % 2 else 0

        def quota(f, home=home, lend=lend):
            own = home_cpu if f == home else 0
            return api.FlavorQuotas(name=f, resources=[
                api.ResourceQuota(name="cpu", nominal_quota=own * 1000,
                                  borrowing_limit=lend * 1000),
                api.ResourceQuota(name="memory", nominal_quota=own << 32,
                                  borrowing_limit=lend << 32)])

        order = [home] + [f for f in flavors if f != home]
        store.create(api.ClusterQueue(
            metadata=ObjectMeta(name=f"cq{i}"),
            spec=api.ClusterQueueSpec(
                cohort=f"cohort{i // per_cohort}",
                namespace_selector=LabelSelector(),
                admission_checks=[check] if check else [],
                resource_groups=[api.ResourceGroup(
                    covered_resources=["cpu", "memory"],
                    flavors=[quota(f) for f in order])])))
        store.create(api.LocalQueue(
            metadata=ObjectMeta(name=f"lq{i}", namespace="default"),
            spec=api.LocalQueueSpec(cluster_queue=f"cq{i}")))


def worker_cluster(store, num_lqs: int, pool_cpu: int) -> None:
    """A MultiKueue worker: flavor f0, the ClusterQueue "pool" of
    `pool_cpu` cores and 4 GiB a core there, and LocalQueues lq0 ..
    lq{num_lqs - 1} into it, through the store."""
    from kueue_tpu_torch.api import kueue as api
    from kueue_tpu_torch.api.meta import LabelSelector, ObjectMeta
    store.create(api.ResourceFlavor(
        metadata=ObjectMeta(name="f0"),
        spec=api.ResourceFlavorSpec(node_labels={"pool": "f0"})))
    store.create(api.ClusterQueue(
        metadata=ObjectMeta(name="pool"),
        spec=api.ClusterQueueSpec(
            namespace_selector=LabelSelector(),
            resource_groups=[api.ResourceGroup(
                covered_resources=["cpu", "memory"],
                flavors=[api.FlavorQuotas(name="f0", resources=[
                    api.ResourceQuota(name="cpu",
                                      nominal_quota=pool_cpu * 1000),
                    api.ResourceQuota(name="memory",
                                      nominal_quota=pool_cpu << 32)])])])))
    for i in range(num_lqs):
        store.create(api.LocalQueue(
            metadata=ObjectMeta(name=f"lq{i}", namespace="default"),
            spec=api.LocalQueueSpec(cluster_queue="pool")))


def manager_jobs(num_cqs: int, count: int, seed: int) -> list:
    """(name, local queue, pods) of `count` Jobs spread over the CQs in
    turn, their pod counts drawn from `seed`."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pods = rng.integers(1, MANAGER_MAX_POD + 1, size=count)
    return [(f"j{n}", f"lq{n % num_cqs}", int(pods[n])) for n in range(count)]


def make_job(name: str, lq: str, pods: int):
    from kueue_tpu_torch.api import batchv1, corev1
    from kueue_tpu_torch.api import kueue as api
    from kueue_tpu_torch.api.meta import ObjectMeta
    job = batchv1.Job(metadata=ObjectMeta(
        name=name, namespace="default", labels={api.QUEUE_LABEL: lq}))
    job.spec.suspend = True
    job.spec.parallelism = pods
    job.spec.template = corev1.PodTemplateSpec(spec=corev1.PodSpec(
        containers=[corev1.Container(name="c", requests={
            "cpu": 1000, "memory": 2 << 30})]))
    return job


class ManagerRun:
    """One KueueManager (kueue_tpu_torch/manager.py) driven through its
    store: the cluster, then the Jobs (intake timed), cycles until
    settled (each schedule() call timed by its route), a finish wave and
    cycles until settled again."""

    def __init__(self, spec: dict, solver, clock=None,
                 remote_clusters=None, check: str = "",
                 home_cpu: int = MANAGER_HOME_CPU,
                 borrow: int = MANAGER_BORROW, label: str = "",
                 pipeline: bool = True):
        from kueue_tpu_torch.api.meta import REAL_CLOCK
        from kueue_tpu_torch.manager import KueueManager
        self.spec, self.label = spec, label
        self.clock = clock or REAL_CLOCK
        t0 = time.perf_counter()
        cfg = manager_cfg()
        cfg.solver.pipeline = pipeline
        self.mgr = KueueManager(cfg, clock=self.clock,
                                solver=solver,
                                remote_clusters=remote_clusters)
        if check:
            manager_mk_objects(self.mgr.store, remote_clusters)
        manager_cluster(self.mgr.store, spec, home_cpu, borrow, check)
        self.mgr.run_until_idle()
        self.setup_s = time.perf_counter() - t0
        self.calls = []   # (route, seconds) a schedule() call
        self.workers = remote_clusters or {}

    def intake(self, jobs: list) -> float:
        """Create the Jobs and drain the controllers (Workloads made and
        queued); returns the seconds."""
        t0 = time.perf_counter()
        for name, lq, pods in jobs:
            self.mgr.store.create(make_job(name, lq, pods))
        self.mgr.run_until_idle()
        return time.perf_counter() - t0

    def call(self) -> None:
        mgr, sched = self.mgr, self.mgr.scheduler
        mgr.runtime.run_until_idle()
        counts0 = dict(sched.cycle_counts)
        t0 = time.perf_counter()
        sched.schedule(timeout=0)
        dt = time.perf_counter() - t0
        mgr.runtime.run_until_idle()
        for wm in self.workers.values():
            wm.schedule_until_settled()
        if self.workers:
            mgr.runtime.run_until_idle()
        route = [r for r, c in sched.cycle_counts.items()
                 if c != counts0.get(r, 0)]
        self.calls.append((route[0] if route else "idle", dt))

    def settle(self) -> float:
        """schedule() calls until MANAGER_SETTLE in a row change nothing,
        leave no cycle in flight and no active head; returns the
        seconds."""
        mgr, sched = self.mgr, self.mgr.scheduler
        t0 = time.perf_counter()
        quiet = 0
        for _ in range(MANAGER_MAX_CALLS):
            rv0 = mgr.store._rv
            self.call()
            active = any(cqh.active and cqh.pending_active() > 0
                         for cqh in mgr.queues.cluster_queues.values())
            if mgr.store._rv == rv0 and not active \
                    and sched._inflight is None:
                quiet += 1
                if quiet >= MANAGER_SETTLE:
                    return time.perf_counter() - t0
            else:
                quiet = 0
        raise AssertionError(f"manager {self.label} did not settle in "
                             f"{MANAGER_MAX_CALLS} calls")

    def finish(self, count: int) -> list:
        """Mark the first `count` running Jobs (by name) Complete."""
        from kueue_tpu_torch.api import batchv1
        from kueue_tpu_torch.api.meta import Condition
        store = self.mgr.store
        running = sorted(
            (j.metadata.name for j in store.list("Job", copy_objects=False)
             if not j.spec.suspend and not j.status.conditions),
            key=lambda n: int(n[1:]))[:count]
        for name in running:
            job = store.get("Job", "default", name)
            job.status.conditions.append(Condition(
                type=batchv1.JOB_COMPLETE, status="True", message="done"))
            store.update(job)
        self.mgr.run_until_idle()
        return running

    def run(self, jobs: list, finishes: int) -> dict:
        out = {"intake_s": self.intake(jobs)}
        out["settle_s"] = self.settle()
        out["pending_after_first_settle"] = len(self.pending())
        out["finished"] = len(self.finish(finishes))
        out["resettle_s"] = self.settle()
        return out

    def pending(self) -> list:
        from kueue_tpu_torch.core import workload as wlpkg
        return [w for w in self.mgr.store.list("Workload", copy_objects=False)
                if not wlpkg.has_quota_reservation(w)
                and not wlpkg.is_finished(w)]

    def shutdown(self) -> int:
        self.mgr.shutdown()
        for wm in self.workers.values():
            wm.shutdown()
        return self.mgr.cache.live_handouts


def manager_checks(mgr, label: str) -> list:
    """The store after settling: every admitted Workload's Job unsuspended
    and every pending one's suspended, no Workload admitted twice (one
    QuotaReserved event a Workload), each CQ's status (its reservation
    and its usage) the sum of its quota-reserving and of its admitted
    Workloads' requests, the reservation within its quota and borrowing
    limits, and each cohort's within its CQs' quota."""
    from kueue_tpu_torch.core import workload as wlpkg
    failures = []
    store = mgr.store
    jobs = {j.metadata.name: j for j in store.list("Job", copy_objects=False)}
    usage: dict = {"reservation": {}, "usage": {}}
    for wl in store.list("Workload", copy_objects=False):
        job = jobs[wl.metadata.owner_references[0].name]
        if wlpkg.is_finished(wl):
            continue
        admitted = wlpkg.is_admitted(wl)
        if admitted == job.spec.suspend:
            failures.append(f"{label}: {job.metadata.name} suspend "
                            f"{job.spec.suspend}, workload admitted "
                            f"{admitted}")
        if not wlpkg.has_quota_reservation(wl):
            continue
        adm = wl.status.admission
        for part in ("reservation", "usage") if admitted \
                else ("reservation",):
            u = usage[part].setdefault(adm.cluster_queue, {})
            for psa in adm.pod_set_assignments:
                for res, q in psa.resource_usage.items():
                    key = (psa.flavors[res], res)
                    u[key] = u.get(key, 0) + q
    reserved = {}
    for e in mgr.recorder.events:
        if e.reason == "QuotaReserved":
            reserved[e.object_key] = reserved.get(e.object_key, 0) + 1
    twice = sorted(k for k, n in reserved.items() if n > 1)
    if twice:
        failures.append(f"{label}: admitted twice: {twice[:6]}")
    cohort_use, cohort_cap = {}, {}
    for cq in store.list("ClusterQueue", copy_objects=False):
        name = cq.metadata.name
        for part, listed in (("reservation", cq.status.flavors_reservation),
                             ("usage", cq.status.flavors_usage)):
            status = {(fu.name, ru.name): ru.total
                      for fu in listed for ru in fu.resources if ru.total}
            want = {k: v for k, v in usage[part].get(name, {}).items() if v}
            if status != want:
                failures.append(f"{label}: {name} status {part} {status} "
                                f"!= the Workloads' requests {want}")
        want = usage["reservation"].get(name, {})
        for rg in cq.spec.resource_groups:
            for fq in rg.flavors:
                for rq in fq.resources:
                    key = (fq.name, rq.name)
                    used = want.get(key, 0)
                    cap = rq.nominal_quota + (rq.borrowing_limit
                                              if rq.borrowing_limit is not None
                                              else 1 << 62)
                    if used > cap:
                        failures.append(f"{label}: {name} {key} uses {used} "
                                        f"over {cap}")
                    ck = (cq.spec.cohort, key)
                    cohort_use[ck] = cohort_use.get(ck, 0) + used
                    cohort_cap[ck] = cohort_cap.get(ck, 0) + rq.nominal_quota
    over = [k for k, v in cohort_use.items() if v > cohort_cap[k]]
    if over:
        failures.append(f"{label}: cohorts over their quota: {over[:4]}")
    return failures


def manager_state(mgr) -> dict:
    """The store's state, each Workload by its Job's name (names hash the
    owner's uid): every Workload's spec and status, every Job's spec and
    status, every CQ's and LQ's status. A Pending condition's message is
    left out: a head the device route finds no fit for carries the
    batched assignment's message ("couldn't assign flavors: insufficient
    quota (batched assignment)", as the JAX Scheduler's device-NoFit
    heads do), the CPU route's the per-flavor reasons."""
    import dataclasses

    def canon(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            pending = getattr(x, "reason", None) == "Pending"
            return tuple((f.name, canon(getattr(x, f.name)))
                         for f in dataclasses.fields(x)
                         if not (pending and f.name == "message"))
        if isinstance(x, dict):
            return tuple(sorted((str(k), canon(v)) for k, v in x.items()))
        if isinstance(x, (list, tuple)):
            return tuple(canon(v) for v in x)
        return x

    store = mgr.store
    return {
        "workloads": {w.metadata.owner_references[0].name:
                      (canon(w.spec), canon(w.status))
                      for w in store.list("Workload", copy_objects=False)},
        "jobs": {j.metadata.name: (canon(j.spec), canon(j.status))
                 for j in store.list("Job", copy_objects=False)},
        "cluster_queues": {c.metadata.name: canon(c.status) for c in
                           store.list("ClusterQueue", copy_objects=False)},
        "local_queues": {q.metadata.name: canon(q.status) for q in
                         store.list("LocalQueue", copy_objects=False)}}


def state_difference(a: dict, b: dict) -> str:
    for part in a:
        for key in sorted(set(a[part]) | set(b[part])):
            if a[part].get(key) != b[part].get(key):
                return (f"{part} {key}: {str(a[part].get(key))[:600]} != "
                        f"{str(b[part].get(key))[:600]}")
    return ""


def wait_quantiles(metrics) -> dict:
    """The creation-to-admission wait (the journey ledger's
    admission_wait_time histograms, every CQ's series summed): count,
    mean and the p50/p99 bucket estimates, seconds."""
    from kueue_tpu_torch import metrics as metricspkg
    h = metrics.admission_wait_time
    merged = metricspkg.Histogram("merged", "", (), buckets=h.buckets)
    counts = [0] * (len(h.buckets) + 1)
    total, n = 0.0, 0
    for c, s, k in h.series.values():
        counts = [a + b for a, b in zip(counts, c)]
        total += s
        n += k
    merged.series[()] = [counts, total, n]
    return {"count": n, "mean_s": total / n if n else math.nan,
            "p50_s": merged.percentile(0.5), "p99_s": merged.percentile(0.99)}


def route_times(calls: list) -> dict:
    by: dict = {}
    for route, secs in calls:
        by.setdefault(route, []).append(secs * 1e3)
    return {r: {"calls": len(v), "p50_ms": percentile(v, 50),
                "max_ms": max(v)} for r, v in sorted(by.items())}


def manager_mk_objects(store, workers: dict) -> None:
    from kueue_tpu_torch.api import autoscaling as asapi
    from kueue_tpu_torch.api import kueue as api
    from kueue_tpu_torch.api.meta import ObjectMeta
    from kueue_tpu_torch.controller.admissionchecks import multikueue as mk
    for w in sorted(workers):
        store.create(asapi.MultiKueueCluster(metadata=ObjectMeta(name=w)))
    store.create(asapi.MultiKueueConfig(
        metadata=ObjectMeta(name="mk-config"),
        spec=asapi.MultiKueueConfigSpec(clusters=sorted(workers))))
    ac = api.AdmissionCheck(metadata=ObjectMeta(name="mk-check"))
    ac.spec.controller_name = mk.CONTROLLER_NAME
    ac.spec.parameters = api.AdmissionCheckParametersReference(
        kind="MultiKueueConfig", name="mk-config")
    store.create(ac)


class ClusterCalls:
    """Within the block, every call of kernel.score_cluster_columns keeps
    its arguments and result (cloned) beside the solver's topology; the
    launch count stays on the registered wrapper."""

    def __init__(self, kernel, mgr):
        self.kernel, self.mgr = kernel, mgr
        self.real = kernel.score_cluster_columns
        self.calls = []

    @property
    def launches(self) -> int:
        return self.real.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.real.launches = n

    def __call__(self, *args, **kwargs):
        out = self.real(*args, **kwargs)
        self.calls.append((tuple(a.clone() for a in args), out.clone(),
                           self.mgr.scheduler.solver._topo_cache[0]))
        return out

    def __enter__(self):
        self.kernel.score_cluster_columns = self
        return self

    def __exit__(self, *exc):
        self.kernel.score_cluster_columns = self.real


# the main path's kernels held call by call against their plain versions:
# KERNEL_WRAPPERS name -> (the wrapper's name in kernel, its plain version)
CAPTURED_KERNELS = {
    "avail": ("avail", "avail_plain"),
    "phase_a": ("phase_a", "phase_a_plain"),
    "drf_share": ("drf_share", "drf_share_plain"),
    "order": ("order_csr", "order_csr_plain"),
    "phase_b": ("phase_b", "phase_b_plain"),
    "pack": ("pack", "pack_plain"),
    "deltas": ("apply_state_deltas", "apply_state_deltas_plain"),
    "arena_scatter": ("scatter_arena_rows", "scatter_arena_rows_plain"),
    "arena_gather": ("gather_arena", "gather_arena_plain")}
KERNEL_CALLS_LIMIT = 64    # calls kept a kernel


def clone_value(x, to=None):
    """A copy of a call's argument or result: tensors cloned (or moved to
    `to`), dicts, lists and tuples (named ones too) copied through, the
    rest as they are."""
    if isinstance(x, dict):
        return {k: clone_value(v, to) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        vals = [clone_value(v, to) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    if hasattr(x, "clone"):
        return x.to(to, copy=True) if to is not None else x.clone()
    return x


def tensors_of(x) -> list:
    """The tensors of a value, in order, through dicts (by key), lists
    and tuples."""
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in tensors_of(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors_of(v)]
    return [x] if hasattr(x, "clone") else []


class KernelCallShim(Captured):
    """One wrapper's shim in KernelCalls: Captured, keeping a list."""

    def __init__(self, module, name: str):
        super().__init__(module, name)
        self.calls = []

    def __call__(self, *args, **kwargs):
        if len(self.calls) >= KERNEL_CALLS_LIMIT:
            return self.real(*args, **kwargs)
        before = clone_value(args)
        out = self.real(*args, **kwargs)
        self.calls.append((before, dict(kwargs), clone_value(args),
                           clone_value(out)))
        return out


class KernelCalls:
    """Within the block, each wrapper of CAPTURED_KERNELS (those named)
    keeps, for its first KERNEL_CALLS_LIMIT calls, the arguments cloned
    before the call, and the arguments and the result cloned after it
    (K6 and K7a write their arguments in place; a result the next cycle
    writes in place stays as the kernel left it). The clones are queued
    on the call's stream, so they hold the values the kernel read and
    wrote. The launch counts stay on the registered wrappers."""

    def __init__(self, kernel, names):
        self.shims = {name: KernelCallShim(kernel, CAPTURED_KERNELS[name][0])
                      for name in names}

    @property
    def calls(self) -> dict:
        return {name: shim.calls for name, shim in self.shims.items()}

    def __enter__(self):
        for shim in self.shims.values():
            shim.__enter__()
        return self

    def __exit__(self, *exc):
        for shim in self.shims.values():
            shim.__exit__(*exc)


def check_kernel_calls(phase: str, kernel, calls: dict,
                       launches: dict) -> dict:
    """Every captured call on the main path against its plain version on
    the same inputs, on the CPU (where the plain versions are the
    reference: torch's sort on the card orders NaNs otherwise): the
    results and the arguments after the call (K6 and K7a write in place)
    equal element by element. Raises unless every launch of the run was
    captured and equal. Returns {kernel: {calls, shapes}}."""
    cpu = "cpu"
    out = {}
    for name, got in calls.items():
        plain = getattr(kernel, CAPTURED_KERNELS[name][1])
        if len(got) != min(launches[name], KERNEL_CALLS_LIMIT):
            raise AssertionError(f"{phase}: {name} launched {launches[name]} "
                                 f"times, {len(got)} calls captured")
        shapes = set()
        for i, (before, kwargs, after, result) in enumerate(got):
            args = clone_value(before, cpu)
            want = plain(*args, **kwargs)
            label = f"{phase} {name} call {i}"
            have = tensors_of(result) + tensors_of(after)
            need = tensors_of(want) + tensors_of(args)
            if len(have) != len(need):
                raise AssertionError(f"{label}: {len(have)} tensors against "
                                     f"the plain version's {len(need)}")
            compare([f"{label} tensor {j}" for j in range(len(have))],
                    [t.cpu() for t in have], need)
            shapes.add(tuple(tuple(t.shape) for t in tensors_of(result))[:3])
        out[name] = {"calls": len(got), "max_abs_err": 0,
                     "result_shapes": sorted(map(str, shapes))[:4]}
    log(f"[{phase}] every captured kernel call equal to its plain version: "
        + json.dumps(out))
    return out


def launch_columns(args: tuple, topo) -> tuple:
    """The capacity columns one K12 launch was given, as the host
    oracle's dicts: column k offers (flavor, resource) where coffer is
    set, with ccap's capacity, and is active where cactive is."""
    ccap, coffer, cactive = (a.cpu().numpy() for a in args[:3])
    flavors = sorted(topo.flavor_index, key=topo.flavor_index.get)
    resources = sorted(topo.resource_index, key=topo.resource_index.get)
    return tuple((f"column{k}", {
        (flavors[f], resources[r]): int(ccap[k, f, r])
        for f in range(len(flavors)) for r in range(len(resources))
        if coffer[k, f, r]}, bool(cactive[k])) for k in range(len(cactive)))


def manager_mk_run(solver, seed: int) -> tuple:
    """The MultiKueue step on a FakeClock: three worker KueueManagers
    with no solver, the manager's CQs on the mk-check, MANAGER_MK["jobs"]
    Jobs, settled. The manager runs the synchronous cycle (the
    production wiring but the pipeline): a pipelined cycle is dispatched
    on capacity columns stamped before the cycles in flight place, as in
    the JAX package, so it places Jobs on a worker they no longer fit
    and the planned mirrors wait there; with the synchronous cycle every
    cycle reads the columns after the last one's placements. Returns (run, placements by Job name, mirrors by Job
    name: (worker, reserved there) for each worker holding one)."""
    from kueue_tpu_torch.core import workload as wlpkg
    from kueue_tpu_torch.api.meta import FakeClock
    from kueue_tpu_torch.manager import KueueManager
    clock = FakeClock(1000.0)
    workers = {}
    for w in range(MANAGER_MK["workers"]):
        wm = KueueManager(clock=clock)
        worker_cluster(wm.store, MANAGER_MK["num_cqs"], MANAGER_WORKER_POOL)
        wm.run_until_idle()
        workers[f"w{w}"] = wm
    run = ManagerRun(MANAGER_MK, solver, clock=clock,
                     remote_clusters=workers, check="mk-check",
                     label="multikueue", pipeline=False)
    from kueue_tpu_torch.solver import kernel
    run.k12 = ClusterCalls(kernel, run.mgr)
    run.captured = KernelCalls(kernel, CAPTURED_KERNELS)
    with run.k12, run.captured:
        run.intake(manager_jobs(MANAGER_MK["num_cqs"], MANAGER_MK["jobs"],
                                seed + 1))
        run.settle()
    owner = {}
    for wl in run.mgr.store.list("Workload", copy_objects=False):
        owner[f"{wl.metadata.namespace}/{wl.metadata.name}"] = \
            wl.metadata.owner_references[0].name
    placements = {owner[k]: c for k, c in run.mgr.multikueue.planned.items()
                  if k in owner}
    mirrors: dict = {}
    for w, wm in workers.items():
        for wl in wm.store.list("Workload", copy_objects=False):
            key = f"{wl.metadata.namespace}/{wl.metadata.name}"
            if key in owner:
                mirrors.setdefault(owner[key], []).append(
                    (w, wlpkg.has_quota_reservation(wl)))
    return run, placements, mirrors


def manager_phase(device) -> dict:
    """The control plane's main path on the card (see MANAGER): the port's
    KueueManager(cfg, solver=BatchSolver()) at the production defaults,
    the objects created through its store, cycles until settled, a
    finish wave of MANAGER["finishes"] Jobs marked Complete, cycles until
    settled again. Checks (manager_checks): Jobs' suspend flags against
    their Workloads', nothing admitted twice, usage per CQ the admitted
    requests' sum within quota, borrowing limits and the cohort's quota;
    the launches of PHASE_KERNELS["manager"]; every kernel call of the
    run (KernelCalls: avail, phase_a, order, phase_b, pack, deltas and
    the arena's scatter and gather at this path's own shapes) equal to
    its plain version on the same inputs (check_kernel_calls);
    live_handouts 0 after shutdown. Then the paired run: MANAGER_PAIRED
    on a FakeClock with BatchSolver() on the card and with solver=None
    must end in the same store state (manager_state), the card's arm
    taking a device route and launching phase_a and phase_b. Prints the intake Jobs/s, the
    schedule() call's p50 and max per route, the creation-to-admission
    wait from the journey ledger's histograms, the settle times and the
    phase's wall."""
    from kueue_tpu_torch.api.meta import FakeClock
    from kueue_tpu_torch.solver import BatchSolver, kernel
    phase = "manager"
    t_phase = time.perf_counter()
    failures = []
    with collector_paused():
        run = ManagerRun(MANAGER, BatchSolver(device=device), label="main")
        jobs = manager_jobs(MANAGER["num_cqs"],
                            MANAGER["num_cqs"] * MANAGER["jobs_per_cq"], SEED)
        kernel.reset_launch_counts()
        with KernelCalls(kernel, CAPTURED_KERNELS) as captured:
            steps = run.run(jobs, MANAGER["finishes"])
        launches = kernel.launch_counts()
    mgr = run.mgr
    failures += manager_checks(mgr, "main")
    for name in PHASE_KERNELS[phase]:
        if launches[name] <= 0:
            failures.append(f"kernel {name} never launched")
    try:
        captured_calls = check_kernel_calls(phase, kernel, captured.calls,
                                            launches)
    except AssertionError as exc:
        failures.append(str(exc))
        captured_calls = None
    del captured
    sched = mgr.scheduler
    if sched.solver_faults:
        failures.append(f"{sched.solver_faults} device faults")
    gov = mgr.warm_governor
    if gov is None or gov.unwarm_routed or gov.warmup_faults:
        failures.append(f"the governor routed or faulted: {gov and gov.status()}")
    summary = {
        "cqs": MANAGER["num_cqs"], "cohorts": MANAGER["num_cohorts"],
        "flavors": MANAGER["num_flavors"], "jobs": len(jobs),
        "cut": "the backlog: 4,096 Jobs, not the north star's 51,200",
        "setup_s": run.setup_s,
        "intake_jobs_per_s": len(jobs) / steps["intake_s"],
        **steps,
        "admitted": len(jobs) - len(run.pending()),
        "calls_by_route": route_times(run.calls),
        "cycle_counts": dict(sched.cycle_counts),
        "speculation": {"hits": sched.speculation_hits,
                        "aborts": sched.speculation_abort_reasons},
        "wait": wait_quantiles(mgr.metrics),
        "journeys": {k: mgr.journey_ledger.status()[k] for k in (
            "started", "completed", "requeues_per_admission")},
        "launches": launches,
        "kernel_calls_equal_plain": captured_calls,
    }
    held = run.shutdown()
    if held:
        failures.append(f"live_handouts {held} after shutdown")
    del run, mgr, sched
    gc.collect()
    log(f"[{phase}] main: {nvidia_smi()}; " + json.dumps(summary))

    # the paired run: the card against solver=None, on a FakeClock
    states = {}
    for arm, solver in (("card", BatchSolver(device=device)), ("none", None)):
        t0 = time.perf_counter()
        paired = ManagerRun(MANAGER_PAIRED, solver, clock=FakeClock(1000.0),
                            label=f"paired-{arm}")
        kernel.reset_launch_counts()
        out = paired.run(manager_jobs(MANAGER_PAIRED["num_cqs"],
                                      MANAGER_PAIRED["num_cqs"]
                                      * MANAGER_PAIRED["jobs_per_cq"], SEED),
                         MANAGER_PAIRED["finishes"])
        arm_launches = kernel.launch_counts()
        counts = dict(paired.mgr.scheduler.cycle_counts)
        failures += manager_checks(paired.mgr, f"paired-{arm}")
        states[arm] = manager_state(paired.mgr)
        summary[f"paired_{arm}"] = {
            "wall_s": time.perf_counter() - t0,
            "pending_after_first_settle": out["pending_after_first_settle"],
            "admitted": len(states[arm]["workloads"]) - len(paired.pending()),
            "cycle_counts": counts,
            "launches": {k: arm_launches[k] for k in ("phase_a", "phase_b")}}
        if arm == "card" and not (
                any(r.startswith("device") for r in counts)
                and arm_launches["phase_a"] > 0
                and arm_launches["phase_b"] > 0):
            failures.append(f"the paired card arm took no device route: "
                            f"{counts}, launches {arm_launches}")
        paired.shutdown()
    diff = state_difference(states["card"], states["none"])
    if diff:
        failures.append(f"the paired runs end apart: {diff}")
    summary["paired_equal"] = not diff
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[{phase}] paired: " + json.dumps(
        {k: summary[k] for k in ("paired_card", "paired_none",
                                 "paired_equal")}))
    log(f"[{phase}] wall {summary['wall_s']:.1f} s; {nvidia_smi()}")
    if failures:
        raise AssertionError(f"{phase}: " + "; ".join(failures[:12]))
    return summary


def manager_multikueue_phase(device) -> dict:
    """The MultiKueue step (MANAGER_MK): a manager on the card with its
    CQs on the mk-check, three worker KueueManagers with no solver. K12
    launches from MultiKueueController.capacity_columns (the cache's
    remote_capacity_source), and every launch's placements equal the
    plain version's and the host oracle's (synth.cluster_oracle: the
    admitted rows walked in the admit order through
    encode.place_remote_dicts on the columns of that launch,
    launch_columns); every other kernel call equal to its plain version
    (check_kernel_calls); every placement mirrored on its worker and on
    no other, and reserved there; the manager's admitted Workloads
    exactly the placed ones; every worker given placements. (A
    solver=None run of the same step places by the same
    oracle but not on the same columns: the pipeline lands a cycle's
    decisions one or two calls later, after the workers have moved.)"""
    from kueue_tpu_torch.core import workload as wlpkg
    from kueue_tpu_torch.solver import BatchSolver, kernel
    phase = "manager_multikueue"
    t_phase = time.perf_counter()
    failures = []
    with collector_paused():
        kernel.reset_launch_counts()
        run, placed, mirrors = manager_mk_run(BatchSolver(device=device),
                                              SEED)
        launches = kernel.launch_counts()
    failures += manager_checks(run.mgr, "multikueue")
    for name in PHASE_KERNELS[phase]:
        if launches[name] <= 0:
            failures.append(f"kernel {name} never launched")
    try:
        captured_calls = check_kernel_calls(phase, kernel,
                                            run.captured.calls, launches)
    except AssertionError as exc:
        failures.append(str(exc))
        captured_calls = None
    run.captured = None
    admitted = {w.metadata.owner_references[0].name
                for w in run.mgr.store.list("Workload", copy_objects=False)
                if wlpkg.is_admitted(w)}
    bad = sorted(n for n, c in placed.items()
                 if mirrors.get(n) != [(c, True)])
    if bad or not placed:
        failures.append(f"{len(bad)} of {len(placed)} placements not "
                        f"mirrored and reserved on their worker alone: "
                        f"{[(n, placed[n], mirrors.get(n)) for n in bad[:4]]}")
    if admitted != set(placed):
        failures.append(f"admitted and placed differ: "
                        f"{sorted(admitted ^ set(placed))[:6]}")
    unmirrored = sorted(set(mirrors) - set(placed))
    if unmirrored:
        failures.append(f"mirrors without a placement: {unmirrored[:6]}")
    summary = {
        "cqs": MANAGER_MK["num_cqs"], "workers": MANAGER_MK["workers"],
        "jobs": MANAGER_MK["jobs"], "admitted": len(admitted),
        "placements": len(placed),
        "by_worker": {w: sum(1 for c in placed.values() if c == w)
                      for w in sorted(run.workers)},
        "pending": len(run.pending()),
        "calls_by_route": route_times(run.calls),
        "cycle_counts": dict(run.mgr.scheduler.cycle_counts),
        "launches": launches,
        "kernel_calls_equal_plain": captured_calls}
    if not all(summary["by_worker"].values()):
        failures.append(f"a worker took no placement: {summary['by_worker']}")
    calls = run.k12.calls
    if not calls:
        failures.append("cluster_cols was never called")
    rows = placed_rows = 0
    for i, (args, out, topo) in enumerate(calls):
        row = cluster_kernel_check(f"manager call {i}", kernel, args, out,
                                   launch_columns(args, topo),
                                   topo.resources, False)
        rows += row["rows"]
        placed_rows += row["placed"]
    summary["k12_calls"] = len(calls)
    summary["k12_rows"] = {"rows": rows, "placed": placed_rows}
    summary["k12_equal_oracle_every_call"] = bool(calls)
    held = run.shutdown()
    if held:
        failures.append(f"live_handouts {held} after shutdown")
    summary["wall_s"] = time.perf_counter() - t_phase
    log(f"[{phase}] {nvidia_smi()}; " + json.dumps(summary))
    if failures:
        raise AssertionError(f"{phase}: " + "; ".join(failures[:12]))
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
            us for k, us in rows if kernel_record(k, kernel)) / 1e3
    # the phase's kernels that launched in the cycle but of which the
    # trace kept no record (the busy time then reads low)
    out["missing_from_trace"] = [
        name for name in (kernels or PHASE_KERNELS[phase])
        if not any(kernel_record(k, name) for k, _ in rows)]
    log(f"[trace:{phase}] " + json.dumps(out))
    return out


# the main-path phases with a runner of their own (the others run
# e2e_phase; the sharded phase takes the preempt and MultiKueue records)
RUNNERS = {"oracles": oracle_phase,
           "scheduler_partial": scheduler_partial_phase,
           "scheduler_fair": scheduler_phase,
           "scheduler_preempt": scheduler_preempt_phase,
           "scheduler_fair_preempt": scheduler_fair_preempt_phase,
           "scheduler_multikueue": scheduler_multikueue_phase,
           "scheduler_faults": scheduler_faults_phase,
           "scheduler_pipelined": scheduler_pipelined_phase,
           "scheduler_observed": scheduler_observed_phase,
           "manager": manager_phase,
           "manager_multikueue": manager_multikueue_phase}


# the numbers of a wide_phase row that the kernels line carries
WIDE_KEYS = ("ms", "call_ms", "plain_ms", "bound_ms", "max_abs_err")


def parse_args(argv: list):
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of kueue_tpu_torch "
                                 "on one NVIDIA H100.")
    ap.add_argument("--seed", type=int, default=SEED,
                    help="the manager phases' Job requests")
    ap.add_argument("--phase", action="append", default=[],
                    choices=sorted(set(PHASE_KERNELS)
                                   - {"scheduler_sharded"}),
                    help="run only this main-path phase (repeatable) after "
                         "the build; the kernels line is then not printed")
    return ap.parse_args(argv)


def main(argv: list = None) -> int:
    global SEED
    args = parse_args(sys.argv[1:] if argv is None else argv)
    SEED = args.seed
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
    if args.phase:
        # a rehearsal of chosen phases: no kernels line, and the last
        # line says which phases ran
        for phase in args.phase:
            if phase in RUNNERS:
                RUNNERS[phase](device)
            else:
                e2e_phase(device, phase)
        log(f"[wall] {time.perf_counter() - t_start:.1f} s")
        log(smi)
        log(json.dumps({"ok": True, "phases": args.phase, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # the launch floor: an empty kernel's device time, and one with a load
    # and a store, which every small kernel here pays
    from kueue_tpu_torch.solver import kernel as kmod
    floor = {name: profiled_device_ms(fn, 200, f"kq_{name}")
             for name, fn in kmod.launch_floor_fns(device).items()}
    log(f"[floor] device ms a launch: {json.dumps(floor)}")
    results: dict = {}
    for kind in ("north_star", "nested"):
        t0 = time.perf_counter()
        kernel_phase(kind, device, results)
        log(f"[kernels:{kind}] wall {time.perf_counter() - t0:.1f} s")
    wide = wide_phase(device)
    runners = RUNNERS
    e2e, full = {}, None
    for phase in PHASE_KERNELS:
        if phase == "scheduler_sharded":
            e2e[phase] = scheduler_sharded_phase(device, {
                "preempt": e2e["scheduler_preempt"].pop("records"),
                "multikueue": e2e["scheduler_multikueue"].pop("records")})
        else:
            e2e[phase] = runners[phase](device) if phase in runners \
                else e2e_phase(device, phase)
        if phase == "bound_churn":
            # bound churn again with the Cache's full rebuild each cycle:
            # the same decisions, and the snapshot phase of each
            full = e2e_phase(device, "bound_churn", incremental=False,
                             timed=FULL_REBUILD_TIMED)
    churn = e2e["bound_churn"]
    cycles = E2E_WARMUP + FULL_REBUILD_TIMED
    if full["decided"][:cycles] != churn["decided"][:cycles]:
        raise AssertionError("bound churn decided otherwise with full "
                             "snapshot rebuilds")
    churn["full_rebuild"] = {k: full[k] for k in (
        "snapshot", "cycle", "snapshot_stats", "snapshot_modes", "wall_s")}
    log("[bound_churn] the same decisions with full rebuilds; snapshot p50 "
        f"(max) ms: incremental {churn['snapshot']['p50_ms']:.3f} "
        f"({churn['snapshot']['max_ms']:.3f}), full rebuild "
        f"{full['snapshot']['p50_ms']:.3f} ({full['snapshot']['max_ms']:.3f})"
        f"; cycle p50 {churn['cycle']['p50_ms']:.1f} against "
        f"{full['cycle']['p50_ms']:.1f}")
    for phase, summary in e2e.items():
        # the cluster columns ride only the MultiKueue cells' cycles, the
        # combine only the mesh's
        if phase not in ("scheduler_multikueue", "scheduler_sharded",
                         "manager_multikueue") \
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
    # K4 with the global order: the MultiKueue cycle's captured inputs
    results["north_star"]["order"]["with_order"] = \
        e2e["scheduler_multikueue"]["kernel_rows"]["order_with_order"]

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
            "max_abs_err": max([results[k][name]["max_abs_err"]
                                for k in results]
                               + [r["max_abs_err"] for key, r in wide.items()
                                  if key.startswith(name)]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "bound_bytes": row["bytes"], "library_ms": row["library_ms"],
            "ms_source": row["ms_source"], "call_ms": row["call_ms"],
            # an empty kernel's device time: the least any launch takes
            "launch_floor_ms": floor["empty"],
            "launch_floor_load_store_ms": floor["load_store"],
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
                           "global_scan") else {}),
            **({"latency_bound": f"{row['dependent_steps']} dependent steps "
                                 "of the chunked pipeline (stages + chunks "
                                 "of 32 rows - 1), its takes left out",
                "dependent_steps": row["dependent_steps"]}
               if name == "cluster_cols" else {}),
            **({"inputs": "the oracle phase's north-star kernel inputs, "
                          "fair sharing off",
                "fit_steps": row["fit_steps"], "phase_b_ms": row["phase_b_ms"],
                "global_over_phase_b": row["global_over_phase_b"]}
               if name == "global_scan" else {}),
            **({"inputs": "the scheduler multikueue phase's first timed "
                          "cycle",
                "rows": row["rows"], "placed": row["placed"],
                "unplaced": row["unplaced"],
                **{key: row[key] for key in
                   ("pipeline_rows", "live_stages", "stage_warps",
                    "stages_per_warp", "chunk_steps", "least_tick_cycles",
                    "sm_clock_khz", "latency_bound_ms",
                    "row_pipeline_bound_ms", "plan_rule",
                    "plan_register_r", "plan_registers")},
                "wide": {label: {key: wide[f"cluster_cols_{label}"][key]
                                 for key in WIDE_KEYS + (
                                     "chunk_steps", "live_stages",
                                     "stage_warps", "latency_bound_ms",
                                     "placed", "plan_rule",
                                     "plan_register_r", "plan_registers",
                                     "plan_local_bytes")}
                         for label in WIDE_K12}}
               if name == "cluster_cols" else {}),
            **({"wide": {"r32": {key: wide["phase_a"][key]
                                 for key in WIDE_KEYS + ("form",)},
                         "r17": {key: wide["phase_a_r17"][key]
                                 for key in WIDE_KEYS + ("form",)}}}
               if name == "phase_a" else {}),
            # the form each launch took and its latency bound: one global
            # round trip and the steps (phase_b) or two and the reductions
            # (phase_a) in the least cycles measured on this card
            **({key: row[key] for key in ("form", "latency_bound_ms")}
               if name in ("phase_a", "phase_b", "order", "arena_gather",
                           "arena_scatter", "pack", "drf_share", "deltas",
                           "global_scan")
               else {}),
            **({"nested_form": results["nested"][name]["form"],
                "nested_latency_bound_ms":
                    results["nested"][name]["latency_bound_ms"]}
               if name in ("phase_a", "phase_b", "order", "arena_gather",
                           "arena_scatter", "pack", "drf_share", "deltas",
                           "global_scan")
               else {}),
            # K3 on the fair cell's captured inputs and WIDE_K3's shapes,
            # K6 on WIDE_K6's
            **({"captured": {key: e2e["scheduler_fair"]["drf_share_check"]
                             ["row"][key] for key in WIDE_KEYS + (
                                 "shape_W_F_R", "form", "latency_bound_ms")}}
               if name == "drf_share" else {}),
            **({"wide": {key[len(name) + 1:]: {
                k2: r[k2] for k2 in WIDE_KEYS + (
                    ("shape_W_F_R", "form", "latency_bound_ms")
                    if name == "drf_share" else
                    ("D", "L", "coords", "shared_level_coords", "form",
                     "latency_bound_ms"))}
                for key, r in wide.items() if key.startswith(name + "_")}}
               if name in ("drf_share", "deltas") else {}),
            # K4: the global order on the MultiKueue cycle's inputs, and
            # the wide shapes; K7b: the odd-width and misaligned twins
            **({"with_order": {key: row["with_order"][key] for key in
                               WIDE_KEYS + ("form", "W")},
                "wide": {label: {key: wide[f"order_{label}"][key] for key in
                                 WIDE_KEYS + ("form", "W", "D",
                                              "with_order_ms",
                                              "card_plain_differs")}
                         for label in WIDE_K4}}
               if name == "order" else {}),
            **({"wide": {label: {key: wide[f"arena_gather_{label}"][key]
                                 for key in WIDE_KEYS + ("form",
                                                         "library_ms")}
                         for label in WIDE_K7B}}
               if name == "arena_gather" else {}),
            **({"wide": {label: {key: wide[f"arena_scatter_{label}"][key]
                                 for key in WIDE_KEYS + ("form",
                                                         "library_ms")}
                         for label in WIDE_K7A}}
               if name == "arena_scatter" else {}),
            # K14 in each form, forced, on the same inputs
            **({"forms": row["forms"],
                "nested_forms": results["nested"][name]["forms"]}
               if name == "global_scan" else {}),
            **({"occupied_columns": row["occupied_columns"],
                "nested_occupied_columns":
                    results["nested"][name]["occupied_columns"]}
               if name == "phase_b" else {}),
            **({"inputs": "the scheduler preempt phase's first timed cycle",
                "wide_k131072": {key: wide["solve_preempt"][key] for key in
                                 WIDE_KEYS + ("index_bits", "rule",
                                              "arena_bytes")},
                "rounds_max": row["rounds_max"],
                "rounds_mean": row["rounds_mean"],
                **{key: row[key] for key in PREEMPT_PLAN_KEYS},
                "global": {key: e2e["scheduler_preempt"]["kernel_rows"]
                           ["global"][key] for key in
                           ("ms", "call_ms", "plain_ms", "bound_ms",
                            "shape_B_K_QL_RF_CL_DC", *PREEMPT_PLAN_KEYS)}}
               if name == "solve_preempt" else {}),
            **({"inputs": "the scheduler fair preempt phase's first timed "
                          "cycle",
                "pops_max": row["pops_max"], "pops_mean": row["pops_mean"],
                "fillback_max": row["fillback_max"],
                **{key: row[key] for key in FAIR_PLAN_KEYS + (
                    "ptxas_registers", "ptxas_spill_bytes", "step_cycles",
                    "load_cycles", "sm_clock_khz", "latency_bound_ms")},
                "nested_latency_bound_ms":
                    results["nested"][name]["latency_bound_ms"],
                "forms": {label: {key: e2e["scheduler_fair_preempt"]
                                  ["kernel_rows"][label][key] for key in
                                  ("ms", "call_ms", "plain_ms", "bound_ms",
                                   "latency_bound_ms",
                                   "shape_B_K_QL_RF_CL_DC", "form",
                                   "lane_per_cq", "arena_bytes")}
                          for label in ("captured global", "nested global",
                                        "ql64")}}
               if name == "solve_fair" else {}),
            **({"wide": {label: {key: wide[f"pack_{label}"][key]
                                 for key in WIDE_KEYS + ("W", "PR")}
                         for label in WIDE_K8}}
               if name == "pack" else {}),
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
        + json.dumps({p: round(e2e[p]["wall_s"], 1) for p in e2e})
        + f", bound churn's full-rebuild run {full['wall_s']:.1f} s"
        + f", wide {wide['wall_s']:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
