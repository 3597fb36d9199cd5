"""One admission cycle: heads -> snapshot -> nominate -> sort -> admit.

The port of kueue_tpu/scheduler/scheduler.py's synchronous cycle
(reference: pkg/scheduler/scheduler.go:197-353, the MultiplePreemptions
path):

1. queues.heads(): one head per ClusterQueue
2. cache.snapshot(): by default an incremental one (cache/incremental.py),
   released back to the cache when the cycle ends
3. nominate: per-head validation, flavor assignment, preemption targets
4. sort by borrows -> DRF share -> priority -> FIFO
5. sequential admit with intra-cycle usage accounting: skip overlapping
   preemption targets, re-check fit after earlier admissions, reserve
   capacity for blocked preemptors
6. requeue the heads not admitted, with Pending condition patches

With a BatchSolver (route "device": a solver is set and the cycle has
at least `solver_min_heads` heads) the solve stage replaces steps 3-5
for the heads the device fits: the solver, bound to this scheduler's
Cache and Manager, solves the cycle against its device-resident state
with one device sync, and the heads it did not fit are nominated on
the CPU against the pre-cycle snapshot before the device's admissions
are accounted on it. With fair sharing on, the device orders the admits
by DRF share (kernel.drf_share). The preempt-mode heads among them get
their targets, still against the pre-cycle snapshot, from the CPU
Preemptor or, where the JAX Scheduler's work gate picks the device, from
the batched solves (solver/candidates.py): minimal preemption
(solver/preempt.py, kernel.solve_preempt, K9) and, with fair sharing on,
fair-sharing preemption for the heads with candidates in their cohort
(solver/fairpreempt.py, kernel.solve_fair, K11), both launched once more
against the usage the cycle's dispatch read, with one sync for the two.
The heads with PartialAdmission on in a Never/Never CQ search their
reduced pod counts together (BatchSolver.batched_partial_admission,
Phase A on the card once per lockstep round, against that same usage)
and get one flavor assignment each at the counts found.
Otherwise (route "cpu-forced") the CPU path runs the whole cycle.

Routing (kueue_tpu/scheduler/scheduler.py:460-512, :1020-1071):
`solver_routing` is "always" by default (the device route whenever the
cycle is wide enough), "never" (the CPU path, "cpu-forced") or
"adaptive": each cycle runs on the engine with the better median
admitted/s over its last 8 samples for the predicted regime ("fit" or
"preempt", the last cycle's), an engine with fewer than 2 samples
first, the other one probed every 16 cycles of the regime (every 64
when its rate is below a quarter of the best); an adaptive CPU cycle is
"cpu". Degraded cycles and the intervention routes take no sample. The
starvation bound: once a preempt-mode head has been blocked (no
feasible targets) for `strict_after_blocked_cycles` observed cycles
in a row (8 by default, 0 disables it), device-routed cycles run the
CPU path as "cpu-strict" (full reference semantics: the blocked
preemptor reserves before later heads admit) until it admits, turns
infeasible or goes away; a cycle with no preempt-mode head keeps the
evidence for a grace of the bound's length, then decays it by one a
cycle (at once while the bound is engaged), and a plan the ladder
deferred never counts. With a compile governor (`warm_gov`,
solver/warmgov.py) a device cycle whose width bucket is not warm runs
"cpu-warmup" and asks the governor to warm it; a solver on the card
has nothing to warm, so its governor never diverts a cycle. The order
of the gates: cpu-strict, cpu-survival, cpu-warmup, then the breaker
(cpu-breaker), so that no other gate takes a half-open probe.

The observability plane (obs/, metrics.py), as kueue_tpu/manager.py
wires it: every cycle that pops heads leaves a CycleTrace in `recorder`
(a FlightRecorder, made when none is given): route, regime, heads,
admitted, evictions, faults, breaker, degraded rung, the transport
deltas (upload and fetch bytes, dispatches, collects), the phase spans
(the Scheduler's and, through `solver.bind_recorder`, the solver's) and
the annotations (fault, breaker-closed, shed, degrade, preempt-plan,
speculation-abort, pipeline-flush, the solver's compile). With
`metrics` (a Registry) the cycle feeds the JAX Scheduler's metrics, the
cycle_phase_seconds histograms from the trace's span sums. With
`journeys` (a JourneyLedger on the Manager's journey listener) every
admit, requeue, shed and preemption stamps its workload's journey, and
the ledger is then the one producer of the wait-time histograms; with
`aging` (an AgingWatch) the watch samples at every seal; with
`query_plane` (a QueryPlane) every seal publishes a read view (the
cycle's nominate order and, on a synchronous cycle, its snapshot
handout, whose ownership passes to the plane: `cache.live_handouts`
then counts what the plane holds). `leader_check` (a callable, None =
standalone): a non-leader call abandons every in-flight cycle
undecoded and returns SlowDown; `cq_filter` restricts every heads pop
to the CQs it accepts; `admitted_total` counts the admissions.

Device-fault containment (the port of kueue_tpu/resilience, as the JAX
Scheduler wires it, kueue_tpu/scheduler/scheduler.py:1073-1193): a
Scheduler has a CircuitBreaker (`breaker`), a DispatchWatchdog
(`watchdog`) and a DegradationLadder (`ladder`, off at its default
budget of 0). The solver's dispatch runs supervised under the
watchdog's cold clamp and its collect under the watchdog's deadline. A
DeviceFault on the device route (an injected fault, a DispatchTimeout or
SupervisedTimeout, a corrupt output caught by the solver's checks, an
abandoned dispatch) is counted in `solver_faults`, fed to the breaker,
drops the solver's resident state and sends the cycle's heads to CPU
nomination: the cycle finishes on the CPU, on the route it was given.
Three consecutive faults open the breaker: cycles take the
"cpu-breaker" route until the backoff passes and a half-open probe
cycle on the device closes it. Under load the ladder caps the heads
and defers preemption planning ("shed"), then also pins the cycle to
the CPU ("cpu-survival"). `on_fault(kind, message)` hears of faults,
trips, recoveries and the ladder's moves.

Differences from the JAX Scheduler, on this synchronous path:
- The JAX Scheduler predicts the non-fit heads before the sync with a
  host-side router (its solver's `_route`) and runs their preemption
  problems in the same device program as the fit solve. The port reads
  the non-fit heads from the device's decisions after the sync, so the
  device is dispatched even when no head fits, and K9 and K11 are
  launched after it, back to back, with one more sync for both, against
  the same pre-cycle usage. The choices and the targets are the same;
  the work gate is ported unchanged, so it still counts the sync as
  shared when fit heads dispatch (never under a mesh, as the JAX
  Scheduler's).
- Containment is narrowed to DeviceFault and its subclasses
  (InjectedFault, DispatchTimeout, SupervisedTimeout, the solver's
  output and scatter checks, the abandoned dispatch). The JAX Scheduler
  sends any Exception of the device path to the CPU: of the solver's
  prepare (scheduler.py:1905, and :1392 on its pipelined path), of the
  device solve (:2084), of the preemption encode (:2064) and of the
  batched partial admission (:2189). Here every other exception
  propagates: an nvcc build failure, a kernel wrapper's raise on a
  CUDA tensor, a CUDA launch or runtime error from torch, a host bug.
  A counted CPU route for those would be a fallback that hides the
  kernel.
- A device solve fault sends every validated head to CPU nomination;
  the JAX Scheduler had already nominated the heads its router
  predicted would not fit (with the device-NoFit shortcut's generic
  message), so the admissions are the same and some Pending messages
  are the per-flavor ones.
- A scrambled arena scatter is a counted fault here (the arena notes
  the injected scramble and collect raises InjectedFault); the JAX
  Scheduler's host router sends the heads the mangled rows deny to the
  CPU without a fault.
- The synchronous device cycle runs no fit router, so its trace has no
  "route" span and the non-fit heads' "nominate" span comes after the
  "fetch" and "decode" spans; the port's own intervals are dotted spans
  (apply.device: the device admissions, which the JAX Scheduler times
  in no span; preempt-plan.solve and preempt-plan.decode: K9/K11's
  launch and their decode; fetch.device: the wait; nominate.partial).
- Not ported yet: `fencing_check`'s setters, `standby_status`,
  `shards_status` and `last_promotion`; they wait for the replicas and
  the shards (ROADMAP item 6).

The threaded loop (kueue_tpu/scheduler/scheduler.py:365-388): `start()`
runs `schedule(timeout=0.2)` on a daemon thread under
utils/wait.until_with_backoff (KeepGoing re-runs at once, SlowDown backs
off 1 ms doubling to 100 ms); `stop()` ends it, releases a snapshot
parked for a seal and abandons an in-flight pipelined cycle.

The speculative pipeline (kueue_tpu/scheduler/scheduler.py:1207-1876,
kueue_tpu/scheduler/PIPELINE.md): with `pipeline_enabled` (off by
default, as in the JAX package) a device cycle that passes the gate
(_pipeline_ok: the breaker closed, the ladder below survival, a bound
solver, no pods-ready tracking, no StrictFIFO CQ) takes a light
snapshot, prepares with the fit router (BatchSolver.prepare(...,
route=True): Phase A on the card against the host mirror), dispatches
without waiting, starts the decisions' fetch, stamps a
stages.SpeculationToken and collects the oldest in-flight cycle a call
later (`pipeline_depth` 1 or 2). The token is validated before the next
dispatch and again before commit; an abort requeues the cycle's heads
undecoded (and every later queued cycle's, "chained"), drops the
resident state and cools the next cycle down to the synchronous path.
Predicted non-fit heads that may preempt (at most a quarter of the
heads, no fair sharing, no partial admission) ride the dispatch as a K9
batch (kernel.solve_cycle_with_preempt) and their evictions are issued
at collect (_collect_pipelined_preempt). `speculation_hits`,
`speculation_aborts` and `speculation_abort_reasons` count the
outcomes; `cycle_counts` adds "device-pipelined" (collected cycles),
"device-dispatch-only", "device-nofit" and "pipelined-preempt", and
`last_route` is the pipelined cycle's shape.

Differences from the JAX Scheduler on the pipelined path:
- Containment is narrowed to DeviceFault, as on the synchronous path:
  the JAX Scheduler sends any Exception of the pipelined prepare
  (scheduler.py:1286), dispatch (:1392), preemption encode (:1526) and
  collect (:1604) to its fallback; here every other exception
  propagates (the preemption encode's releases its snapshot first).
- The router is Phase A on the solver's device (avail and phase_a on
  the card), not a program on a local CPU backend; its fit bits are the
  same. The synchronous path still reads the non-fit heads after its
  sync and runs no router.
- The started fetch is pinned copies and an event on the launches'
  stream, not a thread pool: an abandoned cycle's event is never waited
  on again, so nothing is orphaned (no _abandon_fetch).
- `last_route` names the pipelined cycle's shape, as the JAX
  Scheduler's trace does.

With a mesh solver (`BatchSolver(mesh=...)`, the sharded cycle of
parallel/mesh.py) the Scheduler takes the JAX Scheduler's two mesh
routes (kueue_tpu/scheduler/scheduler.py:1952-1957, :1988): under fair
sharing the CPU Preemptor picks every preempt-mode head's targets at
nomination (the sharded solve carries only minimal preemption), and the
preemption work gate never counts the sync as shared with the fit
heads.

MultiKueue placements: with `on_placement` set (a callable taking the
workload key and a cluster name), every admitted head whose CQ carries a
MultiKueue check gets a remote cluster at admission time. One flush per
cycle, at the end of the apply stage (`_flush_mk_placements`): the rows
the device placed are pinned to the fused solve's mk_cluster choice
(`solver.last_placements`), and the rest run the sequential oracle
(encode.place_remote_dicts) against the snapshot's capacity columns,
continuing from the pinned rows' consumption.

Each cycle's phase times (seconds) are in `last_phase_s`: heads,
snapshot, nominate, preempt-plan, decode-targets, apply and requeue
here, and on the device route the solver's own (encode, upload, device,
fetch, decode, preempt) in `solver.last_phase_s`; the traces carry the
same intervals as spans. The last device preemption solves' stats are
in `last_preempt_plan`.
"""

from __future__ import annotations

import threading
import time as _time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from kueue_tpu_torch import features
from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.corev1 import RESOURCE_PODS
from kueue_tpu_torch.api.meta import REAL_CLOCK, Clock
from kueue_tpu_torch.cache import Cache, Snapshot
from kueue_tpu_torch.cache.snapshot import ClusterQueueSnapshot
from kueue_tpu_torch.core import limitrange as limitrangepkg
from kueue_tpu_torch.core import priority as prioritypkg
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.core.resources import container_limits_violations
from kueue_tpu_torch.obs.recorder import FlightRecorder
from kueue_tpu_torch.queue import Manager, RequeueReason
from kueue_tpu_torch.resilience import faultinject
from kueue_tpu_torch.resilience.breaker import CLOSED, CircuitBreaker
from kueue_tpu_torch.resilience.degrade import NORMAL, DegradationLadder
from kueue_tpu_torch.resilience.faultinject import DeviceFault
from kueue_tpu_torch.resilience.supervisor import SupervisedTimeout
from kueue_tpu_torch.resilience.watchdog import (
    DispatchTimeout,
    DispatchWatchdog,
)
from kueue_tpu_torch.scheduler import flavorassigner as fa
from kueue_tpu_torch.scheduler import stages
from kueue_tpu_torch.scheduler.podset_reducer import PodSetReducer
from kueue_tpu_torch.scheduler.preemption import (
    Preemptor,
    make_reclaim_oracle,
    parse_strategies,
)
from kueue_tpu_torch.solver import encode as solver_encode
from kueue_tpu_torch.solver import fairpreempt
from kueue_tpu_torch.solver import preempt as devpreempt
from kueue_tpu_torch.solver.candidates import candidate_index
from kueue_tpu_torch.utils import vlog
from kueue_tpu_torch.utils.wait import (
    KeepGoing,
    SlowDown,
    SpeedSignal,
    until_with_backoff,
)

# entry statuses (reference: scheduler.go:355-366)
NOT_NOMINATED = ""
NOMINATED = "nominated"
SKIPPED = "skipped"
ASSUMED = "assumed"

# The starvation bound's default (kueue_tpu/config.py:142).
DEFAULT_STRICT_AFTER_BLOCKED_CYCLES = 8

# Routes that are interventions, not engine choices: never a router
# sample (kueue_tpu/scheduler/scheduler.py:1058-1071).
ROUTABLE = ("device", "cpu")

# the scheduler's own phases of a cycle, timed in last_phase_s
CYCLE_PHASES = ("heads", "snapshot", "nominate", "preempt-plan",
                "decode-targets", "apply", "requeue")


@dataclass
class Entry:
    info: wlpkg.Info
    assignment: fa.Assignment = field(default_factory=fa.Assignment)
    preemption_targets: list = field(default_factory=list)
    dominant_resource_share: int = 0
    dominant_resource_name: str = ""
    status: str = NOT_NOMINATED
    inadmissible_msg: str = ""
    requeue_reason: RequeueReason = RequeueReason.GENERIC

    def net_usage(self) -> dict:
        """Capacity needed net of preempted resources
        (reference: scheduler.go:385-400)."""
        if self.assignment.representative_mode() == fa.FIT:
            return self.assignment.usage
        usage = dict(self.assignment.usage)
        for target in self.preemption_targets:
            for fr, v in target.workload_info.flavor_resource_usage().items():
                if fr in usage:
                    usage[fr] = max(0, usage[fr] - v)
        return usage


class SchedulerClient:
    """Host-environment interface for the scheduler's reads/writes.

    The reference talks to the kube-apiserver; the sim (sim/northstar.py)
    and the tests implement this.
    """

    def namespace_labels(self, namespace: str) -> Optional[dict]:
        return {}

    def limit_ranges(self, namespace: str) -> list:
        return []

    def apply_admission(self, wl: api.Workload) -> None:
        """Persist admission status. Raise KeyError if deleted."""

    def patch_not_admitted(self, wl: api.Workload) -> None:
        """Persist the Pending/QuotaReserved=False condition."""

    def event(self, wl: api.Workload, event_type: str, reason: str,
              message: str) -> None:
        pass


class Scheduler:
    def __init__(self, queues: Manager, cache: Cache, client: SchedulerClient,
                 ordering: Optional[wlpkg.Ordering] = None,
                 fair_sharing_enabled: bool = False,
                 fs_preemption_strategies: Optional[list] = None,
                 clock: Clock = REAL_CLOCK,
                 metrics=None,
                 solver=None, solver_min_heads: int = 64,
                 recorder: Optional[FlightRecorder] = None):
        self.queues = queues
        self.cache = cache
        self.client = client
        self.ordering = ordering or wlpkg.Ordering()
        self.fair_sharing_enabled = fair_sharing_enabled
        self.clock = clock
        self.attempt_count = 0
        # cumulative admissions of this scheduler's cycles
        self.admitted_total = 0
        # metrics.Registry, or None (kueue_tpu/scheduler/scheduler.py:126)
        self.metrics = metrics
        self.log = vlog.logger("scheduler")
        # The cycle flight recorder (obs/recorder.py): every schedule()
        # that popped heads leaves a CycleTrace (route, regime, phase
        # spans, annotations) in a bounded ring; the solver's phases land
        # in the same trace.
        self.recorder = recorder if recorder is not None \
            else FlightRecorder()
        # Optional kueue_tpu_torch.solver.BatchSolver: the batched
        # fit-mode admission on the card, bound to this cache (resident
        # usage, reconciled through the usage journal) and these queues
        # (the encode arena). Attached later, it is bound at the next
        # schedule().
        self.solver = solver
        if solver is not None:
            solver.bind_cache(cache)
            solver.bind_queues(queues)
            solver.bind_recorder(self.recorder)
        # Below this head count the cycle runs on the CPU path even with
        # a solver (0 = always solve).
        self.solver_min_heads = solver_min_heads
        # Routing (kueue_tpu/scheduler/scheduler.py:180-195): "always"
        # pins the device route (the default), "never" the CPU, and
        # "adaptive" runs each cycle on the engine with the better median
        # admitted/s for its predicted regime ("fit" or "preempt"),
        # exploring the other one every 16 cycles (64 when it loses by
        # more than 4x). _route_stats: {(engine, regime): [(progress,
        # seconds), ...]}, the last 8 samples.
        self.solver_routing = "always"
        self._route_stats: dict = {}
        self._route_explore: dict = {"fit": 0, "preempt": 0}
        # The starvation bound (kueue_tpu/scheduler/scheduler.py:208-221):
        # once a preempt-mode head has been blocked (no feasible targets)
        # for this many observed cycles in a row, device-routed cycles run
        # the strict CPU path ("cpu-strict", full reference semantics:
        # the blocked preemptor reserves before later heads admit) until
        # it no longer blocks. 0 disables the bound.
        self.strict_after_blocked_cycles = DEFAULT_STRICT_AFTER_BLOCKED_CYCLES
        # The compile governor (solver/warmgov.py) when attached: a cycle
        # whose width bucket has no warm programs runs "cpu-warmup" and
        # the governor warms the bucket in the background.
        self.warm_gov = None
        # The preemption work gate (kueue_tpu/scheduler/scheduler.py:
        # 401-410, ported with its constants): the device preemptor saves
        # about preempt_cand_us of CPU simulation per candidate, which
        # must cover the marginal sync; solver_sync_floor_ms overrides the
        # measured floor (solver.estimated_sync_ms(); 0 sends every
        # preemption with candidates to the device, and a preempt_cand_us
        # of 0 every one to the CPU Preemptor).
        self.solver_sync_floor_ms: Optional[float] = None
        self.preempt_cand_us = 8.0  # minimal preemptor: simulate/candidate
        self.fair_cand_us = 3.0     # fairPreemptions: share compare/cand
        # The last device preemption solves' stats (summed over problems,
        # "minimal" for K9 and "fair" for K11) and the gate's last
        # choice, "cpu" or "device".
        self.last_preempt_plan: dict = {}
        self.last_preempt_gate = ""
        self.cycle_counts: dict = {}  # route -> cycles
        self.last_route = ""
        # Device-fault containment (kueue_tpu/scheduler/scheduler.py:
        # 103-138): the breaker pins cycles to "cpu-breaker" after
        # consecutive faults and re-admits the device through half-open
        # probes; the watchdog gives the dispatch and the collect their
        # deadlines (None: neither is bounded); the ladder, off at its
        # default budget of 0, sheds heads and preemption planning under
        # load and pins "cpu-survival".
        self.breaker = CircuitBreaker()
        self.watchdog: Optional[DispatchWatchdog] = DispatchWatchdog()
        self.ladder = DegradationLadder()
        self.solver_faults = 0      # device faults contained (total)
        self._cycle_faults = 0      # device faults within this cycle
        self.preemption_fallbacks = 0  # preemption solves sent to the CPU
        # on_fault(kind, message): "fault", "breaker-open",
        # "breaker-closed", "degrade", "degrade-recovered"
        self.on_fault: Optional[Callable[[str, str], None]] = None
        self.shed_heads_requeued = 0   # heads re-heaped by the cap (total)
        self.preempt_plans_deferred = 0  # deferred preempt plans (total)
        self._cycle_degraded = NORMAL  # ladder state this cycle ran under
        self._degrade_deferred = 0     # preempt plans deferred this cycle
        self._drain_cost = 0.0  # pipeline-drain seconds within this cycle
        # the solver's transport counters at the cycle's start
        # (_io_counters): _finish_trace stamps the cycle's deltas
        self._cycle_io0 = (0, 0, 0, 0)
        # The cycle's snapshot handout between its take and its retire,
        # so that the next cycle releases one a raise left behind.
        self._cycle_snapshot = None
        # The query plane (obs/queryplane.py) when attached: every cycle
        # seal publishes a read view (the cycle's nominate order and, on
        # a synchronous cycle, its snapshot handout, whose ownership
        # passes to the plane instead of back to the cache).
        self.query_plane = None
        self._cycle_order: Optional[list] = None
        self._seal_snapshot = None  # the handout awaiting the seal
        # The journey ledger (obs/journey.py) and the aging watch
        # (obs/trend.py) when attached; None costs one is-None compare at
        # each site.
        self.journeys = None
        self.aging = None
        # HA (kueue_tpu/scheduler/scheduler.py:335-337): only the leader
        # runs cycles; a non-leader call abandons every in-flight cycle
        # undecoded and returns SlowDown. None = standalone.
        self.leader_check: Optional[Callable[[], bool]] = None
        # cq_filter(cq name) -> bool, threaded into every heads() pop:
        # the CQs an admission shard owns. None pops every CQ.
        self.cq_filter: Optional[Callable[[str], bool]] = None
        self.last_phase_s = dict.fromkeys(CYCLE_PHASES, 0.0)
        self.preemptor = Preemptor(
            ordering=self.ordering,
            enable_fair_sharing=fair_sharing_enabled,
            fs_strategies=parse_strategies(fs_preemption_strategies),
            clock=clock,
            apply_preemption=self._apply_preemption)
        # MultiKueue placement sink (kueue_tpu/scheduler/scheduler.py:333):
        # on_placement(workload key, cluster name) for every admitted head
        # of a CQ with a MultiKueue check, resolved by the cycle's flush.
        self.on_placement = None
        self._mk_admits: list = []  # (Info, cq snapshot) this cycle
        # The speculative pipeline (kueue_tpu/scheduler/scheduler.py:
        # 146-179, kueue_tpu/scheduler/PIPELINE.md): overlap the solve of
        # cycle N with the apply of cycle N-1. Every dispatch carries a
        # generation stamp (stages.SpeculationToken), validated before
        # the result may commit; a mis-speculation abandons the in-flight
        # result and the next cycle runs synchronously. Off by default,
        # as in the JAX package: decisions land one cycle later.
        self.pipeline_enabled = False
        # In-flight speculative cycles, oldest first. Depth 1 reproduces
        # the single-slot pipeline; depth 2 lets dispatch N+2 launch while
        # N's decisions are still on their way. Deeper than 1 only when
        # every queued dispatch carries a token; one mis-speculation
        # aborts every queued cycle (they chain on the same device state).
        self._inflight_q: deque = deque()
        self.pipeline_depth = 1
        self._pipeline_cooldown = 0
        # hits: validated and committed speculative cycles; aborts:
        # mis-speculations, by validation reason
        self.speculation_hits = 0
        self.speculation_aborts = 0
        self.speculation_abort_reasons: dict = {}
        # the shape the last _schedule_pipelined call took:
        # device-pipelined, device-dispatch-only or device-nofit
        self._pipeline_trace_route = "device-pipelined"
        self._drained_admitted = None  # last _drain_pipeline's admissions
        self._last_cycle_admitted = 0
        self._cycle_evictions = 0  # evictions issued within this cycle
        self._cycle_regime = "fit"  # observed regime of the cycle run
        self._last_regime = "fit"   # sticky regime predictor
        # the starvation bound's feed: consecutive blocked cycles, and
        # consecutive cycles without a preempt-mode head
        self._blocked_preempt_streak = 0
        self._preemptless_cycles = 0
        # fencing_check() -> bool: False aborts an in-flight speculation
        # at its commit point ("fenced"; kueue_tpu/scheduler/
        # scheduler.py:338-344). Its setters (replicas, shards) are not
        # ported yet.
        self.fencing_check: Optional[Callable[[], bool]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- lifecycle ---

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="scheduler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.queues.broadcast()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # A snapshot parked for a seal that never happened (a raise
        # mid-cycle) must not outlive the scheduler.
        self._flush_seal_snapshot()
        # Never strand an in-flight speculative cycle: its handout goes
        # back to the cache and its device residency and arena claims
        # drop, or a solver reused by another Scheduler would chain its
        # first cycle on this one's usage mirror.
        if self._inflight is not None:
            self._abandon_pipeline()

    def _run(self) -> None:
        until_with_backoff(self._stop, lambda: self.schedule(timeout=0.2))

    # --- the cycle ---

    def schedule(self, timeout: Optional[float] = None) -> SpeedSignal:
        if self.leader_check is not None and not self.leader_check():
            # A non-leader: an in-flight cycle is abandoned, not drained
            # (the new leader may admit the same heads).
            if self._inflight is not None:
                self._abandon_pipeline()
            return SlowDown
        self.attempt_count += 1
        self.last_phase_s = dict.fromkeys(CYCLE_PHASES, 0.0)
        if self.solver is not None:
            # Solvers attached after construction still get the
            # journal-backed resident state, the encode arena and the
            # recorder.
            if not self.solver.resident_capable:
                self.solver.bind_cache(self.cache)
            self.solver.bind_queues(self.queues)
            if self.solver._recorder is not self.recorder:
                self.solver.bind_recorder(self.recorder)
        t_ph = _time.perf_counter()
        heads = self.queues.heads(timeout=timeout, cq_filter=self.cq_filter)
        self._span("heads", t_ph)
        if not heads:
            if self._inflight is not None:
                # The headless drain: no heads, a cycle in flight. Traced
                # under its own route, with heads=0 (the drained cycle's
                # heads were counted by the cycle that dispatched them).
                trace = self.recorder.begin_cycle(self.attempt_count)
                self._journey_begin_cycle("drain")
                self._cycle_evictions = 0
                self._cycle_faults = 0
                self._cycle_io0 = self._io_counters()
                self._cycle_order = None
                self._flush_seal_snapshot()
                self._cycle_degraded = self.ladder.state
                sig = self._drain_pipeline()
                self.last_route = "drain"
                self._finish_trace(trace, "drain", heads=0,
                                   admitted=self._drained_admitted)
                return sig
            self._observe_idle()
            return KeepGoing
        start = self.clock.now()
        wall0 = _time.perf_counter()
        trace = self.recorder.begin_cycle(self.attempt_count)
        self._journey_begin_cycle()
        self._drain_cost = 0.0
        self._cycle_faults = 0
        self._cycle_evictions = 0
        self._cycle_io0 = self._io_counters()
        self._cycle_order = None
        # A handout a raise left behind (the previous cycle's), released;
        # an in-flight cycle's light snapshot is never released and its
        # pipelined preemption snapshot is released by its collect.
        self._flush_seal_snapshot()
        self._degrade_deferred = 0
        # The ladder moves only at the cycle's end (_observe_budget):
        # shed and survival cap the heads now, the extras re-heap
        # untouched.
        self._cycle_degraded = self.ladder.state
        heads_popped = len(heads)
        cap = self.ladder.head_cap()
        if cap is not None and len(heads) > cap:
            heads = self._shed_extra_heads(heads, cap)
        collects0 = (self.solver.counters["collects"]
                     if self.solver is not None else 0)
        route = self._route_mode(heads)
        if (route == "device" and self.strict_after_blocked_cycles
                and self._blocked_preempt_streak
                >= self.strict_after_blocked_cycles):
            # The starvation bound is engaged: the strict CPU path, until
            # the blocked preemptor admits, turns infeasible or goes away
            # (a fairness intervention, never a router sample).
            route = "cpu-strict"
        if route in ROUTABLE and self.ladder.pin_cpu:
            # survival: the cycle is pinned to the CPU (an adaptive "cpu"
            # choice too), consulted before the breaker so that it never
            # takes a half-open probe
            route = "cpu-survival"
        if route == "device" and self.warm_gov is not None \
                and not self.warm_gov.route_ready(len(heads)):
            # The compile governor: this width's bucket is not warm. The
            # CPU path runs the cycle and the governor warms the bucket in
            # the background; consulted before the breaker, so that it
            # never takes a half-open probe.
            self.warm_gov.request(len(heads))
            route = "cpu-warmup"
        if route == "device" \
                and not self.breaker.allow_device(self.clock.now()):
            route = "cpu-breaker"
        if self.journeys is not None:
            self.journeys.set_route(route)
        # The cooldown elapses per schedule() call, not per device cycle.
        cooling = self._pipeline_cooldown > 0
        if cooling:
            self._pipeline_cooldown -= 1
        if route == "device" and not cooling and self._pipeline_ok(heads):
            signal = self._schedule_pipelined(heads, start)
            if signal is not None:
                # the sample lands under the regime of the collected cycle
                progress = (None if self._last_cycle_admitted is None
                            else self._last_cycle_admitted
                            + self._cycle_evictions)
                self._route_record("device", progress,
                                   _time.perf_counter() - wall0
                                   - self._drain_cost)
                self.last_route = self._pipeline_trace_route
                self._note_device_cycle(collects0)
                self._observe_budget(_time.perf_counter() - wall0,
                                     heads_popped, self._last_cycle_admitted)
                self._finish_trace(trace, self._pipeline_trace_route,
                                   heads=len(heads),
                                   admitted=self._last_cycle_admitted)
                return signal
            # Not applicable this cycle: the synchronous path below, with
            # a fresh full snapshot (the pipelined attempt's light one
            # shares the live trees and never reaches it).
        elif self._inflight is not None:
            # The gate closed (cooldown, StrictFIFO, pipeline off) with a
            # cycle in flight: drain it before the synchronous snapshot,
            # or its admissions would be invisible to nominate.
            self._drain_pipeline()

        t_ph = _time.perf_counter()
        snapshot = self.cache.snapshot()
        self._cycle_snapshot = snapshot
        vlog.dump_snapshot(self.log, snapshot)
        self._span("snapshot", t_ph)
        nom = self._stage_nominate(heads, snapshot, route, timeout)
        self._stage_apply(nom, timeout)
        applied = self._stage_requeue(nom)
        if self.query_plane is not None:
            # the order the apply stage consumed: the solver-routed
            # entries, then the admission-sorted CPU ones
            self._cycle_order = [e.info.key for e in nom.entries]
        # The observed regime feeds the router, and predicts the next
        # cycle's.
        regime = applied.regime
        self._cycle_regime = regime
        self._last_regime = regime
        self._feed_starvation_bound(applied.blocked_preemptor, regime)
        self.cycle_counts[route] = self.cycle_counts.get(route, 0) + 1
        self.last_route = route
        if route == "device":
            self._note_device_cycle(collects0)
        self._retire_cycle_snapshot(snapshot)
        if route in ROUTABLE:
            # progress = admissions + evictions: a cycle that only evicts
            # admits nothing on either engine
            self._route_record(route, applied.admitted
                               + self._cycle_evictions,
                               _time.perf_counter() - wall0
                               - self._drain_cost)
        if self.metrics is not None:
            self.metrics.admission_attempt(applied.success,
                                           self.clock.now() - start)
            for cq_name, count in nom.skipped_preemptions.items():
                self.metrics.preemption_skips(cq_name, count)
        self._observe_budget(_time.perf_counter() - wall0, heads_popped,
                             applied.admitted)
        self._finish_trace(trace, route, heads=len(nom.entries),
                           admitted=applied.admitted)
        return KeepGoing if applied.success else SlowDown

    def _feed_starvation_bound(self, blocked: bool, regime: str) -> None:
        """The streak and its decay (kueue_tpu/scheduler/scheduler.py:
        585-622). A preempt-mode entry is blocked only when it found no
        feasible targets; one that selected targets is progressing. A
        cycle with no preempt-mode entry keeps the evidence through a
        grace of `strict_after_blocked_cycles` cycles (a parked
        preemptor re-heaps between capacity releases), then decays it by
        one a cycle; while the bound is engaged the decay is immediate.
        A deferred preempt plan (shed) looks blocked but is not."""
        if self._degrade_deferred:
            blocked = False
        if blocked:
            self._blocked_preempt_streak += 1
            self._preemptless_cycles = 0
        elif regime == "preempt":
            self._blocked_preempt_streak = 0  # preemptors made progress
            self._preemptless_cycles = 0
        elif self._blocked_preempt_streak > 0:
            self._preemptless_cycles += 1
            bound = self.strict_after_blocked_cycles
            engaged = bound and self._blocked_preempt_streak >= bound
            if engaged or self._preemptless_cycles > max(bound, 1):
                self._blocked_preempt_streak -= 1

    def _span(self, name: str, t0: float, trace_name: str = "") -> float:
        """Add the seconds since t0 to phase `name` of last_phase_s and
        record the span in the open trace, under `trace_name` when the
        JAX Scheduler has no such span (a dotted name, nested under its
        prefix). Returns now."""
        now = _time.perf_counter()
        self.last_phase_s[name] = self.last_phase_s.get(name, 0.0) + now - t0
        self.recorder.span(trace_name or name, t0, now - t0)
        return now

    def _route_mode(self, heads: list) -> str:
        """Which engine runs this cycle (kueue_tpu/scheduler/scheduler.py:
        1020-1056): "device" (the solve stage, pipelined or not), "cpu"
        (adaptive routing chose the CPU path) or "cpu-forced" (no solver,
        a cycle narrower than solver_min_heads, or routing "never").

        Adaptive routing keys the choice by the predicted regime (the
        last observed one): an engine with fewer than 2 samples in it is
        taken first; then the better median per-sample rate, with the
        other engine probed every 16 cycles of the regime, or every 64
        when its rate is below a quarter of the best."""
        if self.solver is None or len(heads) < self.solver_min_heads \
                or self.solver_routing == "never":
            return "cpu-forced"
        if self.solver_routing != "adaptive":
            return "device"
        regime = self._last_regime
        rates = {}
        for m in ROUTABLE:
            samples = self._route_stats.get((m, regime), ())
            if len(samples) < 2:
                return m
            rs = sorted(a / max(t, 1e-9) for a, t in samples)
            rates[m] = rs[len(rs) // 2]
        best = "device" if rates["device"] >= rates["cpu"] else "cpu"
        loser = "cpu" if best == "device" else "device"
        self._route_explore[regime] += 1
        period = 16 if rates[loser] * 4 >= rates[best] else 64
        if self._route_explore[regime] % period == 0:
            return loser
        return best

    def _route_record(self, mode: str, admitted, secs: float) -> None:
        """One routing sample (progress, seconds) under (engine, the
        cycle's regime), the last 8 kept; none unless routing is
        adaptive, none for an intervention route or a degraded cycle
        (kueue_tpu/scheduler/scheduler.py:1058-1071)."""
        if self.solver_routing != "adaptive" or admitted is None \
                or mode not in ROUTABLE:
            return
        if self._cycle_degraded != NORMAL:
            return
        lst = self._route_stats.setdefault((mode, self._cycle_regime), [])
        lst.append((admitted, secs))
        if len(lst) > 8:
            lst.pop(0)

    # --- the flight recorder, metrics and the seal (obs/) ---

    def _io_counters(self) -> tuple:
        """(upload_bytes, fetch_bytes, dispatches, collects) from the
        solver's counters: the cycle's baseline for _finish_trace."""
        if self.solver is None:
            return (0, 0, 0, 0)
        c = self.solver.counters
        return (c["upload_bytes"], c["fetch_bytes"], c["dispatches"],
                c["collects"])

    def _journey_begin_cycle(self, route: str = "") -> None:
        """The journey ledger's cycle context (attempt id and the cache's
        structural generation token), so that every span of the cycle is
        tagged; one is-None compare without a ledger."""
        led = self.journeys
        if led is None:
            return
        led.begin_cycle(self.attempt_count, self.cache.generation_token())
        if route:
            led.set_route(route)

    def _finish_trace(self, trace, route: str, heads: int,
                      admitted: Optional[int]) -> None:
        """Seal the cycle (kueue_tpu/scheduler/scheduler.py:861-901): the
        breaker and ladder gauges, the trace's fields and transport
        deltas, the cycle_phase_seconds histograms fed from the trace's
        span sums, then the query plane's publish, the journey ledger's
        seal and the aging watch's sample."""
        if self.metrics is not None:
            self.metrics.set_breaker_state(self.breaker.state)
            self.metrics.set_degraded_state(self.ladder.state)
        if trace is not None:
            trace.route = route
            trace.regime = self._cycle_regime
            trace.heads = heads
            trace.admitted = admitted
            trace.evictions = self._cycle_evictions
            trace.faults = self._cycle_faults
            trace.breaker = self.breaker.state
            trace.degraded = self._cycle_degraded
            io = self._io_counters()
            base = self._cycle_io0
            trace.upload_bytes = io[0] - base[0]
            trace.fetch_bytes = io[1] - base[1]
            trace.dispatches = io[2] - base[2]
            trace.collects = io[3] - base[3]
            self.recorder.finish(trace)
            if self.metrics is not None:
                self.metrics.cycle_observed(route, heads, trace.phase_sums())
        self._publish_query_plane(route)
        if self.journeys is not None:
            self.journeys.seal_cycle()
        if self.aging is not None:
            self.aging.sample()

    # --- the cycle's snapshot handout ---

    def _flush_seal_snapshot(self) -> None:
        """Release a handout parked for a seal that never happened, and
        a cycle snapshot still tracked between take and retire: the
        previous cycle raised in between (kueue_tpu/scheduler/
        scheduler.py:903-917)."""
        snap, self._seal_snapshot = self._seal_snapshot, None
        if snap is not None:
            self.cache.release_snapshot(snap)
        snap, self._cycle_snapshot = self._cycle_snapshot, None
        if snap is not None:
            self.cache.release_snapshot(snap)

    def _retire_cycle_snapshot(self, snapshot: Snapshot) -> None:
        """The synchronous cycle is done with its handout
        (kueue_tpu/scheduler/scheduler.py:919-931): without a query plane
        it goes back to the cache, which may recycle its untouched shells;
        with one, it passes to the plane at the seal and stays counted in
        cache.live_handouts while the plane holds it."""
        self._cycle_snapshot = None
        if self.query_plane is None:
            self.cache.release_snapshot(snapshot)
        else:
            self._seal_snapshot = snapshot

    def _publish_query_plane(self, route: str) -> None:
        qp = self.query_plane
        snap, self._seal_snapshot = self._seal_snapshot, None
        order, self._cycle_order = self._cycle_order, None
        if qp is None:
            if snap is not None:  # the plane detached mid-cycle
                self.cache.release_snapshot(snap)
            return
        qp.publish(self.attempt_count, route, order, snapshot=snap)

    # --- the cycle deadline budget (resilience/degrade.py) ---

    def _shed_extra_heads(self, heads: list, cap: int) -> list:
        """Shed/survival head cap (kueue_tpu/scheduler/scheduler.py:
        945-974): keep the top `cap` heads by priority (when the gate is
        on) then queue-order timestamp, and re-heap the rest untouched,
        with no status patch."""
        prio_on = features.enabled(features.PRIORITY_SORTING_WITHIN_COHORT)
        heads.sort(key=lambda w: (
            -prioritypkg.priority(w.obj) if prio_on else 0,
            self.ordering.queue_order_timestamp(w.obj)))
        keep, extra = heads[:cap], heads[cap:]
        for w in extra:
            if self.journeys is not None:
                self.journeys.shed(w)
            self.queues.requeue_workload(
                w, RequeueReason.FAILED_AFTER_NOMINATION)
        self.shed_heads_requeued += len(extra)
        self.recorder.annotate(
            "shed", f"head cap {self._cycle_degraded}: kept {cap} of "
                    f"{cap + len(extra)} heads",
            state=self._cycle_degraded, kept=cap, requeued=len(extra))
        return keep

    def _defer_preempt_plans(self, entries: list) -> None:
        """Shed/survival: the entries nominated with deferred preemption
        (targets None) get no target selection this cycle; they keep the
        reserve-capacity semantics in the apply stage and re-heap."""
        for e in entries:
            if e.preemption_targets is None:
                e.preemption_targets = []
                e.inadmissible_msg = ("Preemption planning deferred "
                                      "(load shedding)")
                e.requeue_reason = RequeueReason.FAILED_AFTER_NOMINATION
                self._degrade_deferred += 1
                self.preempt_plans_deferred += 1

    def _observe_budget(self, duration_s: float, heads: int,
                        admitted: Optional[int]) -> None:
        """Feed the cycle's wall seconds and its backlog pressure (heads
        popped minus admissions) to the ladder; a move is annotated on
        the still-open trace and reported to on_fault
        (kueue_tpu/scheduler/scheduler.py:986-1016)."""
        lad = self.ladder
        if not lad.enabled:
            return
        if self._cycle_degraded != NORMAL and self.metrics is not None:
            self.metrics.cycle_shed(self._cycle_degraded)
        prev = lad.state
        backlog = heads - (admitted or 0)
        if not lad.observe_cycle(duration_s, backlog=backlog):
            return
        msg = (f"degraded-mode {prev}->{lad.state}: cycle ewma "
               f"{(lad.ewma_s or 0) * 1e3:.1f}ms vs budget "
               f"{lad.budget_s * 1e3:.1f}ms, backlog {backlog}")
        self.recorder.annotate("degrade", msg, state=lad.state,
                               previous=prev,
                               ewma_ms=round((lad.ewma_s or 0) * 1e3, 3),
                               budget_ms=round(lad.budget_s * 1e3, 3))
        if self.on_fault is not None:
            self.on_fault(
                "degrade-recovered" if lad.state == NORMAL else "degrade",
                msg)

    def _observe_idle(self) -> None:
        """An idle tick (no heads): the ladder counts it as healthy."""
        lad = self.ladder
        if not lad.enabled or lad.state == NORMAL:
            return
        prev = lad.state
        if not lad.observe_idle():
            return
        if self.metrics is not None:
            self.metrics.set_degraded_state(lad.state)
        if self.on_fault is not None:
            self.on_fault(
                "degrade-recovered" if lad.state == NORMAL else "degrade",
                f"degraded-mode {prev}->{lad.state}: queue idle for "
                f"{lad.recovery_cycles} scheduler tick(s)")

    # --- device-fault containment (resilience/) ---

    def _solver_invalidate(self) -> None:
        self.solver.invalidate_resident()

    def _solver_fault(self, where: str, exc: DeviceFault) -> None:
        """A device fault: count it, feed the breaker and drop the
        solver's resident state and arena twin (the host mirrors are the
        truth; the device state is a rebuildable cache), so the next
        device cycle re-establishes from a full snapshot
        (kueue_tpu/scheduler/scheduler.py:1073-1110)."""
        self.solver_faults += 1
        self._cycle_faults += 1
        tripped = self.breaker.record_fault(self.clock.now())
        # exactly one of the two timeout counters per timeout: the
        # supervised dispatch's, or the collect watchdog's
        supervised = isinstance(exc, SupervisedTimeout)
        timeout = isinstance(exc, DispatchTimeout) and not supervised
        self.recorder.annotate(
            "fault", f"{where}: {exc!r}"[:200], site=where,
            timeout=timeout, tripped=tripped,
            supervised=supervised, breaker=self.breaker.state,
            consecutive=self.breaker.consecutive_faults)
        if self.metrics is not None:
            self.metrics.device_fault(where, timeout=timeout,
                                      tripped=tripped, supervised=supervised)
        if self.on_fault is not None:
            self.on_fault("fault", f"{where}: {exc}")
            if tripped:
                self.on_fault("breaker-open",
                              f"device route suspended after {where}: {exc}")
        self._solver_invalidate()

    def _prepare_failed(self, exc: DeviceFault) -> None:
        """A DeviceFault out of the solver's prepare (a journal-replay
        fault): a fault like the dispatch's. The JAX Scheduler also sends
        a host exception of the encode to the CPU, dropping residency
        without a fault (scheduler.py:1112-1121); here it propagates."""
        self._solver_fault("prepare", exc)

    def _note_device_cycle(self, collects_before: int) -> None:
        """A device-routed cycle ended (kueue_tpu/scheduler/scheduler.py:
        1123-1151). A collect with no fault is a breaker success (it
        closes a half-open probe); a cycle that never collected proves
        nothing, and a pending probe is re-armed."""
        if self._cycle_faults:
            return
        if self.solver.counters["collects"] <= collects_before:
            self.breaker.probe_inconclusive(self.clock.now())
            return
        if not self.breaker.record_success(self.clock.now()):
            return
        msg = (f"device route restored after "
               f"{self.breaker.last_recovery_cycles} cycle(s)")
        self.recorder.annotate(
            "breaker-closed", msg,
            recovery_cycles=self.breaker.last_recovery_cycles)
        if self.metrics is not None:
            self.metrics.fault_recovered(self.breaker.last_recovery_cycles)
        if self.on_fault is not None:
            self.on_fault("breaker-closed", msg)

    def _dispatch_deadline(self) -> Optional[float]:
        """The collect's deadline (kueue_tpu/scheduler/scheduler.py:
        1160-1182): the watchdog's over the median device cycle seconds
        of the router's samples for the predicted regime (or "fit"),
        else over the largest of the solver's recent launch-to-sync
        times (its cold clamp before any); None without a watchdog."""
        if self.watchdog is None:
            return None
        est = None
        samples = (self._route_stats.get(("device", self._last_regime))
                   or self._route_stats.get(("device", "fit")))
        if samples:
            secs = sorted(t for _a, t in samples)
            est = secs[len(secs) // 2]
        else:
            sync = self.solver._sync_samples
            if sync:
                est = max(sync) / 1e3
        return self.watchdog.deadline_s(est)

    def _supervise_deadline(self) -> Optional[float]:
        """The supervised dispatch's deadline: the watchdog's cold clamp
        (the kernels built when the solver was made, so no dispatch
        carries a build); None without a watchdog."""
        if self.watchdog is None:
            return None
        return self.watchdog.max_deadline_s

    # --- the speculative pipeline (kueue_tpu/scheduler/scheduler.py:
    # 1207-1876, kueue_tpu/scheduler/PIPELINE.md) ---
    #
    # The all-fit pipelined cycle dispatches cycle N+1 on the device
    # state cycle N left there (resident chaining), before N's decisions
    # reach the host; N is collected, decoded and admitted after N+1's
    # dispatch. Deviations from the synchronous cycle, as in the JAX
    # package: the heads of cycle N+1 are popped before N's requeues (a
    # head skipped in N retries in N+2; StrictFIFO CQs close the gate),
    # and the router predicts against a mirror that lags by the cycles
    # in flight: a head it mispredicts is requeued and the next cycle
    # runs synchronously.

    @property
    def _inflight(self) -> Optional[stages.InFlightCycle]:
        """The oldest in-flight speculative cycle (the next collect's),
        or None when the pipeline is empty."""
        q = self._inflight_q
        return q[0] if q else None

    def _pipeline_ok(self, heads: list) -> bool:
        """The pipeline's gate (kueue_tpu/scheduler/scheduler.py:
        1216-1232). A breaker that is not closed means a half-open probe,
        which runs synchronously so that its outcome is known by the
        cycle's end; survival pins the CPU (ladder.allow_pipeline), while
        shed keeps the pipeline for cycles that need no preempt planning
        (_schedule_pipelined bails on the others)."""
        s = self.solver
        return (s is not None and self.pipeline_enabled
                and self.breaker.state == CLOSED
                and self.ladder.allow_pipeline
                and s.resident_capable
                and not self.cache.pods_ready_tracking
                and len(heads) >= self.solver_min_heads
                and not self.queues.any_strict_fifo())

    def _schedule_pipelined(self, heads: list,
                            start) -> Optional[SpeedSignal]:
        """Dispatch this cycle and process the oldest in-flight one
        (kueue_tpu/scheduler/scheduler.py:1234-1432). Returns None to
        fall back to the synchronous path (any in-flight cycle drained
        first)."""
        solver = self.solver
        self._pipeline_trace_route = "device-pipelined"
        # Validate every in-flight speculation before the next dispatch
        # chains on its device state, oldest first: an invalid token
        # dooms its cycle and every later one (flushed as "chained"),
        # while the validated predecessors collect normally first.
        for early in tuple(self._inflight_q):
            if early.token is None:
                continue
            ok, reason = self._validate_speculation(early)
            if not ok:
                while self._inflight_q and self._inflight_q[0] is not early:
                    self._drain_one(self._inflight_q.popleft(), sample=True)
                if self._inflight_q and self._inflight_q[0] is early:
                    # (a predecessor's processing may have aborted and
                    # flushed the queue already)
                    self._inflight_q.popleft()
                    self._abort_speculation(early, reason)
                return None  # the synchronous path owns these heads
        # A light snapshot: the all-fit pipelined cycle never simulates
        # on it (its usage truth is the device-resident state).
        t_ph = _time.perf_counter()
        snapshot = self.cache.snapshot(light=True)
        self._span("snapshot", t_ph)
        valid_heads, invalid_entries = [], []
        for w in heads:
            if self.cache.is_assumed_or_admitted(w):
                continue
            err = self._validate_head(w, snapshot)
            if err is None:
                valid_heads.append(w)
            else:
                e = Entry(info=w)
                e.inadmissible_msg, e.requeue_reason = err
                invalid_entries.append(e)
        if not valid_heads:
            self._drain_pipeline()
            return None  # the synchronous path handles the invalid heads
        try:
            plan = solver.prepare(snapshot, valid_heads, route=True)
        except DeviceFault as exc:
            self._prepare_failed(exc)
            plan = None
        prev = self._inflight
        if (plan is not None and plan.resident and prev is not None
                and plan.rs is not prev.inflight.plan.rs):
            # Residency was re-established under the in-flight cycle: the
            # fresh state cannot hold the in-flight admissions, and a
            # dispatch on it would double-book quota.
            self._drain_pipeline()
            return None
        nofit_entries, nofit_idx = [], set()
        pend_ws, pend_idx = [], set()
        bail = (plan is None or not plan.resident or plan.fit_pred is None)
        if not bail and not plan.fit_pred.all():
            # Predicted non-fit heads: the device-NoFit shortcut's are
            # requeued at dispatch; preempt-capable ones ride the same
            # dispatch as a K9 batch (the pipelined mixed cycle), their
            # evictions issued at collect. Partial admission and
            # fair-sharing preemption keep the synchronous path.
            for i, w in enumerate(plan.batch.infos):
                if plan.fit_pred[i]:
                    continue
                e = self._device_nofit_entry(w, snapshot)
                if e is not None:
                    nofit_entries.append(e)
                    nofit_idx.add(i)
                elif (not self.fair_sharing_enabled
                      and not (features.enabled(features.PARTIAL_ADMISSION)
                               and w.can_be_partially_admitted())):
                    pend_ws.append(w)
                    pend_idx.add(i)
                else:
                    bail = True
                    break
        if not bail and pend_ws and self.ladder.defer_preemption:
            # shed: the synchronous path owns the deferral
            bail = True
        if not bail and len(pend_ws) * 4 > len(valid_heads):
            # a preempt-dominated cycle: the synchronous path owns it
            bail = True
        pmeta, pbatch = None, None
        prev_signal = None
        if not bail and pend_ws:
            if self._inflight is not None:
                # Collect the in-flight cycles first: their admissions
                # must be in the cache before the nomination snapshot,
                # or the collect's fit re-check would run on state a
                # cycle stale (over-eviction).
                prev_signal = self._drain_pipeline(sample=False)
            t_ph = _time.perf_counter()
            pmeta, pbatch, bail = self._prepare_pipelined_preempt(plan,
                                                                  pend_ws)
            self._span("preempt-plan", t_ph)
            if bail:
                self._last_cycle_admitted = None
        if bail:
            # The synchronous path processes these popped heads with a
            # fresh full snapshot; cool down one cycle so that sustained
            # contention does not pay a discarded prepare every cycle.
            self._drain_pipeline()
            self._pipeline_cooldown = 1
            return None
        if len(nofit_idx) == len(plan.batch.infos):
            # the whole cycle is device-proved NoFit: nothing to dispatch
            for e in invalid_entries:
                self.requeue_and_update(e)
            for e in nofit_entries:
                self.requeue_and_update(e)
            self.cycle_counts["device-nofit"] = \
                self.cycle_counts.get("device-nofit", 0) + 1
            self._pipeline_trace_route = "device-nofit"
            if self._inflight is not None:
                return self._drain_pipeline()
            self._last_cycle_admitted = None
            return SlowDown
        try:
            inflight = solver.dispatch(
                plan, fair_sharing=self.fair_sharing_enabled,
                preempt_batch=pbatch, deadline_s=self._dispatch_deadline(),
                supervise_deadline_s=self._supervise_deadline())
            solver.start_fetch(inflight)
        except DeviceFault as exc:
            self._solver_fault("dispatch", exc)
            if pmeta is not None:
                self.cache.release_snapshot(pmeta[2])
            self._drain_pipeline()
            return None
        for e in invalid_entries:
            self.requeue_and_update(e)
        for e in nofit_entries:
            self.requeue_and_update(e)
        token = stages.SpeculationToken.stamp(self.cache, solver, plan,
                                              snapshot)
        self._inflight_q.append(stages.InFlightCycle(
            inflight=inflight, snapshot=snapshot, nofit_idx=nofit_idx,
            pend_idx=pend_idx, pmeta=pmeta, token=token))
        # A token-less dispatch collapses the depth to 1.
        depth = max(1, self.pipeline_depth)
        if any(ic.token is None for ic in self._inflight_q):
            depth = 1
        if len(self._inflight_q) <= depth:
            if prev_signal is not None:
                return prev_signal  # the mixed cycle's pre-drain
            self._last_cycle_admitted = None
            self.cycle_counts["device-dispatch-only"] = \
                self.cycle_counts.get("device-dispatch-only", 0) + 1
            self._pipeline_trace_route = "device-dispatch-only"
            return KeepGoing  # results a call later
        signal = KeepGoing
        while len(self._inflight_q) > depth:
            signal = self._process_inflight(self._inflight_q.popleft(), start)
        return signal

    def _abandon_pipeline(self) -> None:
        """Drop every in-flight cycle without applying its decisions
        (kueue_tpu/scheduler/scheduler.py:1434-1444: leadership lost):
        requeue their heads and drop the resident state (it holds
        admissions that will never be confirmed)."""
        if not self._inflight_q:
            return
        while self._inflight_q:
            self._requeue_inflight(self._inflight_q.popleft())
        self._solver_invalidate()

    def _requeue_inflight(self, prev: stages.InFlightCycle) -> None:
        """The sweep of every discard path (abort, collect fault,
        abandon): release the pipelined preemption's snapshot and re-heap
        every batch row the device-NoFit shortcut did not requeue at
        dispatch; the pend rows too, whose evictions never issued."""
        if prev.pmeta is not None:
            self.cache.release_snapshot(prev.pmeta[2])
        for i, w in enumerate(prev.inflight.plan.batch.infos):
            if i in prev.nofit_idx:
                continue
            if self.journeys is not None:
                self.journeys.requeued(
                    w, NOMINATED, RequeueReason.FAILED_AFTER_NOMINATION,
                    "in-flight speculative cycle abandoned")
            self.queues.requeue_workload(
                w, RequeueReason.FAILED_AFTER_NOMINATION)

    def _flush_inflight_queue(self, why: str) -> None:
        """Discard every still-queued cycle undecoded (a device fault on
        an older chained cycle): not speculation aborts, nothing about
        their state was proven stale; annotated "pipeline-flush"."""
        if not self._inflight_q:
            return
        flushed = 0
        while self._inflight_q:
            self._requeue_inflight(self._inflight_q.popleft())
            flushed += 1
        self.recorder.annotate(
            "pipeline-flush",
            f"{flushed} chained in-flight cycle(s) discarded: {why}",
            reason=why, flushed=flushed)

    def _prepare_pipelined_preempt(self, plan, pend_ws: list):
        """Nominate the predicted-non-fit, preempt-capable heads against a
        fresh full snapshot (the reclaim oracle simulates, never on a
        light snapshot's live trees) and encode their problems to ride
        the resident dispatch (kueue_tpu/scheduler/scheduler.py:
        1482-1532). Returns (pmeta, pbatch, bail): pmeta = (pending
        entries, cq_by, full snapshot) for the collect, pbatch the
        encoded problems or None (every entry blocked), bail True when
        the synchronous path must own the cycle. A DeviceFault bails;
        any other exception propagates (the JAX package bails on any),
        the snapshot released either way."""
        full_snap = self.cache.snapshot()
        try:
            pre_entries = self.nominate(pend_ws, full_snap,
                                        defer_preemption=True)
            pending, ready = [], []
            for e in pre_entries:
                if e.preemption_targets is None:
                    e.preemption_targets = []
                    pending.append(e)
                else:
                    ready.append(e)  # NO_FIT on the true state (mirror lag)
            for e in ready:
                self.requeue_and_update(e)
            if not pending:
                self.cache.release_snapshot(full_snap)
                return None, None, False
            cand_index = candidate_index(full_snap, self.ordering,
                                         self.clock.now())
            problems, requests_by, cq_by, frs_by = [], {}, {}, {}
            for i, e in enumerate(pending):
                requests_by[i] = e.assignment.total_requests_for(e.info)
                frs_by[i] = fa.flavor_resources_need_preemption(e.assignment)
                cq_by[i] = e.info.cluster_queue
                problems.extend(devpreempt.build_problems(
                    i, e.info, requests_by[i], frs_by[i], full_snap,
                    self.preemptor, cand_index))
            pbatch = None
            if problems:
                pbatch = devpreempt.encode_problems(
                    problems, full_snap, plan.topo, requests_by, cq_by,
                    frs_by)
            return (pending, cq_by, full_snap), pbatch, False
        except DeviceFault:
            self.preemption_fallbacks += 1
            self.cache.release_snapshot(full_snap)
            return None, None, True
        except BaseException:
            self.cache.release_snapshot(full_snap)
            raise

    def _drain_pipeline(self, sample: bool = True) -> SpeedSignal:
        """Process every in-flight cycle, oldest first. sample=False: the
        caller's cycle owns the drained admissions (the mixed cycle's
        pre-drain), which stay in _last_cycle_admitted."""
        if not self._inflight_q:
            return KeepGoing
        sig = KeepGoing
        drained_total = None
        while self._inflight_q:
            sig, admitted = self._drain_one(self._inflight_q.popleft(),
                                            sample)
            if admitted is not None:
                drained_total = (drained_total or 0) + admitted
        self._drained_admitted = drained_total
        if not sample:
            self._last_cycle_admitted = drained_total
        return sig

    def _drain_one(self, prev: stages.InFlightCycle, sample: bool) -> tuple:
        """Process one in-flight cycle; returns (signal, admitted or
        None). With `sample` the drained cycle is a device routing sample
        (even when the draining cycle runs on the CPU), and its time and
        evictions are kept out of the enclosing cycle's own sample
        (kueue_tpu/scheduler/scheduler.py:1557-1579)."""
        t0 = _time.perf_counter()
        ev0 = self._cycle_evictions
        sig = self._process_inflight(prev, self.clock.now())
        admitted = self._last_cycle_admitted
        if sample:
            dt = _time.perf_counter() - t0
            drained_ev = self._cycle_evictions - ev0
            self._cycle_evictions = ev0
            self._drain_cost += dt
            if admitted is not None:
                self._route_record("device", admitted + drained_ev, dt)
            self._last_cycle_admitted = None  # consumed
        return sig, admitted

    def _process_inflight(self, prev: stages.InFlightCycle,
                          start) -> SpeedSignal:
        """Validate, collect, decode and apply one in-flight cycle
        (kueue_tpu/scheduler/scheduler.py:1581-1698)."""
        inflight, snapshot = prev.inflight, prev.snapshot
        nofit_idx, pend_idx, pmeta = (prev.nofit_idx, prev.pend_idx,
                                      prev.pmeta)
        valid_heads = inflight.plan.batch.infos
        # Validated again at the commit point, even after the check at
        # the next dispatch: the cache may have moved in between.
        ok, reason = self._validate_speculation(prev)
        if not ok:
            return self._abort_speculation(prev, reason)
        try:
            decisions, aux = self.solver.collect(inflight, snapshot)
        except DeviceFault as exc:
            # A timeout or a caught corruption: the result is abandoned
            # undecoded, the heads re-heap, and every later cycle that
            # chained on the dropped resident state is flushed.
            self._solver_fault("collect", exc)
            self._requeue_inflight(prev)
            self._flush_inflight_queue("collect-fault")
            self._pipeline_cooldown = 1
            self._last_cycle_admitted = None
            return SlowDown
        if prev.token is not None:
            self.speculation_hits += 1
            if self.metrics is not None:
                self.metrics.speculation_hit()
        entries = []
        any_nonfit = False
        t_ph = _time.perf_counter()
        for i, w in enumerate(valid_heads):
            if i in nofit_idx or i in pend_idx:
                continue  # NoFit: requeued at dispatch; pend: below
            decision = decisions.get(i)
            e = Entry(info=w)
            if decision is None:
                # Predicted fit on the lagging mirror, denied by the
                # device: re-heap, and run the next cycle synchronously
                # so that preempt-mode nomination applies.
                e.inadmissible_msg = "Workload didn't fit on the batched path"
                e.requeue_reason = RequeueReason.FAILED_AFTER_NOMINATION
                any_nonfit = True
                entries.append(e)
                continue
            assignment, admitted = decision
            e.assignment = assignment
            w.last_assignment = assignment.last_state
            if not admitted:
                self._set_skipped(e, "Workload no longer fits after "
                                     "processing another workload")
                entries.append(e)
                continue
            cq = snapshot.cluster_queues[w.cluster_queue]
            e.status = NOMINATED
            try:
                self.admit(e, cq)
            except Exception as exc:  # noqa: BLE001 — cache/API races
                e.inadmissible_msg = f"Failed to admit workload: {exc}"
                self.solver.note_unapplied(w.key)
            entries.append(e)
        self._flush_mk_placements(snapshot)
        self._span("apply", t_ph)
        if any_nonfit:
            self._pipeline_cooldown = 1
        if pmeta is not None:
            t_ph = _time.perf_counter()
            entries.extend(self._collect_pipelined_preempt(
                inflight, pmeta, aux, entries))
            self._span("preempt-plan", t_ph)
            self._cycle_regime = "preempt"
        else:
            self._cycle_regime = "fit"
        self._last_regime = self._cycle_regime
        if self.query_plane is not None:
            # the collected cycle's processing order
            self._cycle_order = [e.info.key for e in entries]
        result_success = False
        admitted_n = 0
        vlog.dump_attempts(self.log, entries)
        t_ph = _time.perf_counter()
        for e in entries:
            if e.status != ASSUMED:
                self.requeue_and_update(e)
            else:
                result_success = True
                admitted_n += 1
                self.solver.release_workload(e.info.key)
        self.admitted_total += admitted_n
        self._span("requeue", t_ph)
        self._last_cycle_admitted = admitted_n
        self.cycle_counts["device-pipelined"] = \
            self.cycle_counts.get("device-pipelined", 0) + 1
        if self.metrics is not None:
            self.metrics.admission_attempt(result_success,
                                           self.clock.now() - start)
        return KeepGoing if result_success else SlowDown

    def _validate_speculation(self, prev: stages.InFlightCycle) -> tuple:
        """(ok, reason) for the in-flight cycle's token, through the
        SITE_SPECULATION injection site (an injected fault is reason
        "injected") and the fencing check ("fenced"); a token-less
        cycle validates trivially (kueue_tpu/scheduler/scheduler.py:
        1700-1716)."""
        if self.fencing_check is not None and not self.fencing_check():
            return False, "fenced"
        try:
            faultinject.site(faultinject.SITE_SPECULATION)
            if prev.token is not None:
                return prev.token.validate(self.cache, self.solver)
        except DeviceFault:
            return False, "injected"
        return True, ""

    def _abort_speculation(self, prev: stages.InFlightCycle,
                           reason: str) -> SpeedSignal:
        """A mis-speculation (kueue_tpu/scheduler/scheduler.py:
        1718-1760): abandon the result undecoded (nothing was assumed,
        so nothing is forgotten), requeue its heads and every later
        queued cycle's (counted as "chained" aborts), drop the resident
        state, which chained Phase B usage for admissions that will never
        be confirmed, and run the next cycle synchronously. Not a breaker
        fault: nothing on the device failed."""
        self.speculation_aborts += 1
        self.speculation_abort_reasons[reason] = \
            self.speculation_abort_reasons.get(reason, 0) + 1
        self.recorder.annotate(
            "speculation-abort",
            f"speculative result abandoned: {reason}", reason=reason,
            aborts=self.speculation_aborts)
        if self.metrics is not None:
            self.metrics.speculation_abort(reason)
        self._requeue_inflight(prev)
        while self._inflight_q:
            chained = self._inflight_q.popleft()
            self.speculation_aborts += 1
            self.speculation_abort_reasons["chained"] = \
                self.speculation_abort_reasons.get("chained", 0) + 1
            if self.metrics is not None:
                self.metrics.speculation_abort("chained")
            self._requeue_inflight(chained)
        self._solver_invalidate()
        self._pipeline_cooldown = 1
        self._last_cycle_admitted = None
        return SlowDown

    def _collect_pipelined_preempt(self, inflight, pmeta, aux,
                                   fit_entries: list) -> list:
        """The collect half of a pipelined mixed cycle
        (kueue_tpu/scheduler/scheduler.py:1800-1876): decode the K9
        targets and issue the evictions a cycle after they were chosen.
        Against the lag: this cycle's device admissions are accounted on
        the nomination snapshot before the fit re-check, overlapping
        target sets are skipped as in the synchronous admit loop, and a
        head one of whose victims completed in the window is requeued
        (its capacity is already free). The full snapshot is released on
        every exit. Returns the preempt-mode entries for the requeue."""
        pending, cq_by, full_snap = pmeta
        try:
            targets_by: dict = {}
            if aux is not None and "preempt" in aux \
                    and inflight.preempt_batch is not None:
                self._note_preempt_stats(aux, inflight.preempt_batch, None)
                t, f = aux["preempt"]
                targets_by = devpreempt.decode_targets(
                    inflight.preempt_batch, t, f, full_snap, cq_by)
            for e in fit_entries:
                if e.status == ASSUMED:
                    cq = full_snap.cluster_queues.get(e.info.cluster_queue)
                    if cq is not None:
                        cq.add_usage(e.assignment.usage)
            preempted: set = set()
            blocked_any = False
            for i, e in enumerate(pending):
                e.preemption_targets = targets_by.get(i, [])
                if not e.preemption_targets:
                    blocked_any = True  # no feasible targets
                    continue
                live = [t for t in e.preemption_targets
                        if self.cache.is_assumed_or_admitted(
                            t.workload_info)]
                if len(live) != len(e.preemption_targets):
                    # a victim completed during the lag
                    e.preemption_targets = []
                    e.requeue_reason = RequeueReason.FAILED_AFTER_NOMINATION
                    continue
                keys = {t.workload_info.key for t in e.preemption_targets}
                if keys & preempted:
                    self._set_skipped(e, "Workload has overlapping "
                                         "preemption targets with another "
                                         "workload")
                    continue
                cq = full_snap.cluster_queues[e.info.cluster_queue]
                usage = e.net_usage()
                if not cq.fits(usage):
                    self._set_skipped(e, "Workload no longer fits after "
                                         "processing another workload")
                    continue
                preempted.update(keys)
                cq.add_usage(usage)
                e.info.last_assignment = None
                n = self.preemptor.issue_preemptions(e.info,
                                                     e.preemption_targets)
                self._cycle_evictions += n
                if n:
                    e.inadmissible_msg += (f". Pending the preemption of "
                                           f"{n} workload(s)")
                    e.requeue_reason = RequeueReason.PENDING_PREEMPTION
            if pending:
                self._blocked_preempt_streak = (
                    self._blocked_preempt_streak + 1 if blocked_any else 0)
                self._preemptless_cycles = 0
                self.cycle_counts["pipelined-preempt"] = \
                    self.cycle_counts.get("pipelined-preempt", 0) + 1
        finally:
            self.cache.release_snapshot(full_snap)
        return pending

    # --- the stage machine (contracts in scheduler/stages.py) ---

    def _stage_nominate(self, heads: list, snapshot: Snapshot, route: str,
                        timeout) -> stages.NominatedCycle:
        """NOMINATE stage: route the device share through the solve
        stage, CPU-nominate the remainder against the cycle snapshot, and
        sort by the admission order."""
        solver_entries: list = []
        pre_entries: list = []
        if route == "device":
            solver_entries, pre_entries, heads = self._stage_solve(
                heads, snapshot, timeout)
        t_ph = _time.perf_counter()
        defer_shed = self.ladder.defer_preemption
        entries = pre_entries + self.nominate(heads, snapshot,
                                              defer_preemption=defer_shed)
        if defer_shed:
            self._defer_preempt_plans(entries)
        entries.sort(key=self._entry_sort_key())
        self._span("nominate", t_ph)
        return stages.NominatedCycle(snapshot=snapshot, entries=entries,
                                     solver_entries=solver_entries,
                                     route=route)

    def _stage_apply(self, nom: stages.NominatedCycle, timeout) -> None:
        """APPLY stage: sequential admit with intra-cycle usage
        accounting — skip overlapping preemption targets, re-check fit
        after earlier admissions, reserve capacity for blocked
        preemptors, issue evictions (reference: scheduler.go:238-330).
        Mutates the nominated entries in place."""
        snapshot = nom.snapshot
        t_ph = _time.perf_counter()
        preempted_workloads: set = set()
        skipped_preemptions = nom.skipped_preemptions
        for e in nom.entries:
            mode = e.assignment.representative_mode()
            if mode == fa.NO_FIT:
                continue
            cq = snapshot.cluster_queues[e.info.cluster_queue]

            if mode == fa.PREEMPT and not e.preemption_targets:
                # Reserve capacity so lower-priority workloads can't admit
                # ahead of the blocked preemptor (reference: scheduler.go:245-253).
                cq.add_usage(resources_to_reserve(e, cq))
                continue

            pending = {t.workload_info.key for t in e.preemption_targets}
            if pending & preempted_workloads:
                self._set_skipped(e, "Workload has overlapping preemption "
                                     "targets with another workload")
                skipped_preemptions[cq.name] = \
                    skipped_preemptions.get(cq.name, 0) + 1
                continue

            usage = e.net_usage()
            if not cq.fits(usage):
                self._set_skipped(e, "Workload no longer fits after "
                                     "processing another workload")
                if mode == fa.PREEMPT:
                    skipped_preemptions[cq.name] = \
                        skipped_preemptions.get(cq.name, 0) + 1
                continue
            preempted_workloads.update(pending)
            cq.add_usage(usage)

            if mode != fa.FIT:
                if e.preemption_targets:
                    # Next attempt should try all flavors again.
                    e.info.last_assignment = None
                    preempted = self.preemptor.issue_preemptions(
                        e.info, e.preemption_targets)
                    self._cycle_evictions += preempted
                    if preempted:
                        e.inadmissible_msg += (f". Pending the preemption of "
                                               f"{preempted} workload(s)")
                        e.requeue_reason = RequeueReason.PENDING_PREEMPTION
                continue

            self._wait_pods_ready_if_needed(e, timeout)
            e.status = NOMINATED
            try:
                self.admit(e, cq)
            except Exception as exc:  # noqa: BLE001 — cache/API races surface here
                e.inadmissible_msg = f"Failed to admit workload: {exc}"
        # one flush for the cycle: the device stage's admissions came
        # first, so the oracle continues from their placements
        self._flush_mk_placements(snapshot)
        self._span("apply", t_ph)

    def _stage_requeue(self, nom: stages.NominatedCycle) -> stages.AppliedCycle:
        """Requeue sweep closing the apply stage: re-heap every
        non-admitted entry (solver-routed entries rejoin here), count
        admissions, release the admitted heads' encode-arena slots, and
        report the observed regime and whether a preempt-mode entry was
        blocked (no feasible targets), the starvation bound's evidence."""
        entries = nom.solver_entries + nom.entries
        nom.entries = entries
        vlog.dump_attempts(self.log, entries)
        admitted_n = 0
        t_ph = _time.perf_counter()
        for e in entries:
            if e.status != ASSUMED:
                self.requeue_and_update(e)
            else:
                admitted_n += 1
                if self.solver is not None:
                    self.solver.release_workload(e.info.key)
        self.admitted_total += admitted_n
        self._span("requeue", t_ph)
        regime = "preempt" if any(
            e.preemption_targets
            or e.assignment.representative_mode() == fa.PREEMPT
            for e in entries) else "fit"
        blocked = any(
            e.status != ASSUMED
            and e.assignment.representative_mode() == fa.PREEMPT
            and not e.preemption_targets
            for e in entries)
        return stages.AppliedCycle(admitted=admitted_n,
                                   success=admitted_n > 0, regime=regime,
                                   blocked_preemptor=blocked)

    def _stage_solve(self, heads: list, snapshot: Snapshot, timeout):
        """SOLVE stage: run the batched solver over the validated heads.

        One device sync per cycle. The heads the device did not fit (no
        decision) are then CPU-nominated against the pre-cycle snapshot,
        exactly like the reference's nominate phase
        (scheduler.go:404-441), before the device's fit decisions are
        accounted on the snapshot and admitted, in the solver's admit
        order.

        Returns (solver entries, nominated preempt/nofit entries for the
        main admit loop, remaining heads for post-sync CPU nomination)."""
        valid_heads, invalid_entries = [], []
        for w in heads:
            if self.cache.is_assumed_or_admitted(w):
                continue
            err = self._validate_head(w, snapshot)
            if err is None:
                valid_heads.append(w)
            else:
                e = Entry(info=w)
                e.inadmissible_msg, e.requeue_reason = err
                invalid_entries.append(e)

        try:
            plan = self.solver.prepare(snapshot, valid_heads)
        except DeviceFault as exc:
            self._prepare_failed(exc)
            return invalid_entries, [], valid_heads
        if plan is None:
            return invalid_entries, [], valid_heads
        try:
            decisions, _ = self.solver.solve_prepared(
                plan, snapshot, fair_sharing=self.fair_sharing_enabled,
                deadline_s=self._dispatch_deadline(),
                supervise_deadline_s=self._supervise_deadline())
        except DeviceFault as exc:
            # the cycle finishes on the CPU: every head to nomination
            self._solver_fault("solve", exc)
            return invalid_entries, [], valid_heads

        # Entries the device did not fit get their CPU nomination (flavor
        # assignment; preemption targets deferred) before any admission
        # is accounted. Device-NoFit shortcut: Phase A proved these
        # entries can't fit, and a Never/Never preemption policy (with no
        # partial admission possible) means the CPU assigner could only
        # restate NoFit.
        nofit_entries, rest, partial_ws = [], [], []
        for i, w in enumerate(valid_heads):
            if i in decisions:
                continue
            e = self._device_nofit_entry(w, snapshot)
            if e is not None:
                nofit_entries.append(e)
            elif self._batched_reducer_eligible(w, snapshot):
                partial_ws.append(w)
            else:
                rest.append(w)  # preemption possible: CPU nomination
        if partial_ws:
            # Batched partial admission (podset_reducer.go:29-86): the
            # heads' searches in lockstep, Phase A on the card a round,
            # then one assigner run per head at its found counts.
            for item in self._batched_partial_admission(partial_ws, plan,
                                                        snapshot):
                if isinstance(item, Entry):
                    nofit_entries.append(item)
                else:
                    rest.append(item)
        # Preempt-mode targets are deferred to the batched solves, except
        # under a mesh with fair sharing: the sharded solve carries only
        # minimal preemption (kueue_tpu/scheduler/scheduler.py:1952-1957),
        # so the CPU Preemptor picks them here.
        defer = not (self.fair_sharing_enabled
                     and self.solver.mesh is not None) \
            or self.ladder.defer_preemption
        t_ph = _time.perf_counter()
        pre_entries = nofit_entries + self.nominate(rest, snapshot,
                                                    defer_preemption=defer)
        pending = [e for e in pre_entries if e.preemption_targets is None]
        if pending and self.ladder.defer_preemption:
            # shed/survival: no target selection this cycle
            self._defer_preempt_plans(pending)
            pending = []
        for e in pending:
            e.preemption_targets = []
        self._span("nominate", t_ph)
        if pending:
            self._stage_preempt(pending, snapshot, plan,
                                fit_count=len(decisions))
        else:
            # the JAX Scheduler's preempt-plan span is there every cycle
            self._span("preempt-plan", _time.perf_counter())

        t_ph = _time.perf_counter()
        solver_entries = list(invalid_entries)
        # Snapshot accounting only matters when the pre-nominated
        # preempt/nofit set will read the snapshot after us.
        account = bool(pre_entries)
        for i, w in enumerate(valid_heads):
            decision = decisions.get(i)
            if decision is None:
                continue  # CPU-nominated above
            assignment, admitted = decision
            e = Entry(info=w, assignment=assignment)
            w.last_assignment = assignment.last_state
            if not admitted:
                # Assigned against the pre-cycle snapshot but no longer fit
                # after intra-cycle accounting (phase B) — skip, don't
                # re-assign (reference: scheduler.go:266-273).
                self._set_skipped(e, "Workload no longer fits after "
                                     "processing another workload")
                solver_entries.append(e)
                continue
            cq = snapshot.cluster_queues[w.cluster_queue]
            if account:
                # Account on the snapshot so the CPU remainder sees it.
                cq.add_usage(assignment.usage)
            self._wait_pods_ready_if_needed(e, timeout)
            e.status = NOMINATED
            try:
                self.admit(e, cq)
            except Exception as exc:  # noqa: BLE001
                e.inadmissible_msg = f"Failed to admit workload: {exc}"
                self.solver.note_unapplied(w.key)
            solver_entries.append(e)
        # (the JAX Scheduler times this admission in no span)
        self._span("apply", t_ph, "apply.device")
        return solver_entries, pre_entries, []

    def _stage_preempt(self, pending: list, snapshot: Snapshot, plan,
                       fit_count: int) -> None:
        """Preemption targets of the preempt-mode entries, against the
        pre-cycle snapshot. When the work gate picks the device
        (_device_preempt_batch): K9 on the minimal problems and K11 on
        the fair ones, launched back to back with one sync
        (solver.solve_preemptions, against the usage the cycle's dispatch
        read), then decode_targets and decode_fair_targets, the minimal
        targets first (kueue_tpu/scheduler/scheduler.py:2092-2108); else
        the CPU Preemptor.

        Timed in last_phase_s: "preempt-plan" (the gate, and the index,
        the problems and their encode, or the CPU Preemptor), then on the
        device route the solver's "preempt" and "decode-targets"."""
        t_ph = _time.perf_counter()
        try:
            found = self._device_preempt_batch(pending, snapshot, plan,
                                               fit_count)
        except DeviceFault:
            self.preemption_fallbacks += 1
            found = None
        if found is None:
            self.last_preempt_gate = "cpu"
            self._cpu_preempt_targets(pending, snapshot)
            self._span("preempt-plan", t_ph)
            return
        self.last_preempt_gate = "device"
        pbatch, fbatch, cq_by = found
        self._span("preempt-plan", t_ph)
        try:
            aux = self.solver.solve_preemptions(
                pbatch, fbatch, fairpreempt.strategy_flags(
                    self.preemptor.fs_strategies))
        except DeviceFault as exc:
            # the CPU Preemptor picks the targets instead
            # (kueue_tpu/scheduler/scheduler.py:2084-2091)
            self._solver_fault("solve", exc)
            self.preemption_fallbacks += 1
            self.last_preempt_gate = "cpu"
            t_ph = _time.perf_counter()
            self._cpu_preempt_targets(pending, snapshot)
            self._span("preempt-plan", t_ph)
            return
        t_ph = _time.perf_counter()
        self._note_preempt_stats(aux, pbatch, fbatch)
        by_entry: dict = {}
        if pbatch is not None:
            by_entry.update(devpreempt.decode_targets(
                pbatch, *aux["preempt"], snapshot, cq_by))
        if fbatch is not None:
            by_entry.update(fairpreempt.decode_fair_targets(
                fbatch, *aux["fair"], snapshot, cq_by))
        for i, e in enumerate(pending):
            e.preemption_targets = by_entry.get(i, [])
        self._retry_partial_admission(pending, snapshot)
        self._span("decode-targets", t_ph, "preempt-plan.decode")

    def _device_preempt_batch(self, pending: list, snapshot: Snapshot,
                              plan, fit_count: int):
        """The JAX Scheduler's work gate (kueue_tpu/scheduler/
        scheduler.py:1983-2062) and, where it picks the device, the
        cycle's CandidateIndex, the problems of each entry (build_problems,
        or under fair sharing build_fair_problems, which splits the
        entries into minimal and fair problems) and their encode. Returns
        (PreemptionBatch or None, FairBatch or None, entry -> CQ name),
        or None for the CPU Preemptor."""
        # The device preemptor saves about preempt_cand_us per candidate
        # (fair_cand_us under fair sharing: fairPreemptions only compares
        # share aggregates), which must cover the marginal sync: zero when
        # fit entries dispatch in the cycle anyway (the JAX package's
        # fused execute; here K9 and K11 are launched after it all the
        # same), but never shared under a mesh (:1988).
        floor_ms = (self.solver_sync_floor_ms
                    if self.solver_sync_floor_ms is not None
                    else self.solver.estimated_sync_ms())
        shares = fit_count > 0 and self.solver.mesh is None
        marginal_sync_us = 0.0 if shares else floor_ms * 1000.0
        # Cheap pre-gate: an upper bound on the candidate count (the
        # domains' workload totals, x2: up to two problems per entry).
        sizes: dict = {}
        bound = 0
        for e in pending:
            cq = snapshot.cluster_queues[e.info.cluster_queue]
            key = cq.cohort.root().name if cq.cohort is not None else cq.name
            if key not in sizes:
                members = (cq.cohort.root().subtree_cqs()
                           if cq.cohort is not None else [cq])
                sizes[key] = sum(len(c.workloads) for c in members)
            bound += 2 * sizes[key]
        per_cand_us = (self.fair_cand_us if self.fair_sharing_enabled
                       else self.preempt_cand_us)
        if bound * per_cand_us <= marginal_sync_us:
            return None
        cand_index = candidate_index(snapshot, self.ordering,
                                     self.clock.now())
        problems, fair_problems = [], []
        requests_by, frs_by, cq_by = {}, {}, {}
        for i, e in enumerate(pending):
            requests_by[i] = e.assignment.total_requests_for(e.info)
            frs_by[i] = fa.flavor_resources_need_preemption(e.assignment)
            cq_by[i] = e.info.cluster_queue
            if self.fair_sharing_enabled:
                mins, fairs = fairpreempt.build_fair_problems(
                    i, e.info, requests_by[i], frs_by[i], snapshot,
                    self.preemptor, cand_index)
                problems.extend(mins)
                fair_problems.extend(fairs)
            else:
                problems.extend(devpreempt.build_problems(
                    i, e.info, requests_by[i], frs_by[i], snapshot,
                    self.preemptor, cand_index))
        # The precise gate: the problems' candidate counts.
        total_cost_us = (sum(p.num_candidates for p in problems)
                         * self.preempt_cand_us
                         + sum(p.num_candidates for p in fair_problems)
                         * self.fair_cand_us)
        if not (problems or fair_problems) \
                or total_cost_us <= marginal_sync_us:
            return None
        pbatch = devpreempt.encode_problems(
            problems, snapshot, plan.topo, requests_by, cq_by,
            frs_by) if problems else None
        fbatch = fairpreempt.encode_fair_problems(
            fair_problems, snapshot, plan.topo, requests_by, cq_by,
            frs_by) if fair_problems else None
        return pbatch, fbatch, cq_by

    def _note_preempt_stats(self, aux: dict, pbatch, fbatch) -> None:
        """The device solves' stats ([B,4] each: candidate pool, prefix
        scanned or heap pops, fill-back rounds or iterations, filled back)
        summed into last_preempt_plan under "minimal" (K9) and "fair"
        (K11), as kueue_tpu/scheduler/scheduler.py:1762-1790 does.
        `problems` counts each batch's problems, not the padded rows."""
        agg: dict = {}
        for key, name, batch in (("preempt_stats", "minimal", pbatch),
                                 ("fair_stats", "fair", fbatch)):
            st = aux.get(key)
            if st is None or len(st) == 0:
                continue
            agg[name] = {
                "problems": len(batch.problems),
                "pool": int(st[:, 0].sum()),
                "scanned": int(st[:, 1].sum()),
                "fillback_rounds_max": int(st[:, 2].max()),
                "filled_back": int(st[:, 3].sum()),
            }
        if not agg:
            return
        self.last_preempt_plan = agg
        flat = {f"{n}_{k}": v for n, d in agg.items() for k, v in d.items()}
        self.recorder.annotate("preempt-plan",
                               "batched preemption solve stats", **flat)

    def _device_nofit_entry(self, w: wlpkg.Info,
                            snapshot: Snapshot) -> Optional[Entry]:
        """A device-proved non-fit entry whose CQ can never preempt and
        which can't be partially admitted needs no CPU nomination.
        Returns the ready Entry, or None when the CPU path must run.
        Its Pending message is the batch path's generic one instead of
        the per-flavor reason list (the resume state is equivalent: a
        NoFit walk always ends exhausted)."""
        cq = snapshot.cluster_queues[w.cluster_queue]
        p = cq.preemption
        if (p.within_cluster_queue != api.PREEMPTION_NEVER
                or p.reclaim_within_cohort != api.PREEMPTION_NEVER):
            return None
        if features.enabled(features.PARTIAL_ADMISSION) \
                and w.can_be_partially_admitted():
            return None
        e = Entry(info=w)  # empty assignment => representative NO_FIT
        e.inadmissible_msg = ("couldn't assign flavors: insufficient quota "
                              "(batched assignment)")
        return e

    def _batched_reducer_eligible(self, w: wlpkg.Info,
                                  snapshot: Snapshot) -> bool:
        """Batched partial admission needs probes that cannot pass by
        preemption: a Never/Never policy makes the reducer's predicate
        fit alone, which is what the batched Phase A evaluates."""
        if not features.enabled(features.PARTIAL_ADMISSION) \
                or not w.can_be_partially_admitted():
            return False
        p = snapshot.cluster_queues[w.cluster_queue].preemption
        return (p.within_cluster_queue == api.PREEMPTION_NEVER
                and p.reclaim_within_cohort == api.PREEMPTION_NEVER)

    def _batched_partial_admission(self, partial_ws: list, plan,
                                   snapshot: Snapshot) -> list:
        """The solver's batched search, then an Entry for each head it
        resolved: at its found counts, one FlavorAssigner run (with the
        reclaim oracle); with none, NoFit with the batch path's generic
        message. A head whose probe could not be encoded is returned as
        it is, for CPU nomination. The assigner runs count as nominate
        time, the search as the solver's "partial"."""
        from kueue_tpu_torch.solver.service import CPU_FALLBACK
        try:
            results = self.solver.batched_partial_admission(plan, snapshot,
                                                            partial_ws)
        except DeviceFault:
            # the CPU reducer searches them instead
            # (kueue_tpu/scheduler/scheduler.py:2186-2191)
            return list(partial_ws)
        t_ph = _time.perf_counter()
        out: list = []
        oracle = make_reclaim_oracle(self.preemptor, snapshot)
        for i, w in enumerate(partial_ws):
            counts = results.get(i)
            if counts is CPU_FALLBACK:
                out.append(w)
                continue
            e = Entry(info=w)
            if counts is None:
                e.inadmissible_msg = ("couldn't assign flavors: "
                                      "insufficient quota "
                                      "(batched assignment)")
                out.append(e)
                continue
            cq = snapshot.cluster_queues[w.cluster_queue]
            assigner = fa.FlavorAssigner(w, cq, snapshot.resource_flavors,
                                         self.fair_sharing_enabled, oracle)
            e.assignment = assigner.assign(counts)
            e.inadmissible_msg = e.assignment.message()
            w.last_assignment = e.assignment.last_state
            out.append(e)
        self._span("nominate", t_ph, "nominate.partial-assign")
        return out

    def _cpu_preempt_targets(self, pending: list, snapshot: Snapshot) -> None:
        """Resolve deferred preempt-mode entries with the CPU preemptor
        (assignments are already computed)."""
        for e in pending:
            e.preemption_targets = self.preemptor.get_targets(
                e.info, e.assignment, snapshot)
        self._retry_partial_admission(pending, snapshot)

    def _retry_partial_admission(self, pending: list,
                                 snapshot: Snapshot) -> None:
        """No feasible target set: the CPU path would now attempt partial
        admission (get_assignments' reducer branch)."""
        if not features.enabled(features.PARTIAL_ADMISSION):
            return
        for e in pending:
            if not e.preemption_targets and e.info.can_be_partially_admitted():
                e.assignment, e.preemption_targets = self.get_assignments(
                    e.info, snapshot)
                e.inadmissible_msg = e.assignment.message()
                e.info.last_assignment = e.assignment.last_state

    def _validate_head(self, w: wlpkg.Info, snapshot: Snapshot):
        """Pre-admission validation (the non-assignment part of nominate).
        Returns None if admissible, else (message, requeue reason)."""
        cq = snapshot.cluster_queues.get(w.cluster_queue)
        ns_labels = self.client.namespace_labels(w.obj.metadata.namespace)
        if wlpkg.has_retry_checks(w.obj) or wlpkg.has_rejected_checks(w.obj):
            return ("The workload has failed admission checks",
                    RequeueReason.GENERIC)
        if w.cluster_queue in snapshot.inactive_cluster_queue_sets:
            return (f"ClusterQueue {w.cluster_queue} is inactive",
                    RequeueReason.GENERIC)
        if cq is None:
            return (f"ClusterQueue {w.cluster_queue} not found",
                    RequeueReason.GENERIC)
        if ns_labels is None:
            return "Could not obtain workload namespace", RequeueReason.GENERIC
        if cq.namespace_selector is None \
                or not cq.namespace_selector.matches(ns_labels):
            return ("Workload namespace doesn't match ClusterQueue selector",
                    RequeueReason.NAMESPACE_MISMATCH)
        if (err := self._validate_resources(w)) is not None:
            return err, RequeueReason.GENERIC
        if (err := self._validate_limit_range(w)) is not None:
            return err, RequeueReason.GENERIC
        return None

    def _wait_pods_ready_if_needed(self, e: Entry, timeout) -> None:
        """waitForPodsReady blockAdmission (reference: scheduler.go:316-327)."""
        if not self.cache.pods_ready_for_all_admitted_workloads():
            # Patch a clone: e.info.obj may alias the store's object.
            patch = wlpkg.clone_for_status_update(e.info.obj)
            wlpkg.unset_quota_reservation_with_condition(
                patch, "Waiting",
                "waiting for all admitted workloads to be in PodsReady "
                "condition", self.clock.now())
            self.client.patch_not_admitted(patch)
            self.cache.wait_for_pods_ready(timeout=timeout)

    # --- nomination (reference: scheduler.go:404-441) ---

    def nominate(self, heads: list, snapshot: Snapshot,
                 defer_preemption: bool = False) -> list:
        entries = []
        for w in heads:
            cq = snapshot.cluster_queues.get(w.cluster_queue)
            e = Entry(info=w)
            if self.cache.is_assumed_or_admitted(w):
                continue
            err = self._validate_head(w, snapshot)
            if err is not None:
                e.inadmissible_msg, e.requeue_reason = err
            else:
                e.assignment, e.preemption_targets = self.get_assignments(
                    w, snapshot, defer_preemption=defer_preemption)
                e.inadmissible_msg = e.assignment.message()
                w.last_assignment = e.assignment.last_state
                if self.fair_sharing_enabled \
                        and e.assignment.representative_mode() != fa.NO_FIT:
                    e.dominant_resource_share, e.dominant_resource_name = \
                        cq.dominant_resource_share_with(
                            e.assignment.total_requests_for(w))
            entries.append(e)
        return entries

    def get_assignments(self, wl: wlpkg.Info, snapshot: Snapshot,
                        defer_preemption: bool = False):
        """reference: scheduler.go:469-507. With defer_preemption a
        preempt-mode assignment returns targets None, resolved later
        (_cpu_preempt_targets)."""
        cq = snapshot.cluster_queues[wl.cluster_queue]
        oracle = make_reclaim_oracle(self.preemptor, snapshot)
        assigner = fa.FlavorAssigner(wl, cq, snapshot.resource_flavors,
                                     self.fair_sharing_enabled, oracle)
        full = assigner.assign()
        mode = full.representative_mode()
        if mode == fa.FIT:
            return full, []
        if defer_preemption and mode == fa.PREEMPT:
            return full, None
        targets: list = []
        if mode == fa.PREEMPT:
            targets = self.preemptor.get_targets(wl, full, snapshot)

        if not features.enabled(features.PARTIAL_ADMISSION) or targets:
            return full, targets

        if wl.can_be_partially_admitted():
            def fits(counts: list):
                assignment = assigner.assign(counts)
                m = assignment.representative_mode()
                if m == fa.FIT:
                    return (assignment, []), True
                if m == fa.PREEMPT:
                    t = self.preemptor.get_targets(wl, assignment, snapshot)
                    if t:
                        return (assignment, t), True
                return None, False

            reducer = PodSetReducer(wl.obj.spec.pod_sets, fits)
            result, found = reducer.search()
            if found:
                return result
        return full, []

    # --- validation (reference: scheduler.go:509-566) ---

    def _validate_resources(self, wl: wlpkg.Info) -> Optional[str]:
        reasons = []
        for ps in wl.obj.spec.pod_sets:
            spec = ps.template.spec
            bad = container_limits_violations(
                list(spec.init_containers) + list(spec.containers))
            if bad:
                reasons.append(f"podSets[{ps.name}][{', '.join(bad)}] "
                               f"requests exceed limits")
        if reasons:
            return "resource validation failed: " + "; ".join(reasons)
        return None

    def _validate_limit_range(self, wl: wlpkg.Info) -> Optional[str]:
        ranges = self.client.limit_ranges(wl.obj.metadata.namespace)
        if not ranges:
            return None
        summary = limitrangepkg.summarize(*ranges)
        reasons = []
        for ps in wl.obj.spec.pod_sets:
            reasons.extend(limitrangepkg.validate_pod_spec(
                ps.template.spec, summary, path=f"podSets[{ps.name}]"))
        if reasons:
            return ("didn't satisfy LimitRange constraints: "
                    + "; ".join(reasons))
        return None

    # --- admission (reference: scheduler.go:571-623) ---

    def admit(self, e: Entry, cq: ClusterQueueSnapshot) -> None:
        new_wl = wlpkg.clone_for_status_update(e.info.obj)
        admission = api.Admission(cluster_queue=e.info.cluster_queue,
                                  pod_set_assignments=e.assignment.to_api())
        now = self.clock.now()
        wlpkg.set_quota_reservation(new_wl, admission, now)
        checks = wlpkg.admission_checks_for_workload(new_wl,
                                                     cq.admission_checks)
        if wlpkg.has_all_checks(new_wl, checks):
            wlpkg.sync_admitted_condition(new_wl, now)
        self.cache.assume_workload(new_wl, info=wlpkg.Info.from_assignment(
            new_wl, e.info.cluster_queue, e.assignment))
        e.status = ASSUMED
        if self.on_placement is not None:
            # the admit ORDER matters: the oracle's accounting is
            # sequential; the flush keeps the MultiKueue CQs' rows
            self._mk_admits.append((e.info, cq))

        def apply():
            try:
                self.client.apply_admission(new_wl)
            except KeyError:
                # Deleted or CQ gone: roll back the assumption.
                try:
                    self.cache.forget_workload(new_wl)
                except KeyError:
                    pass
                return
            wait_time = wlpkg.queued_wait_time(new_wl, now)
            self.client.event(new_wl, "Normal", "QuotaReserved",
                              f"Quota reserved in ClusterQueue "
                              f"{admission.cluster_queue}, wait time since "
                              f"queued was {wait_time:.0f}s")
            if self.journeys is not None:
                # the ledger observes the wait-time histograms and
                # stamps the journey (one producer for both)
                self.journeys.quota_reserved(
                    new_wl, admission.cluster_queue, wait_time,
                    wlpkg.is_admitted(new_wl))
            elif self.metrics is not None:
                self.metrics.quota_reserved(admission.cluster_queue,
                                            wait_time)
                if wlpkg.is_admitted(new_wl):
                    self.metrics.admitted(admission.cluster_queue, wait_time)
            if wlpkg.is_admitted(new_wl):
                self.client.event(new_wl, "Normal", "Admitted",
                                  f"Admitted by ClusterQueue "
                                  f"{admission.cluster_queue}, wait time "
                                  f"since reservation was 0s")

        apply()

    def _flush_mk_placements(self, snapshot: Snapshot) -> None:
        """Resolve the cycle's MultiKueue placements and hand them to
        on_placement (kueue_tpu/scheduler/scheduler.py:2422). Rows the
        device placed are pinned to its mk_cluster choice; the others
        run the sequential oracle against the snapshot's capacity
        columns, continuing from the pinned rows' consumption."""
        admits, self._mk_admits = self._mk_admits, []
        if self.on_placement is None or not admits:
            return
        cols = snapshot.remote_clusters
        checks = snapshot.mk_check_names
        if not cols or not checks:
            return
        device = getattr(self.solver, "last_placements", None) or {}
        mk, reqs, pinned = [], [], []
        for info, cq in admits:
            if checks.isdisjoint(cq.admission_checks):
                continue
            covers_pods = any(RESOURCE_PODS in rg.covered_resources
                              for rg in cq.resource_groups)
            mk.append(info)
            reqs.append(wlpkg.mk_request_vector(info, covers_pods))
            pinned.append(device.get(info.key))
        if not mk:
            return
        placed = solver_encode.place_remote_dicts(cols, reqs, pinned=pinned)
        for info, cluster in zip(mk, placed):
            if cluster is not None:
                self.on_placement(info.key, cluster)

    def _apply_preemption(self, wl: api.Workload, preempting_cq: str,
                          reason: str, message: str) -> None:
        target = wlpkg.clone_for_status_update(wl)
        now = self.clock.now()
        wlpkg.set_evicted_condition(target, api.EVICTED_BY_PREEMPTION,
                                    message, now)
        wlpkg.set_preempted_condition(target, reason, message, now)
        self.client.apply_admission(target)
        self.client.event(target, "Normal", "Preempted", message)
        if self.metrics is not None:
            self.metrics.preempted(preempting_cq, reason)
        if self.journeys is not None:
            # the victim's journey re-opens
            self.journeys.preempted(wlpkg.key(wl), preempting_cq, reason)

    # --- requeue (reference: scheduler.go:674-692) ---

    def requeue_and_update(self, e: Entry) -> None:
        if e.status != NOT_NOMINATED \
                and e.requeue_reason == RequeueReason.GENERIC:
            e.requeue_reason = RequeueReason.FAILED_AFTER_NOMINATION
        if self.journeys is not None:
            self.journeys.requeued(e.info, e.status, e.requeue_reason,
                                   e.inadmissible_msg)
        self.queues.requeue_workload(e.info, e.requeue_reason)
        if e.status in (NOT_NOMINATED, SKIPPED):
            # Clone only when the Pending condition would actually change.
            if wlpkg.pending_patch_needed(e.info.obj, "Pending",
                                          e.inadmissible_msg):
                patch = wlpkg.clone_for_status_update(e.info.obj)
                wlpkg.unset_quota_reservation_with_condition(
                    patch, "Pending", e.inadmissible_msg, self.clock.now())
                self.client.patch_not_admitted(patch)
            self.client.event(e.info.obj, "Normal", "Pending",
                              e.inadmissible_msg[:1024])

    @staticmethod
    def _set_skipped(e: Entry, msg: str) -> None:
        e.status = SKIPPED
        e.inadmissible_msg = msg
        e.requeue_reason = RequeueReason.GENERIC

    # --- ordering (reference: scheduler.go:625-672) ---

    def _entry_sort_key(self):
        def sort_key(e: Entry):
            borrows = e.assignment.borrows()
            share = e.dominant_resource_share if self.fair_sharing_enabled \
                else 0
            prio = (prioritypkg.priority(e.info.obj)
                    if features.enabled(features.PRIORITY_SORTING_WITHIN_COHORT)
                    else 0)
            ts = self.ordering.queue_order_timestamp(e.info.obj)
            return (borrows, share, -prio, ts)
        return sort_key


def resources_to_reserve(e: Entry, cq: ClusterQueueSnapshot) -> dict:
    """How much capacity a blocked preemptor reserves
    (reference: scheduler.go:444-462)."""
    if e.assignment.representative_mode() != fa.PREEMPT:
        return e.assignment.usage
    reserved = {}
    for fr, usage in e.assignment.usage.items():
        quota = cq.quota_for(fr)
        if e.assignment.borrowing:
            if quota.borrowing_limit is None:
                reserved[fr] = usage
            else:
                reserved[fr] = min(usage, quota.nominal + quota.borrowing_limit
                                   - cq.usage_for(fr))
        else:
            reserved[fr] = max(0, min(usage, quota.nominal - cq.usage_for(fr)))
    return reserved
