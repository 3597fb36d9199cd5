"""Controller configuration schema: defaults + validation.

The port's copy of kueue_tpu/config.py, with the same fields, defaults
and validation, so that one configuration file loads alike in both
packages. Equivalent of the reference's apis/config/v1beta1
(configuration_types.go:30-79, defaults.go:66-191) and pkg/config
(config.go:150, validation.go). Server-endpoint/cert fields that only
make sense against a real apiserver are represented but unused by the
sim runtime.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

# defaults (reference: apis/config/v1beta1/defaults.go:31-51)
DEFAULT_NAMESPACE = "kueue-system"
DEFAULT_CLIENT_CONNECTION_QPS = 20.0
DEFAULT_CLIENT_CONNECTION_BURST = 30
DEFAULT_PODS_READY_TIMEOUT_SECONDS = 5 * 60.0
DEFAULT_QUEUE_VISIBILITY_UPDATE_INTERVAL_SECONDS = 5
DEFAULT_CLUSTER_QUEUES_MAX_COUNT = 10
DEFAULT_MULTIKUEUE_GC_INTERVAL_SECONDS = 60.0
DEFAULT_MULTIKUEUE_ORIGIN = "multikueue"
DEFAULT_MULTIKUEUE_WORKER_LOST_TIMEOUT_SECONDS = 15 * 60.0
DEFAULT_REQUEUING_BACKOFF_BASE_SECONDS = 60
DEFAULT_REQUEUING_BACKOFF_MAX_SECONDS = 3600
DEFAULT_REQUEUING_BACKOFF_JITTER = 0.0001

# requeuing timestamp choices (reference: configuration_types.go:243-257)
EVICTION_TIMESTAMP = "Eviction"
CREATION_TIMESTAMP = "Creation"

# fair-sharing preemption strategies (reference: configuration_types.go:381-397)
LESS_THAN_OR_EQUAL_TO_FINAL_SHARE = "LessThanOrEqualToFinalShare"
LESS_THAN_INITIAL_SHARE = "LessThanInitialShare"

DEFAULT_INTEGRATIONS = ["batch/job"]

ALL_INTEGRATIONS = [
    "batch/job",
    "jobset.x-k8s.io/jobset",
    "kubeflow.org/tfjob",
    "kubeflow.org/pytorchjob",
    "kubeflow.org/paddlejob",
    "kubeflow.org/xgboostjob",
    "kubeflow.org/mxjob",
    "kubeflow.org/mpijob",
    "ray.io/rayjob",
    "ray.io/raycluster",
    "pod",
    "deployment",
]


@dataclass
class RequeuingStrategy:
    """reference: configuration_types.go:233-271"""
    timestamp: str = EVICTION_TIMESTAMP
    backoff_limit_count: Optional[int] = None  # None = endless requeuing
    backoff_base_seconds: int = DEFAULT_REQUEUING_BACKOFF_BASE_SECONDS
    backoff_max_seconds: int = DEFAULT_REQUEUING_BACKOFF_MAX_SECONDS
    backoff_jitter: float = DEFAULT_REQUEUING_BACKOFF_JITTER


@dataclass
class WaitForPodsReady:
    """reference: configuration_types.go:189-231"""
    enable: bool = False
    timeout_seconds: float = DEFAULT_PODS_READY_TIMEOUT_SECONDS
    block_admission: bool = True
    requeuing_strategy: RequeuingStrategy = field(default_factory=RequeuingStrategy)
    recovery_timeout_seconds: Optional[float] = None


@dataclass
class ClientConnection:
    qps: float = DEFAULT_CLIENT_CONNECTION_QPS
    burst: int = DEFAULT_CLIENT_CONNECTION_BURST


@dataclass
class ClusterQueueVisibility:
    max_count: int = DEFAULT_CLUSTER_QUEUES_MAX_COUNT


@dataclass
class QueueVisibility:
    """reference: configuration_types.go:348-367"""
    update_interval_seconds: int = DEFAULT_QUEUE_VISIBILITY_UPDATE_INTERVAL_SECONDS
    cluster_queues: ClusterQueueVisibility = field(default_factory=ClusterQueueVisibility)


@dataclass
class FairSharingConfig:
    """reference: configuration_types.go:381-397"""
    enable: bool = False
    preemption_strategies: list[str] = field(default_factory=list)


@dataclass
class MultiKueueConfig:
    """reference: configuration_types.go:211-231"""
    gc_interval_seconds: float = DEFAULT_MULTIKUEUE_GC_INTERVAL_SECONDS
    origin: str = DEFAULT_MULTIKUEUE_ORIGIN
    worker_lost_timeout_seconds: float = DEFAULT_MULTIKUEUE_WORKER_LOST_TIMEOUT_SECONDS


@dataclass
class PodIntegrationOptions:
    """reference: configuration_types.go:326-346 — which namespaces the pod
    integration may touch (kube-system etc. are always excluded)."""
    namespace_selector_exclude: list[str] = field(
        default_factory=lambda: ["kube-system", DEFAULT_NAMESPACE])


@dataclass
class Integrations:
    """reference: configuration_types.go:307-324"""
    frameworks: list[str] = field(default_factory=lambda: list(DEFAULT_INTEGRATIONS))
    external_frameworks: list[str] = field(default_factory=list)
    pod_options: PodIntegrationOptions = field(default_factory=PodIntegrationOptions)


@dataclass
class Resources:
    """reference: configuration_types.go:369-379"""
    exclude_resource_prefixes: list[str] = field(default_factory=list)


@dataclass
class LeaderElectionConfig:
    """HA replica coordination (reference: cmd/kueue/main.go leader
    election flags + config.Configuration LeaderElection; the scheduler
    is leader-gated via NeedLeaderElection, scheduler.go:144)."""
    leader_elect: bool = False
    # reference default resource name (defaults.go DefaultLeaderElectionID)
    resource_name: str = "c1f6bfd2.kueue.x-k8s.io"
    lease_duration_seconds: float = 15.0
    retry_period_seconds: float = 2.0


DEFAULT_STRICT_AFTER_BLOCKED_CYCLES = 8

# Cycle deadline budget / degradation ladder defaults: the ladder
# module owns them (a directly-constructed DegradationLadder and a
# config-driven one must never disagree); only the budget default —
# pure config policy, 0 disables — lives here.
from kueue_tpu_torch.resilience.degrade import (  # noqa: E402
    DEFAULT_ESCALATE_AFTER as DEFAULT_ESCALATE_AFTER_CYCLES,
    DEFAULT_ENTER_FACTOR as DEFAULT_OVERLOAD_ENTER_FACTOR,
    DEFAULT_EWMA_ALPHA as DEFAULT_CYCLE_EWMA_ALPHA,
    DEFAULT_EXIT_FACTOR as DEFAULT_OVERLOAD_EXIT_FACTOR,
    DEFAULT_RECOVERY_CYCLES,
    DEFAULT_SHED_HEADS,
    DEFAULT_SURVIVAL_HEADS,
)

DEFAULT_CYCLE_BUDGET_S = 0.0        # 0 disables the ladder


@dataclass
class SchedulerConfig:
    """Admission-cycle bounding (kueue_tpu_torch/resilience/degrade.py; no
    reference analogue): a wall-clock budget per cycle and the
    graceful load-shedding ladder engaged when sustained load exceeds
    it. ``cycle_budget_s == 0`` disables the ladder entirely."""
    cycle_budget_s: float = DEFAULT_CYCLE_BUDGET_S
    # shed: cap nominate heads at this many (extras re-heap untouched)
    # and defer preempt planning
    shed_heads: int = DEFAULT_SHED_HEADS
    # survival: tighter top-k cap, cycle pinned to the CPU-incremental
    # route ("cpu-survival")
    survival_heads: int = DEFAULT_SURVIVAL_HEADS
    # hysteresis band: degrade when cycle-time EWMA > budget x enter,
    # recover only below budget x exit (exit <= enter)
    overload_enter_factor: float = DEFAULT_OVERLOAD_ENTER_FACTOR
    overload_exit_factor: float = DEFAULT_OVERLOAD_EXIT_FACTOR
    # consecutive overloaded cycles before stepping a rung up / healthy
    # cycles before stepping one down
    escalate_after_cycles: int = DEFAULT_ESCALATE_AFTER_CYCLES
    recovery_cycles: int = DEFAULT_RECOVERY_CYCLES
    cycle_ewma_alpha: float = DEFAULT_CYCLE_EWMA_ALPHA


# Durable-store defaults (the durable log waits for ROADMAP item 6).
DEFAULT_STORE_CHECKPOINT_EVERY = 512


@dataclass
class StoreConfig:
    """Durability for the sim object store — the "etcd is the
    checkpoint, restart is cheap" property. In the port
    ``durable`` waits for ROADMAP item 6: KueueManager raises
    NotImplementedError when it is set. ``durable`` turns on the checkpoint/WAL
    event log; ``wal_dir`` empty keeps it in fsync-free process memory
    (tests, crash harnesses — the log object outliving the manager IS
    the simulated disk), a path puts checkpoint.bin + wal.log in real
    files. A full checkpoint compacts the WAL every
    ``checkpoint_every`` records."""
    durable: bool = False
    wal_dir: str = ""
    checkpoint_every: int = DEFAULT_STORE_CHECKPOINT_EVERY


# Cycle flight recorder defaults (kueue_tpu_torch/obs/recorder.py).
DEFAULT_FLIGHT_RECORDER_CAPACITY = 256

# Workload journey ledger defaults (kueue_tpu_torch/obs/journey.py).
DEFAULT_JOURNEY_LEDGER_CAPACITY = 8192
DEFAULT_JOURNEY_EXEMPLARS = 8


@dataclass
class ObservabilityConfig:
    """Flight-recorder wiring (kueue_tpu_torch/obs): every scheduler cycle
    produces a structured trace held in a bounded ring of the last
    ``flight_recorder_capacity`` cycles, served via /debug/cycles and
    feeding the cycle_phase_seconds histograms. Disabling drops span
    capture to a single compare per phase (the trace_overhead bench row
    pins both modes at <=1% of a cycle). ``query_plane_enable`` wires
    the snapshot-backed read plane (obs/queryplane.py): every cycle
    seal publishes an immutable pending-position view served by the
    visibility server instead of walking live queue state per request;
    disabling reverts reads to the live (per-request) visibility API
    and restores the maintainer's snapshot shell recycling.

    ``journey_enable`` wires the workload journey ledger
    (obs/journey.py): every workload accumulates a causally-stamped
    span timeline (queued -> requeued(cycle)... -> admitted) in a
    bounded LRU of ``journey_ledger_capacity`` active journeys, with
    the ``journey_exemplars`` slowest completed journeys retained in
    full for /debug/journeys. Disabling drops every hook to one
    is-None compare (the journey_overhead bench row pins both modes
    at <=1% of a cycle) and reverts the wait-time histograms to their
    direct call sites."""
    flight_recorder_enable: bool = True
    flight_recorder_capacity: int = DEFAULT_FLIGHT_RECORDER_CAPACITY
    query_plane_enable: bool = True
    journey_enable: bool = True
    journey_ledger_capacity: int = DEFAULT_JOURNEY_LEDGER_CAPACITY
    journey_exemplars: int = DEFAULT_JOURNEY_EXEMPLARS

# Device-fault containment defaults (kueue_tpu_torch/resilience) — single
# source for both the dataclass defaults and load()'s fallbacks.
DEFAULT_WATCHDOG_SAFETY_FACTOR = 20.0
DEFAULT_WATCHDOG_MIN_DEADLINE_S = 1.0
DEFAULT_WATCHDOG_MAX_DEADLINE_S = 30.0
DEFAULT_BREAKER_FAULT_THRESHOLD = 3
DEFAULT_BREAKER_BACKOFF_BASE_S = 1.0
DEFAULT_BREAKER_BACKOFF_MAX_S = 60.0

# Compile governor defaults (solver/warmgov.py).
DEFAULT_WARMUP_DEADLINE_S = 120.0


@dataclass
class SolverConfig:
    """Solver plane wiring (no reference analogue). In the port the
    solver is the caller's BatchSolver, handed to KueueManager; with
    ``solver=None`` the manager runs the reference's CPU scheduler."""
    enable: bool = False
    max_heads: int = 2048          # padded batch width per solve
    max_flavors: int = 32
    # narrower cycles than this skip the accelerator (dispatch overhead
    # exceeds the win); 0 forces the solver for every cycle
    min_heads: int = 64
    device: str = ""               # "" = the solver's default device
    fallback_on_error: bool = True
    # overlap the decision fetch of cycle N with dispatch of cycle N+1
    # (all-fit cycles; decisions land one cycle later)
    pipeline: bool = True
    # speculative dispatch depth: how many cycles may be in flight at
    # once. 2 (the production default) overlaps the donated arena
    # upload + next solve with TWO outstanding round trips; only
    # honored when every queued dispatch carries a SpeculationToken
    # (the scheduler collapses to 1 otherwise). 1 = the single-slot
    # pipeline.
    pipeline_depth: int = 2
    # "adaptive": measure admitted/sec per engine and run each cycle on
    # the faster one; "always"/"never" pin the device/CPU path
    routing: str = "adaptive"
    # Starvation bound: after this many consecutive cycles with a
    # blocked preempt-mode entry, pin strict sequential semantics
    # (reference resourcesToReserve ordering) until it unblocks; 0
    # disables the bound (the documented unbounded deviation)
    strict_after_blocked_cycles: int = DEFAULT_STRICT_AFTER_BLOCKED_CYCLES
    # Device-fault containment (kueue_tpu_torch/resilience).
    # Watchdog: every device round trip carries a deadline of
    # (estimated device cycle seconds) x safety factor, clamped to
    # [min, max] — a collect past it is abandoned instead of blocking
    # the cycle on a wedged tunnel. min guards a sub-ms local-backend
    # estimate against GC-pause false positives; max is also the
    # no-estimate cold-start deadline (a first cycle may carry a
    # multi-second remote compile).
    watchdog_safety_factor: float = DEFAULT_WATCHDOG_SAFETY_FACTOR
    watchdog_min_deadline_s: float = DEFAULT_WATCHDOG_MIN_DEADLINE_S
    watchdog_max_deadline_s: float = DEFAULT_WATCHDOG_MAX_DEADLINE_S
    # Supervised dispatch (resilience/supervisor.py): run the dispatch
    # body (trace/compile/transfer) on a persistent worker thread under
    # the watchdog deadline, so a hang DURING dispatch is abandoned
    # instead of freezing the scheduler. Off = dispatch runs inline.
    supervise_dispatch: bool = True
    # Breaker: this many CONSECUTIVE device faults pin cycles to the
    # CPU fallback (route "cpu-breaker") until a half-open probe — after
    # exponential backoff from base to max, with jitter — succeeds.
    breaker_fault_threshold: int = DEFAULT_BREAKER_FAULT_THRESHOLD
    breaker_backoff_base_s: float = DEFAULT_BREAKER_BACKOFF_BASE_S
    breaker_backoff_max_s: float = DEFAULT_BREAKER_BACKOFF_MAX_S
    # Compile governor (solver/warmgov.py). compileCacheDir: the
    # governor's per-topology directory root (topo-<fingerprint>); the
    # port keeps no compiled programs there (its kernels are built once
    # into solver/_build/), so it only names the governor's stamp.
    compile_cache_dir: str = ""
    # warmupAtStartup: launch the governor's supervised background
    # warmup thread from KueueManager construction — until a shape
    # bucket is warm, cycles that would dispatch it route "cpu-warmup"
    # (no hot-path compile). Off by default: deterministic callers
    # (tests, tools) attach and start the governor explicitly.
    warmup_at_startup: bool = False
    # Per-bucket warmup deadline: a wedged remote compile abandons the
    # bucket (retried once, then skipped) and the ladder continues.
    warmup_deadline_s: float = DEFAULT_WARMUP_DEADLINE_S


@dataclass
class Configuration:
    # logging verbosity (the --v flag analogue; reference wires zap
    # through cmd/kueue/main.go): V2 cycle summaries, V5 attempts,
    # V6 snapshot dumps
    verbosity: int = 0
    namespace: str = DEFAULT_NAMESPACE
    manage_jobs_without_queue_name: bool = False
    client_connection: ClientConnection = field(default_factory=ClientConnection)
    wait_for_pods_ready: Optional[WaitForPodsReady] = None
    integrations: Integrations = field(default_factory=Integrations)
    queue_visibility: QueueVisibility = field(default_factory=QueueVisibility)
    fair_sharing: FairSharingConfig = field(default_factory=FairSharingConfig)
    multi_kueue: MultiKueueConfig = field(default_factory=MultiKueueConfig)
    resources: Resources = field(default_factory=Resources)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    store: StoreConfig = field(default_factory=StoreConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig)
    leader_election: LeaderElectionConfig = field(
        default_factory=LeaderElectionConfig)
    feature_gates: dict[str, bool] = field(default_factory=dict)


def set_defaults(cfg: Configuration) -> Configuration:
    """SetDefaults_Configuration (reference: defaults.go:66-191).
    Dataclass defaults cover the static values; this normalizes the
    conditional ones."""
    if cfg.wait_for_pods_ready is not None and not cfg.wait_for_pods_ready.enable:
        # timeout/block only meaningful when enabled (defaults.go:121-139)
        cfg.wait_for_pods_ready.block_admission = False
    if cfg.fair_sharing.enable and not cfg.fair_sharing.preemption_strategies:
        cfg.fair_sharing.preemption_strategies = [
            LESS_THAN_OR_EQUAL_TO_FINAL_SHARE, LESS_THAN_INITIAL_SHARE]
    return cfg


def validate(cfg: Configuration) -> list[str]:
    """reference: pkg/config/validation.go — returns a list of error strings."""
    errs = []
    w = cfg.wait_for_pods_ready
    if w is not None and w.enable:
        if w.timeout_seconds <= 0:
            errs.append("waitForPodsReady.timeout must be positive")
        rs = w.requeuing_strategy
        if rs.timestamp not in (EVICTION_TIMESTAMP, CREATION_TIMESTAMP):
            errs.append(f"waitForPodsReady.requeuingStrategy.timestamp: "
                        f"unsupported value {rs.timestamp!r}")
        if rs.backoff_limit_count is not None and rs.backoff_limit_count < 0:
            errs.append("waitForPodsReady.requeuingStrategy.backoffLimitCount "
                        "must be >= 0")
        if rs.backoff_base_seconds < 0:
            errs.append("waitForPodsReady.requeuingStrategy.backoffBaseSeconds "
                        "must be >= 0")
        if rs.backoff_max_seconds < 0:
            errs.append("waitForPodsReady.requeuingStrategy.backoffMaxSeconds "
                        "must be >= 0")
    for strategy in cfg.fair_sharing.preemption_strategies:
        if strategy not in (LESS_THAN_OR_EQUAL_TO_FINAL_SHARE, LESS_THAN_INITIAL_SHARE):
            errs.append(f"fairSharing.preemptionStrategies: unsupported value "
                        f"{strategy!r}")
    seen = set()
    for fw in cfg.integrations.frameworks:
        if fw not in ALL_INTEGRATIONS:
            errs.append(f"integrations.frameworks: unsupported framework {fw!r}")
        if fw in seen:
            errs.append(f"integrations.frameworks: duplicate framework {fw!r}")
        seen.add(fw)
    if cfg.multi_kueue.gc_interval_seconds < 0:
        errs.append("multiKueue.gcInterval must be >= 0")
    if cfg.multi_kueue.worker_lost_timeout_seconds < 0:
        errs.append("multiKueue.workerLostTimeout must be >= 0")
    if not _valid_label_value(cfg.multi_kueue.origin):
        errs.append("multiKueue.origin must be a valid label value")
    if cfg.solver.max_heads <= 0 or cfg.solver.max_flavors <= 0:
        errs.append("solver.maxHeads and solver.maxFlavors must be positive")
    if cfg.solver.strict_after_blocked_cycles < 0:
        errs.append("solver.strictAfterBlockedCycles must be >= 0 "
                    "(0 disables the starvation bound)")
    if cfg.solver.routing not in ("adaptive", "always", "never"):
        errs.append("solver.routing must be adaptive, always, or never")
    if cfg.solver.pipeline_depth < 1:
        errs.append("solver.pipelineDepth must be >= 1")
    if cfg.solver.watchdog_safety_factor <= 0 \
            or cfg.solver.watchdog_min_deadline_s <= 0 \
            or cfg.solver.watchdog_max_deadline_s \
            < cfg.solver.watchdog_min_deadline_s:
        errs.append("solver.watchdog: safetyFactor and minDeadline must be "
                    "positive with maxDeadline >= minDeadline")
    if cfg.solver.breaker_fault_threshold < 1:
        errs.append("solver.breakerFaultThreshold must be >= 1")
    if cfg.solver.breaker_backoff_base_s <= 0 \
            or cfg.solver.breaker_backoff_max_s \
            < cfg.solver.breaker_backoff_base_s:
        errs.append("solver.breakerBackoff: base must be positive and "
                    "max >= base")
    if cfg.solver.warmup_deadline_s <= 0:
        errs.append("solver.warmupDeadline must be positive")
    if cfg.observability.flight_recorder_capacity < 1:
        errs.append("observability.flightRecorderCapacity must be >= 1")
    if cfg.observability.journey_ledger_capacity < 1:
        errs.append("observability.journeyLedgerCapacity must be >= 1")
    if cfg.observability.journey_exemplars < 1:
        errs.append("observability.journeyExemplars must be >= 1")
    sc = cfg.scheduler
    if sc.cycle_budget_s < 0:
        errs.append("scheduler.cycleBudget must be >= 0 (0 disables "
                    "the degradation ladder)")
    if sc.shed_heads < 1 or sc.survival_heads < 1:
        errs.append("scheduler.shedHeads and scheduler.survivalHeads "
                    "must be >= 1")
    if not 0 < sc.overload_exit_factor <= sc.overload_enter_factor:
        errs.append("scheduler.overloadExitFactor must be in (0, "
                    "overloadEnterFactor] (the hysteresis band)")
    if sc.escalate_after_cycles < 1 or sc.recovery_cycles < 1:
        errs.append("scheduler.escalateAfterCycles and "
                    "scheduler.recoveryCycles must be >= 1")
    if not 0 < sc.cycle_ewma_alpha <= 1:
        errs.append("scheduler.cycleEwmaAlpha must be in (0, 1]")
    if cfg.store.checkpoint_every < 0:
        errs.append("store.checkpointEvery must be >= 0 (0 disables "
                    "automatic WAL compaction)")
    return errs


def _valid_label_value(v: str) -> bool:
    if len(v) > 63:
        return False
    if not v:
        return True
    ok = lambda c: c.isalnum() or c in "-_."
    return v[0].isalnum() and v[-1].isalnum() and all(ok(c) for c in v)


def load(raw: dict) -> Configuration:
    """Build a Configuration from a plain dict (the file format), apply
    defaults, and raise ValueError on validation failure
    (reference: pkg/config/config.go:150 Load)."""
    cfg = Configuration()
    if "namespace" in raw:
        cfg.namespace = raw["namespace"]
    cfg.manage_jobs_without_queue_name = raw.get("manageJobsWithoutQueueName", False)
    if "waitForPodsReady" in raw:
        w = raw["waitForPodsReady"]
        rs = w.get("requeuingStrategy", {})
        cfg.wait_for_pods_ready = WaitForPodsReady(
            enable=w.get("enable", False),
            timeout_seconds=w.get("timeout", DEFAULT_PODS_READY_TIMEOUT_SECONDS),
            block_admission=w.get("blockAdmission", True),
            recovery_timeout_seconds=w.get("recoveryTimeout"),
            requeuing_strategy=RequeuingStrategy(
                timestamp=rs.get("timestamp", EVICTION_TIMESTAMP),
                backoff_limit_count=rs.get("backoffLimitCount"),
                backoff_base_seconds=rs.get("backoffBaseSeconds",
                                            DEFAULT_REQUEUING_BACKOFF_BASE_SECONDS),
                backoff_max_seconds=rs.get("backoffMaxSeconds",
                                           DEFAULT_REQUEUING_BACKOFF_MAX_SECONDS),
                backoff_jitter=rs.get("backoffJitter",
                                      DEFAULT_REQUEUING_BACKOFF_JITTER),
            ),
        )
    if "integrations" in raw:
        i = raw["integrations"]
        pod_opts = i.get("podOptions", {})
        cfg.integrations = Integrations(
            frameworks=i.get("frameworks", list(DEFAULT_INTEGRATIONS)),
            external_frameworks=i.get("externalFrameworks", []),
            pod_options=PodIntegrationOptions(
                namespace_selector_exclude=pod_opts.get(
                    "namespaceSelectorExclude",
                    ["kube-system", DEFAULT_NAMESPACE])),
        )
    if "queueVisibility" in raw:
        q = raw["queueVisibility"]
        cfg.queue_visibility = QueueVisibility(
            update_interval_seconds=q.get(
                "updateIntervalSeconds", DEFAULT_QUEUE_VISIBILITY_UPDATE_INTERVAL_SECONDS),
            cluster_queues=ClusterQueueVisibility(
                max_count=q.get("clusterQueues", {}).get(
                    "maxCount", DEFAULT_CLUSTER_QUEUES_MAX_COUNT)),
        )
    if "fairSharing" in raw:
        f = raw["fairSharing"]
        cfg.fair_sharing = FairSharingConfig(
            enable=f.get("enable", False),
            preemption_strategies=f.get("preemptionStrategies", []),
        )
    if "multiKueue" in raw:
        m = raw["multiKueue"]
        cfg.multi_kueue = MultiKueueConfig(
            gc_interval_seconds=m.get("gcInterval", DEFAULT_MULTIKUEUE_GC_INTERVAL_SECONDS),
            origin=m.get("origin", DEFAULT_MULTIKUEUE_ORIGIN),
            worker_lost_timeout_seconds=m.get(
                "workerLostTimeout", DEFAULT_MULTIKUEUE_WORKER_LOST_TIMEOUT_SECONDS),
        )
    if "resources" in raw:
        cfg.resources = Resources(
            exclude_resource_prefixes=raw["resources"].get("excludeResourcePrefixes", []))
    if "scheduler" in raw:
        sc = raw["scheduler"]
        cfg.scheduler = SchedulerConfig(
            cycle_budget_s=sc.get("cycleBudget", DEFAULT_CYCLE_BUDGET_S),
            shed_heads=sc.get("shedHeads", DEFAULT_SHED_HEADS),
            survival_heads=sc.get("survivalHeads", DEFAULT_SURVIVAL_HEADS),
            overload_enter_factor=sc.get(
                "overloadEnterFactor", DEFAULT_OVERLOAD_ENTER_FACTOR),
            overload_exit_factor=sc.get(
                "overloadExitFactor", DEFAULT_OVERLOAD_EXIT_FACTOR),
            escalate_after_cycles=sc.get(
                "escalateAfterCycles", DEFAULT_ESCALATE_AFTER_CYCLES),
            recovery_cycles=sc.get("recoveryCycles",
                                   DEFAULT_RECOVERY_CYCLES),
            cycle_ewma_alpha=sc.get("cycleEwmaAlpha",
                                    DEFAULT_CYCLE_EWMA_ALPHA),
        )
    if "store" in raw:
        st = raw["store"]
        cfg.store = StoreConfig(
            durable=st.get("durable", False),
            wal_dir=st.get("walDir", ""),
            checkpoint_every=st.get("checkpointEvery",
                                    DEFAULT_STORE_CHECKPOINT_EVERY),
        )
    if "solver" in raw:
        s = raw["solver"]
        cfg.solver = SolverConfig(
            enable=s.get("enable", False),
            max_heads=s.get("maxHeads", 2048),
            max_flavors=s.get("maxFlavors", 32),
            min_heads=s.get("minHeads", 64),
            device=s.get("device", ""),
            fallback_on_error=s.get("fallbackOnError", True),
            pipeline=s.get("pipeline", True),
            pipeline_depth=s.get("pipelineDepth", 2),
            routing=s.get("routing", "adaptive"),
            strict_after_blocked_cycles=s.get(
                "strictAfterBlockedCycles",
                DEFAULT_STRICT_AFTER_BLOCKED_CYCLES),
            watchdog_safety_factor=s.get(
                "watchdogSafetyFactor", DEFAULT_WATCHDOG_SAFETY_FACTOR),
            watchdog_min_deadline_s=s.get(
                "watchdogMinDeadline", DEFAULT_WATCHDOG_MIN_DEADLINE_S),
            watchdog_max_deadline_s=s.get(
                "watchdogMaxDeadline", DEFAULT_WATCHDOG_MAX_DEADLINE_S),
            breaker_fault_threshold=s.get(
                "breakerFaultThreshold", DEFAULT_BREAKER_FAULT_THRESHOLD),
            breaker_backoff_base_s=s.get(
                "breakerBackoffBase", DEFAULT_BREAKER_BACKOFF_BASE_S),
            breaker_backoff_max_s=s.get(
                "breakerBackoffMax", DEFAULT_BREAKER_BACKOFF_MAX_S),
            supervise_dispatch=s.get("superviseDispatch", True),
            compile_cache_dir=s.get("compileCacheDir", ""),
            warmup_at_startup=s.get("warmupAtStartup", False),
            warmup_deadline_s=s.get("warmupDeadline",
                                    DEFAULT_WARMUP_DEADLINE_S),
        )
    if "observability" in raw:
        o = raw["observability"]
        cfg.observability = ObservabilityConfig(
            flight_recorder_enable=o.get("flightRecorderEnable", True),
            flight_recorder_capacity=o.get(
                "flightRecorderCapacity", DEFAULT_FLIGHT_RECORDER_CAPACITY),
            query_plane_enable=o.get("queryPlaneEnable", True),
            journey_enable=o.get("journeyEnable", True),
            journey_ledger_capacity=o.get(
                "journeyLedgerCapacity", DEFAULT_JOURNEY_LEDGER_CAPACITY),
            journey_exemplars=o.get(
                "journeyExemplars", DEFAULT_JOURNEY_EXEMPLARS),
        )
    cfg.feature_gates = dict(raw.get("featureGates", {}))
    cfg = set_defaults(cfg)
    errs = validate(cfg)
    if errs:
        raise ValueError("invalid configuration: " + "; ".join(errs))
    return cfg
