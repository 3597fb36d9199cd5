"""Prometheus-style metrics registry.

The port's copy of kueue_tpu/metrics.py (same metric names, labels and
buckets). Equivalent of the reference's pkg/metrics/metrics.go:55-256. Implemented
as a dependency-free registry (counters/gauges/histograms keyed by label
tuples) with a text exposition dump; the report helpers mirror the
reference's function-per-transition API (AdmissionAttempt,
QuotaReservedWorkload, ReportEvictedWorkloads, ...), and wait-time
histograms use the same exponential 1 s -> 10,240 s buckets
(generateExponentialBuckets, metrics.go:258-260).
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence

# admission results (reference: metrics.go:30-36)
ADMISSION_RESULT_SUCCESS = "success"
ADMISSION_RESULT_INADMISSIBLE = "inadmissible"

# cluster-queue statuses (reference: metrics.go:40-56)
CQ_STATUS_PENDING = "pending"
CQ_STATUS_ACTIVE = "active"
CQ_STATUS_TERMINATING = "terminating"
CQ_STATUSES = [CQ_STATUS_PENDING, CQ_STATUS_ACTIVE, CQ_STATUS_TERMINATING]

# pending-workload statuses (reference: metrics.go:97-106)
PENDING_STATUS_ACTIVE = "active"
PENDING_STATUS_INADMISSIBLE = "inadmissible"


def exponential_buckets(start: float, factor: float, count: int) -> list[float]:
    return [start * factor**i for i in range(count)]


def _bucket_quantile(buckets: list, counts: list, total: int,
                     q: float) -> float:
    """Promql-style bucket interpolation shared by Histogram.percentile
    and Registry.phase_percentile; ``counts`` are per-bucket
    (non-cumulative) including the +Inf bucket. Values past the last
    finite bucket clamp to it."""
    if total == 0 or not buckets:
        return math.nan
    target = q * total
    cum = 0
    lower = 0.0
    for i, ub in enumerate(buckets):
        prev = cum
        cum += counts[i]
        if cum >= target:
            frac = (target - prev) / counts[i] if counts[i] else 0.0
            return lower + (ub - lower) * frac
        lower = ub
    return buckets[-1]


def wait_time_buckets() -> list[float]:
    """1, 2.5, 5, 10, ... 10240 (reference: metrics.go:258-260, count=14)."""
    return [1.0] + exponential_buckets(2.5, 2, 13)


_DEFAULT_BUCKETS = [0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10]

# Cycle-phase spans are sub-millisecond to seconds (a remote compile);
# finer low buckets than the default so encode/route regressions move
# the estimated percentiles.
_PHASE_BUCKETS = [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                  0.1, 0.25, 0.5, 1.0, 2.5, 5.0]
_HEADS_BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096]

# breaker_state gauge encoding (resilience.breaker state names)
BREAKER_STATE_CODES = {"closed": 0, "half-open": 1, "open": 2}

# degraded_state gauge encoding: the ladder owns the mapping (a rung
# added there must never silently report -1 here)
from kueue_tpu_torch.resilience.degrade import (  # noqa: E402
    STATE_CODES as DEGRADED_STATE_CODES,
)


# shard_state gauge encoding (kueue_tpu/parallel/shards.py's states)
SHARD_STATE_CODES = {"active": 0, "killed": 1, "fenced": 2}


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Sequence[str]):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> tuple:
        return tuple(labels.get(n, "") for n in self.label_names)

    def delete_partial_match(self, match: dict) -> None:
        idxs = {self.label_names.index(k): v for k, v in match.items()}
        with self._lock:
            for key in [k for k in self._series()
                        if all(k[i] == v for i, v in idxs.items())]:
                self._delete(key)


class _ValueMetric(_Metric):
    """Shared scalar-series storage for Counter and Gauge: one float
    per label key, deltas applied under the metric's own lock
    (concurrent HTTP threads drive e.g. the in-flight-reads gauge; a
    read-modify-write through value()/set() would drop counts)."""

    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, label_names)
        self.values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self.values[key] = self.values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self.values.get(self._key(labels), 0.0)

    def _series(self):
        return list(self.values)

    def _delete(self, key):
        self.values.pop(key, None)


class Counter(_ValueMetric):
    pass


class Gauge(_ValueMetric):
    def set(self, value: float, **labels) -> None:
        with self._lock:
            self.values[self._key(labels)] = value


class Histogram(_Metric):
    def __init__(self, name, help_, label_names=(), buckets: Optional[list] = None):
        super().__init__(name, help_, label_names)
        self.buckets = list(buckets) if buckets else list(_DEFAULT_BUCKETS)
        # key -> (bucket counts incl +Inf, sum, count)
        self.series: dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            if key not in self.series:
                self.series[key] = [[0] * (len(self.buckets) + 1), 0.0, 0]
            counts, _, _ = self.series[key]
            idx = len(self.buckets)
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    idx = i
                    break
            counts[idx] += 1
            self.series[key][1] += value
            self.series[key][2] += 1

    def count(self, **labels) -> int:
        s = self.series.get(self._key(labels))
        return s[2] if s else 0

    def sum(self, **labels) -> float:
        s = self.series.get(self._key(labels))
        return s[1] if s else 0.0

    def percentile(self, q: float, **labels) -> float:
        """Estimate the q-quantile from bucket counts (promql-style)."""
        s = self.series.get(self._key(labels))
        if not s or s[2] == 0:
            return math.nan
        counts, _, total = s
        return _bucket_quantile(self.buckets, counts, total, q)

    def _series(self):
        return list(self.series)

    def _delete(self, key):
        self.series.pop(key, None)


class Registry:
    """One instance per manager; tests construct their own
    (the reference's package-level singletons make parallel tests share
    state — avoided here)."""

    def __init__(self):
        wt = wait_time_buckets()
        self.admission_attempts_total = Counter(
            "kueue_admission_attempts_total",
            "Total number of attempts to admit workloads (label result: success|inadmissible)",
            ["result"])
        self.admission_attempt_duration = Histogram(
            "kueue_admission_attempt_duration_seconds",
            "Latency of an admission attempt", ["result"])
        self.admission_cycle_preemption_skips = Gauge(
            "kueue_admission_cycle_preemption_skips",
            "Workloads skipped in the last cycle because of overlapping preemptions",
            ["cluster_queue"])
        self.pending_workloads = Gauge(
            "kueue_pending_workloads",
            "Number of pending workloads (label status: active|inadmissible)",
            ["cluster_queue", "status"])
        self.quota_reserved_workloads_total = Counter(
            "kueue_quota_reserved_workloads_total",
            "Total number of quota-reserved workloads", ["cluster_queue"])
        self.quota_reserved_wait_time = Histogram(
            "kueue_quota_reserved_wait_time_seconds",
            "Time from creation/requeue to quota reservation",
            ["cluster_queue"], buckets=wt)
        self.admitted_workloads_total = Counter(
            "kueue_admitted_workloads_total",
            "Total number of admitted workloads", ["cluster_queue"])
        self.admission_wait_time = Histogram(
            "kueue_admission_wait_time_seconds",
            "Time from creation/requeue to admission", ["cluster_queue"], buckets=wt)
        self.admission_checks_wait_time = Histogram(
            "kueue_admission_checks_wait_time_seconds",
            "Time from quota reservation to admission", ["cluster_queue"], buckets=wt)
        self.evicted_workloads_total = Counter(
            "kueue_evicted_workloads_total",
            "Total evicted workloads by reason", ["cluster_queue", "reason"])
        self.preempted_workloads_total = Counter(
            "kueue_preempted_workloads_total",
            "Total preempted workloads by reason", ["preempting_cluster_queue", "reason"])
        self.reserving_active_workloads = Gauge(
            "kueue_reserving_active_workloads",
            "Workloads currently reserving quota", ["cluster_queue"])
        self.admitted_active_workloads = Gauge(
            "kueue_admitted_active_workloads",
            "Workloads currently admitted", ["cluster_queue"])
        self.cluster_queue_status = Gauge(
            "kueue_cluster_queue_status",
            "ClusterQueue status flags (pending|active|terminating)",
            ["cluster_queue", "status"])
        # optional per-resource metrics (reference: metrics.go:207-255)
        self.cluster_queue_resource_reservation = Gauge(
            "kueue_cluster_queue_resource_reservation",
            "Reserved quantity per CQ/flavor/resource",
            ["cohort", "cluster_queue", "flavor", "resource"])
        self.cluster_queue_resource_usage = Gauge(
            "kueue_cluster_queue_resource_usage",
            "Admitted usage per CQ/flavor/resource",
            ["cohort", "cluster_queue", "flavor", "resource"])
        self.cluster_queue_nominal_quota = Gauge(
            "kueue_cluster_queue_nominal_quota",
            "Nominal quota per CQ/flavor/resource",
            ["cohort", "cluster_queue", "flavor", "resource"])
        self.cluster_queue_borrowing_limit = Gauge(
            "kueue_cluster_queue_borrowing_limit",
            "Borrowing limit per CQ/flavor/resource",
            ["cohort", "cluster_queue", "flavor", "resource"])
        self.cluster_queue_lending_limit = Gauge(
            "kueue_cluster_queue_lending_limit",
            "Lending limit per CQ/flavor/resource",
            ["cohort", "cluster_queue", "flavor", "resource"])
        self.cluster_queue_weighted_share = Gauge(
            "kueue_cluster_queue_weighted_share",
            "Maximum weighted borrowed share (0 = within nominal quota)",
            ["cluster_queue"])
        # Device-fault containment (kueue_tpu/resilience; no reference
        # analogue): solver-path faults, watchdog timeouts, breaker
        # trips, and how long the last outage took to recover.
        self.device_faults_total = Counter(
            "kueue_solver_device_faults_total",
            "Device-path faults by site (dispatch|collect|solve|prepare)",
            ["site"])
        self.dispatch_timeouts_total = Counter(
            "kueue_solver_dispatch_timeouts_total",
            "Device collects abandoned by the dispatch watchdog deadline")
        self.breaker_trips_total = Counter(
            "kueue_solver_breaker_trips_total",
            "Circuit-breaker trips (device route suspended to cpu-breaker)")
        self.fault_recovery_cycles = Gauge(
            "kueue_solver_fault_recovery_cycles",
            "Cycles from the last breaker trip until the device route "
            "was restored by a successful half-open probe")
        # Cycle flight recorder (kueue_tpu/obs): per-cycle phase spans,
        # fed from each sealed CycleTrace so /debug/cycles and /metrics
        # reconcile by construction.
        self.cycle_phase_seconds = Histogram(
            "kueue_cycle_phase_seconds",
            "Per-cycle wall seconds by phase (snapshot|encode|route|"
            "dispatch|fetch|decode|preempt-plan|nominate|apply|requeue) "
            "and route", ["phase", "route"], buckets=_PHASE_BUCKETS)
        self.cycle_heads = Histogram(
            "kueue_cycle_heads",
            "Heads processed per admission cycle by route",
            ["route"], buckets=_HEADS_BUCKETS)
        self.breaker_state = Gauge(
            "kueue_solver_breaker_state",
            "Circuit-breaker state (0=closed, 1=half-open, 2=open)")
        # Bounded-cycle admission (kueue_tpu/resilience/degrade.py +
        # supervisor.py): degradation-ladder state, shed cycles, and
        # dispatches abandoned by the supervised worker deadline.
        self.degraded_state = Gauge(
            "kueue_scheduler_degraded_state",
            "Degradation-ladder state (0=normal, 1=shed, 2=survival)")
        self.cycles_shed_total = Counter(
            "kueue_scheduler_cycles_shed_total",
            "Admission cycles run in a degraded state (label state: "
            "shed|survival)", ["state"])
        self.dispatch_supervised_timeouts_total = Counter(
            "kueue_solver_dispatch_supervised_timeouts_total",
            "Dispatches abandoned by the supervised solver-worker "
            "deadline (hang during trace/compile/transfer)")
        # Compile governor (solver/warmgov.py + solver/COMPILE.md):
        # per-bucket compile provenance and the governor's warm-state
        # machine, plus warmup attempts that faulted.
        self.compile_events_total = Counter(
            "kueue_solver_compile_events_total",
            "Kernel programs compiled or loaded per shape bucket by "
            "source (fresh|cache-hit|jit-cache)", ["bucket", "source"])
        self.warmup_state = Gauge(
            "kueue_solver_warmup_state",
            "Compile-governor state (0=idle, 1=warming, 2=warm, "
            "3=partial)")
        self.warmup_faults_total = Counter(
            "kueue_solver_warmup_faults_total",
            "Warmup bucket attempts that faulted (compile errors or "
            "per-bucket deadline abandonments; the ladder continues)")
        # Speculative admission pipeline (scheduler/PIPELINE.md):
        # validated-and-committed speculative cycles vs mis-speculation
        # aborts by validation reason (topology-epoch | cohort-epoch |
        # flavor-spec-epoch | residency | arena-slots |
        # journal-overflow | injected).
        self.speculation_hits_total = Counter(
            "kueue_scheduler_speculation_hits_total",
            "Speculative pipelined results validated and committed")
        self.speculation_aborts_total = Counter(
            "kueue_scheduler_speculation_aborts_total",
            "Speculative pipelined results abandoned at apply-validation "
            "by reason", ["reason"])
        # Crash-restart durability (resilience/recovery.py +
        # RESILIENCE.md §6): restarts recovered from the durable store
        # and how long the rebuild (load + replay + settle) took.
        self.restarts_total = Counter(
            "kueue_manager_restarts_total",
            "Control-plane restarts recovered from the durable store")
        self.recovery_seconds = Histogram(
            "kueue_manager_recovery_seconds",
            "Wall seconds from restore() entry to a settled control "
            "plane (checkpoint load + WAL replay + reconcile drain)",
            buckets=exponential_buckets(0.005, 2.0, 16))
        # Hot-standby replication (resilience/replica.py +
        # RESILIENCE.md §7): how far the follower's WAL tail replay
        # lags the leader's append head, the fencing epoch in effect,
        # and standby-to-leader promotions.
        self.replication_lag_records = Gauge(
            "kueue_replication_lag_records",
            "WAL records appended by the leader that this standby "
            "replica has not yet applied (refreshed at every poll; 0 "
            "after a drain)")
        self.replication_lag_seconds = Gauge(
            "kueue_replication_lag_seconds",
            "Virtual seconds between the newest WAL record and the "
            "newest this replica applied")
        self.fencing_epoch_gauge = Gauge(
            "kueue_fencing_epoch",
            "The durable log's current leader-lease fencing epoch as "
            "this replica last observed it (a deposed leader's writes "
            "are rejected the moment this advances past its token)")
        self.promotions_total = Counter(
            "kueue_replica_promotions_total",
            "Standby replicas promoted to leadership (sub-cycle "
            "failover, RESILIENCE.md §7)")
        self.promotion_seconds = Histogram(
            "kueue_replica_promotion_seconds",
            "Wall seconds for a standby promotion (fence + tail drain "
            "+ settle + checkpoint)",
            buckets=exponential_buckets(0.001, 2.0, 16))
        # Snapshot-backed query plane (obs/queryplane.py): read-side
        # saturation — per-route request counts by HTTP code, request
        # latency, the sealed view's age, and reads in flight. Fed by
        # the VisibilityServer so the read plane's load shows up in the
        # SAME registry the admission metrics live in.
        self.visibility_requests_total = Counter(
            "kueue_visibility_requests_total",
            "Visibility/query-plane HTTP requests by route and status "
            "code (routes: cq_pending|lq_pending|workload|metrics|"
            "debug|unknown)", ["route", "code"])
        self.visibility_request_seconds = Histogram(
            "kueue_visibility_request_seconds",
            "Visibility/query-plane HTTP request latency by route",
            ["route"], buckets=_PHASE_BUCKETS)
        self.visibility_snapshot_age_seconds = Gauge(
            "kueue_visibility_snapshot_age_seconds",
            "Age of the query plane's sealed view (seconds since the "
            "last cycle-seal publish; 0 is written at each publish)")
        self.visibility_inflight_reads = Gauge(
            "kueue_visibility_inflight_reads",
            "Query-plane HTTP reads currently being served")
        # Workload journey ledger (obs/journey.py): per-class
        # time-to-admission SLIs folded from sealed journeys (the SAME
        # seal that feeds admission_wait_time — one emission site, so
        # /debug/journeys and /metrics reconcile by construction), the
        # requeue-amplification soak invariant (ROADMAP item 5), the
        # burn-rate evaluator's output, and the ledger's LRU pressure.
        self.journey_tta_seconds = Histogram(
            "kueue_journey_tta_seconds",
            "Time-to-admission of sealed workload journeys by SLI class",
            ["cls"], buckets=wt)
        self.journeys_completed_total = Counter(
            "kueue_journeys_completed_total",
            "Workload journeys sealed by full admission, by SLI class",
            ["cls"])
        self.requeues_per_admission = Gauge(
            "kueue_requeues_per_admission",
            "Requeue-class journey events (cycle re-heaps: requeued or "
            "shed) per sealed admission — the requeue-amplification "
            "soak invariant (ROADMAP item 5); refreshed at each cycle "
            "seal")
        self.slo_burn_rate = Gauge(
            "kueue_slo_burn_rate",
            "Per-class SLO burn rate: EWMA of the TTA-objective "
            "violation indicator divided by the error budget fraction "
            "(1.0 = burning exactly at budget; >1 = too fast)", ["cls"])
        self.journey_ledger_evictions_total = Counter(
            "kueue_journey_ledger_evictions_total",
            "Active journeys dropped by the ledger's LRU capacity bound")
        # Coarse reconciler latency (the
        # wall_s - cycle_time_total gap had no signal); fed by the sim
        # Runtime around every reconcile call.
        self.reconcile_seconds = Histogram(
            "kueue_reconcile_seconds",
            "Reconcile latency by controller", ["controller"],
            buckets=_PHASE_BUCKETS)
        # Per-event split of the reconcile latency (it was left
        # coarse): the hot reconcilers time their internal event
        # handlers and feed this alongside nested flight-recorder spans
        # (reconcile.{controller}.{event}).
        self.reconcile_event_seconds = Histogram(
            "kueue_reconcile_event_seconds",
            "Reconcile latency by controller and handled event",
            ["controller", "event"], buckets=_PHASE_BUCKETS)
        # Sharded admission control plane (parallel/shards.py +
        # RESILIENCE.md §9): per-shard lifecycle state, planner-driven
        # cohort moves, and per-shard admission throughput.
        self.shard_state = Gauge(
            "kueue_shard_state",
            "Admission shard lifecycle state "
            "(0=active 1=killed 2=fenced)", ["shard"])
        self.shard_rebalances_total = Counter(
            "kueue_shard_rebalances_total",
            "Planner-driven cohort moves between admission shards")
        self.shard_admitted_total = Counter(
            "kueue_shard_admitted_total",
            "Workloads admitted, by owning admission shard", ["shard"])
        self.shard_promotions_total = Counter(
            "kueue_shard_promotions_total",
            "Hot-promotions of a replacement shard over a killed or "
            "fenced one", ["shard"])
        self._all = [v for v in vars(self).values() if isinstance(v, _Metric)]

    # --- report helpers (reference: metrics.go:262-400) ---

    def admission_attempt(self, result: str, duration_s: float) -> None:
        self.admission_attempts_total.inc(result=result)
        self.admission_attempt_duration.observe(duration_s, result=result)

    def quota_reserved_workload(self, cq: str, wait_s: float) -> None:
        self.quota_reserved_workloads_total.inc(cluster_queue=cq)
        self.quota_reserved_wait_time.observe(wait_s, cluster_queue=cq)

    def admitted_workload(self, cq: str, wait_s: float) -> None:
        self.admitted_workloads_total.inc(cluster_queue=cq)
        self.admission_wait_time.observe(wait_s, cluster_queue=cq)

    # short aliases used by the scheduler hot path
    def quota_reserved(self, cq: str, wait_s: float) -> None:
        self.quota_reserved_workload(cq, wait_s)

    def admitted(self, cq: str, wait_s: float) -> None:
        self.admitted_workload(cq, wait_s)

    def preempted(self, preempting_cq: str, reason: str) -> None:
        self.preempted_workloads_total.inc(
            preempting_cluster_queue=preempting_cq, reason=reason)

    def preemption_skips(self, cq: str, count: int) -> None:
        self.admission_cycle_preemption_skips.set(count, cluster_queue=cq)

    def device_fault(self, site: str, timeout: bool = False,
                     tripped: bool = False,
                     supervised: bool = False) -> None:
        self.device_faults_total.inc(site=site)
        if timeout:
            self.dispatch_timeouts_total.inc()
        if supervised:
            self.dispatch_supervised_timeouts_total.inc()
        if tripped:
            self.breaker_trips_total.inc()

    def fault_recovered(self, cycles: int) -> None:
        self.fault_recovery_cycles.set(cycles)

    def compile_event(self, bucket: str, source: str, n: int = 1) -> None:
        self.compile_events_total.inc(n, bucket=bucket, source=source)

    def set_warmup_state(self, state: str) -> None:
        # Lazy import: the governor module owns the state encoding, but
        # pulls in the solver package (torch): callers without a
        # governor must not pay that import.
        from kueue_tpu_torch.solver.warmgov import WARMUP_STATE_CODES
        self.warmup_state.set(WARMUP_STATE_CODES.get(state, -1))

    def warmup_fault(self) -> None:
        self.warmup_faults_total.inc()

    def set_degraded_state(self, state: str) -> None:
        self.degraded_state.set(DEGRADED_STATE_CODES.get(state, -1))

    def cycle_shed(self, state: str) -> None:
        self.cycles_shed_total.inc(state=state)

    def reconcile_observed(self, controller: str, seconds: float) -> None:
        self.reconcile_seconds.observe(seconds, controller=controller)

    def reconcile_event(self, controller: str, event: str,
                        seconds: float) -> None:
        self.reconcile_event_seconds.observe(seconds,
                                             controller=controller,
                                             event=event)

    def restart_recovered(self, seconds: float) -> None:
        self.restarts_total.inc()
        self.recovery_seconds.observe(seconds)

    def replication_lag(self, records: float, seconds: float) -> None:
        self.replication_lag_records.set(records)
        self.replication_lag_seconds.set(seconds)

    def set_fencing_epoch(self, epoch: int) -> None:
        self.fencing_epoch_gauge.set(epoch)

    def set_shard_state(self, shard: str, state: str) -> None:
        # the sharded control plane is not ported: its encoding is
        # copied here (kueue_tpu/parallel/shards.py:75)
        self.shard_state.set(SHARD_STATE_CODES.get(state, -1), shard=shard)

    def shard_admitted(self, shard: str, n: int) -> None:
        if n:
            self.shard_admitted_total.inc(n, shard=shard)

    def shard_rebalanced(self) -> None:
        self.shard_rebalances_total.inc()

    def shard_promoted(self, shard: str) -> None:
        self.shard_promotions_total.inc(shard=shard)

    def replica_promoted(self, epoch: int, seconds: float) -> None:
        self.promotions_total.inc()
        self.promotion_seconds.observe(seconds)
        self.fencing_epoch_gauge.set(epoch)

    def visibility_request(self, route: str, code: int,
                           seconds: float) -> None:
        self.visibility_requests_total.inc(route=route, code=str(code))
        self.visibility_request_seconds.observe(seconds, route=route)

    def visibility_read_begin(self) -> None:
        self.visibility_inflight_reads.inc(1)

    def visibility_read_end(self) -> None:
        self.visibility_inflight_reads.inc(-1)

    def set_visibility_snapshot_age(self, seconds: float) -> None:
        self.visibility_snapshot_age_seconds.set(seconds)

    def journey_completed(self, cls: str, tta_s: float) -> None:
        self.journeys_completed_total.inc(cls=cls)
        self.journey_tta_seconds.observe(tta_s, cls=cls)

    def set_requeue_amplification(self, value: float) -> None:
        self.requeues_per_admission.set(value)

    def set_slo_burn(self, cls: str, rate: float) -> None:
        self.slo_burn_rate.set(rate, cls=cls)

    def journey_lru_evicted(self) -> None:
        self.journey_ledger_evictions_total.inc()

    def speculation_hit(self) -> None:
        self.speculation_hits_total.inc()

    def speculation_abort(self, reason: str) -> None:
        self.speculation_aborts_total.inc(reason=reason)

    def cycle_observed(self, route: str, heads: int,
                       phase_sums: dict) -> None:
        """One sealed cycle trace: head count + per-phase wall seconds
        (the trace's top-level span sums)."""
        self.cycle_heads.observe(heads, route=route)
        for phase, secs in phase_sums.items():
            self.cycle_phase_seconds.observe(secs, phase=phase, route=route)

    def set_breaker_state(self, state: str) -> None:
        self.breaker_state.set(BREAKER_STATE_CODES.get(state, -1))

    def phase_percentile(self, phase: str, q: float) -> float:
        """Estimate the q-quantile of cycle_phase_seconds for one phase,
        merged across routes (promql-style bucket interpolation). NaN
        when the phase has no observations."""
        h = self.cycle_phase_seconds
        pi = h.label_names.index("phase")
        merged = [0] * (len(h.buckets) + 1)
        total = 0
        with h._lock:
            for key, (counts, _sum, n) in h.series.items():
                if key[pi] != phase:
                    continue
                for i, c in enumerate(counts):
                    merged[i] += c
                total += n
        return _bucket_quantile(h.buckets, merged, total, q)

    def report_pending_workloads(self, cq: str, active: int, inadmissible: int) -> None:
        self.pending_workloads.set(active, cluster_queue=cq, status=PENDING_STATUS_ACTIVE)
        self.pending_workloads.set(inadmissible, cluster_queue=cq,
                                   status=PENDING_STATUS_INADMISSIBLE)

    def report_evicted_workload(self, cq: str, reason: str) -> None:
        self.evicted_workloads_total.inc(cluster_queue=cq, reason=reason)

    def report_cluster_queue_status(self, cq: str, status: str) -> None:
        for s in CQ_STATUSES:
            self.cluster_queue_status.set(1.0 if s == status else 0.0,
                                          cluster_queue=cq, status=s)

    def report_cluster_queue_quotas(self, cohort: str, cq: str, flavor: str,
                                    resource: str, nominal: float,
                                    borrowing: float, lending: float) -> None:
        lbl = dict(cohort=cohort, cluster_queue=cq, flavor=flavor, resource=resource)
        self.cluster_queue_nominal_quota.set(nominal, **lbl)
        self.cluster_queue_borrowing_limit.set(borrowing, **lbl)
        self.cluster_queue_lending_limit.set(lending, **lbl)

    def clear_cluster_queue_metrics(self, cq: str) -> None:
        """ClearClusterQueueMetrics + ClearCacheMetrics (metrics.go:295-324)."""
        for metric in self._all:
            if "cluster_queue" in metric.label_names:
                metric.delete_partial_match({"cluster_queue": cq})
        self.preempted_workloads_total.delete_partial_match(
            {"preempting_cluster_queue": cq})

    # --- exposition ---

    def dump(self) -> str:
        lines = []
        for m in self._all:
            lines.append(f"# HELP {m.name} {m.help}")
            if isinstance(m, (Counter, Gauge)):
                kind = "counter" if isinstance(m, Counter) else "gauge"
                lines.append(f"# TYPE {m.name} {kind}")
                for key, val in sorted(m.values.items()):
                    lines.append(f"{m.name}{_fmt_labels(m.label_names, key)} {val}")
            else:
                lines.append(f"# TYPE {m.name} histogram")
                for key, (counts, total, n) in sorted(m.series.items()):
                    cum = 0
                    for i, ub in enumerate(m.buckets):
                        cum += counts[i]
                        lines.append(
                            f"{m.name}_bucket{_fmt_labels(m.label_names, key, le=ub)} {cum}")
                    lines.append(
                        f"{m.name}_bucket{_fmt_labels(m.label_names, key, le='+Inf')} {n}")
                    lines.append(f"{m.name}_sum{_fmt_labels(m.label_names, key)} {total}")
                    lines.append(f"{m.name}_count{_fmt_labels(m.label_names, key)} {n}")
        return "\n".join(lines) + "\n"


def _fmt_labels(names: tuple, key: tuple, le=None) -> str:
    pairs = [f'{n}="{v}"' for n, v in zip(names, key)]
    if le is not None:
        pairs.append(f'le="{le}"')
    return "{" + ",".join(pairs) + "}" if pairs else ""
