"""Manager assembly: the equivalent of cmd/kueue/main.go:98-336.

The port's copy of kueue_tpu/manager.py. Builds the full control plane
in-process: sim store (the apiserver role), queue manager + cache, core
controllers, the batch/job integration, the provisioning and MultiKueue
admission-check controllers, webhook admission on writes, the scheduler
with a store-backed client, and (optionally) the caller's BatchSolver:
`KueueManager(cfg, solver=BatchSolver())` solves on the card, with the
production wiring (pipeline depth 2, adaptive routing, the watchdog, the
breaker, supervised dispatch, the warm governor). `solver=None` is the
reference's CPU scheduler, as in the JAX package. Callers use
`run_until_idle()` + `schedule_once()` for deterministic cycles, or
`scheduler.start()` for the threaded loop, and `shutdown()` at the end.

Not ported yet, and raising NotImplementedError when asked for: leader
election (`leader_election.leader_elect`) and the durable store
(`store.durable`), ROADMAP item 6; `standby` and `restore`, item 6;
`serve_visibility` and `dumper`, item 5b; every integration in
`integrations.frameworks` other than batch/job, item 5b. Left out with
the visibility server (item 5b): the QueueVisibility cron, which
refreshes the top-N pending snapshots that only that server reads
(`queue_visibility.update_interval_seconds` is read by nothing yet).
"""

from __future__ import annotations

from typing import Optional

from kueue_tpu_torch import config as cfgpkg
from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.meta import REAL_CLOCK, Clock
from kueue_tpu_torch.cache import Cache
from kueue_tpu_torch.controller.core import setup_core_controllers
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.metrics import Registry
from kueue_tpu_torch.queue import Manager as QueueManager
from kueue_tpu_torch.scheduler.scheduler import Scheduler, SchedulerClient
from kueue_tpu_torch.sim import Store
from kueue_tpu_torch.sim.runtime import EventRecorder, Runtime


class StoreSchedulerClient(SchedulerClient):
    """SchedulerClient over the sim store (the reference scheduler's only
    API interactions: namespace Get, SSA admission writes, Pending
    patches, events — scheduler.go:421,571-623,674-692)."""

    def __init__(self, store: Store, recorder: EventRecorder):
        self.store = store
        self.recorder = recorder

    def namespace_labels(self, namespace: str) -> Optional[dict]:
        ns = self.store.try_get("Namespace", "", namespace)
        return ns.metadata.labels if ns is not None else {}

    def limit_ranges(self, namespace: str) -> list:
        return self.store.list("LimitRange", namespace=namespace)

    def apply_admission(self, wl: api.Workload) -> None:
        # Status-subresource write, like the reference's SSA
        # ApplyAdmissionStatus (workload.go): the scheduler only writes
        # status, and it already holds a fresh clone — no read-back
        # round trip, no spec re-validation, no full-object deep copy.
        self.store.update_status(wl, owned_status=True)

    def patch_not_admitted(self, wl: api.Workload) -> None:
        # Merge ONLY the conditions onto the CURRENT status (a
        # strategic-merge patch, like the reference's Pending patches):
        # an admission-check controller may have written
        # admission_checks/requeue_state since the scheduler's snapshot,
        # and a whole-status overwrite from the stale base would revert
        # them.
        current = self.store.try_get("Workload", wl.metadata.namespace,
                                     wl.metadata.name, copy_object=False)
        if current is None:
            return
        patch = wlpkg.clone_for_status_update(current)
        patch.status.conditions = wl.status.conditions
        self.store.update_status(patch, owned_status=True)

    def event(self, wl: api.Workload, event_type: str, reason: str,
              message: str) -> None:
        self.recorder.event(wl, event_type, reason, message)


def _refuse_unported(cfg: cfgpkg.Configuration) -> None:
    """Raise NotImplementedError for the configuration switches whose
    modules the port does not have yet."""
    if cfg.leader_election.leader_elect:
        raise NotImplementedError(
            "leader_election.leader_elect: leader election waits for "
            "ROADMAP item 6")
    if cfg.store.durable:
        raise NotImplementedError(
            "store.durable: the durable log waits for ROADMAP item 6")
    extra = [f for f in cfg.integrations.frameworks
             if f not in PORTED_INTEGRATIONS]
    if extra:
        raise NotImplementedError(
            f"integrations.frameworks {extra}: the port has "
            f"{PORTED_INTEGRATIONS}; the other integrations wait for "
            "ROADMAP item 5b")


# The job integrations the port has (controller/jobs/__init__.py).
PORTED_INTEGRATIONS = ["batch/job"]


class KueueManager:
    def __init__(self, cfg: Optional[cfgpkg.Configuration] = None,
                 clock: Clock = REAL_CLOCK, solver=None,
                 registered_check_controllers: Optional[set] = None,
                 remote_clusters: Optional[dict] = None,
                 store: Optional[Store] = None, identity: str = ""):
        """store/identity: HA replicas share one Store (the apiserver
        stand-in) and elect a leader over it; identity names this
        replica in the lease. Leader election waits for ROADMAP item 6,
        so `identity` is unused."""
        self.cfg = cfgpkg.set_defaults(cfg or cfgpkg.Configuration())
        _refuse_unported(self.cfg)
        from kueue_tpu_torch.utils import vlog
        # Don't clobber a KUEUE_TPU_V env override with the config
        # default: the louder of config and the ENV override wins (not
        # the mutable global — a previous manager's level must not
        # ratchet this one's).
        vlog.set_verbosity(max(self.cfg.verbosity, vlog.env_verbosity()))
        self.clock = clock
        self.store = store if store is not None else Store(clock)
        # A store passed IN keeps its caller-owned durability (the
        # store's attach_durable); the manager makes no log of its own
        # until ROADMAP item 6 (store.durable is refused above).
        self.durable = getattr(self.store, "_durable", None)
        self.recorder = EventRecorder()
        self.metrics = Registry()
        # metrics: every reconcile lands in reconcile_seconds{controller}
        # (the coarse latency signal for the wall_s - cycle_time_total
        # gap in the perf artifacts).
        self.runtime = Runtime(clock, metrics=self.metrics)

        w = self.cfg.wait_for_pods_ready
        ordering = wlpkg.Ordering(
            pods_ready_requeuing_timestamp=(
                w.requeuing_strategy.timestamp if w else cfgpkg.EVICTION_TIMESTAMP))
        self.queues = QueueManager(
            ordering=ordering, clock=clock,
            namespace_labels=lambda ns: self._namespace_labels(ns),
            excluded_resource_prefixes=self.cfg.resources.exclude_resource_prefixes)
        self.cache = Cache(
            pods_ready_tracking=bool(w and w.enable and w.block_admission),
            excluded_resource_prefixes=self.cfg.resources.exclude_resource_prefixes)

        # built-in admission-check controllers are always registered
        # (reference: cmd/kueue/main.go:240-263)
        from kueue_tpu_torch.controller.admissionchecks import multikueue as mkpkg
        from kueue_tpu_torch.controller.admissionchecks import provisioning as provpkg
        check_controllers = set(registered_check_controllers or set())
        check_controllers |= {provpkg.CONTROLLER_NAME, mkpkg.CONTROLLER_NAME}

        # Cycle flight recorder (kueue_tpu_torch/obs): per-cycle phase traces
        # in a bounded ring.
        # Created before the controllers so the workload reconciler's
        # per-event spans (reconcile.workload.{event}) share it.
        from kueue_tpu_torch.obs import FlightRecorder
        o = self.cfg.observability
        self.flight_recorder = FlightRecorder(
            capacity=o.flight_recorder_capacity,
            enabled=o.flight_recorder_enable)

        # Workload journey ledger (obs/journey.py): every
        # workload accumulates a causally-stamped span timeline fed
        # from the queue manager's delta feed (arrivals), the
        # scheduler's admit/requeue/shed sites, the workload
        # controller's eviction paths and the MultiKueue planned-mirror
        # lifecycle. The ledger is also THE emission site for the
        # admission wait-time histograms, so /debug/journeys and
        # /metrics reconcile by construction. Created before the
        # controllers (the workload reconciler seals check-gated
        # admissions through it).
        self.journey_ledger = None
        if o.journey_enable:
            from kueue_tpu_torch.obs import JourneyLedger
            self.journey_ledger = JourneyLedger(
                capacity=o.journey_ledger_capacity,
                exemplars=o.journey_exemplars,
                metrics=self.metrics, clock=clock,
                generation_source=self.cache.generation_token)
            self.queues.add_journey_listener(
                self.journey_ledger.note_queue_delta)

        self.controllers = setup_core_controllers(
            self.runtime, self.store, self.queues, self.cache, self.recorder,
            cfg=self.cfg, metrics=self.metrics,
            registered_check_controllers=check_controllers,
            obs_recorder=self.flight_recorder,
            journeys=self.journey_ledger)

        self.provisioning = provpkg.setup_provisioning_controller(
            self.runtime, self.store, self.recorder)
        self.multikueue = mkpkg.setup_multikueue_controller(
            self.runtime, self.store, self.recorder,
            remote_clusters=remote_clusters,
            origin=self.cfg.multi_kueue.origin,
            worker_lost_timeout=self.cfg.multi_kueue.worker_lost_timeout_seconds)

        # Periodic remote-orphan GC (reference: multikueuecluster.go GC
        # interval): without this timer gc_orphans existed but nothing
        # scheduled it, so mirrors whose local original vanished during
        # a worker-cluster outage leaked until a manual sweep. Runs on
        # the runtime as a timed controller so deterministic callers
        # (advance()) exercise it; <=0 disables.
        gc_interval = self.cfg.multi_kueue.gc_interval_seconds
        if gc_interval > 0 and remote_clusters:

            def gc_orphans(_key):
                self.multikueue.gc_orphans()
                return float(gc_interval)

            gc_ctrl = self.runtime.controller("multikueue-gc", gc_orphans)
            gc_ctrl.enqueue("gc")

        # job integrations (reference: jobframework.SetupControllers via
        # cmd/kueue/main.go:229-290). Registration is idempotent across
        # managers; wiring is per-runtime.
        from kueue_tpu_torch.controller import jobs as jobs_registry
        from kueue_tpu_torch.controller.jobframework import (
            get_integration, setup_integrations)
        if get_integration("batch/job") is None:
            jobs_registry.register_all()
        self.integrations = setup_integrations(
            self.runtime, self.store, self.recorder, self.cfg)

        # admission webhooks on the sim store (reference:
        # webhooks.Setup, cmd/kueue/main.go:265-268)
        from kueue_tpu_torch.webhooks import setup_webhooks
        setup_webhooks(self.store, self.cfg)

        self.scheduler_client = StoreSchedulerClient(self.store, self.recorder)
        self.scheduler = Scheduler(
            self.queues, self.cache, self.scheduler_client,
            ordering=ordering,
            fair_sharing_enabled=self.cfg.fair_sharing.enable,
            fs_preemption_strategies=self.cfg.fair_sharing.preemption_strategies,
            clock=clock, metrics=self.metrics, solver=solver,
            solver_min_heads=self.cfg.solver.min_heads,
            recorder=self.flight_recorder)
        # MultiKueue batched-column placement wiring: the cache stamps
        # every snapshot with the controller's remote capacity columns,
        # the admission cycle scores them (K12, kernel.
        # score_cluster_columns, on device routes; the identical
        # sequential oracle on CPU routes), and the controller executes
        # the decisions (one mirror per workload instead of the
        # mirror-everywhere race).
        if remote_clusters:
            self.cache.remote_capacity_source = self.multikueue.capacity_columns
            self.scheduler.on_placement = self.multikueue.note_placement
            self.multikueue.journeys = self.journey_ledger
        self.scheduler.journeys = self.journey_ledger
        # Aging watch (obs/trend.py + ROADMAP item 5): EWMA-slope trend
        # monitors over the monotone resources long-horizon soak gates
        # on, sampled once per cycle seal and served on /debug/aging.
        # Always wired — the per-cycle cost is a handful of float ops.
        from kueue_tpu_torch.obs import AgingWatch
        from kueue_tpu_torch.obs.trend import rss_kb
        self.aging_watch = AgingWatch()
        self.aging_watch.add(
            # Snapshot handouts not yet released between cycles: the
            # steady state is flat (the query plane legitimately holds
            # one); sustained growth is an abandoned-cycle leak.
            "live_handouts", lambda: self.cache.live_handouts,
            slope_threshold=0.05)
        if self.durable is not None and self.durable.checkpoint_every > 0:
            # WAL records since the last checkpoint: bounded by the
            # compaction interval when healthy; a level past 2x the
            # interval means compaction stalled (slope is useless on a
            # sawtooth, the bound is not).
            self.aging_watch.add(
                "wal_records_since_checkpoint",
                lambda: self.durable.records_since_checkpoint,
                slope_threshold=None,
                bound=2.0 * self.durable.checkpoint_every)
        if self.journey_ledger is not None:
            self.aging_watch.add(
                # ROADMAP item 5's requeue-amplification invariant: the
                # ratio stabilizes on a healthy system; a sustained
                # upward trend is a requeue-backoff pile-up.
                "requeue_amplification",
                lambda: self.journey_ledger.requeues_per_admission,
                slope_threshold=0.02, window=32)
        if solver is not None:
            self.aging_watch.add(
                # Arena slot occupancy grows while a backlog fills and
                # plateaus after; growth sustained past a long window
                # is slot leakage (rows never released at admission).
                "arena_occupied",
                lambda: ((solver._arena.size - len(solver._arena.free))
                         if getattr(solver, "_arena", None) is not None
                         else 0.0),
                slope_threshold=1.0, window=64)
            self.aging_watch.add(
                # Zero mid-traffic compiles after warmup (a live trend;
                # a solver on the card compiles nothing per shape): ANY
                # sustained growth flags.
                "mid_traffic_compiles",
                lambda: getattr(solver, "counters", {}).get(
                    "mid_traffic_compiles", 0),
                slope_threshold=0.01, window=16)
        self.aging_watch.add(
            # Peak RSS plateaus after warmup; a sustained climb of
            # >1MB/cycle over a long window is the flat-RSS-trend
            # invariant failing.
            "rss_kb", rss_kb, slope_threshold=1024.0, window=64,
            warmup=16)
        self.scheduler.aging = self.aging_watch
        # Snapshot-backed query plane (obs/queryplane.py): every cycle
        # seal publishes an immutable pending-position / status view
        # (nominate-order column + the cycle's snapshot handout,
        # ownership transferred from the scheduler); a read storm never
        # touches the live heaps the admission cycle mutates.
        self.query_plane = None
        if self.cfg.observability.query_plane_enable:
            from kueue_tpu_torch.obs.queryplane import QueryPlane
            self.query_plane = QueryPlane(self.cache, self.queues,
                                          metrics=self.metrics)
            self.scheduler.query_plane = self.query_plane
        # Cycle deadline budget (kueue_tpu_torch/resilience/degrade.py): with
        # scheduler.cycleBudget > 0 the degradation ladder watches every
        # cycle's wall seconds and sheds load (head caps, deferred
        # preempt planning, the cpu-survival route) under sustained
        # overload. Engine-agnostic — wired with or without a solver.
        sc = self.cfg.scheduler
        if sc.cycle_budget_s > 0:
            from kueue_tpu_torch.resilience.degrade import DegradationLadder
            self.scheduler.ladder = DegradationLadder(
                budget_s=sc.cycle_budget_s,
                shed_heads=sc.shed_heads,
                survival_heads=sc.survival_heads,
                enter_factor=sc.overload_enter_factor,
                exit_factor=sc.overload_exit_factor,
                escalate_after=sc.escalate_after_cycles,
                recovery_cycles=sc.recovery_cycles,
                ewma_alpha=sc.cycle_ewma_alpha)
        if solver is not None:
            # Production solver wiring: pipelined dispatch + adaptive
            # engine routing. (The JAX package also enables XLA's
            # persistent compilation cache here; the port's kernels are
            # built once into solver/_build/ and it has none.)
            self.scheduler.pipeline_enabled = self.cfg.solver.pipeline
            self.scheduler.pipeline_depth = self.cfg.solver.pipeline_depth
            self.scheduler.solver_routing = self.cfg.solver.routing
            self.scheduler.strict_after_blocked_cycles = \
                self.cfg.solver.strict_after_blocked_cycles
            # Device-fault containment (kueue_tpu_torch/resilience): watchdog
            # deadlines + circuit breaker from the solver config, and
            # fault/trip/recovery events onto the sim event recorder so
            # the outage timeline is visible in the artifacts.
            from kueue_tpu_torch.resilience.breaker import CircuitBreaker
            from kueue_tpu_torch.resilience.watchdog import DispatchWatchdog
            s = self.cfg.solver
            self.scheduler.watchdog = DispatchWatchdog(
                safety_factor=s.watchdog_safety_factor,
                min_deadline_s=s.watchdog_min_deadline_s,
                max_deadline_s=s.watchdog_max_deadline_s)
            self.scheduler.breaker = CircuitBreaker(
                threshold=s.breaker_fault_threshold,
                backoff_base_s=s.breaker_backoff_base_s,
                backoff_max_s=s.breaker_backoff_max_s)
            if hasattr(solver, "supervise_dispatch"):
                # Supervised dispatch: the dispatch half of the round
                # trip carries the watchdog deadline too.
                solver.supervise_dispatch = s.supervise_dispatch
        # Compile governor (solver/warmgov.py): a supervised warmup
        # walks the shape-bucket ladder while the scheduler routes
        # un-warmed buckets to the CPU path ("cpu-warmup"). A solver on
        # the card has nothing to compile per shape, so its governor is
        # warm from start() and never diverts a cycle. Attached whenever
        # a warm-capable solver is present; the background walk starts
        # here only with solver.warmupAtStartup (deterministic callers
        # call start()/run_sync themselves). The JAX governor's
        # cache_dir (XLA's persistent cache) has no counterpart.
        self.warm_governor = None
        if solver is not None and hasattr(solver, "warm_setup"):
            from kueue_tpu_torch.scheduler.preemption import parse_strategies
            from kueue_tpu_torch.solver.fairpreempt import strategy_flags
            from kueue_tpu_torch.solver.warmgov import CompileGovernor
            s = self.cfg.solver
            self.warm_governor = CompileGovernor(
                solver, self.cache, metrics=self.metrics,
                recorder=self.flight_recorder,
                bucket_deadline_s=s.warmup_deadline_s,
                max_width=s.max_heads,
                fair_sharing=self.cfg.fair_sharing.enable,
                fs_flags=strategy_flags(parse_strategies(
                    self.cfg.fair_sharing.preemption_strategies)))
            self.scheduler.warm_gov = self.warm_governor
            if s.warmup_at_startup:
                self.warm_governor.start()
        # Fault/breaker/degrade transitions land as Scheduler system
        # events — the outage + degraded-mode timeline in the artifacts.
        # Wired with or without a solver: the degradation ladder watches
        # the CPU path too.
        self.scheduler.on_fault = (
            lambda kind, msg: self.recorder.system_event(
                "Normal" if kind in ("breaker-closed", "degrade-recovered")
                else "Warning",
                {"fault": "DeviceFault",
                 "breaker-open": "BreakerOpen",
                 "breaker-closed": "BreakerClosed",
                 "degrade": "DegradedMode",
                 "degrade-recovered": "DegradedModeRecovered",
                 }.get(kind, kind),
                msg))

    def _namespace_labels(self, ns: str) -> Optional[dict]:
        obj = self.store.try_get("Namespace", "", ns)
        return obj.metadata.labels if obj is not None else {}

    # -- shutdown ------------------------------------------------------

    def shutdown(self, checkpoint: bool = True) -> None:
        """Graceful process exit: stop the scheduler loop AND abandon
        the in-flight speculative cycle (its snapshot handout goes back
        to the cache, device residency + arena claims drop — never
        strand; the requeued heads are moot for THIS process but keep
        the queues consistent if the caller drives more cycles), stop
        the warm governor, release the query plane's handout and the
        journey ledger, and take a final durable checkpoint when a log
        is attached to the store, so a restart replays no WAL tail. The
        manager object stays readable (store, caches) but must not
        schedule again."""
        self.scheduler.stop()
        if self.warm_governor is not None:
            self.warm_governor.stop()
        if self.query_plane is not None:
            # Release the reader-held snapshot handout (the sealed
            # view's backing): live_handouts must return to zero after
            # a shutdown — the same leak contract abandoned speculative
            # cycles honor.
            self.query_plane.close()
        if self.journey_ledger is not None:
            # Drop every retained journey (active LRU + exemplars):
            # the ledger's leak contract is zero retained journeys
            # after shutdown, mirroring live_handouts.
            self.journey_ledger.close()
        if checkpoint and self.durable is not None:
            from kueue_tpu_torch.sim.durable import Fenced
            try:
                self.store.checkpoint_now()
            except Fenced:
                # A DEPOSED leader shutting down gracefully: its stale
                # image must not replace the checkpoint.
                pass
        if getattr(self.store, "fencing", None) is not None:
            # A leading manager hands the lease off instead of making
            # the standby wait out the full duration.
            self.store.fencing.release()

    # -- not ported yet --------------------------------------------------

    @classmethod
    def standby(cls, durable, cfg=None, clock: Clock = REAL_CLOCK,
                solver=None, **kwargs):
        """A hot-standby follower of a durable log (the JAX package's
        resilience/replica.py)."""
        raise NotImplementedError(
            "KueueManager.standby: the hot-standby replica waits for "
            "ROADMAP item 6 (the durable log and the replica)")

    @classmethod
    def restore(cls, durable, cfg=None, clock: Clock = REAL_CLOCK,
                solver=None, **kwargs) -> "KueueManager":
        """A control plane rebuilt from a durable log (the JAX package's
        resilience/recovery.py)."""
        raise NotImplementedError(
            "KueueManager.restore: crash-restart recovery waits for "
            "ROADMAP item 6 (the durable log and recovery)")

    def serve_visibility(self, port: int = 0):
        """The visibility HTTP server (the JAX package's visibility.py)."""
        raise NotImplementedError(
            "KueueManager.serve_visibility: the visibility server waits "
            "for ROADMAP item 5b")

    def dumper(self, out=None):
        """The SIGUSR2 state dumper (the JAX package's debugger.py)."""
        raise NotImplementedError(
            "KueueManager.dumper: the debug dumper waits for ROADMAP "
            "item 5b")

    # -- deterministic stepping (tests, chip_smoke) ----------------------

    def run_until_idle(self, max_iterations: int = 10000) -> int:
        return self.runtime.run_until_idle(max_iterations=max_iterations)

    def schedule_once(self) -> None:
        """One admission cycle + controller settling."""
        self.runtime.run_until_idle()
        self.scheduler.schedule(timeout=0)
        self.runtime.run_until_idle()

    def schedule_until_settled(self, max_cycles: int = 100) -> int:
        """Run cycles until a cycle admits nothing (queues drained or
        blocked). Returns the number of cycles run."""
        cycles = 0
        for _ in range(max_cycles):
            self.runtime.run_until_idle()
            before = self.store._rv
            self.scheduler.schedule(timeout=0)
            self.runtime.run_until_idle()
            cycles += 1
            has_active = any(cqh.active and cqh.pending_active() > 0
                             for cqh in self.queues.cluster_queues.values())
            if self.store._rv == before and not has_active:
                break
        return cycles

    def advance(self, dt: float) -> None:
        self.runtime.advance(dt)
