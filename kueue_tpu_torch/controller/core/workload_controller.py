"""WorkloadReconciler: the Workload lifecycle state machine.

Equivalent of the reference's
pkg/controller/core/workload_controller.go:136-552 plus its watch event
handlers (:554-757):
- orphan finalizer GC
- deactivation (spec.active=false) -> eviction; DeactivationTarget handling
- Requeued condition management (reactivation, backoff-finished,
  LocalQueue/ClusterQueue restart)
- admission-check state seeding per CQ strategy + check-based eviction
  (Retry -> evict, Rejected -> deactivate)
- SyncAdmittedCondition once QuotaReserved and all checks Ready
- LQ/CQ existence + stop-policy gating (Inadmissible condition, drain
  evictions under HoldAndDrain)
- PodsReady timeout eviction with exponential requeue backoff and
  backoffLimitCount deactivation (:486-552)
- watch handlers feeding queue.Manager / cache.Cache exactly per the
  status-transition matrix (:560-757)
"""

from __future__ import annotations

import random
import time as _time
from typing import Optional

from kueue_tpu_torch import config as cfgpkg
from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.meta import find_condition, is_condition_true, remove_condition
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.sim import ADDED, DELETED, MODIFIED, NotFound, Store
from kueue_tpu_torch.sim.runtime import EventRecorder


class WorkloadReconciler:
    def __init__(self, store: Store, queues, cache, recorder: EventRecorder,
                 clock, cfg: Optional[cfgpkg.Configuration] = None, metrics=None,
                 watchers: Optional[list] = None,
                 rng: Optional[random.Random] = None, obs_recorder=None,
                 journeys=None):
        self.store = store
        self.queues = queues
        self.cache = cache
        self.recorder = recorder
        self.clock = clock
        self.cfg = cfg or cfgpkg.Configuration()
        self.metrics = metrics
        # Optional obs FlightRecorder: the per-event spans inside a
        # reconcile (reconcile.workload.{event}) land in whatever cycle
        # trace is open (no-op otherwise — same disabled contract as
        # every recorder hook).
        self.obs_recorder = obs_recorder
        # Optional obs JourneyLedger: check-gated admissions and
        # evictions stamp the workload's journey, and the admission
        # wait-time histograms are fed FROM the ledger's seal (one
        # emission site). None = direct metrics calls.
        self.journeys = journeys
        # seeded for reproducible backoff jitter in the deterministic sim
        self.rng = rng or random.Random(0)
        # MultiKueue et al. observe workload transitions (reference:
        # workload_controller.go notifyWatchers).
        self.watchers = watchers if watchers is not None else []

    # ------------------------------------------------------------------
    # reconcile
    # ------------------------------------------------------------------

    def reconcile(self, key: str):
        namespace, name = key.split("/", 1)
        # Shared read for the no-write early exits (most reconciles are
        # fan-out echoes of finished/stable workloads); clone only once
        # a mutating path is possible.
        shared = self.store.try_get("Workload", namespace, name,
                                    copy_object=False)
        if shared is None:
            return None
        if wlpkg.is_finished(shared) \
                and shared.metadata.deletion_timestamp is None:
            return None
        wl = api.clone_workload(shared)
        now = self.clock.now()

        # orphan GC (reference: :146-148)
        if not wl.metadata.owner_references and wl.metadata.deletion_timestamp is not None:
            if api.RESOURCE_IN_USE_FINALIZER in wl.metadata.finalizers:
                wl.metadata.finalizers.remove(api.RESOURCE_IN_USE_FINALIZER)
                self.store.update(wl)
            return None

        if wlpkg.is_finished(wl):
            return None

        if wlpkg.is_active(wl):
            if is_condition_true(wl.status.conditions, api.WORKLOAD_DEACTIVATION_TARGET):
                wl.spec.active = False
                self.store.update(wl)
                return None
            requeued = find_condition(wl.status.conditions, api.WORKLOAD_REQUEUED)
            if requeued is not None and requeued.status == "False":
                if requeued.reason == api.EVICTED_BY_DEACTIVATION:
                    wlpkg.set_requeued_condition(
                        wl, api.WORKLOAD_REACTIVATED,
                        "The workload was reactivated", True, now)
                    self.store.update(wl)
                    return None
                if requeued.reason == api.EVICTED_BY_PODS_READY_TIMEOUT:
                    rs = wl.status.requeue_state
                    if rs is not None and rs.requeue_at is not None:
                        remaining = rs.requeue_at - now
                        if remaining > 0:
                            return remaining
                        rs.requeue_at = None
                    wlpkg.set_requeued_condition(
                        wl, api.WORKLOAD_BACKOFF_FINISHED,
                        "The workload backoff was finished", True, now)
                    self.store.update(wl)
                    return None
        else:
            # deactivated -> evict (reference: :186-215)
            if self._event_span("deactivation",
                                self._reconcile_deactivation, wl, now):
                return None

        lq = self.store.try_get("LocalQueue", wl.metadata.namespace,
                                wl.spec.queue_name, copy_object=False)
        lq_exists = lq is not None
        lq_active = lq_exists and lq.spec.stop_policy == api.STOP_POLICY_NONE
        if lq_exists and lq_active and _requeued_disabled_by(wl, api.EVICTED_BY_LOCAL_QUEUE_STOPPED):
            wlpkg.set_requeued_condition(
                wl, api.WORKLOAD_LOCAL_QUEUE_RESTARTED,
                "The LocalQueue was restarted after being stopped", True, now)
            self.store.update(wl)
            return None

        cq_name = self.queues.cluster_queue_for_workload(wl)
        if cq_name is not None:
            cq = self.store.try_get("ClusterQueue", "", cq_name,
                                    copy_object=False)
            if cq is not None:
                if (_requeued_disabled_by(wl, api.EVICTED_BY_CLUSTER_QUEUE_STOPPED)
                        and cq.spec.stop_policy == api.STOP_POLICY_NONE):
                    wlpkg.set_requeued_condition(
                        wl, api.WORKLOAD_CLUSTER_QUEUE_RESTARTED,
                        "The ClusterQueue was restarted after being stopped", True, now)
                    self.store.update(wl)
                    return None
                if self._event_span("admission-checks",
                                    self._sync_admission_checks,
                                    wl, cq, now):
                    return None

        # Admitted flips to True only here, once all checks are Ready
        # (reference: :252-268)
        if not wlpkg.is_admitted(wl) and self._event_span(
                "sync-admitted", wlpkg.sync_admitted_condition, wl, now):
            self.store.update(wl)
            if wlpkg.is_admitted(wl):
                qr = find_condition(wl.status.conditions, api.WORKLOAD_QUOTA_RESERVED)
                checks_wait = now - qr.last_transition_time if qr else 0.0
                self.recorder.event(
                    wl, "Normal", "Admitted",
                    f"Admitted by ClusterQueue {wl.status.admission.cluster_queue}, "
                    f"wait time since reservation was {checks_wait:.0f}s")
                if self.journeys is not None:
                    # THE emission site for check-gated admission SLIs
                    # (reconcile-by-construction): the ledger
                    # observes admission_wait_time +
                    # admission_checks_wait_time and seals the journey.
                    self.journeys.admitted_after_checks(
                        wl, cq_name or "",
                        wlpkg.queued_wait_time(wl, now), checks_wait)
                elif self.metrics and cq_name:
                    self.metrics.admitted_workload(cq_name, wlpkg.queued_wait_time(wl, now))
                    self.metrics.admission_checks_wait_time.observe(
                        checks_wait, cluster_queue=cq_name)
            return None

        if wlpkg.has_quota_reservation(wl):
            if self._event_span("check-eviction",
                                self._reconcile_check_based_eviction,
                                wl, cq_name, now):
                return None
            if self._event_span("lq-active", self._reconcile_lq_active_state,
                                wl, lq, lq_exists, now):
                return None
            if cq_name is not None and self._event_span(
                    "cq-active", self._reconcile_cq_active_state,
                    wl, cq_name, now):
                return None
            return self._event_span("pods-ready-timeout",
                                    self._reconcile_not_ready_timeout,
                                    wl, cq_name, now)

        # Eviction completed (no reservation): retryable/stale check
        # states return to Pending so the next admission re-runs them
        # (reference: ResetChecksOnEviction). Without this a MultiKueue
        # worker-lost Retry would livelock evict/requeue, and a stale
        # Ready could admit a re-reserved workload no worker holds.
        if wl.status.admission_checks and self._event_span(
                "reset-checks", wlpkg.reset_checks_after_eviction, wl, now):
            self.store.update(wl)
            return None

        # pending: surface why the workload can't queue (reference: :285-330)
        msg = None
        if not lq_exists:
            msg = f"LocalQueue {wl.spec.queue_name} doesn't exist"
        elif not lq_active:
            msg = f"LocalQueue {wl.spec.queue_name} is inactive"
        elif cq_name is None:
            msg = f"ClusterQueue {lq.spec.cluster_queue} doesn't exist"
        elif not self.cache.cluster_queue_active(cq_name):
            msg = f"ClusterQueue {cq_name} is inactive"
        if msg is not None:
            if wlpkg.unset_quota_reservation_with_condition(
                    wl, api.WORKLOAD_INADMISSIBLE, msg, now):
                self.store.update(wl)
        return None


    # -- per-event observability ----------------------------------------

    def _event_span(self, name: str, fn, *args):
        """Time one event handler inside the reconcile: feeds the
        reconcile_event_seconds{controller,event} histogram (the
        per-event split of the coarse reconcile_seconds series) and
        emits a nested flight-recorder span
        (``reconcile.workload.{event}`` — dotted, so cycle phase sums
        never double-count it) when a cycle trace is open. Without
        metrics/recorder this is the plain call."""
        if self.metrics is None and self.obs_recorder is None:
            return fn(*args)
        t0 = _time.perf_counter()
        out = fn(*args)
        dt = _time.perf_counter() - t0
        if self.metrics is not None:
            self.metrics.reconcile_event("workload", name, dt)
        if self.obs_recorder is not None:
            self.obs_recorder.span(f"reconcile.workload.{name}", t0, dt)
        return out

    # -- pieces ---------------------------------------------------------

    def _reconcile_deactivation(self, wl: api.Workload, now: float) -> bool:
        updated = evicted = False
        reason = api.EVICTED_BY_DEACTIVATION
        message = "The workload is deactivated"
        dt = find_condition(wl.status.conditions, api.WORKLOAD_DEACTIVATION_TARGET)
        if not wlpkg.is_evicted(wl):
            if dt is not None:
                reason += dt.reason
                message = f"{message} due to {dt.message}"
            wlpkg.set_evicted_condition(wl, reason, message, now)
            updated = evicted = True
        if dt is not None:
            remove_condition(wl.status.conditions, api.WORKLOAD_DEACTIVATION_TARGET)
            updated = True
        if wl.status.requeue_state is not None:
            wl.status.requeue_state = None
            updated = True
        if updated:
            self.store.update(wl)
            if evicted and wl.status.admission is not None:
                self._report_evicted(wl, wl.status.admission.cluster_queue, reason, message)
            return True
        return False

    def _sync_admission_checks(self, wl: api.Workload, cq: api.ClusterQueue,
                               now: float) -> bool:
        from kueue_tpu_torch.cache.clusterqueue import admission_checks_map
        checks = wlpkg.admission_checks_for_workload(wl, admission_checks_map(cq.spec))
        if wlpkg.sync_admission_check_conditions(wl, checks, now):
            self.store.update(wl)
            return True
        return False

    def _reconcile_check_based_eviction(self, wl: api.Workload,
                                        cq_name: Optional[str], now: float) -> bool:
        if wlpkg.is_evicted(wl):
            return False
        if not wlpkg.has_retry_checks(wl) and not wlpkg.has_rejected_checks(wl):
            return False
        if wlpkg.has_rejected_checks(wl):
            rejected = [c for c in wl.status.admission_checks
                        if c.state == api.CHECK_STATE_REJECTED][0]
            wl.spec.active = False
            self.store.update(wl)
            self.recorder.event(
                wl, "Warning", "AdmissionCheckRejected",
                f"Deactivating workload because AdmissionCheck for {rejected.name} "
                f"was Rejected: {rejected.message}")
            return True
        message = "At least one admission check is false"
        wlpkg.set_evicted_condition(wl, api.EVICTED_BY_ADMISSION_CHECK, message, now)
        self.store.update(wl)
        self._report_evicted(wl, cq_name or "", api.EVICTED_BY_ADMISSION_CHECK, message)
        return True

    def _reconcile_lq_active_state(self, wl: api.Workload, lq, lq_exists: bool,
                                   now: float) -> bool:
        stop = lq.spec.stop_policy if lq_exists else api.STOP_POLICY_NONE
        if wlpkg.is_admitted(wl):
            if stop != api.HOLD_AND_DRAIN or wlpkg.is_evicted(wl):
                return False
            wlpkg.set_evicted_condition(
                wl, api.EVICTED_BY_LOCAL_QUEUE_STOPPED, "The LocalQueue is stopped", now)
            self.store.update(wl)
            self._report_evicted(wl, lq.spec.cluster_queue,
                                 api.EVICTED_BY_LOCAL_QUEUE_STOPPED,
                                 "The LocalQueue is stopped")
            return True
        if not lq_exists or lq.metadata.deletion_timestamp is not None:
            wlpkg.unset_quota_reservation_with_condition(
                wl, api.WORKLOAD_INADMISSIBLE,
                f"LocalQueue {wl.spec.queue_name} is terminating or missing", now)
            self.store.update(wl)
            return True
        if stop != api.STOP_POLICY_NONE:
            wlpkg.unset_quota_reservation_with_condition(
                wl, api.WORKLOAD_INADMISSIBLE,
                f"LocalQueue {wl.spec.queue_name} is stopped", now)
            self.store.update(wl)
            return True
        return False

    def _reconcile_cq_active_state(self, wl: api.Workload, cq_name: str,
                                   now: float) -> bool:
        cq = self.store.try_get("ClusterQueue", "", cq_name,
                                copy_object=False)
        stop = cq.spec.stop_policy if cq is not None else api.STOP_POLICY_NONE
        if wlpkg.is_admitted(wl):
            if cq is None or stop != api.HOLD_AND_DRAIN or wlpkg.is_evicted(wl):
                return False
            wlpkg.set_evicted_condition(
                wl, api.EVICTED_BY_CLUSTER_QUEUE_STOPPED, "The ClusterQueue is stopped", now)
            self.store.update(wl)
            self._report_evicted(wl, cq_name, api.EVICTED_BY_CLUSTER_QUEUE_STOPPED,
                                 "The ClusterQueue is stopped")
            return True
        if cq is None or cq.metadata.deletion_timestamp is not None:
            wlpkg.unset_quota_reservation_with_condition(
                wl, api.WORKLOAD_INADMISSIBLE,
                f"ClusterQueue {cq_name} is terminating or missing", now)
            self.store.update(wl)
            return True
        if stop != api.STOP_POLICY_NONE:
            wlpkg.unset_quota_reservation_with_condition(
                wl, api.WORKLOAD_INADMISSIBLE, f"ClusterQueue {cq_name} is stopped", now)
            self.store.update(wl)
            return True
        return False

    # -- PodsReady timeout (reference: :486-552, :778-802) --------------

    def _reconcile_not_ready_timeout(self, wl: api.Workload,
                                     cq_name: Optional[str], now: float):
        if not wlpkg.is_active(wl) or wlpkg.is_evicted(wl):
            return None
        counting, recheck_after = self._admitted_not_ready(wl, now)
        if not counting:
            return None
        if recheck_after > 0:
            return recheck_after
        if self._trigger_deactivation_or_backoff(wl, now):
            return None
        message = f"Exceeded the PodsReady timeout {wl.metadata.namespace}/{wl.metadata.name}"
        wlpkg.set_evicted_condition(wl, api.EVICTED_BY_PODS_READY_TIMEOUT, message, now)
        self.store.update(wl)
        self._report_evicted(wl, cq_name or "", api.EVICTED_BY_PODS_READY_TIMEOUT, message)
        return None

    def _admitted_not_ready(self, wl: api.Workload, now: float):
        w = self.cfg.wait_for_pods_ready
        if w is None or not w.enable:
            return False, 0.0
        if not wlpkg.is_admitted(wl):
            return False, 0.0
        pods_ready = find_condition(wl.status.conditions, api.WORKLOAD_PODS_READY)
        if pods_ready is not None and pods_ready.status == "True":
            return False, 0.0
        admitted = find_condition(wl.status.conditions, api.WORKLOAD_ADMITTED)
        elapsed = now - admitted.last_transition_time
        if (pods_ready is not None and pods_ready.status == "False"
                and pods_ready.last_transition_time > admitted.last_transition_time):
            elapsed = now - pods_ready.last_transition_time
        return True, max(0.0, w.timeout_seconds - elapsed)

    def _trigger_deactivation_or_backoff(self, wl: api.Workload, now: float) -> bool:
        w = self.cfg.wait_for_pods_ready
        rs = wl.status.requeue_state or api.RequeueState()
        count = rs.count + 1
        strategy = w.requeuing_strategy
        if (strategy.backoff_limit_count is not None
                and count > strategy.backoff_limit_count):
            wlpkg.set_deactivation_target(
                wl, api.WORKLOAD_REQUEUING_LIMIT_EXCEEDED,
                "exceeding the maximum number of re-queuing retries", now)
            self.store.update(wl)
            return True
        # 60s * 2^(n-1) + jitter, capped (reference: :530-548)
        backoff = min(strategy.backoff_base_seconds * 2 ** (count - 1),
                      strategy.backoff_max_seconds)
        backoff *= 1.0 + strategy.backoff_jitter * self.rng.random()
        rs.requeue_at = now + backoff
        rs.count = count
        wl.status.requeue_state = rs
        return False

    def _report_evicted(self, wl: api.Workload, cq_name: str, reason: str,
                        message: str) -> None:
        self.recorder.event(wl, "Normal", "EvictedDueTo" + reason, message)
        if self.metrics and cq_name:
            self.metrics.report_evicted_workload(cq_name, reason)
        if self.journeys is not None:
            # Eviction re-opens the journey: the requeue/re-admission
            # loop it starts is part of the workload's admission story.
            self.journeys.evicted(wlpkg.key(wl), cq_name, reason)

    # ------------------------------------------------------------------
    # watch handlers feeding queues + cache (reference: :554-757)
    # ------------------------------------------------------------------

    def handle_event(self, event: str, wl: api.Workload,
                     old: Optional[api.Workload], enqueue) -> None:
        if event == ADDED:
            self._on_create(wl)
        elif event == DELETED:
            self._on_delete(wl)
        else:
            self._on_update(old, wl, enqueue)
        for watcher in self.watchers:
            watcher(old if event != ADDED else None,
                    wl if event != DELETED else None)
        enqueue(wlpkg.key(wl))

    def _on_create(self, wl: api.Workload) -> None:
        if wlpkg.status(wl) == wlpkg.STATUS_FINISHED:
            return
        if not wlpkg.has_quota_reservation(wl):
            self.queues.add_or_update_workload(wl)
        else:
            self.cache.add_or_update_workload(wl)

    def _on_delete(self, wl: api.Workload) -> None:
        if wlpkg.has_quota_reservation(wl):
            self.queues.queue_associated_inadmissible_workloads_after(
                wl, lambda: self.cache.delete_workload(wl))
        self.queues.delete_workload(wl)

    def _on_update(self, old: api.Workload, wl: api.Workload, enqueue) -> None:
        prev_status = wlpkg.status(old)
        status = wlpkg.status(wl)
        active = wlpkg.is_active(wl)
        if status == wlpkg.STATUS_FINISHED or not active:
            self.queues.delete_workload(wl)
            self.queues.queue_associated_inadmissible_workloads_after(
                old, lambda: self.cache.delete_workload(old))
        elif prev_status == wlpkg.STATUS_PENDING and status == wlpkg.STATUS_PENDING:
            self.queues.update_workload(old, wl)
        elif prev_status == wlpkg.STATUS_PENDING:
            self.queues.delete_workload(old)
            self.cache.add_or_update_workload(wl)
        elif status == wlpkg.STATUS_PENDING:
            rs = wl.status.requeue_state
            backoff = (rs.requeue_at - self.clock.now()) if rs and rs.requeue_at else 0.0
            # pass `old` — the new object's admission is already cleared,
            # and the cohort flush needs the releasing CQ from it
            self.queues.queue_associated_inadmissible_workloads_after(
                old, lambda: self.cache.delete_workload(wl))
            if backoff <= 0:
                self.queues.add_or_update_workload(wl)
            # else: the reconcile loop re-queues after the backoff expires
            # (Requeued=BackoffFinished), replacing the reference's
            # time.AfterFunc (:700-713).
        elif (prev_status == wlpkg.STATUS_ADMITTED and status == wlpkg.STATUS_ADMITTED
              and old.status.reclaimable_pods != wl.status.reclaimable_pods):
            self.queues.queue_associated_inadmissible_workloads_after(
                wl, lambda: self.cache.add_or_update_workload(wl))
        else:
            self.cache.add_or_update_workload(wl)


def _requeued_disabled_by(wl: api.Workload, reason: str) -> bool:
    cond = find_condition(wl.status.conditions, api.WORKLOAD_REQUEUED)
    return cond is not None and cond.status == "False" and cond.reason == reason
