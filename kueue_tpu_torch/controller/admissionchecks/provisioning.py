"""ProvisioningRequest admission-check controller.

Equivalent of the reference's
pkg/controller/admissionchecks/provisioning/controller.go:139-608:
- for every workload with QuotaReserved and a check handled by this
  controller, create one ProvisioningRequest (+ PodTemplates from the
  assigned pod sets) per relevant check, configured by the check's
  ProvisioningRequestConfig
- map ProvReq conditions to check state: Provisioned=True -> Ready with
  podSetUpdates binding pods to the request (consume annotation);
  Failed -> Retry with capped exponential backoff on a fresh
  "-attemptN" request (attempt <= maxRetries), then Rejected
  (:246-335, :484-608)
- BookingExpired/CapacityRevoked after admission -> no-op here; the
  workload controller evicts on check state changes
"""

from __future__ import annotations

import hashlib
import struct
from typing import Optional

from kueue_tpu_torch.api import autoscaling as asapi
from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.meta import Condition, ObjectMeta, find_condition, is_condition_true, set_condition
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.sim import ADDED, DELETED, Store

CONTROLLER_NAME = "kueue.x-k8s.io/provisioning-request"
CONSUME_ANNOTATION = "autoscaling.x-k8s.io/consume-provisioning-request"
CLASS_NAME_ANNOTATION = "autoscaling.x-k8s.io/provisioning-class-name"
DEFAULT_MAX_RETRIES = 3
DEFAULT_MIN_BACKOFF_SECONDS = 60.0
DEFAULT_BACKOFF_JITTER = 0.2


def request_name(wl_name: str, check_name: str, attempt: int) -> str:
    base = f"{wl_name}-{check_name}"
    return base if attempt <= 1 else f"{base}-attempt{attempt}"


def _jitter_fraction(seed: int, key: str) -> float:
    """Deterministic per-key jitter in [0, 1): a keyed hash, NOT a
    shared RNG stream — the backoff is recomputed on every reconcile,
    so the fraction must be stable for a given (workload, check,
    attempt) while differing across workloads. Python's builtin hash is
    salted per process; blake2b is stable across runs, so fake-clock
    tests stay reproducible."""
    salt = (seed & (2**64 - 1)).to_bytes(8, "little")  # any int seed
    digest = hashlib.blake2b(key.encode(), digest_size=8,
                             salt=salt).digest()
    return struct.unpack("<Q", digest)[0] / 2**64


class ProvisioningController:
    def __init__(self, store: Store, recorder, clock,
                 max_retries: int = DEFAULT_MAX_RETRIES,
                 min_backoff_seconds: float = DEFAULT_MIN_BACKOFF_SECONDS,
                 backoff_jitter: float = DEFAULT_BACKOFF_JITTER,
                 jitter_seed: int = 0):
        self.store = store
        self.recorder = recorder
        self.clock = clock
        self.max_retries = max_retries
        self.min_backoff_seconds = min_backoff_seconds
        # Retry-storm de-synchronization: workloads that failed together
        # (one capacity outage fails a whole wave of ProvReqs at the
        # same transition time) must not all retry at the same instant.
        # Each (workload, check, attempt) gets a stable multiplicative
        # jitter in [1, 1 + backoff_jitter); 0 restores the pure
        # base * 2^(attempt-1) schedule.
        self.backoff_jitter = backoff_jitter
        self.jitter_seed = jitter_seed

    def _backoff_seconds(self, wl_name: str, check_name: str,
                         attempt: int) -> float:
        backoff = self.min_backoff_seconds * 2 ** (attempt - 1)
        if self.backoff_jitter > 0:
            frac = _jitter_fraction(self.jitter_seed,
                                    f"{wl_name}/{check_name}/{attempt}")
            backoff *= 1.0 + self.backoff_jitter * frac
        return backoff

    # -- discovery ------------------------------------------------------

    def _relevant_checks(self, wl: api.Workload) -> list:
        """Names of this controller's checks on the workload."""
        out = []
        for state in wl.status.admission_checks:
            ac = self.store.try_get("AdmissionCheck", "", state.name)
            if ac is not None and ac.spec.controller_name == CONTROLLER_NAME:
                out.append(state.name)
        return out

    def _config_for(self, check_name: str) -> Optional[asapi.ProvisioningRequestConfig]:
        ac = self.store.try_get("AdmissionCheck", "", check_name)
        if ac is None or ac.spec.parameters is None:
            return None
        return self.store.try_get("ProvisioningRequestConfig", "",
                                  ac.spec.parameters.name)

    # -- reconcile ------------------------------------------------------

    def reconcile(self, key: str):
        namespace, name = key.split("/", 1)
        wl = self.store.try_get("Workload", namespace, name)
        if wl is None or wlpkg.is_finished(wl):
            return None
        if not wlpkg.has_quota_reservation(wl) or not wlpkg.is_active(wl):
            return None
        checks = self._relevant_checks(wl)
        if not checks:
            return None
        requeue_after = None
        updated = False
        for check_name in checks:
            result = self._sync_check(wl, check_name)
            if isinstance(result, float):
                requeue_after = result if requeue_after is None \
                    else min(requeue_after, result)
            elif result:
                updated = True
        if updated:
            self.store.update(wl)
        return requeue_after

    def _sync_check(self, wl: api.Workload, check_name: str):
        """Returns True if the workload's check state changed, or a float
        requeue delay while backing off."""
        now = self.clock.now()
        state = wlpkg.find_admission_check(wl, check_name)
        if state is None or state.state in (api.CHECK_STATE_READY,
                                            api.CHECK_STATE_REJECTED):
            return False

        # find the latest attempt's request
        attempt = 1
        pr = None
        for a in range(self.max_retries + 1, 0, -1):
            candidate = self.store.try_get(
                "ProvisioningRequest", wl.metadata.namespace,
                request_name(wl.metadata.name, check_name, a))
            if candidate is not None:
                pr = candidate
                attempt = a
                break

        if pr is None:
            self._create_request(wl, check_name, 1)
            return False

        if is_condition_true(pr.status.conditions, asapi.PROVISIONED):
            # Ready + podSetUpdates binding pods to the request
            # (reference: :593-608)
            updates = [api.PodSetUpdate(
                name=psa.name,
                annotations={CONSUME_ANNOTATION: pr.metadata.name,
                             CLASS_NAME_ANNOTATION:
                                 pr.spec.provisioning_class_name})
                for psa in wl.status.admission.pod_set_assignments]
            wlpkg.set_admission_check_state(
                wl.status.admission_checks,
                api.AdmissionCheckState(name=check_name,
                                        state=api.CHECK_STATE_READY,
                                        message="Provisioning completed",
                                        pod_set_updates=updates), now)
            return True

        failed = find_condition(pr.status.conditions, asapi.FAILED)
        if failed is not None and failed.status == "True":
            if attempt <= self.max_retries:
                # exponential backoff before the next attempt
                # (reference: remainingTimeToRetry :317-335), with
                # seeded per-workload jitter so a wave that failed
                # together doesn't retry in lockstep
                backoff = self._backoff_seconds(wl.metadata.name,
                                                check_name, attempt)
                elapsed = now - failed.last_transition_time
                remaining = backoff - elapsed
                if remaining > 0:
                    return float(remaining)
                self._create_request(wl, check_name, attempt + 1)
                wlpkg.set_admission_check_state(
                    wl.status.admission_checks,
                    api.AdmissionCheckState(
                        name=check_name, state=api.CHECK_STATE_PENDING,
                        message=f"Retrying after failure: {failed.message}"), now)
                return True
            wlpkg.set_admission_check_state(
                wl.status.admission_checks,
                api.AdmissionCheckState(name=check_name,
                                        state=api.CHECK_STATE_REJECTED,
                                        message=failed.message), now)
            return True

        if state.message != "Provisioning in progress":
            wlpkg.set_admission_check_state(
                wl.status.admission_checks,
                api.AdmissionCheckState(name=check_name,
                                        state=api.CHECK_STATE_PENDING,
                                        message="Provisioning in progress"), now)
            return True
        return False

    def _create_request(self, wl: api.Workload, check_name: str,
                        attempt: int) -> None:
        config = self._config_for(check_name)
        name = request_name(wl.metadata.name, check_name, attempt)
        managed = set(config.spec.managed_resources) if config else set()
        pod_sets = []
        for psa in wl.status.admission.pod_set_assignments:
            ps = next(p for p in wl.spec.pod_sets if p.name == psa.name)
            if managed and not (managed & set(psa.resource_usage)):
                continue  # podset doesn't use any managed resource
            template_name = f"ppt-{name}-{psa.name}"
            self._ensure(asapi.PodTemplate(
                metadata=ObjectMeta(name=template_name,
                                    namespace=wl.metadata.namespace),
                template=ps.template))
            count = psa.count if psa.count is not None else ps.count
            pod_sets.append(asapi.ProvisioningRequestPodSet(
                pod_template_ref=template_name, count=count))
        pr = asapi.ProvisioningRequest(
            metadata=ObjectMeta(name=name, namespace=wl.metadata.namespace,
                                owner_references=[]))
        pr.spec.provisioning_class_name = \
            config.spec.provisioning_class_name if config else ""
        pr.spec.parameters = dict(config.spec.parameters) if config else {}
        pr.spec.pod_sets = pod_sets
        self._ensure(pr)
        self.recorder.event(wl, "Normal", "ProvisioningRequestCreated",
                            f"Created ProvisioningRequest: {name}")

    def _ensure(self, obj) -> None:
        from kueue_tpu_torch.sim import AlreadyExists
        try:
            self.store.create(obj)
        except AlreadyExists:
            pass


def setup_provisioning_controller(runtime, store: Store, recorder,
                                  **kwargs) -> ProvisioningController:
    """Wire the controller: reconcile on Workload and ProvisioningRequest
    events (reference: SetupWithManager + indexes, indexer.go:83)."""
    controller = ProvisioningController(store, recorder, runtime.clock, **kwargs)
    ctrl = runtime.controller("provisioning", controller.reconcile)

    def on_workload(event, wl, old):
        if event != DELETED:
            ctrl.enqueue(wlpkg.key(wl))

    def on_provreq(event, pr, old):
        # requests are named "<wl>-<check>[-attemptN]" — find owners by
        # listing workloads in the namespace (the reference uses an index)
        for wl in store.list("Workload", namespace=pr.metadata.namespace):
            if pr.metadata.name.startswith(wl.metadata.name + "-"):
                ctrl.enqueue(wlpkg.key(wl))

    store.watch("Workload", on_workload)
    store.watch("ProvisioningRequest", on_provreq)
    return controller
