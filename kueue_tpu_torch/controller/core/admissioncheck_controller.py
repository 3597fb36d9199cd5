"""AdmissionCheckReconciler + ResourceFlavorReconciler.

Equivalents of the reference's
pkg/controller/core/admissioncheck_controller.go (Active condition per
registered check controller, cache sync, CQ re-activation fan-out) and
pkg/controller/core/resourceflavor_controller.go (in-use finalizer while
any ClusterQueue references the flavor, cache sync).
"""

from __future__ import annotations

from typing import Optional

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.api.meta import Condition, set_condition
from kueue_tpu_torch.sim import ADDED, DELETED, Store
from kueue_tpu_torch.sim.runtime import EventRecorder


class AdmissionCheckReconciler:
    """An AdmissionCheck is Active iff a controller is registered for its
    spec.controller_name (the reference checks this lazily via the
    controllers' own status updates; here registration is explicit)."""

    def __init__(self, store: Store, queues, cache, recorder: EventRecorder,
                 clock, registered_controllers: Optional[set] = None):
        self.store = store
        self.queues = queues
        self.cache = cache
        self.recorder = recorder
        self.clock = clock
        self.registered_controllers = registered_controllers if \
            registered_controllers is not None else set()

    def reconcile(self, key: str):
        ac = self.store.try_get("AdmissionCheck", "", key)
        if ac is None:
            return None
        now = self.clock.now()
        if ac.spec.controller_name in self.registered_controllers:
            cond = Condition(type=api.ADMISSION_CHECK_ACTIVE, status="True",
                             reason="Active",
                             message="The admission check is active",
                             observed_generation=ac.metadata.generation)
        else:
            cond = Condition(type=api.ADMISSION_CHECK_ACTIVE, status="False",
                             reason="ControllerNotRegistered",
                             message=f"No controller registered for "
                                     f"{ac.spec.controller_name!r}",
                             observed_generation=ac.metadata.generation)
        if set_condition(ac.status.conditions, cond, now):
            self.store.update(ac)
        return None

    def handle_event(self, event: str, ac: api.AdmissionCheck,
                     old: Optional[api.AdmissionCheck], enqueue) -> None:
        if event == DELETED:
            affected = self.cache.delete_admission_check(ac.metadata.name)
        else:
            affected = self.cache.add_or_update_admission_check(ac)
            enqueue(ac.metadata.name)
        # CQs whose active state flipped need re-queueing of parked work
        if affected:
            self.queues.queue_inadmissible_workloads(affected)


class ResourceFlavorReconciler:
    """Finalizer lifecycle: the flavor keeps the in-use finalizer while any
    ClusterQueue references it (reference: resourceflavor_controller.go)."""

    def __init__(self, store: Store, queues, cache, recorder: EventRecorder, clock):
        self.store = store
        self.queues = queues
        self.cache = cache
        self.recorder = recorder
        self.clock = clock

    def reconcile(self, key: str):
        rf = self.store.try_get("ResourceFlavor", "", key)
        if rf is None:
            return None
        in_use = self._flavor_in_use(key)
        if rf.metadata.deletion_timestamp is not None:
            if not in_use and api.RESOURCE_IN_USE_FINALIZER in rf.metadata.finalizers:
                rf.metadata.finalizers.remove(api.RESOURCE_IN_USE_FINALIZER)
                self.store.update(rf)
            return None
        if api.RESOURCE_IN_USE_FINALIZER not in rf.metadata.finalizers:
            rf.metadata.finalizers.append(api.RESOURCE_IN_USE_FINALIZER)
            self.store.update(rf)
        return None

    def _flavor_in_use(self, name: str) -> bool:
        for cq in self.store.list("ClusterQueue", copy_objects=False):
            for rg in cq.spec.resource_groups:
                if any(fq.name == name for fq in rg.flavors):
                    return True
        return False

    def handle_event(self, event: str, rf: api.ResourceFlavor,
                     old: Optional[api.ResourceFlavor], enqueue) -> None:
        if event == DELETED:
            affected = self.cache.delete_resource_flavor(rf.metadata.name)
        else:
            affected = self.cache.add_or_update_resource_flavor(rf)
            enqueue(rf.metadata.name)
        if affected:
            self.queues.queue_inadmissible_workloads(affected)
