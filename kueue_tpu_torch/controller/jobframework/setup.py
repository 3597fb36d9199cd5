"""Wire enabled job integrations onto the sim runtime.

Equivalent of the reference's pkg/controller/jobframework/setup.go:53-155:
one JobReconciler-backed controller per enabled framework, watching the
job kind and re-enqueuing the owner on child Workload events.
"""

from __future__ import annotations

from typing import Optional

from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.controller.jobframework.interface import get_integration
from kueue_tpu_torch.controller.jobframework.reconciler import JobReconciler
from kueue_tpu_torch.sim import DELETED


def setup_integrations(runtime, store, recorder, cfg, frameworks: Optional[list] = None):
    """Returns {framework name -> JobReconciler}. Unknown frameworks raise
    (the reference disables integrations whose CRDs are absent; every
    registered kind exists in the sim store by construction)."""
    enabled = {}
    names = list(frameworks if frameworks is not None
                 else cfg.integrations.frameworks)
    # expand dependencies (reference: DependencyList, e.g. deployment->pod)
    for name in list(names):
        cb = get_integration(name)
        if cb is None:
            raise ValueError(f"unknown integration {name!r} "
                             f"(is its module imported?)")
        for dep in cb.depends_on:
            if dep not in names:
                names.append(dep)

    w = cfg.wait_for_pods_ready
    for name in names:
        cb = get_integration(name)
        rec = JobReconciler(
            store, recorder, runtime.clock, cb,
            manage_jobs_without_queue_name=cfg.manage_jobs_without_queue_name,
            wait_for_pods_ready=bool(w and w.enable))
        ctrl = runtime.controller(f"job:{name}", rec.reconcile)

        def on_job(event, obj, old, _ctrl=ctrl, _cb=cb):
            if _cb.reconcile_key is not None:
                _ctrl.enqueue(_cb.reconcile_key(obj))
            else:
                _ctrl.enqueue(f"{obj.metadata.namespace}/{obj.metadata.name}")

        store.watch(cb.kind, on_job)
        enabled[name] = rec

    # child Workload events re-enqueue the owning job's reconciler
    kind_to_entry = {}
    for name in enabled:
        cb = get_integration(name)
        ctrl = runtime.controllers[
            [c.name for c in runtime.controllers].index(f"job:{name}")]
        kind_to_entry[cb.kind] = (cb, ctrl)

    def on_workload(event, wl, old):
        for owner in wl.metadata.owner_references:
            if owner.controller and owner.kind in kind_to_entry:
                cb, ctrl = kind_to_entry[owner.kind]
                if cb.reconcile_key_for_workload is not None:
                    ctrl.enqueue(cb.reconcile_key_for_workload(wl, owner))
                else:
                    ctrl.enqueue(f"{wl.metadata.namespace}/{owner.name}")

    store.watch("Workload", on_workload)
    return enabled
