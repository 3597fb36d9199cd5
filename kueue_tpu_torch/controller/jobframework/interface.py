"""GenericJob SPI and the integration registry.

Equivalent of the reference's pkg/controller/jobframework/interface.go:36-128
and integrationmanager.go:56-118. Optional capabilities (reclaimable pods,
custom stop, finalize, skip, priority class) are modeled as optional
methods probed with hasattr — the Python analogue of the reference's Go
type assertions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

# stop reasons (reference: interface.go:76-83)
STOP_REASON_WORKLOAD_DELETED = "WorkloadDeleted"
STOP_REASON_WORKLOAD_EVICTED = "WorkloadEvicted"
STOP_REASON_NO_MATCHING_WORKLOAD = "NoMatchingWorkload"
STOP_REASON_NOT_ADMITTED = "NotAdmitted"


class GenericJob:
    """The contract every job integration implements
    (reference: interface.go:36-60).

    Optional capability methods (probed with hasattr, mirroring the
    reference's optional interfaces):
    - reclaimable_pods() -> list[api.ReclaimablePod]     (JobWithReclaimablePods)
    - stop(store, podsets_info, reason, msg) -> bool     (JobWithCustomStop)
    - finalize(store)                                    (JobWithFinalize)
    - skip() -> bool                                     (JobWithSkip)
    - priority_class() -> str                            (JobWithPriorityClass)
    """

    def object(self):
        """The underlying store object (has .metadata)."""
        raise NotImplementedError

    def is_suspended(self) -> bool:
        raise NotImplementedError

    def suspend(self) -> None:
        raise NotImplementedError

    def run_with_podsets_info(self, podsets_info: list) -> None:
        """Inject node selectors/counts and unsuspend
        (may raise podset.PermanentError)."""
        raise NotImplementedError

    def restore_podsets_info(self, podsets_info: list) -> bool:
        raise NotImplementedError

    def finished(self) -> tuple:
        """(message, success, finished)."""
        raise NotImplementedError

    def pod_sets(self) -> list:
        """list[api.PodSet] for the workload."""
        raise NotImplementedError

    def is_active(self) -> bool:
        """True if any pods are still running."""
        raise NotImplementedError

    def pods_ready(self) -> bool:
        raise NotImplementedError

    def gvk(self) -> str:
        """Group/kind string, e.g. "batch/job"."""
        raise NotImplementedError


class ComposableJob(GenericJob):
    """A job composed of multiple objects (reference: interface.go:108-128;
    implemented by the pod-group integration)."""

    def load(self, store, namespace: str, name: str) -> tuple:
        """Returns (remove_finalizers, found)."""
        raise NotImplementedError

    def run(self, store, podsets_info: list, recorder, msg: str) -> None:
        raise NotImplementedError

    def construct_composable_workload(self, store, recorder):
        raise NotImplementedError

    def list_child_workloads(self, store) -> list:
        raise NotImplementedError

    def find_matching_workloads(self, store, recorder) -> tuple:
        """Returns (match, to_delete)."""
        raise NotImplementedError

    def stop(self, store, podsets_info: list, reason: str, msg: str) -> list:
        """Returns the objects stopped now."""
        raise NotImplementedError


@dataclass
class IntegrationCallbacks:
    """Registry entry (reference: integrationmanager.go:56-82)."""
    name: str                        # framework name, e.g. "batch/job"
    kind: str                        # store kind, e.g. "Job"
    new_job: Callable                # (obj) -> GenericJob wrapper
    job_type: type                   # the store object dataclass
    add_to_scheme: Optional[Callable] = None
    is_managing_conflict: Optional[Callable] = None
    # integrations that must also be enabled (reference: DependencyList,
    # e.g. deployment -> pod)
    depends_on: list = field(default_factory=list)
    # ComposableJob integrations construct their wrapper without a loaded
    # object (new_job(None)) and load members themselves
    composable: bool = False
    # map a watched object to its reconcile key (default: ns/name); the
    # pod integration maps group members to "group/ns/groupname"
    # (reference: pod/event_handlers.go:43)
    reconcile_key: Optional[Callable] = None
    # map a child Workload (+ its controller OwnerReference) to the owner
    # job's reconcile key (default: "ns/owner.name")
    reconcile_key_for_workload: Optional[Callable] = None


_registry: dict[str, IntegrationCallbacks] = {}


def register_integration(cb: IntegrationCallbacks) -> None:
    """reference: integrationmanager.go RegisterIntegration"""
    if cb.name in _registry:
        raise ValueError(f"integration {cb.name} already registered")
    _registry[cb.name] = cb


def get_integration(name: str) -> Optional[IntegrationCallbacks]:
    return _registry.get(name)


def integration_names() -> list:
    return list(_registry)


def forget_integrations() -> None:
    """Test hook (reference: integrationmanager_test)."""
    _registry.clear()
