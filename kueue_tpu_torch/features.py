"""Feature gates (reference: pkg/features/kube_features.go:37-125).

Defaults match the reference's v0.8 line.
"""

from __future__ import annotations

from contextlib import contextmanager

PARTIAL_ADMISSION = "PartialAdmission"
QUEUE_VISIBILITY = "QueueVisibility"
FLAVOR_FUNGIBILITY = "FlavorFungibility"
PROVISIONING_ACC = "ProvisioningACC"
VISIBILITY_ON_DEMAND = "VisibilityOnDemand"
PRIORITY_SORTING_WITHIN_COHORT = "PrioritySortingWithinCohort"
MULTIKUEUE = "MultiKueue"
LENDING_LIMIT = "LendingLimit"
MULTIKUEUE_BATCH_JOB_WITH_MANAGED_BY = "MultiKueueBatchJobWithManagedBy"
MULTIPLE_PREEMPTIONS = "MultiplePreemptions"

_DEFAULTS = {
    PARTIAL_ADMISSION: True,
    QUEUE_VISIBILITY: False,
    FLAVOR_FUNGIBILITY: True,
    PROVISIONING_ACC: True,
    VISIBILITY_ON_DEMAND: False,
    PRIORITY_SORTING_WITHIN_COHORT: True,
    MULTIKUEUE: False,
    LENDING_LIMIT: True,
    MULTIKUEUE_BATCH_JOB_WITH_MANAGED_BY: False,
    MULTIPLE_PREEMPTIONS: True,
}

_gates = dict(_DEFAULTS)


def enabled(name: str) -> bool:
    return _gates.get(name, False)


def set_feature_gates(gates: dict) -> None:
    for name, value in gates.items():
        if name not in _DEFAULTS:
            raise ValueError(f"unknown feature gate {name}")
        _gates[name] = bool(value)


def reset() -> None:
    _gates.clear()
    _gates.update(_DEFAULTS)


@contextmanager
def override(**gates):
    """Test helper: temporarily flip gates."""
    saved = dict(_gates)
    try:
        set_feature_gates({k: v for k, v in gates.items()})
        yield
    finally:
        _gates.clear()
        _gates.update(saved)
