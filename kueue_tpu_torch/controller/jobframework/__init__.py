"""Job-integration framework: the GenericJob SPI + shared reconciler.

Equivalent of the reference's pkg/controller/jobframework
(interface.go:36-128, reconciler.go:204-1000, integrationmanager.go,
workload_names.go, setup.go). Integrations register via
`register_integration`; `setup_integrations` wires the enabled ones onto
the sim runtime.
"""

from kueue_tpu_torch.controller.jobframework.interface import (
    GenericJob,
    ComposableJob,
    IntegrationCallbacks,
    register_integration,
    get_integration,
    integration_names,
    forget_integrations,
    STOP_REASON_WORKLOAD_DELETED,
    STOP_REASON_WORKLOAD_EVICTED,
    STOP_REASON_NO_MATCHING_WORKLOAD,
    STOP_REASON_NOT_ADMITTED,
)
from kueue_tpu_torch.controller.jobframework.reconciler import JobReconciler
from kueue_tpu_torch.controller.jobframework.workload_names import workload_name_for_owner
from kueue_tpu_torch.controller.jobframework.setup import setup_integrations

__all__ = [
    "GenericJob", "ComposableJob", "IntegrationCallbacks",
    "register_integration", "get_integration", "integration_names",
    "forget_integrations",
    "JobReconciler", "workload_name_for_owner", "setup_integrations",
    "STOP_REASON_WORKLOAD_DELETED", "STOP_REASON_WORKLOAD_EVICTED",
    "STOP_REASON_NO_MATCHING_WORKLOAD", "STOP_REASON_NOT_ADMITTED",
]
