"""cluster-autoscaler ProvisioningRequest + kueue config CRDs.

Reference: apis/kueue/v1beta1/provisioningrequestconfig_types.go:25-80 and
the autoscaler.x-k8s.io/v1beta1 ProvisioningRequest consumed by
pkg/controller/admissionchecks/provisioning.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.api.corev1 import PodTemplateSpec
from kueue_tpu_torch.api.meta import ObjectMeta

PROVISIONED = "Provisioned"
FAILED = "Failed"
ACCEPTED = "Accepted"
BOOKING_EXPIRED = "BookingExpired"
CAPACITY_REVOKED = "CapacityRevoked"


@dataclass
class ProvisioningRequestPodSet:
    pod_template_ref: str = ""
    count: int = 0


@dataclass
class ProvisioningRequestSpec:
    provisioning_class_name: str = ""
    pod_sets: list = field(default_factory=list)
    parameters: dict = field(default_factory=dict)


@dataclass
class ProvisioningRequestStatus:
    conditions: list = field(default_factory=list)
    provisioning_class_details: dict = field(default_factory=dict)


@dataclass
class ProvisioningRequest:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ProvisioningRequestSpec = field(default_factory=ProvisioningRequestSpec)
    status: ProvisioningRequestStatus = field(default_factory=ProvisioningRequestStatus)

    KIND = "ProvisioningRequest"


@dataclass
class ProvisioningRequestConfigSpec:
    provisioning_class_name: str = ""
    parameters: dict = field(default_factory=dict)
    # resources that gate podset inclusion; empty = all podsets
    managed_resources: list = field(default_factory=list)


@dataclass
class ProvisioningRequestConfig:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ProvisioningRequestConfigSpec = field(
        default_factory=ProvisioningRequestConfigSpec)

    KIND = "ProvisioningRequestConfig"


@dataclass
class PodTemplate:
    """corev1.PodTemplate object created alongside a ProvisioningRequest."""
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)

    KIND = "PodTemplate"


# --- MultiKueue CRDs (reference: apis/kueue/v1alpha1/multikueue_types.go) ---


@dataclass
class MultiKueueClusterSpec:
    # the reference holds a kubeconfig secret/path; the sim resolves the
    # cluster name through an injected registry of remote stores
    kubeconfig_ref: str = ""


@dataclass
class MultiKueueClusterStatus:
    conditions: list = field(default_factory=list)


@dataclass
class MultiKueueCluster:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: MultiKueueClusterSpec = field(default_factory=MultiKueueClusterSpec)
    status: MultiKueueClusterStatus = field(default_factory=MultiKueueClusterStatus)

    KIND = "MultiKueueCluster"


@dataclass
class MultiKueueConfigSpec:
    clusters: list = field(default_factory=list)  # MultiKueueCluster names


@dataclass
class MultiKueueConfig:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: MultiKueueConfigSpec = field(default_factory=MultiKueueConfigSpec)

    KIND = "MultiKueueConfig"
