"""API types for kueue_tpu_torch: the three core modules (meta, corev1,
kueue), re-exported. Plain dataclasses equivalent to the reference CRD
Go structs (apis/kueue/v1beta1, apis/kueue/v1alpha1). The job kinds the
port's integrations consume are in their own modules: `batchv1` (the
batch/v1 Job) and `autoscaling` (ProvisioningRequest and the MultiKueue
types); the other frameworks' kinds wait for ROADMAP item 5b.
"""

from kueue_tpu_torch.api.meta import (  # noqa: F401
    Condition,
    LabelSelector,
    LabelSelectorRequirement,
    ObjectMeta,
    OwnerReference,
    find_condition,
    is_condition_true,
    set_condition,
)
from kueue_tpu_torch.api.corev1 import (  # noqa: F401
    Affinity,
    Container,
    NodeAffinity,
    NodeSelector,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    PodSpec,
    PodTemplateSpec,
    Taint,
    Toleration,
)
from kueue_tpu_torch.api.kueue import (  # noqa: F401
    Admission,
    AdmissionCheck,
    AdmissionCheckSpec,
    AdmissionCheckState,
    AdmissionCheckStrategyRule,
    BorrowWithinCohort,
    ClusterQueue,
    ClusterQueuePreemption,
    ClusterQueueSpec,
    ClusterQueueStatus,
    Cohort,
    CohortSpec,
    FairSharing,
    FlavorFungibility,
    FlavorQuotas,
    FlavorUsage,
    LocalQueue,
    LocalQueueSpec,
    LocalQueueStatus,
    PodSet,
    PodSetAssignment,
    PodSetUpdate,
    ReclaimablePod,
    RequeueState,
    ResourceFlavor,
    ResourceFlavorSpec,
    ResourceGroup,
    ResourceQuota,
    ResourceUsage,
    Workload,
    WorkloadPriorityClass,
    WorkloadSpec,
    WorkloadStatus,
)
