"""batch/v1 Job — the subset the job integration consumes
(reference: k8s batch/v1 as used by pkg/controller/jobs/job)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from kueue_tpu_torch.api.corev1 import PodTemplateSpec
from kueue_tpu_torch.api.meta import Condition, ObjectMeta

JOB_COMPLETE = "Complete"
JOB_FAILED = "Failed"


@dataclass
class JobSpec:
    parallelism: int = 1
    completions: Optional[int] = None
    suspend: bool = False
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)


@dataclass
class JobStatus:
    active: int = 0
    ready: int = 0
    succeeded: int = 0
    failed: int = 0
    conditions: list = field(default_factory=list)  # list[Condition]


@dataclass
class Job:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: JobSpec = field(default_factory=JobSpec)
    status: JobStatus = field(default_factory=JobStatus)

    KIND = "Job"
