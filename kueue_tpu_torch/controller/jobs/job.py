"""batch/v1 Job integration.

Equivalent of the reference's pkg/controller/jobs/job/job_controller.go:
- suspend semantics; one "main" PodSet of min(parallelism, completions)
- partial admission: parallelism scaled to the admitted count, original
  kept in an annotation; optional completions sync (:260-299)
- reclaimable pods from succeeded counts (:216-231)
- Finished from the Complete/Failed conditions (:301-308)
"""

from __future__ import annotations

import copy
from typing import Optional

from kueue_tpu_torch.api import batchv1
from kueue_tpu_torch.api import kueue as api
from kueue_tpu_torch.core import podset as podsetpkg
from kueue_tpu_torch.controller.jobframework.interface import (
    GenericJob,
    IntegrationCallbacks,
    register_integration,
)

FRAMEWORK_NAME = "batch/job"
MIN_PARALLELISM_ANNOTATION = "kueue.x-k8s.io/job-min-parallelism"
COMPLETIONS_EQUAL_PARALLELISM_ANNOTATION = \
    "kueue.x-k8s.io/job-completions-equal-parallelism"
ORIGINAL_PARALLELISM_ANNOTATION = "kueue.x-k8s.io/original-parallelism"


class BatchJob(GenericJob):
    def __init__(self, obj: batchv1.Job):
        self.job = obj

    def object(self):
        return self.job

    def gvk(self) -> str:
        return FRAMEWORK_NAME

    def is_suspended(self) -> bool:
        return self.job.spec.suspend

    def suspend(self) -> None:
        self.job.spec.suspend = True

    def is_active(self) -> bool:
        return self.job.status.active != 0

    def _pods_count(self) -> int:
        count = self.job.spec.parallelism
        if self.job.spec.completions is not None:
            count = min(count, self.job.spec.completions)
        return count

    def _min_pods_count(self) -> Optional[int]:
        raw = self.job.metadata.annotations.get(MIN_PARALLELISM_ANNOTATION)
        try:
            return int(raw) if raw is not None else None
        except ValueError:
            return None

    def _sync_completions(self) -> bool:
        return self.job.metadata.annotations.get(
            COMPLETIONS_EQUAL_PARALLELISM_ANNOTATION, "") == "true"

    def pod_sets(self) -> list:
        return [api.PodSet(name=api.DEFAULT_PODSET_NAME,
                           template=copy.deepcopy(self.job.spec.template),
                           count=self._pods_count(),
                           min_count=self._min_pods_count())]

    def run_with_podsets_info(self, podsets_info: list) -> None:
        self.job.spec.suspend = False
        if len(podsets_info) != 1:
            raise podsetpkg.PermanentError(
                f"expected 1 podset info, got {len(podsets_info)}")
        info = podsets_info[0]
        if self._min_pods_count() is not None and info.count != self.job.spec.parallelism:
            self.job.metadata.annotations[ORIGINAL_PARALLELISM_ANNOTATION] = \
                str(self.job.spec.parallelism)
            self.job.spec.parallelism = info.count
            if self._sync_completions():
                self.job.spec.completions = info.count
        podsetpkg.merge_into_template(self.job.spec.template, info)

    def restore_podsets_info(self, podsets_info: list) -> bool:
        if not podsets_info:
            return False
        changed = False
        original = self.job.metadata.annotations.pop(
            ORIGINAL_PARALLELISM_ANNOTATION, None)
        if original is not None and int(original) != self.job.spec.parallelism:
            self.job.spec.parallelism = int(original)
            if self._sync_completions():
                self.job.spec.completions = int(original)
            changed = True
        return podsetpkg.restore_template(
            self.job.spec.template, podsets_info[0]) or changed

    def finished(self) -> tuple:
        for c in self.job.status.conditions:
            if c.type in (batchv1.JOB_COMPLETE, batchv1.JOB_FAILED) and c.status == "True":
                return c.message, c.type != batchv1.JOB_FAILED, True
        return "", True, False

    def pods_ready(self) -> bool:
        return self.job.status.succeeded + self.job.status.ready >= self._pods_count()

    # optional: JobWithReclaimablePods (reference: :216-231)
    def reclaimable_pods(self) -> list:
        parallelism = self.job.spec.parallelism
        if parallelism == 1 or self.job.status.succeeded == 0:
            return []
        completions = (self.job.spec.completions
                       if self.job.spec.completions is not None else parallelism)
        remaining = completions - self.job.status.succeeded
        if remaining >= parallelism:
            return []
        return [api.ReclaimablePod(name=api.DEFAULT_PODSET_NAME,
                                   count=parallelism - remaining)]


register_integration(IntegrationCallbacks(
    name=FRAMEWORK_NAME, kind="Job", new_job=BatchJob, job_type=batchv1.Job))
