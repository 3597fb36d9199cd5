"""Pending-workload queues (reference: pkg/queue)."""

from kueue_tpu_torch.queue.cluster_queue import ClusterQueueHeap, RequeueReason  # noqa: F401
from kueue_tpu_torch.queue.manager import Manager  # noqa: F401
