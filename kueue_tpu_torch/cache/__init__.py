"""State layer: in-memory mirror of admitted usage plus full-rebuild
scheduling snapshots (reference: pkg/cache)."""

from kueue_tpu_torch.cache.cache import Cache  # noqa: F401
from kueue_tpu_torch.cache.snapshot import ClusterQueueSnapshot, CohortSnapshot, Snapshot  # noqa: F401
