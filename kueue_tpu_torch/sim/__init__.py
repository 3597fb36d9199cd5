"""In-process simulated apiserver + controller runtime, and the
scenario builders that drive the port without the manager
(`sim/northstar.py`).

The port's copy of kueue_tpu/sim/__init__.py: an in-memory object store
with watch events, finalizer-aware deletion and resource-version
bumping, plus a deterministic controller runtime (workqueues drained to
idle) replacing controller-runtime's manager. Of the durable log only
`Fenced` is here; the rest waits for ROADMAP item 6.
"""

from kueue_tpu_torch.sim.store import (
    Invalid,
    ADDED,
    DELETED,
    MODIFIED,
    Conflict,
    NotFound,
    AlreadyExists,
    Store,
    kind_of,
    obj_key,
)
from kueue_tpu_torch.sim.durable import Fenced
from kueue_tpu_torch.sim.runtime import Controller, EventRecorder, Runtime

__all__ = [
    "ADDED", "MODIFIED", "DELETED",
    "Store", "NotFound", "AlreadyExists", "Conflict", "Invalid",
    "kind_of", "obj_key", "Fenced",
    "Controller", "Runtime", "EventRecorder",
]
