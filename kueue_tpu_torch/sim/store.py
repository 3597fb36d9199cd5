"""In-memory object store with watches — the simulated apiserver.

The port's copy of kueue_tpu/sim/store.py. Semantics mirrored from the
kube-apiserver behaviors the reference relies on:
- resourceVersion bumped on every write; stale-RV updates raise Conflict
  (opt-in; server-side-apply style last-writer-wins is the default, since
  the reference does all status writes via SSA — pkg/workload/workload.go:521).
- deletion with finalizers parks the object with deletionTimestamp set;
  it is only removed once the last finalizer is stripped
  (pkg/controller/core/workload_controller.go finalizer GC path).
- watch events (ADDED/MODIFIED/DELETED) are dispatched synchronously to
  registered handlers, carrying the stored objects themselves — the
  client-go informer contract (shared cache pointers, read-only by
  convention; the store never mutates a stored object in place).
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, Optional

from kueue_tpu_torch.api.kueue import (clone_cluster_queue, clone_local_queue,
                                 clone_workload)
from kueue_tpu_torch.api.meta import Clock, REAL_CLOCK, new_uid
from kueue_tpu_torch.resilience import faultinject
from kueue_tpu_torch.sim.durable import Fenced  # noqa: F401 — re-exported

# Hand-rolled per-kind deep clones for the hottest objects: semantically
# identical to copy.deepcopy, ~10x faster (reconciler reads + status
# writes copy Workloads hundreds of thousands of times at scale).
_FAST_CLONE = {"Workload": clone_workload,
               "ClusterQueue": clone_cluster_queue,
               "LocalQueue": clone_local_queue}


def _clone(obj):
    fc = _FAST_CLONE.get(type(obj).__name__)
    return fc(obj) if fc is not None else copy.deepcopy(obj)

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


class NotFound(KeyError):
    pass


class AlreadyExists(ValueError):
    pass


class Conflict(ValueError):
    pass


class Invalid(ValueError):
    """Admission-webhook rejection (the apiserver's 422)."""


def kind_of(obj) -> str:
    return type(obj).__name__


def obj_key(obj) -> str:
    meta = obj.metadata
    return f"{meta.namespace}/{meta.name}" if meta.namespace else meta.name


class Store:
    """Keyed by (kind, namespace/name).

    Reads (get/list) and watch events return deep copies. `create`
    returns a copy of the stored object; `update` returns None — the
    written object is owned by the store and callers must re-`get` to
    observe the persisted state."""

    def __init__(self, clock: Clock = REAL_CLOCK, durable=None):
        self._clock = clock
        self._lock = threading.RLock()
        self._objects: dict[str, dict[str, object]] = {}
        self._watchers: dict[str, list[Callable]] = {}
        self._admission_hooks: dict[str, list[Callable]] = {}
        self._rv = 0
        # Optional durability sink (sim/durable.py): every committed
        # mutation appends one WAL record BEFORE its watch event fires,
        # so the log's order is exactly the event order the live
        # controllers consumed — replaying it rebuilds this store
        # bit-for-bit (resilience/recovery.py).
        self._durable = durable
        # Leader fencing (the JAX package's resilience/replica.py; the
        # port's replica waits for ROADMAP item 6):
        # when a FencingToken is attached, every commit validates the
        # token against the durable log's lease BEFORE the WAL append
        # (and the append itself re-checks under the log lock), so a
        # deposed leader's write raises Fenced instead of reaching the
        # log the new leader replays. None = standalone store.
        self.fencing = None

    # -- durability (the JAX package's sim/durable.py and
    # resilience/recovery.py; the port's log waits for ROADMAP item 6,
    # and these paths run only with a log attached) ---------------------

    def attach_durable(self, durable) -> None:
        """Attach a DurableLog mid-life (recovery re-attaches after the
        replay so restored objects are not re-logged; scenario harnesses
        attach before seeding capacity)."""
        self._durable = durable

    def _check_fence(self) -> None:
        """Raise Fenced when this store's leadership epoch is stale.
        Called at the TOP of every mutator — BEFORE the local bucket
        mutates — so a deposed-but-alive leader that survives the
        exception is not left holding phantom objects its own log never
        saw (a retried create must raise Fenced again, not
        AlreadyExists). The checks at _persist and inside
        DurableLog.append remain as backstops."""
        f = self.fencing
        if f is not None:
            f.check()

    def checkpoint_now(self) -> None:
        """Take a full durable checkpoint of the committed state (the
        WAL rotates). No-op without an attached log; a deposed
        leader's checkpoint raises Fenced — it would otherwise replace
        the checkpoint with a stale image and rotate away the new
        leader's live tail."""
        with self._lock:
            if self._durable is not None:
                f = self.fencing
                self._durable.checkpoint(
                    self._objects, self._rv,
                    fence=(f.identity, f.epoch,
                           getattr(f, "name", ""))
                    if f is not None else None)

    def _persist(self, event: str, kind: str, key: str, stored) -> None:
        """The commit point every mutation passes through, just before
        its watch event fires: validate the fencing token (a deposed
        leader raises Fenced here — its write must never reach the log
        the new leader replays), append the WAL
        record, then cross the ``store_write`` crash window
        (a crash AFTER the append is
        durable-but-unobserved: the write survives restart even though
        no watcher ever saw it), then maybe compact. The crash window
        only exists where a WAL exists, so the injection site is gated
        on an attached log (a fenced standby's own reconcile writes
        must not consume kill points armed for the leader). Caller
        holds the store lock."""
        d = self._durable
        fence = self.fencing
        if fence is not None:
            fence.check()
        if d is None:
            return
        ftup = ((fence.identity, fence.epoch, getattr(fence, "name", ""))
                if fence is not None else None)
        d.append(event, kind, key, stored, t=self._clock.now(),
                 fence=ftup)
        faultinject.site(faultinject.SITE_STORE)
        if d.should_checkpoint():
            d.checkpoint(self._objects, self._rv, fence=ftup)

    def load_object(self, obj) -> object:
        """Recovery-path insert (resilience/recovery.py): place an
        object reconstructed from the durable log into the store
        VERBATIM — uid, resourceVersion and timestamps preserved,
        admission webhooks skipped (they ran before the object was
        first persisted; re-defaulting a restored status would fight
        the durable truth) — and fire the ADDED watch event so the
        derived caches rebuild through the normal event path. Not
        re-logged: the record that produced ``obj`` is already
        durable."""
        kind = kind_of(obj)
        with self._lock:
            key = obj_key(obj)
            bucket = self._objects.setdefault(kind, {})
            if key in bucket:
                raise AlreadyExists(f"{kind} {key} already exists")
            bucket[key] = obj
            self._rv = max(self._rv,
                           obj.metadata.resource_version or 0)
            self._notify(kind, ADDED, obj, None)
            return obj

    def apply_replicated(self, event: str, obj) -> None:
        """Replica-side application of ONE replicated watch record
        (resilience/replica.py: the hot-standby's tail replay, and
        recovery.py's incremental cold restore). Like ``load_object``,
        the object is placed VERBATIM (uid/resourceVersion/timestamps
        preserved, admission webhooks skipped — they ran on the leader
        before the record was persisted) and the ORIGINAL event fires
        so the derived caches advance through the normal watch path —
        the same journal replay the snapshot maintainer already runs.
        Not persisted and not fault-sited: applying a record is
        consumption, not a commit. Event fidelity is defended against
        replay edge cases: an ADDED for a key we already hold becomes
        MODIFIED, a MODIFIED for an unknown key becomes ADDED, and a
        DELETED for an unknown key is a no-op — reconcilers see a
        self-consistent stream even across a bootstrap boundary."""
        kind = kind_of(obj)
        with self._lock:
            key = obj_key(obj)
            bucket = self._objects.setdefault(kind, {})
            old = bucket.get(key)
            self._rv = max(self._rv,
                           obj.metadata.resource_version or 0)
            if event == DELETED:
                if old is None:
                    return
                del bucket[key]
                self._notify(kind, DELETED, obj, old)
                return
            bucket[key] = obj
            if old is None:
                self._notify(kind, ADDED, obj, None)
            else:
                self._notify(kind, MODIFIED, obj, old)

    # -- admission webhooks -------------------------------------------------

    def add_admission_hook(self, kind: str,
                           hook: Callable[[str, object, Optional[object]], None]) -> None:
        """hook(op, obj, old) runs before a create ("CREATE") or update
        ("UPDATE") is persisted — the webhook role. It may mutate obj
        (defaulting) or raise Invalid (validation)."""
        self._admission_hooks.setdefault(kind, []).append(hook)

    def _admit(self, op: str, obj, old) -> None:
        for hook in self._admission_hooks.get(kind_of(obj), []):
            hook(op, obj, old)

    # -- watch registration ------------------------------------------------

    def watch(self, kind: str, handler: Callable[[str, object, Optional[object]], None]) -> None:
        """handler(event_type, obj, old_obj). old_obj is None for ADDED."""
        self._watchers.setdefault(kind, []).append(handler)

    def _notify(self, kind: str, event: str, obj, old) -> None:
        handlers = self._watchers.get(kind, [])
        if not handlers:
            return
        # Handlers receive the stored objects themselves — the client-go
        # informer contract (shared cache pointers, read-only by
        # convention). The store never mutates stored objects in place
        # (writes replace them), so aliasing is safe; copying per event
        # dominated the profile at the 2k-CQ scale.
        for handler in handlers:
            handler(event, obj, old)

    # -- CRUD --------------------------------------------------------------

    def create(self, obj) -> object:
        kind = kind_of(obj)
        with self._lock:
            self._check_fence()
            key = obj_key(obj)
            bucket = self._objects.setdefault(kind, {})
            if key in bucket:
                raise AlreadyExists(f"{kind} {key} already exists")
            stored = _clone(obj)
            self._admit("CREATE", stored, None)
            if not stored.metadata.uid:
                stored.metadata.uid = new_uid(kind.lower())
            if stored.metadata.creation_timestamp is None:
                stored.metadata.creation_timestamp = self._clock.now()
            self._rv += 1
            stored.metadata.resource_version = self._rv
            bucket[key] = stored
            self._persist(ADDED, kind, key, stored)
            self._notify(kind, ADDED, stored, None)
            return _clone(stored)

    def get(self, kind: str, namespace: str, name: str,
            copy_object: bool = True) -> object:
        """copy_object=False returns the stored object itself (the
        informer-lister contract: read-only by convention) — gating
        lookups at the 2k-CQ scale can't afford a deep copy of a
        16-flavor ClusterQueue spec per reconcile."""
        with self._lock:
            key = f"{namespace}/{name}" if namespace else name
            try:
                stored = self._objects[kind][key]
            except KeyError:
                raise NotFound(f"{kind} {key} not found") from None
            return _clone(stored) if copy_object else stored

    def try_get(self, kind: str, namespace: str, name: str,
                copy_object: bool = True):
        try:
            return self.get(kind, namespace, name, copy_object=copy_object)
        except NotFound:
            return None

    def update(self, obj, expect_rv: Optional[int] = None) -> None:
        """Write back an object. With expect_rv set, raises Conflict on a
        stale resourceVersion (optimistic concurrency); by default the
        write wins (SSA-style — the reference's status writes are all SSA
        and conflict-tolerant). Returns None; re-`get` to observe the
        persisted state."""
        kind = kind_of(obj)
        with self._lock:
            self._check_fence()
            key = obj_key(obj)
            bucket = self._objects.setdefault(kind, {})
            if key not in bucket:
                raise NotFound(f"{kind} {key} not found")
            old = bucket[key]
            if obj is old:
                # In-place mutation of a shared (copy_object=False) read:
                # old == stored would make every such write a silent
                # no-op (no RV bump, no watch event). Fail loudly.
                raise ValueError(
                    f"{kind} {key}: update() with the stored object "
                    "itself (in-place mutation of a shared read?)")
            if expect_rv is not None and old.metadata.resource_version != expect_rv:
                raise Conflict(
                    f"{kind} {key}: resourceVersion {expect_rv} != {old.metadata.resource_version}")
            stored = _clone(obj)
            if self._admission_hooks.get(kind):
                self._admit("UPDATE", stored, _clone(old))
            stored.metadata.uid = old.metadata.uid
            stored.metadata.creation_timestamp = old.metadata.creation_timestamp
            # deletionTimestamp is apiserver-owned: preserve it across writes
            if old.metadata.deletion_timestamp is not None:
                stored.metadata.deletion_timestamp = old.metadata.deletion_timestamp
            # A write that changes nothing does not bump the RV or fire a
            # watch event (apiserver no-op update semantics) — this is what
            # lets status-writing reconcilers settle.
            stored.metadata.resource_version = old.metadata.resource_version
            if stored == old:
                return None
            self._rv += 1
            stored.metadata.resource_version = self._rv
            if stored.metadata.deletion_timestamp is not None and not stored.metadata.finalizers:
                # last finalizer removed -> actually delete
                del bucket[key]
                self._persist(DELETED, kind, key, stored)
                self._notify(kind, DELETED, stored, old)
                return None
            bucket[key] = stored
            self._persist(MODIFIED, kind, key, stored)
            self._notify(kind, MODIFIED, stored, old)
            return None

    def update_status(self, obj, owned_status: bool = False) -> None:
        """Status-subresource write (k8s /status semantics): admission
        webhooks are NOT invoked and only `.status` is persisted — spec
        and metadata changes on obj are ignored. A write that changes
        nothing does not bump the RV or fire a watch event. This is what
        keeps per-admission ClusterQueue/LocalQueue counter refreshes
        from re-validating (and re-copying) a 16-flavor spec at the
        2k-CQ scale."""
        kind = kind_of(obj)
        with self._lock:
            self._check_fence()
            key = obj_key(obj)
            bucket = self._objects.setdefault(kind, {})
            if key not in bucket:
                raise NotFound(f"{kind} {key} not found")
            old = bucket[key]
            if obj is old or obj.status is old.status:
                # A caller holding a shared pointer (copy_object=False
                # read) wrote through it: the no-change check below would
                # compare the status with itself and silently drop the
                # write. Fail loudly instead — build a fresh status
                # (owned_status) or read with a copy.
                raise ValueError(
                    f"{kind} {key}: status aliases the stored object "
                    "(in-place mutation of a shared read?)")
            if obj.status == old.status:
                return None
            stored = copy.copy(old)
            stored.metadata = copy.copy(old.metadata)
            # owned_status: the caller hands over a freshly built status
            # object (reconciler pattern) — no defensive copy needed.
            stored.status = (obj.status if owned_status
                             else copy.deepcopy(obj.status))
            self._rv += 1
            stored.metadata.resource_version = self._rv
            bucket[key] = stored
            self._persist(MODIFIED, kind, key, stored)
            self._notify(kind, MODIFIED, stored, old)
            return None

    def delete(self, kind: str, namespace: str, name: str) -> None:
        with self._lock:
            self._check_fence()
            key = f"{namespace}/{name}" if namespace else name
            bucket = self._objects.get(kind, {})
            if key not in bucket:
                raise NotFound(f"{kind} {key} not found")
            old = bucket[key]
            if old.metadata.finalizers:
                if old.metadata.deletion_timestamp is None:
                    stored = _clone(old)
                    stored.metadata.deletion_timestamp = self._clock.now()
                    self._rv += 1
                    stored.metadata.resource_version = self._rv
                    bucket[key] = stored
                    self._persist(MODIFIED, kind, key, stored)
                    self._notify(kind, MODIFIED, stored, old)
                return
            del bucket[key]
            self._persist(DELETED, kind, key, old)
            self._notify(kind, DELETED, old, old)

    def list(self, kind: str, namespace: Optional[str] = None,
             labels: Optional[dict] = None,
             where: Optional[Callable[[object], bool]] = None,
             copy_objects: bool = True) -> list:
        """copy_objects=False returns the stored objects themselves —
        the informer-lister contract (client-go listers return shared
        cache pointers, read-only by convention): callers must not
        mutate. Deep-copying every ClusterQueue per reconcile event is
        what made membership scans quadratic at the 2k-CQ scale."""
        with self._lock:
            out = []
            for obj in self._objects.get(kind, {}).values():
                if namespace is not None and obj.metadata.namespace != namespace:
                    continue
                if labels is not None and any(
                        obj.metadata.labels.get(k) != v for k, v in labels.items()):
                    continue
                if where is not None and not where(obj):
                    continue
                out.append(_clone(obj) if copy_objects else obj)
            return out

    def count(self, kind: str) -> int:
        with self._lock:
            return len(self._objects.get(kind, {}))
