"""The port's sim store and controller runtime against the JAX package's.

tests/test_controllers.py's TestSimStore cases run on both packages
(tests/torch_twin.py), and scripts written once for both drive the
store's writes, watches, admission hooks, finalizers, resource versions
and errors (Invalid, Conflict, NotFound, AlreadyExists), the
`store_write` fault site behind an attached log, and the runtime's
workqueues, requeue-after timers, `advance`, the hot-loop guard and the
EventRecorder's ring. Every store write's outcome (the exception's type
and message), the store after every drain and the script's own
observations must be equal, with no tolerance.
"""

import pytest

from tests.torch_twin import assert_script_twins, assert_twins


@pytest.mark.parametrize("test", [
    "TestSimStore.test_finalizer_blocks_deletion",
    "TestSimStore.test_noop_update_fires_no_event",
])
def test_sim_store_case(test):
    assert_twins("tests.test_controllers", test)


def workload(M, name, queue="lq", ns="default"):
    api, meta = M("api.kueue"), M("api.meta")
    wl = api.Workload(metadata=meta.ObjectMeta(name=name, namespace=ns))
    wl.spec.queue_name = queue
    return wl


def expect(exc_type, fn, *args, **kw):
    """The exception fn raises, as (type name, message)."""
    try:
        fn(*args, **kw)
    except exc_type as e:
        return type(e).__name__, str(e)
    raise AssertionError(f"{fn.__name__} did not raise")


def store_errors(M):
    sim, meta = M("sim"), M("api.meta")
    store = sim.Store(meta.FakeClock(5.0))
    store.create(workload(M, "w"))
    seen = [expect(sim.AlreadyExists, store.create, workload(M, "w")),
            expect(sim.NotFound, store.get, "Workload", "default", "nope"),
            expect(sim.NotFound, store.delete, "Workload", "default", "nope")]
    stale = store.get("Workload", "default", "w")
    fresh = store.get("Workload", "default", "w")
    fresh.spec.priority = 3
    store.update(fresh)
    stale.spec.priority = 4
    seen.append(expect(sim.Conflict, store.update, stale,
                       expect_rv=stale.metadata.resource_version))
    got = store.get("Workload", "default", "w")
    seen.append((got.spec.priority, got.metadata.resource_version,
                 got.metadata.generation, got.metadata.creation_timestamp))
    assert store.try_get("Workload", "default", "nope") is None
    return seen


def store_watch_and_versions(M):
    sim, meta, api = M("sim"), M("api.meta"), M("api.kueue")
    store = sim.Store(meta.FakeClock(0.0))
    events = []
    store.watch("Workload", lambda e, o, old: events.append(
        (e, o.metadata.name, o.metadata.resource_version,
         old.metadata.resource_version if old is not None else None)))
    for i in range(3):
        store.create(workload(M, f"w{i}", ns=f"ns{i % 2}"))
    wl = store.get("Workload", "ns1", "w1")
    wl.status.conditions.append(meta.Condition(
        type=api.WORKLOAD_QUOTA_RESERVED, status="False", reason="Pending"))
    store.update_status(wl)
    wl = store.get("Workload", "ns0", "w0")
    wl.spec.active = False
    store.update(wl)
    store.delete("Workload", "ns0", "w2")
    listed = [(w.metadata.namespace, w.metadata.name)
              for w in store.list("Workload")]
    in_ns = [w.metadata.name for w in store.list("Workload", namespace="ns1")]
    assert events and listed and in_ns
    return events, listed, in_ns


def store_admission_hooks(M):
    sim, meta = M("sim"), M("api.meta")
    store = sim.Store(meta.FakeClock(0.0))
    calls = []

    def hook(op, obj, old):
        calls.append((op, obj.metadata.name,
                      old.metadata.name if old is not None else None))
        if obj.spec.queue_name == "bad":
            raise sim.Invalid(f"Workload {obj.metadata.name!r} is invalid")
        obj.spec.priority = 7  # defaulting

    store.add_admission_hook("Workload", hook)
    store.create(workload(M, "ok"))
    refused = expect(sim.Invalid, store.create, workload(M, "x", queue="bad"))
    got = store.get("Workload", "default", "ok")
    got.spec.queue_name = "bad"
    refused_update = expect(sim.Invalid, store.update, got)
    assert store.try_get("Workload", "default", "x") is None
    return (calls, refused, refused_update,
            store.get("Workload", "default", "ok").spec.priority)


def store_finalizers(M):
    sim, meta, api = M("sim"), M("api.meta"), M("api.kueue")
    clock = meta.FakeClock(10.0)
    store = sim.Store(clock)
    events = []
    store.watch("Workload", lambda e, o, old: events.append(
        (e, o.metadata.name, o.metadata.deletion_timestamp,
         tuple(o.metadata.finalizers))))
    wl = workload(M, "w")
    wl.metadata.finalizers = [api.RESOURCE_IN_USE_FINALIZER, "other"]
    store.create(wl)
    clock.advance(3.0)
    store.delete("Workload", "default", "w")
    store.delete("Workload", "default", "w")  # parked: deleting again
    parked = store.get("Workload", "default", "w")
    parked.metadata.finalizers = ["other"]
    store.update(parked)
    parked = store.get("Workload", "default", "w")
    parked.metadata.finalizers = []
    store.update(parked)
    assert store.try_get("Workload", "default", "w") is None
    return events


class StandInLog:
    """An attached log: appends counted, never a checkpoint."""

    checkpoint_every = 0

    def __init__(self):
        self.records = []

    def append(self, event, kind, key, obj, t=None, fence=None):
        self.records.append((event, kind, key, t))

    def should_checkpoint(self):
        return False


def store_fault_site(M):
    sim, meta = M("sim"), M("api.meta")
    fi = M("resilience.faultinject")
    store = sim.Store(meta.FakeClock(1.0))
    store.create(workload(M, "before"))  # no log: the site is not crossed
    log = StandInLog()
    store.attach_durable(log)
    injector = fi.FaultInjector({fi.SITE_STORE: {1: fi.CRASH}})
    with fi.installed(injector):
        store.create(workload(M, "a"))
        try:
            store.create(workload(M, "b"))
            crashed = None
        except fi.InjectedCrash as e:
            crashed = str(e)
    # the crash came after the append: the write is in the log and the
    # store, but no watcher saw it
    return (log.records, crashed, injector.hits[fi.SITE_STORE],
            sorted(w.metadata.name for w in store.list("Workload")))


def runtime_timers(M):
    rt, meta = M("sim.runtime"), M("api.meta")
    clock = meta.FakeClock(100.0)
    runtime = rt.Runtime(clock)
    seen = []
    counts = {}

    def reconcile(key):
        counts[key] = counts.get(key, 0) + 1
        seen.append((clock.now(), key, counts[key]))
        if key == "again" and counts[key] < 3:
            return True
        if key == "later" and counts[key] < 3:
            return 5.0
        return None

    ctrl = runtime.controller("c", reconcile)
    for key in ("later", "again", "once", "again"):
        ctrl.enqueue(key)
    first = runtime.run_until_idle()
    due = runtime.next_timer_due()
    runtime.advance(4.0)
    runtime.advance(1.0)
    runtime.advance(5.0)
    return first, due, seen, runtime.next_timer_due()


def runtime_hot_loop(M):
    rt, meta = M("sim.runtime"), M("api.meta")
    runtime = rt.Runtime(meta.FakeClock(0.0))
    runtime.controller("spin", lambda key: True).enqueue("k")
    return expect(RuntimeError, runtime.run_until_idle, max_iterations=50)


def event_recorder_ring(M):
    rt, api, meta = M("sim.runtime"), M("api.kueue"), M("api.meta")
    rec = rt.EventRecorder(capacity=3)
    for i in range(5):
        wl = api.Workload(metadata=meta.ObjectMeta(
            name=f"w{i}", namespace="default"))
        rec.event(wl, "Normal", "EvictedDueToPreempted" if i % 2 else
                  "Admitted", f"message {i}")
    rec.system_event("Warning", "DeviceFault", "fault")
    return (len(rec.events), rec.total_events, dict(rec.reason_counts),
            rec.count_by_reason_prefix("EvictedDueTo"),
            [e.object_key for e in rec.by_reason("Admitted")],
            expect(ValueError, rt.EventRecorder, capacity=0))


SCRIPTS = [store_errors, store_watch_and_versions, store_admission_hooks,
           store_finalizers, store_fault_site, runtime_timers,
           runtime_hot_loop, event_recorder_ring]


@pytest.mark.parametrize("script", SCRIPTS, ids=[s.__name__ for s in SCRIPTS])
def test_store_and_runtime_match_jax(script):
    results = {}

    def run(M):
        results[M("sim").__name__.split(".")[0]] = script(M)

    assert_script_twins(run)
    assert results["kueue_tpu_torch"] == results["kueue_tpu"], results
