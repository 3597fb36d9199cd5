"""Run a control-plane test on both packages and hold the port's store,
step by step, equal to the JAX package's.

`load_twin(modname, pkg)` loads a test module (tests/test_controllers.py
and the like) with every `kueue_tpu` import pointed at package `pkg`
and `tests.wrappers` at its own twin of the same package, as a fresh
module. `run_twin(...)` runs one test function of it under a `Trace`:
every Store and EventRecorder made during the test is registered (the
KueueManagers' own among them), and after every
`Runtime.run_until_idle` (which `schedule_once`,
`schedule_until_settled` and `advance` end in), every
`Scheduler.schedule` and the test's end the trace keeps a canonical
dump of each registered store (every object's spec, status,
conditions, finalizers and owner references) and each recorder's
events; every store write records its outcome (the exception's type
and message, or success). `assert_twins` runs the test on both
packages and requires the same steps and the same outcome, with no
tolerance; `assert_script_twins(script)` does the same for a
`script(M)` written once for both, `M(name)` importing the module of
the package under test. Each run starts the uid counter at 1 (workload
names hash the owner's uid) and the feature gates at their defaults.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import itertools
import pathlib
import re
import sys
import types
from enum import Enum

ROOT = pathlib.Path(__file__).resolve().parent.parent


def load_twin(modname: str, pkg: str, subs: tuple = ()):
    """`modname` (a module of tests/) loaded for package `pkg`, with the
    source substitutions `subs` ((old, new) pairs, each required to
    match) applied on both packages alike."""
    tag = abs(hash(subs)) if subs else 0
    name = f"twin_{pkg}_{modname.replace('.', '_')}_{tag}"
    if name in sys.modules:
        return sys.modules[name]
    path = ROOT / (modname.replace(".", "/") + ".py")
    src = path.read_text()
    if modname != "tests.wrappers":
        wrappers = load_twin("tests.wrappers", pkg)
        src = src.replace("from tests.wrappers import",
                          f"from {wrappers.__name__} import")
    for old, new in subs:
        assert old in src, (modname, old)
        src = src.replace(old, new)
    if pkg != "kueue_tpu":
        src = re.sub(r"\bkueue_tpu\b", pkg, src)
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    try:
        exec(compile(src, str(path), "exec"), mod.__dict__)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def canon(x):
    """A plain, comparable form of an api object: dataclasses by class
    name and fields, enums by name, containers in their order."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, canon(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, Enum):
        return (type(x).__name__, x.name)
    if isinstance(x, dict):
        return ("dict",) + tuple((canon(k), canon(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return ("set",) + tuple(sorted(repr(canon(v)) for v in x))
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return x
    return ("object", type(x).__name__)


class Canon:
    """canon() of stored objects, kept by identity and resource version:
    the store replaces an object on every write and never mutates a
    stored one in place, so an unchanged object is not walked again."""

    def __init__(self):
        self._seen: dict = {}  # id -> (object, version, canon)

    def __call__(self, obj):
        meta = getattr(obj, "metadata", None)
        version = meta.resource_version if meta is not None else None
        hit = self._seen.get(id(obj))
        if hit is not None and hit[0] is obj and hit[1] == version:
            return hit[2]
        c = canon(obj)
        self._seen[id(obj)] = (obj, version, c)
        return c

    def store(self, store) -> tuple:
        """Every object of the store by kind and key, in key order."""
        with store._lock:
            return tuple(
                (kind, tuple((key, self(obj))
                             for key, obj in sorted(bucket.items())))
                for kind, bucket in sorted(store._objects.items())
                if bucket)

    def events(self, recorder) -> tuple:
        return tuple(self(e) for e in recorder.events)


@contextlib.contextmanager
def patched(obj, name, wrap):
    real = getattr(obj, name)
    setattr(obj, name, wrap(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


class Trace:
    """Records one package's run: the store after every drain and every
    cycle, and the outcome of every store write."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        self.managers: list = []
        self.stores: list = []
        self.recorders: list = []
        self.steps: list = []
        self.canon = Canon()

    def mod(self, name):
        return importlib.import_module(f"{self.pkg}.{name}")

    def snap(self, what: str) -> None:
        self.steps.append((what,
                           tuple(self.canon.store(s) for s in self.stores),
                           tuple(self.canon.events(r)
                                 for r in self.recorders)))

    @contextlib.contextmanager
    def active(self):
        trace = self

        def wrap_init(registry):
            def wrap(real):
                def __init__(self, *a, **kw):
                    real(self, *a, **kw)
                    registry.append(self)
                return __init__
            return wrap

        def wrap_drain(what):
            def wrap(real):
                def fn(self, *a, **kw):
                    out = real(self, *a, **kw)
                    trace.snap(what)
                    return out
                return fn
            return wrap

        def wrap_write(op):
            def wrap(real):
                def fn(self, obj_or_kind, *a, **kw):
                    kind = (obj_or_kind if isinstance(obj_or_kind, str)
                            else type(obj_or_kind).__name__)
                    try:
                        out = real(self, obj_or_kind, *a, **kw)
                    except Exception as e:  # recorded, then re-raised
                        trace.steps.append((op, kind, type(e).__name__,
                                            str(e)))
                        raise
                    trace.steps.append((op, kind, "ok"))
                    return out
                return fn
            return wrap

        store_cls = self.mod("sim.store").Store
        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(self.mod("manager").KueueManager,
                                        "__init__",
                                        wrap_init(self.managers)))
            stack.enter_context(patched(store_cls, "__init__",
                                        wrap_init(self.stores)))
            stack.enter_context(patched(
                self.mod("sim.runtime").EventRecorder, "__init__",
                wrap_init(self.recorders)))
            stack.enter_context(patched(self.mod("sim.runtime").Runtime,
                                        "run_until_idle",
                                        wrap_drain("drain")))
            stack.enter_context(patched(
                self.mod("scheduler.scheduler").Scheduler, "schedule",
                wrap_drain("cycle")))
            for op in ("create", "update", "update_status", "delete"):
                stack.enter_context(patched(store_cls, op, wrap_write(op)))
            yield self


@contextlib.contextmanager
def fresh_package(pkg: str):
    """The feature gates at their defaults and the uid counter from 1
    for the run; the package's own counter is put back after it."""
    meta = importlib.import_module(f"{pkg}.api.meta")
    features = importlib.import_module(f"{pkg}.features")
    saved = meta._uid_counter
    meta._uid_counter = itertools.count(1)
    features.reset()
    try:
        yield
    finally:
        meta._uid_counter = saved
        features.reset()


def run_traced(pkg: str, body) -> tuple:
    """body() under a Trace of `pkg`; returns (steps, outcome). Every
    manager made in it is shut down after."""
    trace = Trace(pkg)
    with fresh_package(pkg):
        with trace.active():
            try:
                body()
                outcome = "passed"
            except Exception as e:
                outcome = f"{type(e).__name__}: {e}"
            trace.snap("end")
        for m in trace.managers:
            m.shutdown()
    return trace.steps, outcome


def _fixture_fn(fx):
    get = getattr(fx, "_get_wrapped_function", None)
    return get() if get is not None else fx.__wrapped__


def _call(fn, mod, cache: dict):
    """fn with its arguments resolved from the module's fixtures."""
    import inspect
    kwargs = {}
    for p in inspect.signature(fn).parameters:
        if p not in cache:
            cache[p] = _call(_fixture_fn(getattr(mod, p)), mod, cache)
        kwargs[p] = cache[p]
    return fn(**kwargs)


def run_twin(modname: str, test: str, pkg: str, subs: tuple = ()) -> tuple:
    """Run `test` ("Class.test_name" or "test_name") of the twin of
    `modname` for `pkg`; returns (steps, outcome)."""
    mod = load_twin(modname, pkg, subs)
    cls_name, _, fn_name = test.rpartition(".")
    fn = getattr(getattr(mod, cls_name)() if cls_name else mod, fn_name)
    return run_traced(pkg, lambda: _call(fn, mod, {}))


def first_difference(a: list, b: list):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x, y
    return len(min(a, b, key=len)), None, None


def assert_twins(modname: str, test: str, subs: tuple = ()) -> list:
    """The test passes on the JAX package, and on the port with the same
    steps and outcome. Returns the JAX package's steps."""
    return _compare(run_twin(modname, test, "kueue_tpu", subs),
                    run_twin(modname, test, "kueue_tpu_torch", subs))


def assert_script_twins(script, expect: str = "passed") -> list:
    """script(M) on both packages, M(name) importing `name` of the
    package under test; the same steps and outcome (`expect` for the
    JAX package's). Returns the JAX package's steps."""
    def run(pkg):
        def M(name):
            return importlib.import_module(f"{pkg}.{name}")
        return run_traced(pkg, lambda: script(M))
    return _compare(run("kueue_tpu"), run("kueue_tpu_torch"), expect)


def _compare(ref: tuple, port: tuple, expect: str = "passed") -> list:
    (ref_steps, ref_out), (port_steps, port_out) = ref, port
    assert ref_out == expect, ref_out
    assert port_out == ref_out
    if port_steps != ref_steps:
        i, x, y = first_difference(ref_steps, port_steps)
        raise AssertionError(
            f"step {i} of {len(ref_steps)} (port {len(port_steps)}) "
            f"differs:\nJAX:  {str(x)[:3000]}\nport: {str(y)[:3000]}")
    assert ref_steps, "the test recorded no step"
    return ref_steps
