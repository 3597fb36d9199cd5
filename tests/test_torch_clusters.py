"""MultiKueue placement in the port against the JAX package.

The remote-cluster capacity columns, from the snapshot stamp to the
placements a Scheduler hands to `on_placement`, on the same seeded
numpy inputs or the same objects in both packages, every output
exactly equal (quantities int64, choices int32 indices):

- the plain score_cluster_columns (K12) against score_cluster_columns_impl
  over 60 seeds of synth.synth_cluster_inputs (lost clusters, partial
  offers, capacity that runs out mid-scan, requests in inactive podsets),
  and against the host oracle walked in the admit order;
- the global admit order (order_csr with_order) against the order the
  JAX fused program hands to its scan, with ties, NaN timestamps and
  fair-sharing shares;
- the Cache's column stamp, encode_cluster_columns, place_remote_dicts
  (pinned and not) and consume_remote_dicts against their JAX twins;
- the fused cycle with and without compact, and the resident and arena
  cycles, with cluster_args (mk_cluster included);
- the port's Scheduler with a capacity source and an on_placement sink
  against the JAX Scheduler (tests/test_torch_scheduler.py run_both):
  both routes, fair sharing on and off, several cycles with finishes, a
  cluster lost between cycles, a CQ without the check and a capacity
  source that raises.

tests/test_torch_cuda.py holds the CUDA kernel against the plain version
and the oracle on the card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_tpu.solver import kernel as jk  # enables jax x64 before any array
from kueue_tpu.core import workload as jwl
from kueue_tpu.solver import encode as jenc
from kueue_tpu_torch.solver import encode as tenc
from kueue_tpu_torch.solver import kernel as tk
from kueue_tpu_torch.solver.synth import (
    cluster_oracle,
    synth_cluster_inputs,
    synth_deltas,
)
from tests.test_torch_kernels import (
    KINDS,
    P,
    WL_KEYS,
    assert_same,
    jax_topo,
    make_inputs,
    t,
    torch_topo,
    with_fair_sharing,
    with_ties_and_padding,
)
from tests.test_torch_scheduler import PKGS, ROUTES, run_both, to_pkg
from tests.wrappers import (
    ClusterQueueWrapper,
    WorkloadWrapper,
    flavor_quotas,
    make_flavor,
)

MK_CONTROLLER = "kueue.x-k8s.io/multikueue"
# most seeds share one shape (one JAX compile); every tenth is wider
NARROW = dict(num_clusters=8, num_flavors=5, num_resources=2,
              num_workloads=48, num_podsets=2, num_cqs=6, max_capacity=24)
WIDE = dict(num_clusters=3, num_flavors=12, num_resources=3,
            num_workloads=40, num_podsets=3, num_cqs=4, max_capacity=30)
_score = jax.jit(jk.score_cluster_columns_impl)


def cluster_case(seed: int):
    return synth_cluster_inputs(**(WIDE if seed % 10 == 0 else NARROW),
                                seed=seed)


# --- K12: the scan ---

@pytest.mark.parametrize("seed", range(60))
def test_score_cluster_columns_matches_jax(seed):
    cols, _, resources, args = cluster_case(seed)
    ref = np.asarray(_score(*(jnp.asarray(a) for a in args)))
    got = tk.score_cluster_columns(*(t(a) for a in args))
    assert_same(got, ref, "mk_cluster")
    # the sequential oracle walked in the admit order agrees
    np.testing.assert_array_equal(
        cluster_oracle(cols, resources, args[4], args[5], args[6], args[7],
                       args[8], args[3]), ref)
    # rows not admitted, or of a CQ without the check, never place
    ccap, coffer, cactive, mk_cq, _, _, wl_cq, _, admitted = args
    assert (ref[~(mk_cq[wl_cq] & admitted)] == -1).all()
    assert cactive[ref[ref >= 0]].all()


def test_cluster_cases_reach_every_branch():
    """Over the seeds: lost clusters, partial offers (a cluster offering
    a flavor in some resources only), rows that take part but find no
    column while capacity is left (exhausted mid-scan), and placed rows."""
    lost = partial = exhausted = placed = 0
    for seed in range(60):
        _, _, _, args = cluster_case(seed)
        ccap, coffer, cactive, mk_cq, _, _, wl_cq, _, admitted = args
        got = tk.score_cluster_columns(*(t(a) for a in args)).numpy()
        part = mk_cq[wl_cq] & admitted
        lost += int((~cactive).sum())
        partial += int((coffer.any(2) & ~coffer.all(2)).sum())
        exhausted += int((part & (got == -1)).sum())
        placed += int((got >= 0).sum())
    assert lost and partial and exhausted and placed


# --- the global admit order ---

def fused_scan_order(topo, usage, cu, wl, cargs, monkeypatch, fair):
    """The order the JAX fused program hands to its cluster scan."""
    captured = {}
    real = jk.score_cluster_columns_impl

    def capture(*args):
        captured["order"] = np.asarray(args[7])
        return real(*args)

    monkeypatch.setattr(jk, "score_cluster_columns_impl", capture)
    jk.solve_cycle_fused_impl(
        jax_topo(topo), jnp.asarray(usage), jnp.asarray(cu),
        *(jnp.asarray(wl[k]) for k in WL_KEYS), num_podsets=P,
        max_rank=wl["wl_cq"].shape[0], fair_sharing=fair,
        cluster_args=tuple(jnp.asarray(a) for a in cargs))
    return captured["order"]


def cycle_cluster_args(topo, wl, seed: int, K: int = 4) -> tuple:
    """(ccap, coffer, cactive, mk_cq) for a topology and batch: a lost
    cluster, partial offers and capacity of a few heads' requests."""
    rng = np.random.default_rng(seed + 40)
    Q, F, R = topo["nominal"].shape
    treq = np.where(wl["podset_active"][:, :, None], wl["requests"], 0).sum(1)
    coffer = rng.random((K, F, R)) < 0.7
    ccap = np.where(coffer, rng.integers(0, 3 * int(treq.max()) + 1,
                                         size=(K, F, R)), 0).astype(np.int64)
    cactive = np.ones(K, bool)
    cactive[1] = False
    mk_cq = rng.random(Q) < 0.7
    return ccap, coffer, cactive, mk_cq


@pytest.mark.parametrize("variant", ("ties", "nan", "shares"))
@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("kind", KINDS)
def test_global_order_matches_jax(kind, seed, variant, monkeypatch):
    """order_csr's global order (with_order) against the lexsort the JAX
    fused program scans in: ties and padding rows, NaN timestamps, and
    fair-sharing shares (weights 0/500/1000/3000, roots lending
    nothing)."""
    topo, usage, cu, wl = make_inputs(kind, seed)
    fair = variant == "shares"
    if fair:
        topo, wl = with_fair_sharing(topo, wl, seed)
    else:
        wl = with_ties_and_padding(wl, seed)
    if variant == "nan":
        rng = np.random.default_rng(seed)
        wl["timestamp"][rng.random(wl["timestamp"].shape[0]) < 0.25] = np.nan
    ref = fused_scan_order(topo, usage, cu, wl,
                           cycle_cluster_args(topo, wl, seed), monkeypatch,
                           fair)
    tt = torch_topo(topo)
    fit, borrows, _, _, asg = tk.phase_a(
        tt, tk.avail(tt, t(usage), t(cu)), t(usage),
        *(t(wl[k]) for k in ("requests", "podset_active", "wl_cq",
                             "eligible", "solvable")), P)
    share = tk.drf_share(tt, t(usage), asg, t(wl["wl_cq"])) if fair \
        else None
    offsets, members, order = tk.order_csr(
        tt, fit, borrows, t(wl["priority"]), t(wl["timestamp"]),
        t(wl["wl_cq"]), share, with_order=True)
    assert order.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), ref)
    # the CSR is unchanged by asking for the order
    want = tk.order_csr(tt, fit, borrows, t(wl["priority"]),
                        t(wl["timestamp"]), t(wl["wl_cq"]), share)
    assert torch.equal(offsets, want[0]) and torch.equal(members, want[1])
    if fair:
        assert (share.numpy() != 0).any()


# --- the cycles with cluster_args ---

@pytest.mark.parametrize("cycle", ("fused", "fused_dense", "fused_fair",
                                   "resident", "arena"))
@pytest.mark.parametrize("kind", KINDS)
def test_cycles_with_cluster_args_match_jax(kind, cycle):
    topo, usage, cu, wl = make_inputs(kind, 1)
    fair = cycle == "fused_fair"
    if fair:
        topo, wl = with_fair_sharing(topo, wl, 1)
    cargs = cycle_cluster_args(topo, wl, 2)
    jc = tuple(jnp.asarray(a) for a in cargs)
    tc = tuple(t(a) for a in cargs)
    kw = dict(num_podsets=P, max_rank=64, compact=cycle != "fused_dense",
              fair_sharing=fair)
    jbatch = [jnp.asarray(wl[k]) for k in WL_KEYS]
    tbatch = [t(wl[k]) for k in WL_KEYS]
    slots = None
    if cycle.startswith("fused"):
        ref = jk.solve_cycle_fused(jax_topo(topo), jnp.asarray(usage),
                                   jnp.asarray(cu), *jbatch, cluster_args=jc,
                                   **kw)
        got = tk.solve_cycle_fused(torch_topo(topo), t(usage), t(cu),
                                   *tbatch, cluster_args=tc, **kw)
    elif cycle == "resident":
        deltas = synth_deltas(topo, usage, 12, seed=5)
        ref = jk.solve_cycle_resident_impl(
            jax_topo(topo), jnp.asarray(usage), jnp.asarray(cu),
            tuple(jnp.asarray(a) for a in deltas), *jbatch, cluster_args=jc,
            **kw)
        got = tk.solve_cycle_resident(
            torch_topo(topo), t(usage), t(cu), tuple(t(a) for a in deltas),
            *tbatch, cluster_args=tc, **kw)
    else:
        slots = np.arange(wl["wl_cq"].shape[0], dtype=np.int32)[::-1].copy()
        slots[-5:] = -1
        ref = jk.solve_cycle_resident_arena_impl(
            jax_topo(topo), jnp.asarray(usage), jnp.asarray(cu), None,
            {k: jnp.asarray(wl[k]) for k in WL_KEYS}, jnp.asarray(slots),
            cluster_args=jc, **kw)
        got = tk.solve_cycle_resident_arena(
            torch_topo(topo), t(usage), t(cu), None,
            {k: t(wl[k]) for k in WL_KEYS}, t(slots), cluster_args=tc, **kw)
    assert set(got) == set(ref) and "mk_cluster" in got
    for k in ref:
        assert_same(got[k], ref[k], k)
    mkc = got["mk_cluster"].numpy()
    assert (mkc >= 0).any() and (mkc == -1).any()
    assert not (mkc == 1).any()  # cluster 1 is lost
    if slots is not None:
        assert (mkc[slots < 0] == -1).all()  # padding never places


# --- the snapshot stamp and the encode ---

def mk_check(pkg: str):
    api = importlib.import_module(f"{pkg}.api.kueue")
    meta = importlib.import_module(f"{pkg}.api.meta")
    ac = api.AdmissionCheck(metadata=meta.ObjectMeta(name="mk-check"))
    ac.spec.controller_name = MK_CONTROLLER
    ac.status.conditions.append(meta.Condition(
        type=api.ADMISSION_CHECK_ACTIVE, status="True", reason="Active"))
    return ac


# f2 before f10 in numeric order, after it in the string order the
# topology index follows
FLAVORS = ("f1", "f2", "f10")


def mk_cq(name: str, cohort: str, checks=("mk-check",), cpu="8"):
    w = ClusterQueueWrapper(name).resource_group(
        *(flavor_quotas(f, cpu=cpu, memory="8Gi") for f in FLAVORS))
    if cohort:
        w = w.cohort(cohort)
    return w.admission_checks(*checks).obj()


# (cluster, {(flavor, resource): available}) columns, sorted by name:
# an unknown flavor and an unknown resource, a negative reading, a
# partial offer
COLUMNS = (
    ("w0", {("f1", "cpu"): 4000, ("f1", "memory"): 4 << 30,
            ("f10", "cpu"): -5}),
    ("w1", {("f10", "cpu"): 6000, ("f10", "memory"): 6 << 30,
            ("f2", "cpu"): 3000, ("f2", "memory"): 3 << 30,
            ("gpu-x", "cpu"): 50000, ("f2", "nvidia.com/gpu"): 4}),
    ("w2", {(f, r): 100000 if r == "cpu" else 100 << 30
            for f in FLAVORS for r in ("cpu", "memory")}),
)

CASES = ("fleet", "lost", "one_cluster", "five_clusters", "no_check_on_cq",
         "no_remotes", "source_raises", "no_source")


def stamped_cache(pkg: str, case: str):
    """A cache of `pkg` with three CQs (two with the MultiKueue check)
    and the remote columns of `case` as its capacity source."""
    def conv(obj):
        return obj if pkg == "kueue_tpu" else to_pkg(obj, pkg)
    cache = importlib.import_module(f"{pkg}.cache").Cache()
    for f in FLAVORS:
        cache.add_or_update_resource_flavor(conv(make_flavor(f)))
    cache.add_or_update_admission_check(mk_check(pkg))
    checks = () if case == "no_check_on_cq" else ("mk-check",)
    cache.add_cluster_queue(conv(mk_cq("a", "team", checks)))
    cache.add_cluster_queue(conv(mk_cq("b", "team", ())))
    cache.add_cluster_queue(conv(mk_cq("c", "", checks)))
    cols = [(name, caps, name != "w1" or case != "lost")
            for name, caps in COLUMNS]
    if case == "one_cluster":
        cols = cols[:1]
    elif case == "five_clusters":
        cols = cols + [("w3", dict(COLUMNS[2][1]), True),
                       ("w4", {}, False)]
    elif case == "no_remotes":
        cols = []

    def source():
        if case == "source_raises":
            raise RuntimeError("torn read of a remote cache")
        return tuple(cols), frozenset({"mk-check", "other-check"})

    if case != "no_source":
        cache.remote_capacity_source = source
    return cache


@pytest.mark.parametrize("case", CASES)
def test_encode_cluster_columns_matches_jax(case):
    out = {}
    for pkg, enc in zip(PKGS, (jenc, tenc)):
        snap = stamped_cache(pkg, case).snapshot()
        topo = enc.encode_topology(snap)
        out[pkg] = (snap, topo, enc.encode_cluster_columns(snap, topo))
    (jsnap, jtopo, ref), (tsnap, ttopo, got) = out.values()
    assert tsnap.remote_clusters == jsnap.remote_clusters
    assert tsnap.mk_check_names == jsnap.mk_check_names
    assert ttopo.flavors == jtopo.flavors == sorted(FLAVORS)
    if case in ("no_check_on_cq", "no_remotes", "source_raises",
                "no_source"):
        assert ref is None and got is None
        if case == "source_raises":  # the rule: no columns this cycle
            assert tsnap.remote_clusters == () and not tsnap.mk_check_names
        return
    assert got.names == ref.names
    for name in ("ccap", "coffer", "cactive", "mk_cq"):
        assert_same(getattr(got, name), getattr(ref, name), name)
    K = {"one_cluster": 1, "five_clusters": 8}.get(case, 4)
    assert got.ccap.shape[0] == K and not got.cactive[len(got.names):].any()
    assert (got.ccap >= 0).all()
    for a, b in zip(tenc.cluster_args_device(got),
                    jenc.cluster_args_device(ref)):
        assert_same(a, b)


def random_requests(rng, n: int) -> list:
    resources = ("cpu", "memory", "nvidia.com/gpu")
    return [{r: int(rng.integers(-1, 5)) * (1000 if r == "cpu" else 1 << 30)
             for r in resources if rng.random() < 0.7} for _ in range(n)]


@pytest.mark.parametrize("pinned", (False, True))
@pytest.mark.parametrize("seed", range(8))
def test_place_and_consume_remote_dicts_match_jax(seed, pinned):
    """The oracle and the in-flight debit on the columns of COLUMNS (and
    a lost cluster), with requests of 0, negative and missing resources;
    pins to column clusters (some no longer fitting: honored anyway),
    to a cluster outside the columns, and none."""
    rng = np.random.default_rng(seed)
    cols = tuple((name, caps, name != "w0" or seed % 2 == 0)
                 for name, caps in COLUMNS)
    reqs = random_requests(rng, 30)
    pins = None
    if pinned:
        pins = [rng.choice(["w0", "w1", "w2", "elsewhere", None, None])
                for _ in reqs]
        pins = [None if p is None else str(p) for p in pins]
    ref = jenc.place_remote_dicts(cols, reqs, pinned=pins)
    assert tenc.place_remote_dicts(cols, reqs, pinned=pins) == ref
    assert any(ref) and None in ref
    debit_pins = pins if pinned else ref
    assert tenc.consume_remote_dicts(cols, reqs, debit_pins) == \
        jenc.consume_remote_dicts(cols, reqs, debit_pins)


def test_place_remote_dicts_honors_a_pin_that_no_longer_fits():
    cols = (("w0", {("f1", "cpu"): 10}, True),
            ("w1", {("f1", "cpu"): 100}, True))
    reqs = [{"cpu": 8}, {"cpu": 8}, {"cpu": 8}]
    for enc in (jenc, tenc):
        # the second pin finds w0 spent: kept, and nothing is debited
        # twice, so the third (unpinned) still goes to w1
        assert enc.place_remote_dicts(cols, reqs, ["w0", "w0", None]) == \
            ["w0", "w0", "w1"]


# --- the Scheduler with a capacity source and a placement sink ---

class Fleet:
    """Worker clusters for either package: `columns` is a Cache's
    remote_capacity_source (sorted names, a lost cluster inactive with
    no capacity), `place` a Scheduler's on_placement (debits the
    workload's request vector with the package's consume_remote_dicts),
    `release` credits a finished workload back."""

    def __init__(self, pkg: str, clusters: dict, requests: dict,
                 raises: bool = False):
        self.enc = importlib.import_module(f"{pkg}.solver.encode")
        self.free = {n: dict(c) for n, c in clusters.items()}
        self.requests, self.raises = requests, raises
        self.lost: set = set()
        self.held: dict = {}
        self.placements: list = []

    def columns(self):
        if self.raises:
            raise RuntimeError("torn read of a remote cache")
        return tuple((n, {} if n in self.lost else dict(self.free[n]),
                      n not in self.lost) for n in sorted(self.free)), \
            frozenset({"mk-check"})

    def place(self, key, cluster):
        self.placements.append((key, cluster))
        caps = self.free[cluster]
        ((_, left, _),) = self.enc.consume_remote_dicts(
            ((cluster, caps, True),), [self.requests[key]], [cluster])
        self.held[key] = (cluster, {fr: caps[fr] - v for fr, v in left.items()
                                    if caps[fr] != v})
        self.free[cluster] = left

    def release(self, key):
        cluster, debit = self.held.pop(key, (None, {}))
        for fr, v in debit.items():
            self.free[cluster][fr] += v


FLEET = {
    "w0": {("f1", "cpu"): 5000, ("f1", "memory"): 5 << 30},
    "w1": {(f, r): 6000 if r == "cpu" else 6 << 30
           for f in ("f10", "f2") for r in ("cpu", "memory")},
    "w2": {("f2", "cpu"): 40000},                         # partial offer
    "w3": {**{(f, r): 7000 if r == "cpu" else 7 << 30
              for f in FLAVORS for r in ("cpu", "memory")},
           ("gpu-x", "cpu"): 50000, ("gpu-x", "memory"): 50 << 30},
}


def mk_workloads(partial: bool = False):
    """Thirty workloads over the CQs a, b (no check), c, d: sizes 1-4
    cpu (and GiB), priorities -1..2, creation times with ties; with
    `partial`, first in d a 6-pod workload that fits only in part (3 of
    its pods, admitted on the CPU beside the device's admissions)."""
    rng = np.random.default_rng(3)
    out = []
    if partial:
        out.append(WorkloadWrapper("p0").queue("lq-d").priority(5)
                   .pod_set(count=6, min_count=1, cpu="1", memory="1Gi")
                   .obj())
    for i in range(30):
        q = "abcd"[i % 4]
        size = int(rng.integers(1, 5))
        out.append(WorkloadWrapper(f"w{i}").queue(f"lq-{q}")
                   .priority(int(rng.integers(-1, 3)))
                   .creation(float(rng.integers(0, 6)))
                   .pod_set(count=1, cpu=str(size), memory=f"{size}Gi")
                   .obj())
    return out


def request_vectors() -> dict:
    return {jwl.key(w): jwl.mk_request_vector(jwl.Info(w), False)
            for w in mk_workloads(partial=True)}


def mk_setup(case: str):
    def setup(env):
        for f in FLAVORS:
            env.add_flavor(f)
        env.cache.add_or_update_admission_check(mk_check(env.pkg))
        for name, cohort, checks in (("a", "team", ("mk-check",)),
                                     ("b", "team", ()),
                                     ("c", "team", ("mk-check",)),
                                     ("d", "", ("mk-check",))):
            env.add_cq(mk_cq(name, cohort, checks, cpu="3"), f"lq-{name}")
        env.fleet = Fleet(env.pkg, FLEET, request_vectors(),
                          raises=case == "source_raises")
        env.cache.remote_capacity_source = env.fleet.columns
        env.scheduler.on_placement = env.fleet.place
    return setup


def finish_and_lose(env, cycle):
    """Between cycles: the admitted workloads finish (their remote
    capacity credited back) and, from the third cycle on, w1 is lost
    (`env.lost_from`: the placements made before)."""
    if not hasattr(env, "finished"):
        env.finished = set()
    done = [k for k in env.client.applied if k not in env.finished]
    for key in done:
        wl = env.client.applied[key]
        env.cache.delete_workload(wl)
        env.queues.queue_associated_inadmissible_workloads_after(wl)
        env.fleet.release(key)
        env.finished.add(key)
    if cycle == 2:
        env.fleet.lost.add("w1")
        env.lost_from = len(env.fleet.placements)


@pytest.mark.parametrize("case", ("fleet", "source_raises", "partial"))
@pytest.mark.parametrize("fair", (False, True))
@pytest.mark.parametrize("route", ROUTES)
def test_scheduler_placements_match_jax(route, fair, case):
    """On the device route the partial case's first cycle admits the
    device's heads and, in the apply stage, the partially admitted one:
    the one flush pins the device's rows and places the partial one from
    what they left."""
    envs = []
    run_both(mk_setup(case), lambda: mk_workloads(case == "partial"),
             route, fair_sharing=fair, cycles=5, between=finish_and_lose,
             envs_out=envs, admissions_only=case == "partial")
    ref, got = (env.fleet.placements for env in envs)
    assert got == ref
    if case == "source_raises":
        assert not got
        return
    placed = dict(got)
    assert {"w0", "w1", "w3"} <= set(placed.values())
    assert "w2" not in placed.values()  # a partial offer never fits
    assert all(c != "w1" for _, c in got[envs[1].lost_from:])
    # the CQ without the check never places
    assert not {f"default/w{i}" for i in range(1, 30, 4)} & set(placed)


# --- the solver: upload, the fetch, the decode into last_placements ---

@pytest.mark.parametrize("compact", (True, False))
def test_batch_solver_placements_match_jax(compact, monkeypatch):
    """An unbound BatchSolver cycle with the columns of COLUMNS: the same
    decisions' placements by name as the JAX BatchSolver, mk_cluster
    fetched beside the packed (or dense) decisions in one copy; the next
    cycle without columns resets last_placements; the columns' bytes
    count in last_upload_bytes."""
    from kueue_tpu_torch.solver import service as tsvc
    if not compact:
        monkeypatch.setattr(tsvc, "MAX_COMPACT_FLAVORS", 0)
    rng = np.random.default_rng(5)
    wls = [WorkloadWrapper(f"h{i}").queue(f"lq-{'abc'[i % 3]}")
           .priority(int(rng.integers(0, 3))).creation(float(i % 4))
           .pod_set(count=1, cpu=str(int(rng.integers(1, 4))),
                    memory="1Gi").obj() for i in range(24)]
    got = {}
    for pkg in PKGS:
        cache = stamped_cache(pkg, "fleet")
        wlpkg = importlib.import_module(f"{pkg}.core.workload")
        heads = []
        for i, w in enumerate(wls):
            info = wlpkg.Info(w if pkg == "kueue_tpu" else to_pkg(w, pkg))
            info.cluster_queue = "abc"[i % 3]
            heads.append(info)
        mod = importlib.import_module(f"{pkg}.solver")
        solver = mod.BatchSolver(device="cpu") if pkg != "kueue_tpu" \
            else mod.BatchSolver()
        decisions = solver.solve(cache.snapshot(), heads)
        placed = dict(solver.last_placements)
        up = getattr(solver, "last_upload_bytes", None)
        cache.remote_capacity_source = None
        solver.solve(cache.snapshot(), heads)
        assert solver.last_placements == {}
        got[pkg] = (sorted((i, ok) for i, (_, ok) in decisions.items()),
                    placed, up, solver.last_upload_bytes)
    ref, port = got["kueue_tpu"], got["kueue_tpu_torch"]
    assert port[:2] == ref[:2]
    assert set(port[1].values()) >= {"w0", "w2"}
    # the columns ride the upload: 4 clusters x 3 flavors x 2 resources
    # (int64 and bool), 4 active flags, 3 CQs' check flags (Q bucketed)
    cols = tenc.encode_cluster_columns(stamped_cache(
        "kueue_tpu_torch", "fleet").snapshot(), tenc.encode_topology(
        stamped_cache("kueue_tpu_torch", "fleet").snapshot()))
    assert port[2] - port[3] == sum(a.nbytes for a in
                                    tenc.cluster_args_device(cols))


def test_fetch_keeps_each_array_aligned():
    """The one-copy fetch of arrays of mixed widths: each comes back equal
    and aligned for its type (the uint8 decisions' lengths are not
    multiples of 4 or 8)."""
    from kueue_tpu_torch.solver.service import BatchSolver
    result = {"dec_pr": torch.arange(15, dtype=torch.uint8).reshape(5, 3),
              "dec_bits": torch.arange(3, dtype=torch.uint8).reshape(3, 1),
              "mk_cluster": torch.tensor([-1, 2, 0, 7, -1], dtype=torch.int32),
              "stats": torch.tensor([[1, -2], [3, 4]], dtype=torch.int64),
              "feasible": torch.tensor([True, False, True])}
    out = BatchSolver(device="cpu")._fetch(result, list(result))
    for k, v in result.items():
        assert out[k].dtype == v.numpy().dtype and out[k].shape == v.shape
        np.testing.assert_array_equal(out[k], v.numpy())
        assert out[k].ctypes.data % out[k].itemsize == 0, k
