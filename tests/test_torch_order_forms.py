"""The admit order's and the arena copy's launch plans, and numpy models
of csrc/order.cu, against the plain versions and the JAX lexsort.

The CUDA kernels run only on the card (tests/test_torch_cuda.py). Here:
`kernel.order_plan`'s form choice and shared-memory arithmetic;
`kernel.arena_copy_plan`'s vector widths; the packed key (four 64-bit
words whose unsigned order is the admit key's order) as a numpy model,
whose order equals order_csr_plain's and the JAX lexsort's on keys with
signed zeros, NaNs of both signs and several payloads, subnormals of
both signs (flushed to 0.0, as XLA's CPU backend flushes them), INT64_MIN and
INT64_MAX priorities, NO_LIMIT and negative shares; and numpy models of
the kernel's two forms (the staged form's histogram, scan, scatter into
domain order in any order and rank within the domain; the global form's
counting rank over (domain, key) and the offsets' lower bounds), equal
to order_csr_plain and to the CSR the JAX program builds (a stable sort
of the lexsort by domain).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_tpu.solver import kernel as jk  # enables jax x64 before any array
from kueue_tpu_torch.solver import kernel as tk

INT64_MIN = np.iinfo(np.int64).min
INT64_MAX = np.iinfo(np.int64).max
NAN_BITS = np.array([0x7ff8000000000000, 0x7ff8000000000123,
                     0xfff8000000000000, 0xfff0000000000001,
                     0x7ff0000000000001], np.uint64)
SIGN = np.uint64(1 << 63)
# subnormals of both signs, the largest one, and the smallest normal,
# which must not tie 0.0
MAX_SUBNORMAL = 2.225073858507201e-308
MIN_NORMAL = 2.2250738585072014e-308
SUBNORMAL_EDGES = np.array([5e-324, -5e-324, 1e-310, -1e-310, MAX_SUBNORMAL,
                            -MAX_SUBNORMAL, MIN_NORMAL, -MIN_NORMAL])


def ord_i64(v):
    return v.astype(np.int64).view(np.uint64) ^ SIGN


def ord_f64(t):
    """csrc/order.cu kq_ord_f64: an order-preserving uint64 of a double,
    -0.0 and every subnormal as 0.0, every NaN one code above +inf."""
    b = np.asarray(t, np.float64).view(np.uint64).copy()
    b[(b >> np.uint64(52)) & np.uint64(0x7ff) == 0] = 0
    out = np.where(b >> np.uint64(63) == 1, ~b, b | SIGN)
    out[np.isnan(t)] = np.uint64(2**64 - 1)
    return out


def pack_keys(fit, borrows, priority, timestamp, share=None):
    """csrc/order.cu kq_pack_key: [W, 4] uint64, w0 most significant."""
    W = fit.shape[0]
    nf = (~fit.astype(bool)).astype(np.uint64)
    bo = borrows.astype(bool).astype(np.uint64)
    s = ord_i64(np.zeros(W, np.int64) if share is None else share)
    n = ord_i64(np.negative(priority.astype(np.int64)))  # wraps INT64_MIN
    t = ord_f64(timestamp)
    i = np.arange(W, dtype=np.uint64)
    u = np.uint64
    return np.stack([nf << u(63) | bo << u(62) | s >> u(2),
                     s << u(62) | n >> u(2),
                     n << u(62) | t >> u(2),
                     t << u(62) | i], axis=1)


def key_less(a, b):
    """Rows of a below rows of b, 256-bit unsigned (broadcasting)."""
    less = np.zeros(np.broadcast_shapes(a.shape[:-1], b.shape[:-1]), bool)
    eq = np.ones_like(less)
    for w in range(4):
        less |= eq & (a[..., w] < b[..., w])
        eq &= a[..., w] == b[..., w]
    return less


def domains(cq_cohort, cohort_root, wl_cq):
    C = cohort_root.shape[0]
    c = cq_cohort[wl_cq]
    return np.where(c >= 0, cohort_root[np.maximum(c, 0)], C + wl_cq)


def staged_model(cq_cohort, cohort_root, keys, wl_cq, with_order, rng):
    """The staged form: a histogram of the domains scanned into the offsets,
    the keys scattered into domain order in an arbitrary arrival order
    (the kernel's shared atomics), each workload ranked against its
    domain's keys; the global order against every key."""
    W = keys.shape[0]
    D = cohort_root.shape[0] + cq_cohort.shape[0]
    dom = domains(cq_cohort, cohort_root, wl_cq)
    hist = np.bincount(dom, minlength=D + 1).astype(np.int64)
    start = np.concatenate(([0], np.cumsum(hist)[:-1]))
    fill = start.copy()
    pos = np.empty(W, np.int64)
    for j in rng.permutation(W):
        pos[j] = fill[dom[j]]
        fill[dom[j]] += 1
    staged = np.empty_like(keys)
    staged[pos] = keys
    members = np.full(W, -1, np.int64)
    for i in range(W):
        lo, hi = start[dom[i]], fill[dom[i]]
        members[lo + key_less(staged[lo:hi], keys[i]).sum()] = i
    order = None
    if with_order:
        order = np.full(W, -1, np.int64)
        order[key_less(keys[:, None], keys[None]).sum(0)] = np.arange(W)
    return start[:D + 1], members, order


def global_model(cq_cohort, cohort_root, keys, wl_cq, with_order):
    """The global form: a counting rank over (domain, key) and over the
    key, then each domain boundary's lower bound in the sorted domains."""
    W = keys.shape[0]
    D = cohort_root.shape[0] + cq_cohort.shape[0]
    dom = domains(cq_cohort, cohort_root, wl_cq)
    lt = key_less(keys[:, None], keys[None])            # [j, i]: j below i
    rank = ((dom[:, None] < dom[None]) | ((dom[:, None] == dom[None]) & lt)) \
        .sum(0)
    members = np.full(W, -1, np.int64)
    members[rank] = np.arange(W)
    sorted_dom = np.empty(W, np.int64)
    sorted_dom[rank] = dom
    offsets = np.searchsorted(sorted_dom, np.arange(D + 1), side="left")
    order = None
    if with_order:
        order = np.full(W, -1, np.int64)
        order[lt.sum(0)] = np.arange(W)
    return offsets, members, order


def jax_csr(cq_cohort, cohort_root, fit, borrows, priority, timestamp,
            wl_cq, share):
    """The CSR as the JAX program builds it (kueue_tpu/solver/kernel.py
    :498-512): the lexsort, then a stable argsort of its domains."""
    W = fit.shape[0]
    s = jnp.zeros(W, jnp.int64) if share is None else jnp.asarray(share)
    order = jnp.lexsort((jnp.asarray(timestamp), -jnp.asarray(priority), s,
                         jnp.asarray(borrows).astype(jnp.int32),
                         (~jnp.asarray(fit)).astype(jnp.int32)))
    dom = jnp.asarray(domains(cq_cohort, cohort_root, wl_cq))
    perm = jnp.argsort(dom[order], stable=True)
    D = cohort_root.shape[0] + cq_cohort.shape[0]
    counts = np.bincount(np.asarray(dom), minlength=D)
    offsets = np.concatenate(([0], np.cumsum(counts)))
    return offsets, np.asarray(order[perm]), np.asarray(order)


def order_inputs(W, seed, edge=False, one_domain=False, solo_every=0,
                 Q=24, C=6, share_kind="mixed"):
    rng = np.random.default_rng(seed)
    cq_cohort = rng.integers(0, C, size=Q).astype(np.int32)
    if solo_every:
        cq_cohort[::solo_every] = -1
    cohort_root = np.arange(C, dtype=np.int32)
    if one_domain:
        cq_cohort = rng.integers(0, C, size=Q).astype(np.int32)
        cohort_root[:] = 0
    else:
        cohort_root[1::2] -= 1  # pairs of cohorts under one root
    fit = rng.random(W) < 0.7
    borrows = rng.random(W) < 0.3
    priority = rng.integers(0, 3, size=W).astype(np.int64)
    timestamp = rng.integers(0, 4, size=W).astype(np.float64)
    share = rng.choice(np.array([-2, -1, 0, 0, 125, 333, tk.NO_LIMIT],
                                np.int64), size=W)
    if edge:
        priority = rng.choice(np.array([INT64_MIN, INT64_MAX, 0, 1, -1,
                                        INT64_MIN + 1], np.int64), size=W)
        special = np.concatenate([np.array([0.0, -0.0, np.inf, -np.inf, 1.5,
                                            -1.5]),
                                  NAN_BITS.view(np.float64)])
        if edge == "subnormal":
            special = np.concatenate([special, SUBNORMAL_EDGES])
        timestamp = rng.choice(special, size=W)
        share = rng.choice(np.array([tk.NO_LIMIT, -1, -2, 0, INT64_MAX,
                                     INT64_MIN, 7], np.int64), size=W)
    if share_kind == "none":
        share = None
    wl_cq = rng.integers(0, Q, size=W).astype(np.int32)
    return cq_cohort, cohort_root, fit, borrows, priority, timestamp, \
        wl_cq, share


def plain_csr(cq_cohort, cohort_root, fit, borrows, priority, timestamp,
              wl_cq, share, with_order=True):
    C = cohort_root.shape[0]
    topo = {"cq_cohort": torch.from_numpy(cq_cohort),
            "cohort_root": torch.from_numpy(cohort_root),
            "cohort_subtree": torch.zeros((C, 1, 1), dtype=torch.int64)}
    t = torch.from_numpy
    out = tk.order_csr(topo, t(fit), t(borrows), t(priority), t(timestamp),
                       t(wl_cq), None if share is None else t(share),
                       with_order=with_order)
    return tuple(None if x is None else x.numpy() for x in out)


CASES = [dict(W=W, seed=seed, edge=edge)
         for W in (1, 31, 33, 96) for seed in (0, 1) for edge in (False, True)]
CASES += [dict(W=96, seed=seed, edge="subnormal") for seed in (0, 1)]
CASES += [dict(W=0, seed=0), dict(W=64, seed=3, one_domain=True),
          dict(W=64, seed=4, solo_every=3, edge=True),
          dict(W=200, seed=5, edge=True, Q=64, C=16)]


@pytest.mark.parametrize("share_kind", ("mixed", "none"))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_packed_key_order_matches_plain_and_jax(case, share_kind):
    """The packed words' unsigned order is the admit order: their
    lexicographic sort equals order_csr_plain's global order and the JAX
    lexsort's, and the CSR equals the JAX program's."""
    args = order_inputs(share_kind=share_kind, **case)
    cq_cohort, cohort_root, fit, borrows, priority, timestamp, wl_cq, \
        share = args
    keys = pack_keys(fit, borrows, priority, timestamp, share)
    assert len(set(map(tuple, keys.tolist()))) == keys.shape[0]  # unique
    packed = np.lexsort(keys.T[::-1]) if keys.shape[0] else \
        np.zeros(0, np.int64)
    offsets, members, order = plain_csr(*args)
    j_offsets, j_members, j_order = jax_csr(*args)
    np.testing.assert_array_equal(packed, order)
    np.testing.assert_array_equal(packed, j_order)
    np.testing.assert_array_equal(offsets, j_offsets)
    np.testing.assert_array_equal(members, j_members)


@pytest.mark.parametrize("with_order", (False, True))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_order_form_models_match_plain(case, with_order):
    """Both forms of csrc/order.cu, as numpy models over the packed keys,
    give order_csr_plain's CSR and order: every workload in members once
    (a permutation of range(W)), whatever order the scatter takes."""
    args = order_inputs(**case)
    cq_cohort, cohort_root, fit, borrows, priority, timestamp, wl_cq, \
        share = args
    keys = pack_keys(fit, borrows, priority, timestamp, share)
    want = plain_csr(*args, with_order=with_order)
    for seed in (0, 1):
        got = staged_model(cq_cohort, cohort_root, keys, wl_cq, with_order,
                           np.random.default_rng(seed))
        for name, a, b in zip(("offsets", "members", "order"), got, want):
            if b is None:
                assert a is None
                continue
            np.testing.assert_array_equal(a, b, err_msg=f"staged {name}")
    got = global_model(cq_cohort, cohort_root, keys, wl_cq, with_order)
    for name, a, b in zip(("offsets", "members", "order"), got, want):
        if b is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"global {name}")
    np.testing.assert_array_equal(np.sort(want[1]), np.arange(case["W"]))


def test_ord_f64_edges():
    """-0.0 and every subnormal tie 0.0; the smallest normal of either
    sign does not; every NaN ties every other, above +inf; negative
    numbers below positive ones in their order."""
    nans = NAN_BITS.view(np.float64)
    vals = np.array([-np.inf, -1.5, -MIN_NORMAL, -MAX_SUBNORMAL, -5e-324,
                     -0.0, 0.0, 5e-324, 1e-310, MAX_SUBNORMAL, MIN_NORMAL,
                     1.5, np.inf])
    codes = ord_f64(vals)
    zero = codes[6]
    assert (codes[3:10] == zero).all()
    assert (np.diff(codes[[0, 1, 2, 6, 10, 11, 12]].astype(object)) > 0).all()
    nan_codes = ord_f64(nans)
    assert (nan_codes == nan_codes[0]).all() and nan_codes[0] > codes[-1]


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_subnormal_timestamps_tie_zero_like_jax(seed):
    """The repaired fault: subnormal timestamps of both signs tie +-0.0 in
    admit_order, as in the JAX lexsort (XLA's CPU backend flushes them),
    and the smallest normal orders above them."""
    rng = np.random.default_rng(seed)
    W = 64
    ts = rng.choice(np.concatenate([[0.0, -0.0], SUBNORMAL_EDGES]), size=W)
    ts[:4] = (MIN_NORMAL, -MIN_NORMAL, 5e-324, -0.0)
    fit = np.ones(W, bool)
    borrows = np.zeros(W, bool)
    priority = np.zeros(W, np.int64)
    got = tk.admit_order(*(torch.from_numpy(a) for a in (fit, borrows,
                                                         priority, ts)))
    want = jnp.lexsort((jnp.asarray(ts), -jnp.asarray(priority)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tiny = np.abs(ts) < MIN_NORMAL
    pos = np.empty(W, np.int64)
    pos[got.numpy()] = np.arange(W)
    # the ties keep the index order; the smallest normals bound them
    assert (np.diff(pos[tiny]) > 0).all()
    assert pos[1] < pos[tiny].min() and pos[0] > pos[tiny].max()


STAGED_D = 2304  # the north star's domains: 256 cohorts + 2048 CQs


@pytest.mark.parametrize("W,D,sms,form,launches,blocks,mines", [
    (0, STAGED_D, 132, "staged", 1, 1, 0),
    (1, STAGED_D, 132, "staged", 1, 1, 1),
    (33, STAGED_D, 132, "staged", 1, 3, 11),
    (2048, STAGED_D, 132, "staged", 1, 128, 16),
    (4096, STAGED_D, 132, "staged", 1, 132, 32),
    (4097, STAGED_D, 132, "global", 3, 129, 32),
    (2048, 50000, 132, "global", 3, 64, 32),
    (64, 26000, 132, "global", 3, 2, 32),  # the histogram past the cap
    (0, 60000, 132, "global", 1, 0, 32),
    (65536, 65536 + 256, 132, "global", 3, 2048, 32),
    (2048, STAGED_D, 1, "staged", 1, 1, 2048),
])
def test_order_plan_forms(W, D, sms, form, launches, blocks, mines):
    plan = tk.order_plan(W, D, sms=sms)
    assert (plan["form"], plan["launches"], plan["blocks"],
            plan["mines_per_block"]) == (form, launches, blocks, mines)
    if form == "staged":
        # keys as four planes of words, the workloads in domain order, the
        # histogram, the topology's cq_cohort and cohort_root (D entries),
        # three ints a workload the block ranks
        assert plan["smem_bytes"] == 36 * W + 4 * (D + 1) + 4 * D + 12 * mines
        assert plan["smem_bytes"] <= tk.ORDER_SMEM
        assert W <= tk.ORDER_THREADS * tk.ORDER_ILP
        assert plan["threads"] == tk.ORDER_THREADS
        assert blocks * mines >= W and plan["scratch_bytes"] == 0
    else:
        assert plan["scratch_bytes"] == 40 * W  # keys, domains, sorted
        assert plan["threads"] == tk.ORDER_RANK_THREADS


def test_order_plan_follows_smem_cap(monkeypatch):
    """ORDER_SMEM is read at each call; the limit moves with it."""
    assert tk.order_plan(2048, STAGED_D)["form"] == "staged"
    monkeypatch.setattr(tk, "ORDER_SMEM", 36 * 2048 + 8 * STAGED_D)
    assert tk.order_plan(2048, STAGED_D)["form"] == "global"
    monkeypatch.setattr(tk, "ORDER_SMEM", 0)
    assert tk.order_plan(1, 1, with_order=True)["form"] == "global"


@pytest.mark.parametrize("row_bytes,src_off,vec,passes", [
    # the north star's rows (P=4, F=32, R=2), aligned
    ((64, 4, 4, 8, 8, 128, 1), (0,) * 7, (16, 4, 4, 8, 8, 16, 1), 1),
    # P=3, F=5, R=3: odd widths
    ((72, 3, 4, 8, 8, 15, 1), (0,) * 7, (8, 1, 4, 8, 8, 1, 1), 1),
    # P=2, F=4: the bool fields' 2- and 8-byte rows take 1 and 4
    ((32, 2, 4, 8, 8, 8, 1), (0,) * 7, (16, 1, 4, 8, 8, 4, 1), 1),
    # sources one element off a 16-byte boundary
    ((64, 4, 4, 8, 8, 128, 1), (8, 1, 4, 8, 8, 1, 1), (8, 1, 4, 8, 8, 1, 1),
     4),
    # R = 32: 1024 bytes of requests, two passes of 32 vectors
    ((1024, 4, 4, 8, 8, 128, 1), (0,) * 7, (16, 4, 4, 8, 8, 16, 1), 2),
])
def test_arena_gather_plan_widths(row_bytes, src_off, vec, passes):
    base = 1 << 20
    plan = tk.arena_copy_plan(row_bytes, [base + o for o in src_off],
                              [base] * 7)
    assert tuple(plan["vec_bytes"]) == vec
    assert plan["passes"] == passes
    assert plan["warps_per_row"] == {1: 1, 2: 2, 4: 4}[passes]
    assert plan["rows_per_block"] * plan["warps_per_row"] == 8
    for name, rb, v in zip(tk.ARENA_FIELDS, row_bytes, plan["vec_bytes"]):
        assert rb % v == 0 and v in tk.ARENA_COPY_WIDTHS[name]
    # a bool field's destination 4 bytes off narrows it as a source does
    plan = tk.arena_copy_plan(row_bytes, [base] * 7,
                              [base, base + 4, base, base, base, base + 4,
                               base])
    assert plan["vec_bytes"][1] <= 4 and plan["vec_bytes"][5] <= 4
