"""Numpy models of csrc/solve_fair.cu (K11) against the plain versions and
the JAX programs.

The CUDA kernels run only on the card (tests/test_torch_cuda.py). Here:

- K11's launch plan: the arena's bytes (a layout model of sf_layout),
  the form a shape takes ("shared", "global") under the
  shared-memory cap, and the grid;
- the keyed pick: four warp reductions (the share's high word, then its
  low word, then cq_order, then the slot) over lanes that each own one
  CQ (QL <= 32) or offer their best of several, against the JAX
  program's `pick_cq` rule (kueue_tpu/solver/fairpreempt.py:302) on
  seeded shares, and against solve_fair_plain's first pop on batches
  where one removal fits;
- the divisions by a precomputed multiplier (sf_magic, sf_fdiv) against
  floor division on every int64 dividend class;
- solve_fair_plain against the JAX solve_fair_impl on the edge batches
  of synth.synth_fair_edges (shares that tie on the high word, on the
  share, weight 0, limits around 2^61 / 4) and on a batch past 32 local
  CQs, under every strategy order;
- pack_plain, K8's plain version, against the JAX pack_decisions_impl
  at the edge shapes of K8's card test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kueue_tpu.solver import fairpreempt as jfp
from kueue_tpu.solver import kernel as jk  # enables jax x64 before any array
from kueue_tpu_torch.solver import kernel as tk
from kueue_tpu_torch.solver.synth import synth_fair_edges, synth_fair_inputs
from tests.test_torch_kernels import assert_same, jax_topo, t, torch_topo

MAXSHARE = 2**62
NONE = 2**30
INT_MAX = 2**31 - 1
STRATS = ((True, True, False), (True, False, False), (False, False, False),
          (False, True, True))
STRAT_IDS = ("default", "s2a", "s2b", "reversed")
OUTPUTS = ("targets", "feasible", "reasons", "stats")

# --- the launch plan ---

# sf_layout: (elements, bytes each) of every array of a problem's arena
ARENA = (
    # int64: U, NOM, GUAR, BASE [QL][RF]; CU, CG, CSUB, CBL [CL][RF];
    # LEND, REQ, BL0, DEL, LMAG [RF]; SAVE [1 + DC][RF]; SH, WGT, FLR,
    # WMAG [QL]; CAND [K][RF] when staged
    lambda QL, RF, CL, DC, K, st: (4 * QL * RF, 8),
    lambda QL, RF, CL, DC, K, st: (4 * CL * RF, 8),
    lambda QL, RF, CL, DC, K, st: (5 * RF, 8),
    lambda QL, RF, CL, DC, K, st: ((1 + DC) * RF, 8),
    lambda QL, RF, CL, DC, K, st: (4 * QL, 8),
    lambda QL, RF, CL, DC, K, st: (K * RF if st else 0, 8),
    # int32: SLOTF, SLOTR, SAME, LSH [RF]; GQ [QL]; GC [CL]; CHAIN
    # [QL][DC]; START [QL + 1]; POS, ACT, FRETRY, CNT, ORD, WSH [QL];
    # TABLE, LOGK, LOGQ, CIDX, CQL [K]; CPRIO [K] when staged
    lambda QL, RF, CL, DC, K, st: (4 * RF + QL + CL + QL * DC, 4),
    lambda QL, RF, CL, DC, K, st: (QL + 1 + 6 * QL, 4),
    lambda QL, RF, CL, DC, K, st: (5 * K + (K if st else 0), 4),
    # bytes: FRS [RF]; FANY [QL]
    lambda QL, RF, CL, DC, K, st: (RF + QL, 1),
)

SHAPES = [
    (16, 8, 8, 1, 128),     # the fair cell's (B = 256)
    (16, 8, 32, 3, 128),    # chip_smoke's nested batch
    (4, 8, 8, 2, 32),
    (1, 8, 1, 1, 8),
    (64, 8, 8, 2, 512),     # past 32 local CQs
    (64, 32, 32, 3, 4096),  # past shared memory with the rows staged
    (16, 64, 4, 1, 128),    # past 32 slots
    (1024, 32, 64, 4, 8192),  # past shared memory altogether
]


def arena_model(QL, RF, CL, DC, K, stage) -> int:
    raw = sum(n * size for n, size in
              (f(QL, RF, CL, DC, K, stage) for f in ARENA))
    return -(-raw // 16) * 16


@pytest.mark.parametrize("stage", (True, False))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_fair_arena_bytes_match_layout_model(shape, stage):
    got = tk.fair_arena_bytes(*shape, stage)
    assert got == arena_model(*shape, stage)
    assert got % 16 == 0
    QL, RF, CL, DC, K = shape
    # staging adds the candidates' rows and priorities
    extra = tk.fair_arena_bytes(*shape, True) - \
        tk.fair_arena_bytes(*shape, False)
    assert abs(extra - (8 * K * RF + 4 * K)) < 16


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("smem", (None, 64 * 1024, 16 * 1024, 0))
def test_fair_form_choice(shape, smem):
    cap = tk.FAIR_SMEM if smem is None else smem
    want = "shared" if arena_model(*shape, True) <= cap else "global"
    assert tk.fair_form(*shape, smem=smem) == want


def test_fair_cell_plan_is_shared():
    """The fair cell's problems fit a block's shared memory whole: 19,136
    bytes a problem, so the card holds up to eleven a SM."""
    assert tk.fair_arena_bytes(16, 8, 8, 1, 128, True) == 19136
    assert tk.fair_form(16, 8, 8, 1, 128) == "shared"
    assert tk.fair_form(64, 32, 32, 3, 4096) == "global"
    assert tk.fair_form(1024, 32, 64, 4, 8192) == "global"


def test_fair_form_follows_smem_cap(monkeypatch):
    """FAIR_SMEM is read at each call, so a test can force each form."""
    shape = (16, 8, 32, 3, 128)
    assert tk.fair_form(*shape) == "shared"
    monkeypatch.setattr(tk, "FAIR_SMEM", arena_model(*shape, True))
    assert tk.fair_form(*shape) == "shared"
    monkeypatch.setattr(tk, "FAIR_SMEM", arena_model(*shape, True) - 1)
    assert tk.fair_form(*shape) == "global"
    monkeypatch.setattr(tk, "FAIR_SMEM", 0)
    assert tk.fair_form(*shape) == "global"


@pytest.mark.parametrize("B,form,per_sm,sms,grid", [
    (256, "shared", 11, 132, 256),   # a block a problem: every SM busy
    (1024, "shared", 8, 132, 1024),
    (0, "shared", 8, 132, 0),
    (16, "global", 8, 132, 16),      # persistent: at most what is resident
    (5000, "global", 2, 132, 264),
    (3, "global", 0, 132, 3),
])
def test_fair_grid(B, form, per_sm, sms, grid):
    assert tk.fair_grid(B, form, per_sm, sms) == grid


# --- the keyed pick ---

def jax_pick(sh, elig, order):
    """kueue_tpu/solver/fairpreempt.py:302 pick_cq."""
    sh, elig, order = (jnp.asarray(x) for x in (sh, elig, order))
    m = jnp.max(jnp.where(elig, sh, -MAXSHARE))
    tie = jnp.where(elig & (sh == m), order, 2**30)
    return int(jnp.argmin(tie)), bool(jnp.any(elig))


def lane_words(v):
    """An int64's (signed high word, unsigned low word)."""
    v = int(v)
    return v >> 32, v & 0xffffffff


def keyed_pick(sh, elig, order):
    """csrc/solve_fair.cu sf_pick_keyed over 32 lanes: lane l offers the
    CQs l, l + 32, ...: its largest eligible share (-2^62 if none); the
    warp's largest high word (__reduce_max_sync, signed), then the largest
    low word (unsigned) among the lanes that hold that high word; each
    lane's lowest (tie value, slot) at that share (cq_order where eligible
    at the share, SF_NONE where not, INT_MAX from a lane with no CQ); the
    smallest tie value (__reduce_min_sync), then the smallest slot among
    the lanes that hold it."""
    QL = len(sh)
    keys = []
    for lane in range(32):
        qs = range(lane, QL, 32)
        best = -MAXSHARE
        for q in qs:
            if elig[q] and sh[q] > best:
                best = int(sh[q])
        keys.append(best)
    hi = max(lane_words(k)[0] for k in keys)
    lo = max(lane_words(k)[1] for k in keys if lane_words(k)[0] == hi)
    m = (hi << 32) | lo
    ties = []
    for lane in range(32):
        tv, slot = INT_MAX, INT_MAX
        for q in range(lane, QL, 32):
            v = int(order[q]) if elig[q] and sh[q] == m else NONE
            if v < tv:
                tv, slot = v, q
        ties.append((tv, slot))
    mt = min(tv for tv, _ in ties)
    return min(slot for tv, slot in ties if tv == mt), bool(np.any(elig))


def seeded_pick_inputs(QL, seed):
    rng = np.random.default_rng(seed)
    high = int(rng.integers(-2, 3))
    values = np.array([(high << 32) + 5, (high << 32) + 7,
                       ((high + 1) << 32) + 5, (high << 32) + 0xffffffff,
                       MAXSHARE, -1, 0, 125, 125], np.int64)
    sh = values[rng.integers(0, len(values), size=QL)]
    kind = seed % 4
    elig = rng.uniform(size=QL) < (0.0 if kind == 0 else 0.6)
    order = rng.integers(0, 6, size=QL).astype(np.int64)
    if kind == 2:
        order[rng.uniform(size=QL) < 0.3] = NONE
    if kind == 3:  # past SF_NONE: the JAX rule lets a non-tie win
        order[rng.uniform(size=QL) < 0.3] = NONE + 3
    return sh, elig, order


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("QL", (1, 5, 16, 32, 33, 64, 100))
def test_keyed_pick_matches_jax_pick_cq(QL, seed):
    sh, elig, order = seeded_pick_inputs(QL, seed)
    assert keyed_pick(sh, elig, order) == jax_pick(sh, elig, order)


def test_keyed_pick_words():
    """The share's high word decides first (signed), then the low one
    (unsigned); at equal shares the lowest cq_order, then the lowest
    slot; slot 0 when nothing is eligible."""
    sh = np.array([(1 << 32) + 7, (2 << 32) + 1, (2 << 32) + 5,
                   (2 << 32) + 5, -(1 << 32)], np.int64)
    order = np.array([0, 0, 3, 1, 0], np.int64)
    assert keyed_pick(sh, np.ones(5, bool), order)[0] == 3
    order[2] = 1
    assert keyed_pick(sh, np.ones(5, bool), order)[0] == 2
    assert keyed_pick(sh, np.zeros(5, bool), order) == (0, False)
    only_negative = np.array([False] * 4 + [True])
    assert keyed_pick(sh, only_negative, order)[0] == 4


def one_pop_batch(seed):
    """synth_fair_edges' "ties" batch where the first pop removes and
    fits: every candidate under the threshold, the request one unit of
    one slot, every candidate row a few units."""
    topo, usage, cu, args = synth_fair_edges(
        "ties", num_problems=64, max_candidates=24, seed=seed,
        max_local_cqs=8, num_cqs=64, num_flavors=3, depth=1)
    args = [a.copy() for a in args]
    args[11][:] = True                     # threshold_active
    args[12][:] = MAXSHARE                 # threshold
    unit = max(1, int(topo["nominal"].mean() // 8))
    args[5][:] = np.where(args[5] > 0, 1, 0)       # requests
    args[9][1:] = np.maximum(args[9][1:], 4 * unit)  # candidate rows
    return topo, usage, cu, args


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_keyed_pick_matches_plain_first_pop(seed):
    """solve_fair_plain's one-pop problems removed the candidate of rank
    0 of the CQ the keyed pick takes on the initial shares: weight 0 is
    2^62, else base_other's value (lendable and weight 1000, nothing
    borrowed)."""
    topo, usage, cu, args = one_pop_batch(seed)
    targets, feasible, reasons, stats = (x.numpy() for x in tk.solve_fair(
        torch_topo(topo), t(usage), t(cu), *(t(a) for a in args),
        strat=STRATS[0]))
    gq, cql, count, order = args[0], args[8], args[15], args[16]
    base, weight = args[17], args[20]
    checked = 0
    for b in np.flatnonzero(feasible & (stats[:, 1] == 1)):
        sh = np.where(weight[b] == 0, MAXSHARE, base[b, :, 0])
        elig = (gq[b] >= 0) & (count[b] > 0)
        q, _ = keyed_pick(sh, elig, order[b])
        (k,) = np.flatnonzero(targets[b])
        assert cql[b, k] == q, b
        checked += 1
    assert checked >= 10


def test_tie_batches_tie():
    """The "ties" batches hold shares that tie on the high word and
    differ in the low one, and shares that tie outright."""
    _, _, _, args = synth_fair_edges("ties", seed=0, max_local_cqs=8,
                                     num_cqs=64, num_flavors=3)
    base = args[17][:, :, 0]
    hi, lo = base >> 32, base & 0xffffffff
    assert (hi[:, :1] == hi).all()
    assert any(len(set(r)) > 1 for r in lo.tolist())
    assert any(len(r) > len(set(r)) for r in lo.tolist())


# --- divisions by a multiplier ---

def magic(d):
    """csrc/solve_fair.cu sf_magic: (multiplier, shift), (0, 0) outside
    [1, 2^31)."""
    if d < 1 or d >= 2**31:
        return 0, 0
    ell = (d - 1).bit_length()
    return (1 << (31 + ell)) // d + 1, 31 + ell


def fdiv(n, d):
    """sf_fdiv: by the multiplier where n is in [-2^31, 2^31), else the
    floor division; the 64-bit products wrap as the card's."""
    m, sh = magic(d)
    if m and -2**31 <= n < 2**31:
        u = n if n >= 0 else ~n
        assert u * m < 2**64
        q = ((u * m) & (2**64 - 1)) >> sh
        return q if n >= 0 else ~q
    return n // d


@pytest.mark.parametrize("seed", range(6))
def test_multiplier_division_is_floor_division(seed):
    rng = np.random.default_rng(seed)
    ds = [1, 2, 3, 7, 1000, 3000, 2**31 - 1, 2**31, 2**40, 2**61] + \
        [int(x) for x in rng.integers(1, 2**31, size=40)] + \
        [int(x) for x in rng.integers(1, 2**16, size=40)]
    ns = [0, 1, -1, -1000, 999, 2**31 - 1, -2**31, 2**31, -2**31 - 1,
          2**63 - 1, -2**63] + \
        [int(x) for x in rng.integers(-2**31, 2**31, size=60)] + \
        [int(x) for x in rng.integers(-2**62, 2**62, size=20)]
    for d in ds:
        for n in ns:
            assert fdiv(n, d) == n // d, (n, d)


# --- solve_fair_plain against the JAX program on the edges ---

_SOLVE = {}


def jax_fair(topo, usage, cu, args, strat):
    fn = _SOLVE.get(strat)
    if fn is None:
        fn = _SOLVE[strat] = jax.jit(
            lambda tp, u, c, *a: jfp.solve_fair_impl(tp, u, c, *a,
                                                     strat=strat))
    return [np.asarray(x) for x in fn(jax_topo(topo), jnp.asarray(usage),
                                      jnp.asarray(cu),
                                      *(jnp.asarray(a) for a in args))]


def edge_batch(kind, seed):
    if kind == "ql64":
        return synth_fair_inputs(24, 40, max_local_cqs=40, depth=2,
                                 num_cqs=256, num_leaf_cohorts=4, fanout=2,
                                 num_flavors=3, seed=seed)
    return synth_fair_edges(kind, seed=seed, max_local_cqs=8, num_cqs=64,
                            num_flavors=3, depth=2)


@pytest.mark.parametrize("strat", STRATS, ids=STRAT_IDS)
@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("kind", ("ties", "limits", "ql64"))
def test_solve_fair_plain_matches_jax_on_edges(kind, seed, strat):
    topo, usage, cu, args = edge_batch(kind, seed)
    if kind == "ql64":
        assert args[0].shape[1] > 32
    ref = jax_fair(topo, usage, cu, args, strat)
    got = [x.numpy() for x in tk.solve_fair(
        torch_topo(topo), t(usage), t(cu), *(t(a) for a in args),
        strat=strat)]
    for name, a, b in zip(OUTPUTS, got, ref):
        assert_same(a, b, name)
    assert got[1].any()


# --- K8: pack_plain at the edge shapes ---

@pytest.mark.parametrize("W,P,R", [(1, 1, 1), (31, 3, 1), (33, 3, 3),
                                   (2047, 4, 2), (2049, 1, 5), (64, 4, 2),
                                   (100, 2, 2)])
def test_pack_plain_matches_jax_at_edge_shapes(W, P, R):
    """pack_plain, which the card test of K8 holds the kernel to, against
    the JAX pack_decisions_impl at W not a multiple of 8 or 32 and odd
    P * R."""
    rng = np.random.default_rng(W * 7 + P)
    dense = {
        "chosen": rng.integers(-1, 40, size=(W, P, R)).astype(np.int32),
        "chosen_borrow": rng.uniform(size=(W, P, R)) < 0.3,
        "fit": rng.uniform(size=W) < 0.6,
        "admitted": rng.uniform(size=W) < 0.4,
        "borrows": rng.uniform(size=W) < 0.2,
    }
    names = ("chosen", "chosen_borrow", "fit", "admitted", "borrows")
    plain = tk.pack_plain(*(t(dense[k]) for k in names))
    ref = jk.pack_decisions_impl({k: jnp.asarray(v) for k, v in dense.items()})
    np.testing.assert_array_equal(plain[0].numpy(), np.asarray(ref["dec_pr"]))
    np.testing.assert_array_equal(plain[1].numpy(), np.asarray(ref["dec_bits"]))
