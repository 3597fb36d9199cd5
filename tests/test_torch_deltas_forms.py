"""The delta prologue (K6) and the DRF share (K3) on the shapes their
card forms split on, held to the JAX package on the CPU.

The delta kernel preloads a cohort coord's old usage unless the
topology's chain table `cohort_multilevel` says the cohort can sit at two
levels of one tuple; the tuples here put one cohort coord at levels 0
and 1 (CQs attached at two depths) and reach D = 8192 (2049 coords), and
the plain version and the encode are held to apply_state_deltas_impl and
the JAX encode_deltas there. The chain tables are held to a walk of the
tuples themselves, and drf_share's plain version to _drf_share on
topologies carrying the derived cq_root table. The plans' arithmetic and
a model of the kernel's floor division close the file.
tests/test_torch_cuda.py holds the kernels to these plain versions on
the card.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_tpu.solver import kernel as jk  # enables jax x64 before any array
from kueue_tpu.core.resources import FlavorResource as JaxFR
from kueue_tpu.solver import encode as jenc
from kueue_tpu_torch.core.resources import FlavorResource as TorchFR
from kueue_tpu_torch.solver import encode as tenc
from kueue_tpu_torch.solver import kernel as tk
from kueue_tpu_torch.solver.synth import (shared_level_coords,
                                          synth_deltas, synth_nested_inputs,
                                          synth_share_inputs)


def mixed_tree(num_cqs=128, num_flavors=16, depth=3, seed=0):
    """Cohort trees `depth` deep with every 3rd CQ attached to its leaf
    cohort's parent: a node shared by CQs at two depths."""
    topo, usage, cu, _ = synth_nested_inputs(
        num_cqs=num_cqs, num_leaf_cohorts=16, fanout=2, depth=depth,
        num_flavors=num_flavors, num_resources=2, num_workloads=8,
        no_cohort_every=11, attach_up_every=3, seed=seed)
    return topo, usage, cu


def coords_of(deltas):
    dq, df, dr, dv = deltas[:4]
    real = dq >= 0
    return [(int(q), int(f), int(r), int(v))
            for q, f, r, v in zip(dq[real], df[real], dr[real], dv[real])]


def both_encodes(topo, coords):
    """The port's and the JAX package's encode of the same corrections,
    asserted equal."""
    Q, F, R = topo["guaranteed"].shape
    ns_topo = SimpleNamespace(
        cq_index={f"cq{i}": i for i in range(Q)},
        flavor_index={f"f{i}": i for i in range(F)},
        resource_index={f"r{i}": i for i in range(R)},
        cq_chain=topo["cq_chain"], cohort_parent=topo["cohort_parent"])
    port = tenc.encode_deltas({(f"cq{q}", TorchFR(f"f{f}", f"r{r}")): v
                               for q, f, r, v in coords}, ns_topo)
    ref = jenc.encode_deltas({(f"cq{q}", JaxFR(f"f{f}", f"r{r}")): v
                              for q, f, r, v in coords}, ns_topo)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype
    return port


def levels_of(lvl_c):
    """{(c, f, r): the levels of the tuple it sits at}."""
    at = {}
    for lvl in range(lvl_c.shape[0]):
        for c, f, r in lvl_c[lvl][lvl_c[lvl, :, 0] >= 0].tolist():
            at.setdefault((c, f, r), []).append(lvl)
    return at


def apply_both(topo, usage, cu, deltas):
    ref = jk.apply_state_deltas_impl(
        {k: jnp.asarray(topo[k]) for k in jk.TOPO_FIELDS}, jnp.asarray(usage),
        jnp.asarray(cu), *(jnp.asarray(a) for a in deltas))
    got_u, got_c = torch.from_numpy(usage.copy()), torch.from_numpy(cu.copy())
    tk.apply_state_deltas(tk.topo_to_device(topo, "cpu"), got_u, got_c,
                          *(torch.from_numpy(a) for a in deltas))
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref[1]))
    return got_u.numpy(), got_c.numpy()


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("num_coords", (40, 200))
def test_mixed_depth_tuple_matches_jax(num_coords, seed):
    """One cohort coord at levels 0 and 1 of the tuple: the JAX program
    reads its old usage at level 1 after level 0's add."""
    topo, usage, cu = mixed_tree(seed=seed)
    coords = coords_of(synth_deltas(topo, usage, num_coords, seed=seed,
                                    level_pairs=4))
    deltas = both_encodes(topo, coords)
    at = levels_of(deltas[4])
    assert any(lv[:2] == [0, 1] for lv in at.values())
    assert shared_level_coords(deltas[4]) > 0
    new_u, new_c = apply_both(topo, usage, cu, deltas)
    assert not np.array_equal(new_c, cu)


@pytest.mark.parametrize("num_coords,D", ((2049, 8192), (4000, 8192)))
def test_deltas_past_2048_coords_match_jax(num_coords, D):
    """D above 2048 (the card kernel's old limit): 2049 coords bucket to
    D = 8192, on the mixed-depth tree."""
    topo, usage, cu = mixed_tree(num_cqs=128, num_flavors=16)
    coords = coords_of(synth_deltas(topo, usage, num_coords, seed=3,
                                    level_pairs=8))
    deltas = both_encodes(topo, coords)
    assert deltas[0].shape[0] == D and (deltas[0] >= 0).sum() == num_coords
    assert shared_level_coords(deltas[4]) > 0
    apply_both(topo, usage, cu, deltas)


@pytest.mark.parametrize("depth", (1, 2, 3, 5))
def test_cohort_multilevel_covers_every_tuple(depth):
    """The chain table the kernel preloads by: every cohort that sits at
    two levels of a tuple built from the topology is marked, and with no
    CQ attached up the table marks nothing."""
    for attach in (0, 3):
        topo, usage, _, _ = synth_nested_inputs(
            num_cqs=96, num_leaf_cohorts=16, fanout=2, depth=depth,
            num_flavors=4, num_resources=2, num_workloads=8,
            no_cohort_every=7, attach_up_every=attach, seed=depth)
        tables = tk.chain_tables(topo["cq_cohort"], topo["cohort_root"],
                                 topo["cohort_parent"], topo["cq_chain"])
        marked = set(np.flatnonzero(tables["cohort_multilevel"]).tolist())
        shared = set()
        for seed in range(4):
            d = synth_deltas(topo, usage, 300, seed=seed)
            shared |= {c for (c, _, _), lv in levels_of(d[4]).items()
                       if len(lv) > 1}
        assert shared <= marked
        if attach == 0 or depth == 1:
            assert not marked
        # a cohort's levels are its positions in cq_chain
        pos = {}
        for j in range(topo["cq_chain"].shape[1]):
            for c in topo["cq_chain"][:, j][topo["cq_chain"][:, j] >= 0]:
                pos.setdefault(int(c), set()).add(j)
        assert marked == {c for c, p in pos.items() if len(p) > 1}
        want_root = np.array([topo["cohort_root"][c] if c >= 0 else -1
                              for c in topo["cq_cohort"]], np.int32)
        np.testing.assert_array_equal(tables["cq_root"], want_root)
        on_device = tk.topo_to_device(topo, "cpu")
        assert set(tk.CHAIN_FIELDS) <= set(on_device)
        assert on_device["cohort_multilevel"].dtype == torch.bool


@pytest.mark.parametrize("D,L,form", (
    (8, 1, "register"), (512, 1, "register"), (512, 3, "register"),
    (512, 0, "register"), (1024, 4, "register"), (512, 5, "shared"),
    (2048, 1, "shared"), (8192, 3, "shared"), (32768, 3, "global")))
def test_deltas_plan(D, L, form):
    plan = tk.deltas_plan(D, L)
    assert plan["form"] == form
    if form == "register":
        assert plan["threads"] % 32 == 0 and plan["threads"] >= D
        assert plan["levels"] in tk.DELTAS_REGISTER_LEVELS
        assert plan["levels"] >= L
    elif form == "shared":
        assert plan["smem"] == 16 * D <= tk.DELTAS_SMEM
    else:
        assert plan["scratch_bytes"] == 16 * D > tk.DELTAS_SMEM


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("F", (1, 33))
@pytest.mark.parametrize("R", (1, 3, 17))
def test_drf_share_with_chain_table_matches_jax(R, F, seed):
    """The plain version with topo_to_device's cq_root table present (the
    kernel reads it, the plain version the base arrays) against
    _drf_share: weights 0/500/1000/3000, a root lending nothing, another
    lending in every other resource."""
    topo, usage, asg, wl_cq = synth_share_inputs(F, R, seed=seed)
    tt = tk.topo_to_device(topo, "cpu")
    assert "cq_root" in tt
    got = tk.drf_share(tt, *(torch.from_numpy(a) for a in (usage, asg,
                                                           wl_cq)))
    ref = jk._drf_share({k: jnp.asarray(topo[k]) for k in jk.TOPO_FIELDS},
                        jnp.asarray(usage), jnp.asarray(asg),
                        jnp.asarray(wl_cq))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got == tk.NO_LIMIT).any() and (got < 0).any()
    assert (got > 0).any() and (got == 0).any()


@pytest.mark.parametrize("scale", (2**33, 2**45))
def test_drf_share_int64_extremes_match_jax(scale):
    """Borrowing x 1000 past 2^53 (the kernel's int64 division path) and
    past int64 (both wrap alike)."""
    topo, usage, asg, wl_cq = synth_share_inputs(32, 2, scale=scale,
                                                 seed=1)
    got = tk.drf_share(tk.topo_to_device(topo, "cpu"),
                       *(torch.from_numpy(a) for a in (usage, asg, wl_cq)))
    ref = jk._drf_share({k: jnp.asarray(topo[k]) for k in jk.TOPO_FIELDS},
                        jnp.asarray(usage), jnp.asarray(asg),
                        jnp.asarray(wl_cq))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("F,R,G,form,passes", (
    (1, 1, 1, "lanes", 1), (1, 2, 2, "lanes", 1), (1, 3, 4, "lanes", 1),
    (32, 1, 8, "lanes", 4), (33, 1, 16, "lanes", 3),
    (32, 2, 16, "lanes", 4), (33, 2, 32, "lanes", 3),
    (1, 17, 32, "lanes", 1), (32, 17, 32, "lanes", 32),
    (32, 32, 32, "lanes", 32), (2, 40, 32, "wide", 2)))
def test_drf_share_plan(F, R, G, form, passes):
    """The fewest lanes a head that hold a resource each and load the row
    in one chunk of DRF_CHUNK passes, at most 32."""
    plan = tk.drf_share_plan(F, R)
    assert (plan["lanes_per_head"], plan["form"], plan["passes"]) == \
        (G, form, passes)
    assert plan["heads_per_warp"] * G == 32 or form == "wide"
    if form == "lanes":  # every element is some lane's, in `passes`
        m = R * (G // R)
        assert m >= 1 and passes * m >= F * R > (passes - 1) * m
        assert passes <= tk.DRF_CHUNK or G == 32
        assert G == 1 or G // 2 < R or -(-F * R // (R * (G // 2 // R))) \
            > tk.DRF_CHUNK


def floordiv_model(a: int, b: int) -> int:
    """csrc/drf_share.cu kq_floordiv_pos: below 2^53 the correctly
    rounded double quotient, floored, then one multiply-back."""
    if -2**53 < a < 2**53 and b < 2**53:
        q = int(np.floor(np.float64(a) / np.float64(b)))
        return q - 1 if q * b > a else q
    return a // b


def test_floordiv_model_is_exact():
    """The quotient floors to the exact one or one above it: values next
    to 2^53, quotients next to integers, negatives and large divisors."""
    rng = np.random.default_rng(0)
    edge = [2**53 - 1, 2**53 - 2, -(2**53 - 1), 2**52 + 1, 10**15 + 7,
            -1000, -1, 0, 1, 999, 1000, 3 * 10**15]
    divisors = [1, 2, 3, 7, 500, 1000, 3000, 2**26 + 1, 2**52 - 1,
                2**53 - 1, 10**15 + 3]
    for a in edge:
        for b in divisors:
            for x in (a, a - 1, a + 1, b * (a // b), b * (a // b) - 1):
                assert floordiv_model(x, b) == x // b, (x, b)
    for _ in range(20000):
        b = int(rng.integers(1, 2**int(rng.integers(1, 53))))
        q = int(rng.integers(-2**20, 2**20))
        for a in (q * b, q * b - 1, q * b + 1):
            if -2**53 < a < 2**53:
                assert floordiv_model(a, b) == a // b, (a, b)
