"""The arena twin's index rules against the JAX package's.

`scatter_arena_rows_impl` (kueue_tpu/solver/kernel.py) writes with
`.at[upd_slots].set(..., mode="drop")`: a slot in [-cap, 0) writes row
cap + slot, a slot in [0, cap) its row, any other slot is dropped.
`gather_arena_impl` marks every slot >= 0 valid and reads row
min(slot, cap - 1); a slot < 0 gives zeros / False. The port's plain
versions (what `scatter_arena_rows` and `gather_arena` run for CPU
tensors) must give the same arrays on every slot class, exactly.
Production pads the scatter with `cap` and the gather with -1; the other
classes are the reference's answers all the same. Two slots that reach
one row after wrapping are left out: XLA leaves their order unspecified.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kueue_tpu.solver import kernel as jk  # enables jax x64 before any array
from kueue_tpu_torch.solver import kernel as tk

CAP, P, F, R = 8, 2, 3, 2
SEEDS = (0, 1, 2)


def twin(seed, S=CAP):
    rng = np.random.default_rng(seed)
    return {
        "requests": rng.integers(1, 9000, size=(S, P, R)).astype(np.int64),
        "podset_active": rng.uniform(size=(S, P)) < 0.6,
        "wl_cq": rng.integers(1, 24, size=S).astype(np.int32),
        "priority": rng.integers(-3, 4, size=S).astype(np.int64),
        "timestamp": rng.uniform(1, 100, size=S),
        "eligible": rng.uniform(size=(S, P, F)) < 0.5,
        "solvable": rng.uniform(size=S) < 0.8,
    }


def same(got: torch.Tensor, want, name: str) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.array_equal(got, want), name


def scatter_both(seed: int, upd_slots: np.ndarray) -> None:
    arena = twin(seed)
    rows = twin(seed + 50, S=len(upd_slots))
    want = jk.scatter_arena_rows_impl(
        {k: jnp.asarray(v) for k, v in arena.items()},
        jnp.asarray(upd_slots), {k: jnp.asarray(v) for k, v in rows.items()})
    got = {k: torch.from_numpy(v.copy()) for k, v in arena.items()}
    tk.scatter_arena_rows(got, torch.from_numpy(upd_slots),
                          {k: torch.from_numpy(v) for k, v in rows.items()})
    for name in tk.ARENA_FIELDS:
        same(got[name], want[name], name)


# each class beside two in-range slots whose rows it does not reach
SCATTER_CLASSES = {"minus_1": -1, "minus_cap": -CAP, "minus_cap_1": -CAP - 1,
                   "minus_2cap": -2 * CAP, "cap": CAP, "cap_5": CAP + 5}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("label", tuple(SCATTER_CLASSES))
def test_scatter_slot_class_matches_jax(label, seed):
    slot = SCATTER_CLASSES[label]
    scatter_both(seed, np.array([slot, 3, 5], np.int32))
    scatter_both(seed, np.array([2, slot, 4], np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_scatter_mixed_batch_matches_jax(seed):
    """Distinct targets, each written as its row or its row - cap, among
    slots that are dropped on both sides."""
    rng = np.random.default_rng(seed + 7)
    targets = rng.choice(CAP, size=6, replace=False)
    slots = np.where(rng.uniform(size=6) < 0.5, targets, targets - CAP)
    drops = np.array([CAP, CAP + 5, -CAP - 1, -2 * CAP, 2**31 - 1,
                      -2**31], np.int64)
    batch = np.concatenate([slots, drops])[rng.permutation(12)]
    assert (batch < 0).any() and (batch >= CAP).any()
    scatter_both(seed, batch.astype(np.int32))


def test_scatter_known_batches_match_jax():
    """The batches on which the earlier port and JAX differed, and one on
    which they agreed."""
    for slots in ([-1, 3, 8], [0, -2, 8], [-9, -8, 2], [-1, -8, -9],
                  [-16, 1, 100]):
        scatter_both(0, np.array(slots, np.int32))


def gather_both(seed: int, slots: np.ndarray) -> tuple:
    arena = twin(seed)
    want = jk.gather_arena_impl({k: jnp.asarray(v) for k, v in arena.items()},
                                jnp.asarray(slots))
    got = tk.gather_arena({k: torch.from_numpy(v) for k, v in arena.items()},
                          torch.from_numpy(slots))
    for name, a, b in zip(tk.ARENA_FIELDS, got, want):
        same(a, b, name)
    return got


GATHER_CLASSES = {"cap": CAP, "cap_5": CAP + 5, "int32_max": 2**31 - 1,
                  "minus_1": -1, "minus_cap_1": -CAP - 1}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("label", tuple(GATHER_CLASSES))
def test_gather_slot_class_matches_jax(label, seed):
    slot = GATHER_CLASSES[label]
    got = gather_both(seed, np.array([slot, 2, slot, 0], np.int32))
    arena = twin(seed)
    if slot >= 0:  # clamped to the last row, valid
        assert np.array_equal(got[0][0].numpy(), arena["requests"][CAP - 1])
        assert bool(got[6][0]) == bool(arena["solvable"][CAP - 1])
    else:
        assert not got[0][0].any() and not got[6][0]


@pytest.mark.parametrize("seed", SEEDS)
def test_gather_mixed_batch_matches_jax(seed):
    rng = np.random.default_rng(seed + 11)
    slots = rng.integers(-2 * CAP, 2 * CAP, size=40).astype(np.int32)
    slots[:5] = tuple(GATHER_CLASSES.values())
    gather_both(seed, slots)
