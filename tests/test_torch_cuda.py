"""The CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips on a machine without a CUDA
device. The file imports no JAX, so that it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from kueue_tpu_torch.sim import northstar as ns
from kueue_tpu_torch.solver import BatchSolver
from kueue_tpu_torch.solver import kernel as tk
from kueue_tpu_torch.solver.synth import (synth_nested_inputs,
                                          synth_solver_inputs,
                                          synth_start_rank)

WL_KEYS = ("requests", "podset_active", "wl_cq", "priority", "timestamp",
           "eligible", "solvable")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def inputs(kind: str):
    if kind == "flat":
        topo, usage, cu, wl = synth_solver_inputs(
            num_cqs=64, num_cohorts=8, num_flavors=40, num_resources=3,
            num_workloads=96, num_podsets=3, seed=3)
    else:
        topo, usage, cu, wl = synth_nested_inputs(
            num_cqs=64, num_leaf_cohorts=8, fanout=2, depth=3,
            num_flavors=40, num_resources=3, num_workloads=96, num_podsets=3,
            no_cohort_every=5, seed=3)
    return topo, usage + topo["nominal"] // 3, cu, wl


@pytest.mark.cuda
@pytest.mark.parametrize("compact", (True, False))
@pytest.mark.parametrize("kind", ("flat", "nested"))
def test_fused_cycle_on_card_equals_plain(kind, compact, cuda_device):
    """F=40 puts more than one flavor on a lane; R=3 and P=3 widen the
    per-podset loops."""
    topo, usage, cu, wl = inputs(kind)
    start_rank = torch.from_numpy(synth_start_rank(wl, 40, seed=3))
    host = [tk.topo_to_device(topo, "cpu"),
            *tk.state_to_device(usage, cu, "cpu"),
            *(torch.from_numpy(np.array(wl[k])) for k in WL_KEYS)]
    card = [{k: v.to(cuda_device) for k, v in host[0].items()}] + \
        [t.to(cuda_device) for t in host[1:]]
    want = tk.solve_cycle_fused(*host, num_podsets=3, max_rank=0,
                                start_rank=start_rank, compact=compact)
    before = tk.launch_counts()
    got = tk.solve_cycle_fused(*card, num_podsets=3, max_rank=0,
                               start_rank=start_rank.to(cuda_device),
                               compact=compact)
    torch.cuda.synchronize()
    after = tk.launch_counts()
    launched = ("avail", "phase_a", "phase_b") + (("pack",) if compact else ())
    assert all(after[k] == before[k] + 1 for k in launched)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
def test_batch_solver_on_card_equals_cpu(cuda_device):
    flavors = [f"f{i}" for i in range(6)]
    cache = ns.build_cluster(48, 6, flavors, 40)
    heaps = ns.PendingHeaps()
    ns.stage_waves(heaps, 4, 48, 40)
    on_card, on_cpu = BatchSolver(device=cuda_device), BatchSolver(device="cpu")
    for cycle in range(3):
        heads = heaps.heads()
        snapshot = cache.snapshot()
        got = on_card.solve(snapshot, heads)
        want = on_cpu.solve(snapshot, heads)
        assert {i: (a.pod_sets, ok) for i, (a, ok) in got.items()} == \
            {i: (a.pod_sets, ok) for i, (a, ok) in want.items()}
        assert ns.apply_decisions(cache, heaps, heads, got, float(cycle)) == 48
