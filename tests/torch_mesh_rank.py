"""One gloo rank of the port's mesh, for tests/test_torch_mesh.py.

    python tests/torch_mesh_rank.py STORE WORLD RANK LAYOUT CASE_DIR

Joins a process group of WORLD ranks on the FileStore STORE (no address,
no port), builds the mesh of LAYOUT ("flat": make_mesh; "hosts":
make_host_mesh with two hosts) on the CPU, and runs every case
CASE_DIR/<name>.in.npz through the sharded cycle (dense and compact) or
the sharded preemption solve, writing CASE_DIR/<name>.<LAYOUT><WORLD>.
r<RANK>.npz. Imports no JAX.
"""

import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from kueue_tpu_torch.parallel import mesh as tmesh  # noqa: E402

WL_KEYS = ("requests", "podset_active", "wl_cq", "priority", "timestamp",
           "eligible", "solvable")


def run_case(mesh, case: dict) -> dict:
    t = {k: torch.from_numpy(np.array(v)) for k, v in case.items()}
    topo = {k[5:]: v for k, v in t.items() if k.startswith("topo/")}
    state = (t["usage"], t["cohort_usage"])
    if "pargs/0" in t:
        pargs = tuple(t[f"pargs/{i}"] for i in range(15))
        got = tmesh.solve_preempt_sharded(mesh, topo, *state, pargs)
        return dict(zip(("targets", "feasible", "stats"), got))
    kw = dict(num_podsets=int(case["num_podsets"]),
              fair_sharing=bool(case["fair_sharing"]),
              start_rank=t.get("start_rank"),
              cluster_args=(tuple(t[f"cargs/{i}"] for i in range(4))
                            if "cargs/0" in t else None))
    out = {}
    for compact in (False, True):
        res = tmesh.solve_cycle_sharded(mesh, topo, *state,
                                        *(t[k] for k in WL_KEYS),
                                        compact=compact, **kw)
        out.update({f"{'compact' if compact else 'dense'}/{k}": v
                    for k, v in res.items()})
    plan = tmesh.plan_cycle(mesh, topo, t["wl_cq"])
    out["plan/columns"] = torch.from_numpy(plan.columns)
    return out


def main(store: str, world: int, rank: int, layout: str,
         case_dir: str) -> None:
    torch.set_num_threads(1)
    tmesh.init_distributed(f"file://{store}", world, rank, device="cpu")
    mesh = tmesh.make_mesh(device="cpu") if layout == "flat" \
        else tmesh.make_host_mesh(device="cpu", hosts=2)
    for path in sorted(Path(case_dir).glob("*.in.npz")):
        name = path.name[:-len(".in.npz")]
        before = mesh.collectives
        with np.load(path) as case:
            out = run_case(mesh, dict(case))
        np.savez(Path(case_dir) / f"{name}.{layout}{world}.r{rank}.npz",
                 **{k: v.numpy() for k, v in out.items()},
                 collectives=np.int64(mesh.collectives - before))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
