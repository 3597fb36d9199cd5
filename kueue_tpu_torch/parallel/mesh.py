"""The sharded admission cycle over a torch.distributed mesh.

The port of kueue_tpu/parallel/mesh.py (K13: `solve_cycle_sharded`,
`_build_sharded`). Conflict domains (root cohorts, and a domain of its
own for each CQ with no cohort) never contend for the same quota, so
they are the SPMD axis. Every rank calls the same functions with the
same host inputs (the JAX package's single controller becomes identical
replicated host code on each rank); a rank's body is:

1. `avail` over every CQ (replicated);
2. `phase_a` on the rank's workload slice [r*w_local, (r+1)*w_local) of
   the batch padded to n*w_local rows, w_local = ceil(W/n);
3. one all-gather of the slice's decisions and assignments (as bytes:
   NCCL has no bool), cut back to W rows;
4. `drf_share` with fair sharing, and `order_csr` (replicated: both are
   deterministic, so every rank gets the same order);
5. `phase_b` over the rank's planner columns only (parallel/domains.py
   plan_domains, cost-balanced over the occupied domains);
6. the combine: `combine_pack` of the admitted mask and the usage
   deltas into one buffer, one all-reduce (two on a two-axis mesh,
   staged "cohorts" then "hosts", as the JAX package's hier_psum), and
   `combine_unpack`;
7. `score_cluster_columns` with cluster columns (replicated).

`solve_preempt_sharded` runs the minimal-preemption solve (K9) over the
planner's problem axis: each rank solves its slots straight from the
full arguments, writing each problem's outputs at its own row of
zero-initialised outputs, and one all-reduce of their bytes rebuilds
the whole result (each row has exactly one writer).

A `Mesh` holds the process group, the rank, the world size, the axis
names and the device. NCCL runs on the card and gloo on the CPU (the
tests); a collective on a tensor of the other kind raises. The card's
machine has one GPU, and NCCL runs no two ranks on one GPU, so there
the mesh has world size 1; more ranks need more cards.

Left out: the JAX package compiles one executable per mesh layout and
program variant and caches it (`_SHARDED_CACHE`, `mesh_fingerprint`).
Nothing here is compiled per shape, so there is no such cache; the warm
governor, which reads them, is not ported yet.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from kueue_tpu_torch.device import resolve
from kueue_tpu_torch.parallel.domains import (DomainPlan, plan_domains,
                                              plan_problems)
from kueue_tpu_torch.solver import kernel

# the backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _backend(device: torch.device) -> str:
    if device.type not in BACKENDS:
        raise ValueError(f"no collective backend for device {device}")
    return BACKENDS[device.type]


def _device(device) -> torch.device:
    """`device` resolved (None: the card, raising without one), a CUDA
    device pinned to its index."""
    device = resolve(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """A group of ranks that run the sharded cycle together. `group` is
    the process group of all its ranks, in flattened mesh order (rank
    r is mesh position r); `axis_groups` maps each axis name to the
    group this rank reduces over along it."""

    def __init__(self, group, device, axis_names=("cohorts",), shape=None,
                 axis_groups=None, store_dir=None):
        self.group = group
        self.device = torch.device(device)
        backend = dist.get_backend(group)
        if backend != _backend(self.device):
            raise ValueError(f"a {backend} group cannot run collectives on "
                             f"{self.device} tensors")
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape) if shape is not None else (self.size,)
        self.axis_groups = axis_groups or {self.axis_names[0]: group}
        self.collectives = 0  # collective calls made, for the phase counts
        self._store_dir = store_dir  # the world-size-1 group this mesh made

    def _check(self, t: torch.Tensor) -> None:
        if t.device.type != self.device.type:
            raise ValueError(f"mesh on {self.device}: a collective on a "
                             f"{t.device} tensor")

    def all_gather_rows(self, parts, n_rows: int) -> tuple:
        """One all-gather of the rows of `parts` (tensors with the same
        leading dimension, any dtype): they travel side by side as the
        bytes of one [rows, row_bytes] uint8 tensor. Returns each part
        gathered over the ranks in mesh order and cut to n_rows rows."""
        local = parts[0].shape[0]
        flat = [p.reshape(local, -1).view(torch.uint8) for p in parts]
        rows = torch.cat(flat, dim=1)
        self._check(rows)
        out = torch.empty((self.size * local, rows.shape[1]),
                          dtype=torch.uint8, device=rows.device)
        dist.all_gather_into_tensor(out, rows, group=self.group)
        self.collectives += 1
        got, off = [], 0
        for p, f in zip(parts, flat):
            width = f.shape[1]
            piece = out[:n_rows, off:off + width].contiguous()
            got.append(piece.view(p.dtype).reshape(n_rows, *p.shape[1:]))
            off += width
        return tuple(got)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum of `t` over every rank of the mesh: over the
        minor axis, then the major one on a two-axis mesh (the JAX
        package's hier_psum)."""
        self._check(t)
        for name in reversed(self.axis_names):
            dist.all_reduce(t, group=self.axis_groups[name])
            self.collectives += 1
        return t

    def close(self) -> None:
        """Destroy the world-size-1 process group this mesh started, if
        it started one."""
        if self._store_dir is not None:
            if dist.is_initialized():
                dist.destroy_process_group()
            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None


def _init_single(backend: str) -> str:
    """A process group of world size 1 on a FileStore in a fresh temp
    directory (no address, no port). Returns the directory."""
    store_dir = tempfile.mkdtemp(prefix="kueue-mesh-")
    store = dist.FileStore(os.path.join(store_dir, "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return store_dir


def make_mesh(device=None, group=None, axis_name: str = "cohorts") -> Mesh:
    """A one-axis mesh over `group` (default: the world). device=None is
    the card with NCCL (raises without one); device="cpu" is gloo. With
    no process group yet, starts one of world size 1."""
    device = _device(device)
    backend = _backend(device)
    store_dir = None
    if group is None:
        if not dist.is_initialized():
            store_dir = _init_single(backend)
        group = dist.group.WORLD
    return Mesh(group, device, (axis_name,), store_dir=store_dir)


def make_host_mesh(device=None, hosts: int = None) -> Mesh:
    """The two-axis ("hosts", "cohorts") mesh over the world
    (kueue_tpu/parallel/mesh.py:87-104): the major axis groups the ranks
    by host, the minor one is the ranks of a host. hosts=None: the world
    size over torchrun's LOCAL_WORLD_SIZE where that is set, else one
    host. With no process group yet, starts one of world size 1."""
    from torch.distributed.device_mesh import init_device_mesh
    device = _device(device)
    store_dir = None
    if not dist.is_initialized():
        store_dir = _init_single(_backend(device))
    n = dist.get_world_size()
    if hosts is None:
        local = os.environ.get("LOCAL_WORLD_SIZE")
        hosts = n // int(local) if local else 1
    if hosts < 1 or n % hosts != 0:
        raise ValueError(f"{n} ranks do not fold into {hosts} hosts")
    names = ("hosts", "cohorts")
    dm = init_device_mesh(device.type, (hosts, n // hosts),
                          mesh_dim_names=names)
    return Mesh(dist.group.WORLD, device, names, (hosts, n // hosts),
                {name: dm.get_group(name) for name in names},
                store_dir=store_dir)


def init_distributed(coordinator: str = None, num_processes: int = None,
                     process_id: int = None, device=None) -> bool:
    """Start the default process group for a multi-process mesh
    (kueue_tpu/parallel/mesh.py:107-125): from the arguments, else from
    torch's standard environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK). `coordinator` is an init_method URL (tcp://host:port or
    file://path). Returns False, and starts nothing, when neither names
    a coordinator."""
    if coordinator is None:
        addr = os.environ.get("MASTER_ADDR")
        if addr is None:
            return False
        coordinator = f"tcp://{addr}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    dist.init_process_group(_backend(_device(device)), init_method=coordinator,
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def plan_cycle(mesh: Mesh, topo, wl_cq) -> DomainPlan:
    """The cycle's domain -> rank plan (parallel/domains.py) on the FULL
    padded batch's wl_cq: padding rows occupy domain slots in the JAX
    package's plan, so leaving them out would change the columns and the
    fingerprint. `topo` is the host Topology or a dict of its arrays (a
    dict of tensors is read back from the device)."""
    get = topo.get if isinstance(topo, dict) else (lambda k: getattr(topo, k))
    return plan_domains(_host(wl_cq), _host(get("cq_cohort")),
                        _host(get("cohort_root")), _host(get("offered")),
                        mesh.size)


def solve_cycle_sharded(mesh: Mesh, topo: dict, usage, cohort_usage,
                        requests, podset_active, wl_cq, priority, timestamp,
                        eligible, solvable, num_podsets: int,
                        fair_sharing: bool = False, start_rank=None,
                        compact: bool = True, cluster_args=None,
                        plan: DomainPlan = None) -> dict:
    """The fused cycle SPMD over the mesh (kueue_tpu/parallel/mesh.py:166
    solve_cycle_sharded). Every rank calls it with the same inputs (topo a
    dict of tensors, the rest tensors on mesh.device) and gets the same
    result, which is what kernel.solve_cycle_fused returns (compact or
    dense, with mk_cluster under cluster_args). `plan` defaults to
    plan_cycle on the batch."""
    n, r = mesh.size, mesh.rank
    W = requests.shape[0]
    C = topo["cohort_subtree"].shape[0]
    D = C + topo["cq_cohort"].shape[0]
    if plan is None:
        plan = plan_cycle(mesh, topo, wl_cq)
    if plan.n_devices != n:
        raise ValueError(f"a plan for {plan.n_devices} ranks on a mesh of {n}")
    # padding columns (-1) -> the sentinel D, a no-op lane of phase_b
    cols = np.where(plan.columns[r] >= 0, plan.columns[r], D)
    cols = torch.from_numpy(cols.astype(np.int32)).to(mesh.device)

    avail_q = kernel.avail(topo, usage, cohort_usage)
    w_local = -(-W // n)
    w_pad = w_local * n

    def wslice(a):
        if w_pad != W:
            a = torch.cat([a, a.new_zeros((w_pad - W,) + tuple(a.shape[1:]))])
        return a[r * w_local:(r + 1) * w_local]

    local = kernel.phase_a(
        topo, avail_q, usage, wslice(requests), wslice(podset_active),
        wslice(wl_cq), wslice(eligible), wslice(solvable), num_podsets,
        None if start_rank is None else wslice(start_rank))
    fit, borrows, chosen, chosen_borrow, asg_usage = \
        mesh.all_gather_rows(local, W)
    share = kernel.drf_share(topo, usage, asg_usage, wl_cq) \
        if fair_sharing else None
    offsets, members, order = kernel.order_csr(
        topo, fit, borrows, priority, timestamp, wl_cq, share,
        with_order=cluster_args is not None)
    admitted, usage_out, cohort_out = kernel.phase_b(
        topo, usage, cohort_usage, asg_usage, fit, wl_cq, offsets, members,
        cols)
    buf = kernel.combine_pack(admitted, usage, usage_out, cohort_usage,
                              cohort_out)
    mesh.all_reduce(buf)
    admitted, usage_out, cohort_out = kernel.combine_unpack(
        buf, usage, cohort_usage)
    out = {"usage": usage_out, "cohort_usage": cohort_out}
    if cluster_args is not None:
        out["mk_cluster"] = kernel.score_cluster_columns(
            *cluster_args, requests, podset_active, wl_cq, order, admitted)
    if compact:
        out["dec_pr"], out["dec_bits"] = kernel.pack(
            chosen, chosen_borrow, fit, admitted, borrows)
    else:
        out.update(admitted=admitted, chosen=chosen, borrows=borrows,
                   chosen_borrow=chosen_borrow, fit=fit)
    return out


def preempt_weights(cand_idx) -> np.ndarray:
    """Each problem's planner weight: its candidates (cand_idx >= 0) plus
    one (kueue_tpu/parallel/mesh.py:206-212)."""
    return np.count_nonzero(_host(cand_idx) >= 0, axis=1) + 1


def solve_preempt_sharded(mesh: Mesh, topo: dict, usage, cohort_usage,
                          preempt_args: tuple, weights=None) -> tuple:
    """K9 over the planner's problem axis (kueue_tpu/parallel/mesh.py:
    206-217, 335-364): `weights` (default preempt_weights) place the
    problems on the ranks; each rank solves its b_local slots from the
    full arguments, and one all-reduce of the outputs' bytes rebuilds
    them in the original problem order. Returns what kernel.solve_preempt
    returns: (targets[B,K], feasible[B], stats[B,4])."""
    B, K = preempt_args[7].shape
    if weights is None:
        weights = preempt_weights(preempt_args[7])
    perm, _inv, b_local = plan_problems(weights, mesh.size)
    # pad lanes hold B: no problem
    mine = perm[mesh.rank * b_local:(mesh.rank + 1) * b_local]
    slots = torch.from_numpy(mine.astype(np.int32)).to(mesh.device)
    targets, feasible, stats = kernel.solve_preempt(
        topo, usage, cohort_usage, *preempt_args, slots=slots)
    # every row has one writer and zeros elsewhere, so the byte-wise sum
    # of the three outputs side by side is each row's own bytes
    buf = torch.cat([stats.reshape(-1).view(torch.uint8),
                     targets.reshape(-1).view(torch.uint8),
                     feasible.view(torch.uint8)])
    mesh.all_reduce(buf)
    n_stats = stats.numel() * stats.element_size()
    return (buf[n_stats:n_stats + B * K].view(torch.bool).reshape(B, K),
            buf[n_stats + B * K:].view(torch.bool),
            buf[:n_stats].view(torch.int32).reshape(B, 4))


def per_device_scan_width(num_cqs: int, num_cohorts: int, n_dev: int,
                          plan: DomainPlan = None) -> tuple:
    """(replicated width, per-rank width) of one Phase B scan: with a
    plan, the planner's bucketed column count (occupied domains only);
    without one, the all-domains estimate."""
    D = num_cqs + num_cohorts
    if plan is not None:
        return D, plan.d_cols
    return D, -(-D // n_dev)
