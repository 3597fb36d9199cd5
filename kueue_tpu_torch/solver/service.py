"""BatchSolver: the fit-mode admission solve from a snapshot to decisions.

The port of kueue_tpu/solver/service.py's unbound path
(`BatchSolver().solve(snapshot, entries)`): encode the cycle, upload it,
run the fused cycle (kernel.solve_cycle_fused) on the solver's device,
fetch only the packed decisions, unpack and decode them into the
scheduler's Assignment form, including the LastTriedFlavorIdx resume
state.

Left out of this slice (the JAX package has them): the adaptive CPU/device
router (`_route`), the dispatch supervisor and watchdog, fault injection,
the flight recorder, the encode arena, device-resident state with its
usage journal, preemption, fair sharing, MultiKueue cluster columns, and
the multi-chip mesh.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from kueue_tpu_torch import features
from kueue_tpu_torch.api.corev1 import RESOURCE_PODS
from kueue_tpu_torch.cache.snapshot import Snapshot
from kueue_tpu_torch.core import workload as wlpkg
from kueue_tpu_torch.core.resources import FlavorResource
from kueue_tpu_torch.device import resolve
from kueue_tpu_torch.scheduler import flavorassigner as fa
from kueue_tpu_torch.solver import encode
from kueue_tpu_torch.solver.kernel import (
    DECISION_KEYS,
    MAX_COMPACT_FLAVORS,
    solve_cycle_fused,
    topo_to_device,
)

# the dense decision keys the compact wire format replaces
DENSE_DECISION_KEYS = ("admitted", "fit", "chosen", "borrows",
                       "chosen_borrow")

# the phases of one solve, timed per cycle (seconds) in last_phase_s
PHASES = ("encode", "upload", "device", "fetch", "decode")


def unpack_decisions(fetched: dict, num_podsets: int,
                     num_resources: int) -> dict:
    """Host-side inverse of kernel.pack: the compact wire format back to
    the dense decision arrays (kueue_tpu/solver/service.py:66). Dicts
    without the packed keys pass through."""
    if "dec_pr" not in fetched:
        return fetched
    pr = np.asarray(fetched["dec_pr"])
    bits = np.asarray(fetched["dec_bits"])
    W = pr.shape[0]
    planes = np.unpackbits(bits, axis=1,
                           bitorder="little")[:, :W].astype(bool)
    out = {k: v for k, v in fetched.items() if k not in DECISION_KEYS}
    out["fit"], out["admitted"], out["borrows"] = planes
    chosen = (pr & 0x7F).astype(np.int32) - 1
    out["chosen"] = chosen.reshape(W, num_podsets, num_resources)
    out["chosen_borrow"] = (pr >> 7).astype(bool).reshape(
        W, num_podsets, num_resources)
    return out


class Plan:
    """One cycle's encoded inputs."""

    def __init__(self, topo, topo_dev, state, batch, start_rank):
        self.topo = topo
        self.topo_dev = topo_dev
        self.state = state
        self.batch = batch
        self.start_rank = start_rank


class BatchSolver:
    def __init__(self, max_podsets: int = 4, device=None):
        """device=None means the card (raises without one); the tests
        pass device="cpu", which runs the kernels' plain versions.
        Workloads are ordered by the default wlpkg.Ordering."""
        self.max_podsets = max_podsets
        self.device = resolve(device)
        self._topo_cache = None
        self._topo_key = None
        self.counters = {"dispatches": 0, "collects": 0, "upload_bytes": 0,
                         "fetch_bytes": 0}
        self.last_phase_s = dict.fromkeys(PHASES, 0.0)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _topology(self, snapshot: Snapshot):
        # keyed on topology_epoch: it bumps on every spec change that
        # alters the encoded tensors, never on workload churn
        key = snapshot.topology_epoch
        if key != self._topo_key or self._topo_cache is None:
            topo = encode.encode_topology(snapshot)
            self._topo_cache = (topo, topo_to_device(topo, self.device))
            self._topo_key = key
        return self._topo_cache

    def prepare(self, snapshot: Snapshot, entries: list) -> Optional[Plan]:
        """Encode the cycle; None when nothing is solvable."""
        if not entries:
            return None
        t0 = time.perf_counter()
        topo, topo_dev = self._topology(snapshot)
        state = encode.encode_state(snapshot, topo)
        batch = encode.encode_workloads(entries, snapshot, topo,
                                        max_podsets=self.max_podsets)
        self.last_phase_s["encode"] = time.perf_counter() - t0
        if not batch.solvable.any():
            return None
        start_rank = batch.start_rank if batch.start_rank.any() else None
        return Plan(topo, topo_dev, state, batch, start_rank)

    def dispatch(self, plan: Plan) -> tuple:
        """Upload the state and the batch, run the fused cycle. Returns
        (device outputs, keys to fetch)."""
        t0 = time.perf_counter()
        topo, batch, state = plan.topo, plan.batch, plan.state
        host = [state.usage, state.cohort_usage, batch.requests,
                batch.podset_active, batch.wl_cq, batch.priority,
                batch.timestamp, batch.eligible, batch.solvable]
        if plan.start_rank is not None:
            host.append(plan.start_rank)
        dev = [torch.from_numpy(a).to(self.device, non_blocking=True)
               for a in host]
        start_rank = dev[9] if plan.start_rank is not None else None
        self._sync()
        t1 = time.perf_counter()
        compact = topo.nominal.shape[1] <= MAX_COMPACT_FLAVORS
        result = solve_cycle_fused(
            plan.topo_dev, *dev[:9], num_podsets=self.max_podsets,
            start_rank=start_rank, compact=compact)
        self._sync()
        self.last_phase_s["upload"] = t1 - t0
        self.last_phase_s["device"] = time.perf_counter() - t1
        self.counters["dispatches"] += 1
        self.counters["upload_bytes"] += sum(a.nbytes for a in host)
        keys = DECISION_KEYS if compact else DENSE_DECISION_KEYS
        return result, keys

    def collect(self, plan: Plan, result: dict, keys, snapshot: Snapshot):
        """Fetch the decisions only, unpack and decode them."""
        t0 = time.perf_counter()
        fetched = {k: result[k].cpu().numpy() for k in keys}
        self.counters["fetch_bytes"] += sum(v.nbytes for v in fetched.values())
        self.counters["collects"] += 1
        fetched = unpack_decisions(fetched, self.max_podsets,
                                   plan.topo.nominal.shape[2])
        t1 = time.perf_counter()
        decisions = self._decode_batch(plan.batch.infos, snapshot, plan.topo,
                                       plan.batch, fetched)
        self.last_phase_s["fetch"] = t1 - t0
        self.last_phase_s["decode"] = time.perf_counter() - t1
        return decisions

    def solve(self, snapshot: Snapshot, entries: list) -> dict:
        """entries: list of workload Info. Returns {entry index ->
        (fa.Assignment, admitted)} for every entry the solver could fully
        assign (fit mode); admitted=False means the assignment no longer
        fit after intra-cycle accounting (reference: scheduler.go:266-273)."""
        self.last_phase_s = dict.fromkeys(PHASES, 0.0)
        plan = self.prepare(snapshot, entries)
        if plan is None:
            return {}
        result, keys = self.dispatch(plan)
        return self.collect(plan, result, keys, snapshot)

    def _decode_batch(self, entries: list, snapshot: Snapshot,
                      topo: encode.Topology, batch, fetched: dict) -> dict:
        """Decisions into the scheduler's Assignment form, with the
        LastTriedFlavorIdx resume state exactly as the CPU assigner
        stores it (reference: flavorassigner.go:289-324): the rank where
        the search ended, -1 when the list was exhausted (chosen == last
        flavor, or a TryNextFlavor CQ settling for a borrowing fit after
        scanning the whole list)."""
        n = batch.n
        fit = np.asarray(fetched["fit"])[:n]
        idx = np.flatnonzero(fit)
        if idx.size == 0:
            return {}
        admitted = np.asarray(fetched["admitted"])[:n][idx]     # [M]
        chosen = np.asarray(fetched["chosen"])[:n][idx]          # [M,P,R]
        borrows = np.asarray(fetched["borrows"])[:n][idx]        # [M]
        chosen_borrow = np.asarray(fetched["chosen_borrow"])[:n][idx]
        qi_arr = batch.wl_cq[idx]                                 # [M]

        # With FlavorFungibility off the CPU assigner never writes the
        # tried index (stays at the dataclass default 0).
        fungibility_on = features.enabled(features.FLAVOR_FUNGIBILITY)
        fi_safe = np.maximum(chosen, 0)
        rank = topo.flavor_rank[qi_arr[:, None, None], fi_safe]   # [M,P,R]
        gi = topo.group_id[qi_arr]                                # [M,R]
        gsize = topo.group_size[qi_arr[:, None], np.maximum(gi, 0)]  # [M,R]
        exhausted = rank == gsize[:, None, :] - 1
        prefer_nb = topo.prefer_no_borrow[qi_arr]                 # [M]
        # TryNextFlavor CQs scanned the whole list looking for a no-borrow
        # fit before settling for this borrowing one.
        exhausted |= prefer_nb[:, None, None] & chosen_borrow
        if fungibility_on:
            tried = np.where(exhausted | (chosen < 0), -1, rank)
        else:
            tried = np.zeros_like(rank)

        fname_l = np.asarray(topo.flavors, dtype=object)[fi_safe].tolist()
        tried_l = tried.tolist()
        chosen_neg = (chosen < 0).tolist()
        borrows_l = borrows.tolist()
        admitted_l = admitted.tolist()
        resource_index = topo.resource_index

        # last_state generations per CQ, read fresh per cycle: the cohort
        # generation is the cache's capacity version, which moves on
        # events that never rebuild the topology.
        gen_cache: dict = {}
        out = {}
        for row, wi in enumerate(idx.tolist()):
            info = entries[wi]
            gens = gen_cache.get(info.cluster_queue)
            if gens is None:
                cq = snapshot.cluster_queues[info.cluster_queue]
                gens = (cq.allocatable_resource_generation,
                        cq.cohort.allocatable_resource_generation
                        if cq.cohort else 0)
                gen_cache[info.cluster_queue] = gens
            assignment = fa.Assignment(borrowing=bool(borrows_l[row]))
            assignment.last_state = wlpkg.AssignmentClusterQueueState(
                cluster_queue_generation=gens[0], cohort_generation=gens[1])
            covers_pods = topo.covers_pods[batch.wl_cq[wi]]
            usage = assignment.usage
            for pi, psr in enumerate(info.total_requests):
                reqs = dict(psr.requests)
                if covers_pods:
                    reqs[RESOURCE_PODS] = psr.count
                fname_p = fname_l[row][pi]
                neg_p = chosen_neg[row][pi]
                tried_p = tried_l[row][pi]
                flavors = {}
                flavor_idx = {}
                for r, v in reqs.items():
                    ri = resource_index[r]
                    if v > 0 and neg_p[ri]:
                        raise AssertionError(
                            "solver admitted workload without flavor")
                    fname = fname_p[ri]
                    t = tried_p[ri]
                    flavors[r] = fa.FlavorAssignment(name=fname, mode=fa.FIT,
                                                     tried_flavor_idx=t)
                    flavor_idx[r] = t
                    fr = FlavorResource(fname, r)
                    usage[fr] = usage.get(fr, 0) + v
                assignment.pod_sets.append(fa.PodSetAssignmentResult(
                    name=psr.name, flavors=flavors, requests=reqs,
                    count=psr.count))
                assignment.last_state.last_tried_flavor_idx.append(flavor_idx)
            out[wi] = (assignment, bool(admitted_l[row]))
        return out
