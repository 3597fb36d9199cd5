"""Smoke run of kueue_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Builds the solver's CUDA kernels from kueue_tpu_torch/solver/csrc, holds
each one against its plain PyTorch version on the card at the north-star
shape (2048 ClusterQueues, 256 cohorts, 32 flavors, 2 resources, 2048
heads, 4 podsets) and on a nested-cohort input (depth 3, 3 active
podsets), and times both. Then it drives the port's main path end to
end: a 2048-CQ cluster with 51,200 pending workloads in the port's
Cache, one warm-up and ten timed admission cycles through
BatchSolver(device="cuda"), each checked against the same solve on the
CPU with the plain versions, admissions applied between cycles.

Every phase raises on failure; nothing is caught. The last lines are
the card's name and power limit, one JSON line with the kernels'
numbers, and {"ok": true, "device": {...}}. Without a CUDA device, or
without the kueue_tpu_torch package beside this file, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)

NORTH_STAR = dict(num_cqs=2048, num_cohorts=256, num_flavors=32,
                  num_resources=2, num_workloads=2048, num_podsets=4)
NESTED = dict(num_cqs=2048, num_leaf_cohorts=256, fanout=4, depth=3,
              num_flavors=32, num_resources=2, num_workloads=2048,
              num_podsets=3, no_cohort_every=16)
E2E_WAVES = 25          # 25 x 2048 = 51,200 pending workloads
E2E_WARMUP = 1
E2E_TIMED = 10
NOMINAL_UNITS = 40      # per flavor and CQ; workloads are one flavor's size

REPLACES = {
    "avail": "kueue_tpu/solver/kernel.py:50",
    "phase_a": "kueue_tpu/solver/kernel.py:221",
    "phase_b": "kueue_tpu/solver/kernel.py:420",
    "pack": "kueue_tpu/solver/kernel.py:372",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def percentile(values: list, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=float), q))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def time_cuda(fn, iters: int, warmup: int = 3) -> float:
    """Milliseconds per call: CUDA events around `iters` calls after a
    warm-up, then a synchronize."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(event, self_only: bool = False) -> float:
    """Device microseconds of a profiler key_averages() row."""
    prefix = "self_" if self_only else ""
    value = getattr(event, f"{prefix}device_time_total", None)
    return value if value is not None else getattr(event, f"{prefix}cuda_time_total")


class GcClock:
    """Wall time spent in the cyclic garbage collector (gc.callbacks)."""

    def __init__(self):
        self.total = 0.0
        self._start = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.total += time.perf_counter() - self._start
            self._start = None


def profiled_device_ms(fn, iters: int, kernel_name: str):
    """Mean device time of the CUDA kernel `kernel_name` per call, from a
    torch.profiler trace of `iters` calls; None when the trace holds no
    device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(device_us(e) for e in prof.key_averages()
                if e.key.startswith(kernel_name))
    return total / iters / 1e3 if total else None


def compare(names, got, want) -> float:
    """Largest element difference between a kernel's outputs and its
    plain version's; raises when any element differs."""
    import torch
    worst = 0
    for name, a, b in zip(names, got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: {a.shape}/{a.dtype} vs "
                                 f"{b.shape}/{b.dtype}")
        diff = (a.to(torch.int64) - b.to(torch.int64)).abs().max().item() \
            if a.numel() else 0
        if diff:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version by up to {diff}")
        worst = max(worst, diff)
    return float(worst)


def phase_a_bytes(topo, wl, num_podsets: int, start_rank, outs) -> int:
    """Bytes phase_a must move on these inputs: per head, its request,
    flags and eligibility rows; of the [Q,F,R] inputs (nominal, offered,
    avail, usage) only the elements of the heads' CQs in a flavor of the
    requested resource's group; of the per-CQ rows only the heads' CQs;
    every output once."""
    import torch
    q = wl["wl_cq"].long()
    req = wl["requests"][:, :num_podsets]                    # [W,NP,R]
    gid = topo["group_id"][q]                                 # [W,R]
    rel = (((req > 0) & (gid[:, None, :] >= 0))[:, :, None, :]
           & (topo["flavor_group"][q][:, None, :, None]
              == gid[:, None, None, :]))                      # [W,NP,F,R]
    touched = torch.zeros(topo["nominal"].shape, dtype=torch.int32,
                          device=q.device)
    touched.index_add_(0, q, rel.any(1).to(torch.int32))
    F, R = topo["nominal"].shape[1:]
    moved = int((touched > 0).sum()) * (8 + 1 + 8 + 8)
    moved += int(torch.unique(q).numel()) * (R * 4 + 2 * F * 4 + 1)
    moved += int(rel.any(3).sum())                            # eligible
    moved += nbytes(req, wl["podset_active"], wl["wl_cq"], wl["solvable"],
                    *outs)
    if start_rank is not None:
        moved += nbytes(start_rank[:, :num_podsets])
    return moved


def phase_b_bytes(topo, usage, cohort_usage, asg, fit, wl_cq, offsets,
                  members, outs) -> int:
    """Bytes phase_b must move on these inputs: the CSR and per-head
    flags; the assignment rows of fitting heads; the CQ quota and usage
    elements those rows touch, and the cohort elements up their chains;
    the usage and cohort-usage elements that change, written once; the
    admitted flags."""
    import torch
    admitted, usage_out, cohort_out = outs
    w = torch.nonzero(fit).flatten()
    q = wl_cq[w].long()
    touched = torch.zeros(usage.shape, dtype=torch.int32, device=fit.device)
    touched.index_add_(0, q, (asg[w] != 0).to(torch.int32))
    touched = touched > 0
    has_cohort = topo["cq_cohort"] >= 0
    chain = topo["cq_chain"].long()
    up = torch.zeros(cohort_usage.shape, dtype=torch.int32, device=fit.device)
    for d in range(chain.shape[1]):
        on = has_cohort & (chain[:, d] >= 0)
        up.index_add_(0, chain[on, d], touched[on].to(torch.int32))
    qs = torch.unique(q)
    FR = usage[0].numel()
    moved = int(touched.sum()) * 8 * 4      # nominal, guaranteed, limit, usage
    moved += int((up > 0).sum()) * 8 * 4    # subtree, guaranteed, limit, usage
    moved += int((usage_out != usage).sum() + (cohort_out != cohort_usage)
                 .sum()) * 8
    moved += int(qs.numel()) * 4 + int(has_cohort[qs].sum()) * chain.shape[1] * 4
    moved += int(w.numel()) * FR * 8
    return moved + nbytes(fit, wl_cq, offsets, members, admitted)


def kernel_inputs(kind: str, device):
    import numpy as np
    import torch
    from kueue_tpu_torch.solver import kernel, synth
    if kind == "north_star":
        topo, usage, cu, wl = synth.synth_solver_inputs(seed=42, **NORTH_STAR)
        start_rank = None
    else:
        topo, usage, cu, wl = synth.synth_nested_inputs(seed=7, **NESTED)
        rng = np.random.default_rng(7)
        W, P, R = wl["requests"].shape
        wl["podset_active"][:] = True
        wl["requests"] = rng.integers(1, 20, size=(W, P, R)).astype(np.int64) * 1000
        start_rank = synth.synth_start_rank(wl, NESTED["num_flavors"], seed=7)
    wl_d = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in wl.items()}
    usage_d, cu_d = kernel.state_to_device(usage, cu, device)
    sr = None if start_rank is None else torch.from_numpy(start_rank).to(device)
    return kernel.topo_to_device(topo, device), usage_d, cu_d, wl_d, sr


def kernel_phase(kind: str, device, results: dict) -> None:
    """Each kernel against its plain version on the same inputs on the
    card, and both timed."""
    from kueue_tpu_torch.solver import kernel as k
    topo, usage, cu, wl, sr = kernel_inputs(kind, device)
    W, P, R = wl["requests"].shape
    F = wl["eligible"].shape[2]
    rows = {}

    v_args = (topo, usage, cu)
    ref_avail = k.avail_plain(*v_args)
    rows["avail"] = (
        compare(("avail",), (k.avail(*v_args),), (ref_avail,)),
        lambda: k.avail(*v_args), lambda: k.avail_plain(*v_args),
        nbytes(topo["cq_cohort"], topo["cq_chain"], topo["nominal"],
               topo["guaranteed"], topo["borrow_limit"], usage,
               topo["cohort_subtree"], topo["cohort_guaranteed"],
               topo["cohort_borrow_limit"], cu, ref_avail))

    a_args = (topo, ref_avail, usage, wl["requests"], wl["podset_active"],
              wl["wl_cq"], wl["eligible"], wl["solvable"], P, sr)
    ref_a = k.phase_a_plain(*a_args)
    rows["phase_a"] = (
        compare(("fit", "borrows", "chosen", "chosen_borrow", "asg_usage"),
                k.phase_a(*a_args), ref_a),
        lambda: k.phase_a(*a_args), lambda: k.phase_a_plain(*a_args),
        phase_a_bytes(topo, wl, P, sr, ref_a))

    fit, borrows, chosen, chosen_borrow, asg = ref_a
    order = k.admit_order(fit, borrows, wl["priority"], wl["timestamp"])
    offsets, members = k.domain_csr(topo, wl["wl_cq"], order)
    b_args = (topo, usage, cu, asg, fit, wl["wl_cq"], offsets, members)
    ref_b = k.phase_b_plain(*b_args)
    steps = int((offsets[1:] - offsets[:-1]).max().item())
    rows["phase_b"] = (
        compare(("admitted", "usage", "cohort_usage"), k.phase_b(*b_args),
                ref_b),
        lambda: k.phase_b(*b_args), lambda: k.phase_b_plain(*b_args),
        phase_b_bytes(topo, usage, cu, asg, fit, wl["wl_cq"], offsets,
                      members, ref_b))

    p_args = (chosen, chosen_borrow, fit, ref_b[0], borrows)
    ref_p = k.pack_plain(*p_args)
    rows["pack"] = (
        compare(("dec_pr", "dec_bits"), k.pack(*p_args), ref_p),
        lambda: k.pack(*p_args), lambda: k.pack_plain(*p_args),
        nbytes(*p_args, *ref_p))

    log(f"[kernels:{kind}] W={W} P={P} F={F} R={R} "
        f"Q={usage.shape[0]} C={cu.shape[0]} DC={topo['cq_chain'].shape[1]} "
        f"fit={int(fit.sum())} admitted={int(ref_b[0].sum())} "
        f"phase_b dependent steps={steps}")
    for name, (err, run_kernel, run_plain, moved) in rows.items():
        # call_ms: back-to-back wrapper calls between CUDA events, bounded
        # by the host's enqueue rate; ms: the kernel's own device time
        # from a profiler trace (call_ms when the trace shows none)
        call_ms = time_cuda(run_kernel, iters=50)
        plain_ms = time_cuda(run_plain, iters=10 if name == "phase_b" else 50)
        kernel_ms = profiled_device_ms(run_kernel, 50, f"{name}_kernel")
        ms, source = (kernel_ms, "profiler") if kernel_ms is not None \
            else (call_ms, "events")
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        log(f"[kernels:{kind}] {name}: equal to plain (max_abs_err {err}) "
            f"ms={ms:.5f} ({source}) call_ms={call_ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
            f"({moved} bytes / 3.35 TB/s)"
            + (f"; latency-bound: {steps} dependent steps"
               if name == "phase_b" else ""))
        results.setdefault(kind, {})[name] = {
            "max_abs_err": err, "ms": ms, "ms_source": source,
            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bytes": moved,
            **({"dependent_steps": steps} if name == "phase_b" else {})}


def normalize(decisions: dict) -> dict:
    out = {}
    for i, (a, admitted) in decisions.items():
        out[i] = (admitted, a.borrowing,
                  [sorted((r, fl.name, fl.tried_flavor_idx)
                          for r, fl in ps.flavors.items())
                   for ps in a.pod_sets],
                  a.last_state.last_tried_flavor_idx)
    return out


def e2e_phase(device) -> dict:
    """The main path: cache snapshot -> BatchSolver(device) -> admissions,
    with every cycle's decisions held against the CPU plain path."""
    from kueue_tpu_torch.sim import northstar as ns
    from kueue_tpu_torch.solver import BatchSolver, kernel
    num_cqs, num_cohorts = NORTH_STAR["num_cqs"], NORTH_STAR["num_cohorts"]
    flavors = [f"f{i}" for i in range(NORTH_STAR["num_flavors"])]
    t0 = time.perf_counter()
    cache = ns.build_cluster(num_cqs, num_cohorts, flavors, NOMINAL_UNITS)
    heaps = ns.PendingHeaps()
    staged = ns.stage_waves(heaps, E2E_WAVES, num_cqs, NOMINAL_UNITS)
    log(f"[e2e] cluster: {num_cqs} CQs, {num_cohorts} cohorts, "
        f"{len(flavors)} flavors x {NOMINAL_UNITS} units; {staged} pending "
        f"staged in {time.perf_counter() - t0:.1f} s")
    solver = BatchSolver(device=device)
    reference = BatchSolver(device="cpu")
    phases = {p: [] for p in ("snapshot", "encode", "upload", "device",
                              "fetch", "decode", "admit", "gc", "cycle")}
    admitted_timed = 0
    gc_clock = GcClock()
    gc.callbacks.append(gc_clock)

    def run_cycle(cycle: int) -> tuple:
        """One main-path cycle; returns (admitted, cycle seconds,
        snapshot s, admit s, gc s). The CPU reference solve runs between
        the solve and the admissions and is not part of the cycle; a full
        collection after it, also untimed, takes the reference's garbage
        (a second encode and decode of every head) out of the timed
        phases."""
        heads = heaps.heads()
        g0, t0 = gc_clock.total, time.perf_counter()
        snapshot = cache.snapshot()
        t1 = time.perf_counter()
        decisions = solver.solve(snapshot, heads)
        g2, t2 = gc_clock.total, time.perf_counter()
        expected = reference.solve(snapshot, heads)
        if normalize(decisions) != normalize(expected):
            raise AssertionError(f"cycle {cycle}: CUDA decisions differ "
                                 "from the CPU plain path")
        del expected
        gc.collect()
        g3, t3 = gc_clock.total, time.perf_counter()
        n = ns.apply_decisions(cache, heaps, heads, decisions, 1000.0 + cycle)
        g4, t4 = gc_clock.total, time.perf_counter()
        cycle_s, gc_s = (t2 - t0) + (t4 - t3), (g2 - g0) + (g4 - g3)
        depth = sorted({ps.flavors["cpu"].name for a, ok in decisions.values()
                        if ok for ps in a.pod_sets})
        log(f"[e2e] cycle {cycle}{' (warm-up)' if cycle < E2E_WARMUP else ''}:"
            f" heads={len(heads)} admitted={n} flavors={depth} "
            f"pending={len(heaps)} cycle_ms={cycle_s * 1e3:.1f} snapshot_ms="
            f"{(t1 - t0) * 1e3:.1f} admit_ms={(t4 - t3) * 1e3:.1f} gc_ms="
            f"{gc_s * 1e3:.1f} untimed_gc_ms={(g3 - g2) * 1e3:.1f} solve_ms="
            + json.dumps({k: round(v * 1e3, 3) for k, v in
                          solver.last_phase_s.items()}))
        return n, cycle_s, t1 - t0, t4 - t3, gc_s

    kernel.reset_launch_counts()
    for cycle in range(E2E_WARMUP + E2E_TIMED):
        n, cycle_s, snap_s, admit_s, gc_s = run_cycle(cycle)
        if cycle < E2E_WARMUP:
            continue
        admitted_timed += n
        phases["snapshot"].append(snap_s)
        for k, v in solver.last_phase_s.items():
            phases[k].append(v)
        phases["admit"].append(admit_s)
        phases["gc"].append(gc_s)
        phases["cycle"].append(cycle_s)
    launches = kernel.launch_counts()
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    summary = {k: {"p50_ms": percentile(v, 50) * 1e3,
                   "p99_ms": percentile(v, 99) * 1e3}
               for k, v in phases.items()}
    summary["admitted_per_s"] = admitted_timed / sum(phases["cycle"])
    summary["admitted_timed"] = admitted_timed
    summary["launches"] = launches
    summary["counters"] = solver.counters
    summary["traced_cycle"] = traced_cycle(run_cycle, E2E_WARMUP + E2E_TIMED)
    gc.callbacks.remove(gc_clock)
    log("[e2e] " + json.dumps(summary))
    return summary


def traced_cycle(run_cycle, cycle: int) -> dict:
    """One more main-path cycle under torch.profiler (after the timed
    ones, outside the launch count): device busy time by kernel and the
    card's idle share of the cycle's wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, cycle_s, _, _, _ = run_cycle(cycle)
    # device-side rows only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched
    rows = sorted(((e.key, device_us(e, self_only=True))
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")),
                  key=lambda r: -r[1])
    busy_us = sum(us for _, us in rows)
    out = {"wall_ms": cycle_s * 1e3, "device_busy_ms": busy_us / 1e3,
           "idle_share": 1.0 - busy_us / 1e3 / (cycle_s * 1e3),
           "top_device_ms": {k[:60]: us / 1e3 for k, us in rows[:12] if us}}
    log("[trace] " + json.dumps(out))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "kueue_tpu_torch" / "solver" / "csrc").is_dir():
        print("chip_smoke: kueue_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    from kueue_tpu_torch.solver import _build

    device = torch.device("cuda")
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"capability {cap} count {torch.cuda.device_count()}; {smi}")
    if cap != (9, 0):
        raise AssertionError(f"expected an sm_90 device, got capability {cap}")

    seconds = _build.build_all()
    log(f"[build] {len(_build.KERNELS)} kernels built in {seconds:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name in _build.KERNELS:
        for line in _build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    results: dict = {}
    for kind in ("north_star", "nested"):
        kernel_phase(kind, device, results)
    e2e = e2e_phase(device)

    kernels = []
    for name in _build.KERNELS:
        row = results["north_star"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"kueue_tpu_torch/solver/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": e2e["launches"][name],
            "max_abs_err": max(results[k][name]["max_abs_err"]
                               for k in results),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": "bytes",
            "bound_bytes": row["bytes"], "library_ms": None,
            "ms_source": row["ms_source"], "call_ms": row["call_ms"],
            "nested": {k: v for k, v in results["nested"][name].items()
                       if k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                "dependent_steps")},
            # phase_b's real limit is its serial chain, which a byte or
            # operation count does not capture
            **({"latency_bound": f"{row['dependent_steps']} dependent steps",
                "dependent_steps": row["dependent_steps"]}
               if name == "phase_b" else {})})
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
