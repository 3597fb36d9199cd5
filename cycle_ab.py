"""Same-call cycle timings on one CUDA card, each comparison run in the
order A, B, B, A so that a drift of the host cancels:

- bound fill and bound churn (chip_smoke.e2e_phase at 1 + BOUND_TIMED
  cycles, the solver driven without a Scheduler) on an earlier checkout
  of the repo (`--parent DIR`, unpacked with `git archive`) against
  this one, each run in a process of its own;
- the port's Scheduler bound to the card on the north star's fill and
  trickle (chip_smoke.FaultsRun, no injector) with its default watchdog
  (supervised dispatch, the collect deadline polled on a CUDA event)
  against `watchdog = None` (the dispatch on the caller's thread, an
  event wait), in one process;
- the same Scheduler pipelined (depth 1) against synchronous, both with
  the default watchdog, on the same traffic run until settled
  (chip_smoke.PipelineRun, its trickle's finishes fixed by name), in one
  process: each run's fill and trickle step p50, the p50 of its device
  collects' launch span read from the CUDA events recorded around the
  launches (the same measure on both arms), the router's p50, and the
  admitted set, which must be the same;
- the same synchronous Scheduler with the observability plane attached
  as the JAX package's manager wires it ("observed":
  chip_smoke.attach_observers: metrics, journeys, the aging watch, the
  query plane; the flight recorder on), as it is made ("default": the
  flight recorder on, no other observer) and with none of it ("bare":
  the recorder disabled; each hook one is-None compare), on the fill
  and trickle steps, in one process, in the order observed, default,
  bare, bare, default, observed: each arm's fill and trickle step p50
  and the admitted records, which must be the same.

Prints one JSON line a run and, last, a JSON summary of the p50s; the
children's logs and the summary go to chiprun_out/cycle_ab/.

    python3 cycle_ab.py                        # the Scheduler pairs
    python3 cycle_ab.py --parent _archive/parent
    python3 cycle_ab.py --pairs obs            # the observer arms alone
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "cycle_ab"
E2E_PHASES = ("bound_fill", "bound_churn")
E2E_KEYS = ("cycle", "snapshot", "heads", "encode", "upload", "device",
            "fetch", "decode", "admit", "gc")
TIMED = 5
TAG = "CYCLE_AB "
DEVICE = "cuda"


def child_e2e() -> dict:
    import chip_smoke as cs
    import torch
    cs.BOUND_TIMED = TIMED
    out = {}
    for phase in E2E_PHASES:
        s = cs.e2e_phase(torch.device(DEVICE), phase)
        out[phase] = {k: s[k]["p50_ms"] for k in E2E_KEYS}
        out[phase]["cycle_max"] = s["cycle"]["max_ms"]
        out[phase]["admitted"] = s["admitted_timed"]
        # the decisions themselves, where the checkout's chip_smoke
        # keeps them
        out[phase]["decided"] = s.get("decided")
    return out


def child_sched(order: list) -> dict:
    """The Scheduler's steps under each arm: the fill's steps after the
    first (2048 admissions each) and the trickle's (128 finishes and 128
    admissions each), every step's wall ms, the solver's device phase
    and the admitted names; a full collection before each arm. Each
    arm's line is printed as it ends."""
    import gc

    import chip_smoke as cs
    import torch
    device = torch.device(DEVICE)
    out = []
    for arm in order:
        gc.collect()
        run = cs.FaultsRun(device, f"ab {arm}", cs.FAULTS_CLOCK_S)
        if arm == "none":
            run.sched.watchdog = None
        fill, trickle, device_ms = [], [], []
        for n in range(cs.E2E_WAVES + cs.FAULTS_TRICKLE):
            row = run.step(n)
            if row["route"] != "device" or row["new_faults"]:
                raise AssertionError(f"{arm} step {n}: {row}")
            if n >= 1:
                (fill if n < cs.E2E_WAVES else trickle).append(row["wall_ms"])
                device_ms.append(run.sched.solver.last_phase_s["device"] * 1e3)
        records = run.records
        run.close()
        out.append({"arm": arm, "fill_p50_ms": statistics.median(fill),
                    "trickle_p50_ms": statistics.median(trickle),
                    "device_p50_ms": statistics.median(device_ms),
                    "fill_ms": fill, "trickle_ms": trickle,
                    "records": records})
        print("CYCLE_AB_ARM " + json.dumps({k: v for k, v in out[-1].items()
                                          if k != "records"}), flush=True)
    if any(o["records"] != out[0]["records"] for o in out):
        raise AssertionError("the watchdog arms admitted differently")
    for o in out:
        del o["records"]
    return out


def child_pipe(order: list) -> dict:
    """The pipelined and synchronous Scheduler on the same traffic (no
    update, no injector), each arm's line printed as it ends."""
    import gc

    import chip_smoke as cs
    import torch
    device = torch.device(DEVICE)
    out, admitted = [], []
    for arm in order:
        gc.collect()
        run = cs.PipelineRun(device, f"ab {arm}",
                             1 if arm == "pipelined" else 0)
        run.run(update_step=-1)
        walls = [r["wall_ms"] for r in run.steps]
        # each arm's device collects, both read from the CUDA events
        device_ms = run.collect_device_ms if arm == "pipelined" \
            else run.sync_device_ms
        out.append({
            "arm": arm,
            "fill_p50_ms": statistics.median(walls[1:cs.E2E_WAVES]),
            "trickle_p50_ms": statistics.median(
                walls[cs.E2E_WAVES:cs.FAULTS_STEPS]),
            "device_events_p50_ms": statistics.median(device_ms),
            "route_p50_ms": (statistics.median(run.route_ms)
                             if run.route_ms else None),
            "steps": len(walls), "admitted": len(run.reserved),
            "cycle_counts": dict(run.sched.cycle_counts),
            "fill_ms": walls[1:cs.E2E_WAVES]})
        admitted.append(sorted(run.reserved))
        run.close()
        print("CYCLE_AB_ARM " + json.dumps(out[-1]), flush=True)
    if any(a != admitted[0] for a in admitted):
        raise AssertionError("the pipeline arms admitted differently")
    return out


def child_obs(order: list) -> dict:
    """The synchronous Scheduler with every observer attached
    ("observed"), as made ("default": its flight recorder on) and with
    none ("bare"), on the fill and the trickle, each arm's line printed
    as it ends."""
    import gc

    import chip_smoke as cs
    import torch
    device = torch.device(DEVICE)

    class ObsRun(cs.FaultsRun):
        def __init__(self, arm):
            self.arm = arm
            super().__init__(device, f"ab {arm}", cs.FAULTS_CLOCK_S)

        def build_env(self, device):
            from kueue_tpu_torch.sim import northstar as ns
            from kueue_tpu_torch.solver import BatchSolver
            flavors = [f"f{i}" for i in range(cs.NORTH_STAR["num_flavors"])]
            env = ns.build_scheduler(cs.NORTH_STAR["num_cqs"],
                                     cs.NORTH_STAR["num_cohorts"], flavors,
                                     cs.NOMINAL_UNITS,
                                     solver=BatchSolver(device=device))
            sched, cache, queues, _client = env
            if self.arm == "observed":
                cs.attach_observers(sched, cache, queues)
            elif self.arm == "bare":
                sched.recorder.enabled = False
            ns.stage_waves(queues, cs.E2E_WAVES, cs.NORTH_STAR["num_cqs"],
                           cs.NOMINAL_UNITS)
            return env

    out, records = [], []
    for arm in order:
        gc.collect()
        run = ObsRun(arm)
        fill, trickle = [], []
        for n in range(cs.E2E_WAVES + cs.FAULTS_TRICKLE):
            row = run.step(n, quiet=True)
            if row["route"] != "device" or row["new_faults"]:
                raise AssertionError(f"{arm} step {n}: {row}")
            if n >= 1:
                (fill if n < cs.E2E_WAVES else trickle).append(row["wall_ms"])
        traces = len(run.sched.recorder.traces())
        records.append(run.records)
        if run.sched.query_plane is not None:
            run.sched.query_plane.close()
        run.close()
        out.append({"arm": arm, "fill_p50_ms": statistics.median(fill),
                    "trickle_p50_ms": statistics.median(trickle),
                    "traces": traces, "fill_ms": fill,
                    "trickle_ms": trickle})
        print("CYCLE_AB_ARM " + json.dumps(out[-1]), flush=True)
    if any(r != records[0] for r in records):
        raise AssertionError("the observer arms admitted differently")
    return out


def spawn(label: str, root: Path, args: list) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    logf = OUT / f"{label}.log"
    t0 = time.perf_counter()
    with open(logf, "w") as f:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             *args, "--root", str(root)],
            cwd=root, stdout=f, stderr=subprocess.STDOUT)
    if proc.returncode != 0:
        raise SystemExit(f"{label}: exit {proc.returncode}, see {logf}")
    line = [ln for ln in logf.read_text().splitlines()
            if ln.startswith(TAG)][-1]
    result = json.loads(line[len(TAG):])
    print(json.dumps({"run": label, "wall_s": time.perf_counter() - t0,
                      "result": result if not label.startswith("e2e")
                      else {p: {k: v for k, v in r.items() if k != "decided"}
                            for p, r in result.items()}}), flush=True)
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="an earlier checkout to time against")
    ap.add_argument("--pairs", default="sched,pipe,obs",
                    help="the Scheduler comparisons to run (of sched, "
                         "pipe, obs)")
    ap.add_argument("--child", nargs="+")
    ap.add_argument("--root")
    a = ap.parse_args()
    if a.child:
        sys.path[0] = a.root
        children = {"e2e": lambda: child_e2e(),
                    "sched": lambda: child_sched(a.child[1].split(",")),
                    "pipe": lambda: child_pipe(a.child[1].split(",")),
                    "obs": lambda: child_obs(a.child[1].split(","))}
        result = children[a.child[0]]()
        print(TAG + json.dumps(result), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("cycle_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    summary = {"card": smi, "timed_cycles": TIMED}
    if a.parent:
        parent = Path(a.parent).resolve()
        # the same sources build the same libraries (named by their hash)
        sys.path.insert(0, str(ROOT))
        from kueue_tpu_torch.solver import _build
        _build.build_all()
        dst = parent / "kueue_tpu_torch" / "solver" / "_build"
        dst.mkdir(parents=True, exist_ok=True)
        for lib in _build.BUILD_DIR.glob("*.so"):
            (dst / lib.name).write_bytes(lib.read_bytes())
        runs = []
        for i, (name, root) in enumerate((("parent", parent), ("change", ROOT),
                                          ("change", ROOT),
                                          ("parent", parent))):
            runs.append((name, spawn(f"e2e{i}-{name}", root, ["e2e"])))
        for phase in E2E_PHASES:
            if len({r[phase]["admitted"] for _, r in runs}) != 1 or len(
                    {json.dumps(r[phase]["decided"]) for n, r in runs
                     if n == "change"}) != 1:
                raise SystemExit(f"{phase}: the runs decided differently")
        summary["e2e_phases"] = {
            phase: {name: {k: [r[phase][k] for n, r in runs if n == name]
                           for k in E2E_KEYS}
                    for name in ("parent", "change")}
            for phase in E2E_PHASES}
    pairs = a.pairs.split(",")
    if "sched" in pairs:
        sched = spawn("sched", ROOT, ["sched", "default,none,none,default"])
        summary["sched"] = {
            arm: {k: [o[k] for o in sched if o["arm"] == arm]
                  for k in ("fill_p50_ms", "trickle_p50_ms",
                            "device_p50_ms")}
            for arm in ("default", "none")}
    if "pipe" in pairs:
        pipe = spawn("pipe", ROOT, ["pipe", "pipelined,sync,sync,pipelined"])
        summary["pipe"] = {
            arm: {k: [o[k] for o in pipe if o["arm"] == arm]
                  for k in ("fill_p50_ms", "trickle_p50_ms",
                            "device_events_p50_ms", "route_p50_ms",
                            "admitted")}
            for arm in ("pipelined", "sync")}
    if "obs" in pairs:
        obs = spawn("obs", ROOT, [
            "obs", "observed,default,bare,bare,default,observed"])
        summary["obs"] = {
            arm: {k: [o[k] for o in obs if o["arm"] == arm]
                  for k in ("fill_p50_ms", "trickle_p50_ms", "traces")}
            for arm in ("observed", "default", "bare")}
    (OUT / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
