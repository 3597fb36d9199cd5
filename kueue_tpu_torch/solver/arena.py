"""Persistent workload encode arena: O(changed) per-cycle batch assembly.

The port's copy of kueue_tpu/solver/arena.py. Every pending workload's
encoded rows live in a stable SLOT of a set of persistent host arrays,
from the moment it first appears as a head until it is admitted or
deleted:

- Rows are (re)encoded only when their validity key moves. The key is
  (topology token, metadata.resourceVersion), enforced as OBJECT
  IDENTITY: a resourceVersion bump always arrives on a fresh Workload
  object (the queue manager builds a fresh Info and fires the 'upsert'
  delta feed); 'del' frees the slot. Requeues of an unchanged Info keep
  the row.
- Per cycle, batch assembly is a gather of this cycle's head slots: an
  `np.take` on the host (`assemble`, bit-identical to
  encode.encode_workloads), or a slot index array shipped to the card
  so the gather runs there (kernel.gather_arena) against a device TWIN
  of the arena arrays.
- The twin is kept current by `prepare_device`: a wholesale upload when
  it is missing or stale, else the rows dirtied since the last dispatch
  are scattered into it in place (kernel.scatter_arena_rows), the torch
  form of the JAX package's donated scatter.
- Only `start_rank` — the one genuinely per-cycle input (flavor-resume
  state moves with capacity generations) — is recomputed each cycle,
  by encode.fill_start_ranks.
- The scatter is a fault site (resilience/faultinject.SITE_SCATTER,
  kueue_tpu/solver/arena.py:63, :551-552): CORRUPT mangles the rows in
  transit (`_scramble_rows`) and K7a scatters them. The port has no
  host-side router to send the heads it denies to the CPU, so the
  arena notes the injector's hit (`last_scramble`) and the solver's
  collect raises InjectedFault for that cycle.
"""

from __future__ import annotations

from collections import deque

import numpy as np

import torch

from kueue_tpu_torch.api.corev1 import RESOURCE_PODS
from kueue_tpu_torch.core import priority as prioritypkg
from kueue_tpu_torch.resilience import faultinject
from kueue_tpu_torch.solver import encode

# The host/device twin field list — the arena ABI, owned here and
# imported by kernel.py, so the two sides can never drift. Gathered per
# cycle into the WorkloadBatch; start_rank is deliberately absent:
# per-cycle, see module docstring.
ARENA_FIELDS = ("requests", "podset_active", "wl_cq", "priority",
                "timestamp", "eligible", "solvable")

# Changed-row scatter buckets: exactly two shapes, as in the JAX
# package; a bigger dirty set re-uploads the twin wholesale.
_UPD_BUCKETS = (8, 512)

# Churn batches at least this big take the vectorized multi-row encode
# (_encode_rows) instead of the per-row path: below it, the batch
# bookkeeping costs more than the per-row numpy dispatch it saves.
_BATCH_ENCODE_MIN = 8


def _scramble_rows(upd_rows: dict) -> dict:
    """The scatter site's CORRUPT action (kueue_tpu/solver/arena.py:63):
    requests inflated past any real quota, so a mangled row can only
    fail Phase A on the card (deny), never admit."""
    out = dict(upd_rows)
    out["requests"] = np.full_like(upd_rows["requests"], 1 << 40)
    return out


class WorkloadArena:
    def __init__(self, max_podsets: int = 4):
        self.P = max_podsets
        self.token = -1          # topology token the rows are encoded for
        self.F = self.R = -1
        self.cap = 0             # allocated slots (bucketed powers of 4)
        self.size = 0            # high-water slot index
        self.slot_of: dict = {}  # workload key -> slot
        # Per-slot validity (plain lists: the ensure loop scalar-indexes
        # them, where list access beats ndarray scalar boxing): a row is
        # current iff info_at is the very Info carrying the slot hint
        # AND enc_obj is that Info's current obj. The (topo.token,
        # resourceVersion) invalidation key is enforced through object
        # identity: every resourceVersion bump arrives on a FRESH object
        # (the store clones on update; the queue manager then builds a
        # fresh Info and fires the upsert feed). Callers that swap a
        # live Info's obj or rebuild its requests in place MUST re-push
        # it through the Manager (every controller path does) — the
        # positional fast path cannot see a mutation that changes no
        # identity and fires no delta.
        self.enc_obj: list = []  # the api.Workload the row encoded
        self.info_at: list = []  # the Info whose row this is
        self.free: list = []     # recycled slots
        # Per-slot encode generation: bumped on every re-encode AND on
        # every delta that invalidates the slot (del/upsert), so an
        # in-flight dispatch can prove its gathered rows were untouched
        # mid-flight (BatchSolver.slot_generations).
        self.gen = np.zeros(0, np.int64)
        # Positional fast path: the previous cycle's (entry ids, slots).
        # A head list position whose Info identity is unchanged AND whose
        # slot no delta touched since needs NO per-entry Python work —
        # the steady state for a requeued backlog. _last_entries pins the
        # previous cycle's Infos so a recycled id can never masquerade as
        # an unchanged entry.
        self._last_ids = None     # np.int64 [m]
        self._last_slots = None   # np.int32 [m]
        self._last_entries = None
        self._touched: set = set()  # slots invalidated since last ensure
        # queue-manager delta feed: ('upsert'|'del', key), appended under
        # the manager lock, drained at the start of every assemble()
        self._pending: deque = deque()
        # host arrays (allocated on first use / topology change)
        self.requests = None       # [S,P,R] int64
        self.podset_active = None  # [S,P] bool
        self.eligible = None       # [S,P,F] bool
        self.wl_cq = None          # [S] int32
        self.priority = None       # [S] int64
        self.timestamp = None      # [S] float64
        self.solvable = None       # [S] bool
        # device twin + upload bookkeeping
        self.dirty: set = set()  # slots changed since the last device upload
        self.dev = None          # {field: device array} or None
        self.dev_cap = -1
        self.dev_token = -1
        # the injector's hit that scrambled the last prepare_device's
        # scatter, or None
        self.last_scramble = None
        # engagement counters (perf artifacts)
        self.encoded_rows = 0
        self.gathers = 0
        self.full_uploads = 0
        self.row_uploads = 0

    # --- delta feed (queue manager listeners; see Manager.add_workload_listener) ---

    def note(self, kind: str, key: str) -> None:
        """Thread-safe enqueue; applied at the next assemble()."""
        self._pending.append((kind, key))

    def _drain(self) -> None:
        pending = self._pending
        while pending:
            try:
                kind, key = pending.popleft()
            except IndexError:  # pragma: no cover — racing producers
                break
            slot = self.slot_of.get(key)
            if slot is None:
                continue
            if kind == "del":
                del self.slot_of[key]
                self.enc_obj[slot] = None
                self.info_at[slot] = None
                self.free.append(slot)
            else:  # upsert: the object was replaced — row is stale
                self.enc_obj[slot] = None
            self.gen[slot] += 1  # an in-flight gather of this row is stale
            self._touched.add(slot)

    # --- slot storage ---

    def _alloc_arrays(self, cap: int, F: int, R: int) -> None:
        P = self.P
        self.requests = np.zeros((cap, P, R), np.int64)
        self.podset_active = np.zeros((cap, P), bool)
        self.eligible = np.zeros((cap, P, F), bool)
        self.wl_cq = np.zeros(cap, np.int32)
        self.priority = np.zeros(cap, np.int64)
        self.timestamp = np.zeros(cap, np.float64)
        self.solvable = np.zeros(cap, bool)

    def reserve(self, n: int, topo) -> None:
        """Pre-size for an expected pending-set cardinality so a long
        run never pays mid-run growth (each growth drops the device twin,
        which the next dispatch re-uploads wholesale)."""
        self.begin_cycle(topo)
        if n > self.cap:
            self._grow(n)

    def begin_cycle(self, topo) -> None:
        """Topology-epoch invalidation: a new token (or reshaped F/R
        dims) makes every encoded row stale at once. Slots survive —
        rows re-encode lazily as their workloads next appear as heads."""
        _, F, R = topo.nominal.shape
        if topo.token == self.token and F == self.F and R == self.R:
            return
        self.token = topo.token
        if F != self.F or R != self.R:
            self.F, self.R = F, R
            if self.cap:
                self._alloc_arrays(self.cap, F, R)
        self.enc_obj = [None] * self.cap
        self._last_ids = None  # every row is stale: full rescan
        self.dirty.clear()
        self.dev = None  # stale twin: full re-upload on next dispatch

    def _grow(self, need: int) -> None:
        cap = encode._bucket(max(need, 256), 256)
        if cap <= self.cap:
            return
        if self.cap == 0:
            self._alloc_arrays(cap, self.F, self.R)
        else:
            for name in ARENA_FIELDS:
                old = getattr(self, name)
                arr = np.zeros((cap,) + old.shape[1:], old.dtype)
                arr[: self.cap] = old
                setattr(self, name, arr)
        self.enc_obj.extend([None] * (cap - self.cap))
        self.info_at.extend([None] * (cap - self.cap))
        gen = np.zeros(cap, np.int64)
        gen[: self.cap] = self.gen[: self.cap]
        self.gen = gen
        self.cap = cap
        self.dev = None  # shape moved: full re-upload on next dispatch

    def _alloc(self) -> int:
        if self.free:
            return self.free.pop()
        if self.size >= self.cap:
            self._grow(self.size + 1)
        slot = self.size
        self.size += 1
        return slot

    def release(self, key: str) -> None:
        """The workload left the pending set outside the queue-manager
        feed (admission: it holds quota now and can never be a head
        again until evicted — which re-adds it through the manager)."""
        self.note("del", key)

    # --- encoding & assembly ---

    def _encode_row(self, slot: int, info, snapshot, topo, ordering) -> None:
        """Encode one workload's cycle-stable rows IN PLACE (same
        semantics as encode._encode_one, which stays the oracle — the
        randomized equivalence suite pins the two together; writing row
        views directly skips its per-call scratch allocations, and row
        encodes are the arena's only per-churned-workload cost)."""
        self.dirty.add(slot)
        self.encoded_rows += 1
        self.gen[slot] += 1
        req_row = self.requests[slot]
        act_row = self.podset_active[slot]
        elig_row = self.eligible[slot]
        if self.solvable[slot]:
            # Invariant: non-solvable rows are already all-zero (every
            # encode bail path re-zeroes) — only a previously-solvable
            # occupant's data needs clearing.
            req_row[:] = 0
            act_row[:] = False
            elig_row[:] = False
            self.solvable[slot] = False
        cq = snapshot.cluster_queues.get(info.cluster_queue)
        if cq is None:
            # Unknown CQ: the oracle leaves the whole row zero.
            self.wl_cq[slot] = 0
            self.priority[slot] = 0
            self.timestamp[slot] = 0.0
            return
        qi = topo.cq_index[info.cluster_queue]
        self.wl_cq[slot] = qi
        self.priority[slot] = prioritypkg.priority(info.obj)
        self.timestamp[slot] = ordering.queue_order_timestamp(info.obj)
        if len(info.total_requests) > self.P:
            return  # CPU fallback row (zeros, not solvable)
        resource_index = topo.resource_index
        covers_pods = topo.covers_pods[qi]
        for pi, psr in enumerate(info.total_requests):
            reqs = dict(psr.requests)
            if covers_pods:
                reqs[RESOURCE_PODS] = psr.count
            for r, v in reqs.items():
                ri = resource_index.get(r)
                if ri is None or topo.group_id[qi, ri] < 0:
                    # Unencodable resource: discard the partial fill,
                    # exactly like the oracle's not-ok row.
                    req_row[:] = 0
                    act_row[:] = False
                    elig_row[:] = False
                    return
                req_row[pi, ri] = v
            act_row[pi] = True
            elig_row[pi] = encode.eligibility_row(info, pi, qi, cq,
                                                  snapshot, topo)
        self.solvable[slot] = True

    def _encode_rows(self, slots: list, infos: list, snapshot, topo,
                     ordering) -> None:
        """Vectorized multi-row churn encode: same semantics as
        ``_encode_row`` — the randomized equivalence suite pins the two
        to the from-scratch oracle — but the numpy
        work is ONE fancy-indexed write per arena field for the whole
        batch instead of ~15us/row of small-array dispatch. The
        per-workload dict walks (requests, eligibility-cache lookups)
        stay host Python; they were never the overhead — the per-row
        ndarray scalar stores were."""
        n = len(slots)
        self.encoded_rows += n
        slots_arr = np.asarray(slots, np.int64)
        self.dirty.update(slots)
        self.gen[slots_arr] += 1
        solv = self.solvable[slots_arr]
        if solv.any():
            # Only previously-solvable occupants hold non-zero data
            # (same invariant _encode_row relies on).
            clear = slots_arr[solv]
            self.requests[clear] = 0
            self.podset_active[clear] = False
            self.eligible[clear] = False
            self.solvable[clear] = False
        cqs = snapshot.cluster_queues
        resource_index = topo.resource_index
        qis = np.zeros(n, np.int32)
        prios = np.zeros(n, np.int64)
        tss = np.zeros(n, np.float64)
        solvable = np.zeros(n, bool)
        req_r: list = []
        req_p: list = []
        req_c: list = []
        req_v: list = []
        act_r: list = []
        act_p: list = []
        elig_rows: list = []
        P = self.P
        for k, info in enumerate(infos):
            cq = cqs.get(info.cluster_queue)
            if cq is None:
                continue  # unknown CQ: all-zero row, like the oracle
            qi = topo.cq_index[info.cluster_queue]
            qis[k] = qi
            prios[k] = prioritypkg.priority(info.obj)
            tss[k] = ordering.queue_order_timestamp(info.obj)
            if len(info.total_requests) > P:
                continue  # CPU fallback row (zeros, not solvable)
            covers_pods = topo.covers_pods[qi]
            slot = slots[k]
            triples: list = []
            ok = True
            for pi, psr in enumerate(info.total_requests):
                reqs = dict(psr.requests)
                if covers_pods:
                    reqs[RESOURCE_PODS] = psr.count
                for r, v in reqs.items():
                    ri = resource_index.get(r)
                    if ri is None or topo.group_id[qi, ri] < 0:
                        ok = False  # unencodable: whole row stays zero
                        break
                    triples.append((pi, ri, v))
                if not ok:
                    break
            if not ok:
                continue
            for pi in range(len(info.total_requests)):
                act_r.append(slot)
                act_p.append(pi)
                elig_rows.append(encode.eligibility_row(
                    info, pi, qi, cq, snapshot, topo))
            for pi, ri, v in triples:
                req_r.append(slot)
                req_p.append(pi)
                req_c.append(ri)
                req_v.append(v)
            solvable[k] = True
        self.wl_cq[slots_arr] = qis
        self.priority[slots_arr] = prios
        self.timestamp[slots_arr] = tss
        if req_r:
            self.requests[req_r, req_p, req_c] = req_v
        if act_r:
            self.podset_active[act_r, act_p] = True
            self.eligible[act_r, act_p] = np.stack(elig_rows)
        self.solvable[slots_arr] = solvable

    def slot_generations(self, slots) -> np.ndarray:
        """Current per-slot encode generations for ``slots``
        (staleness check of a dispatched batch). Pending queue-manager
        deltas are drained first, so a del/upsert that arrived mid-flight but has
        not been through ``assemble`` yet still bumps the generation it
        invalidates."""
        self._drain()
        return self.gen[np.asarray(slots, np.int64)].copy()

    def ensure(self, entries: list, snapshot, topo, ordering) -> np.ndarray:
        """Slots for this cycle's heads, (re)encoding only the rows whose
        validity key moved. Returns [n] int32.

        The steady-state fast path is positional and fully vectorized: a
        head-list position holding the SAME Info as last cycle, whose
        slot no queue-manager delta touched since, is valid as-is (a
        requeued backlog re-pops in stable order, so at 2048 heads this
        skips the per-entry Python work entirely). Everything else takes
        the per-entry path: slot hint -> owning-Info identity -> encoded
        obj identity (see the class comment for why object identity
        enforces the (token, resourceVersion) key)."""
        self._drain()
        n = len(entries)
        ids = np.fromiter(map(id, entries), np.int64, n)
        last_ids = self._last_ids
        if last_ids is not None and last_ids.shape[0] == n:
            slots = self._last_slots.copy()
            same = ids == last_ids
            if self._touched:
                t = np.fromiter(self._touched, np.int64,
                                len(self._touched))
                same &= ~np.isin(slots, t)
            changed = np.flatnonzero(~same)
        else:
            slots = np.empty(n, np.int32)
            changed = range(n)
        self._touched.clear()
        enc_obj = self.enc_obj
        info_at = self.info_at
        slot_of = self.slot_of
        cap = self.cap
        enc_slots: list = []
        enc_infos: list = []
        for i in changed:
            info = entries[i]
            slot = info._arena_slot
            if not (0 <= slot < cap and info_at[slot] is info):
                key = info.key
                slot = slot_of.get(key)
                if slot is None:
                    slot = self._alloc()
                    slot_of[key] = slot
                    enc_obj = self.enc_obj  # rebind after growth
                    info_at = self.info_at
                    cap = self.cap
                info._arena_slot = slot
                info_at[slot] = info
            if enc_obj[slot] is not info.obj:
                # Deferred: churn batches big enough to amortize the
                # bookkeeping re-encode vectorized, in one pass. The
                # enc_obj mark lands only AFTER the encode succeeds —
                # a raising encode (an anticipated fallback path) must
                # leave the slot retryable, not sticky-stale.
                enc_slots.append(slot)
                enc_infos.append(info)
            slots[i] = slot
        if len(enc_slots) >= _BATCH_ENCODE_MIN:
            self._encode_rows(enc_slots, enc_infos, snapshot, topo,
                              ordering)
            for slot, info in zip(enc_slots, enc_infos):
                self.enc_obj[slot] = info.obj
        else:
            for slot, info in zip(enc_slots, enc_infos):
                self._encode_row(slot, info, snapshot, topo, ordering)
                self.enc_obj[slot] = info.obj
        self._last_ids = ids
        self._last_slots = slots
        # Copy: callers may mutate their list, and the pin must hold the
        # exact objects the ids were taken from (id-recycle guard).
        self._last_entries = list(entries)
        return slots

    def assemble(self, entries: list, snapshot, topo, ordering,
                 max_podsets: int):
        """(WorkloadBatch bit-identical to encode.encode_workloads,
        slots [n] int32). The batch arrays are fresh (not views into the
        arena), so downstream code may hold them across cycles."""
        slots = self.ensure(entries, snapshot, topo, ordering)
        n = len(entries)
        W = encode._bucket(max(1, n))
        P = max_podsets
        _, F, R = topo.nominal.shape
        batch = encode.WorkloadBatch(infos=list(entries), n=n)
        for name, shape, dtype in (
                ("requests", (W, P, R), np.int64),
                ("podset_active", (W, P), bool),
                ("wl_cq", (W,), np.int32),
                ("priority", (W,), np.int64),
                ("timestamp", (W,), np.float64),
                ("eligible", (W, P, F), bool),
                ("solvable", (W,), bool)):
            # np.take into the uninitialized rows, zero only the padding
            # tail (np.zeros + fancy-index assignment paid an extra full
            # pass over every array).
            out = np.empty(shape, dtype)
            if n:
                np.take(getattr(self, name), slots, axis=0, out=out[:n])
            out[n:] = 0
            setattr(batch, name, out)
        batch.start_rank = np.zeros((W, P, R), np.int32)
        encode.fill_start_ranks(batch.start_rank, entries, batch.solvable,
                                snapshot, topo, P)
        self.gathers += 1
        return batch, slots

    # --- device twin (the gather kernel's source) ---

    def drop_device(self) -> None:
        """Device state unknown (failed dispatch / residency reset):
        force a full re-upload at the next dispatch."""
        self.dev = None

    def _full_upload(self, device):
        # copy=True: on the CPU a plain .to() would alias the host
        # arrays, which keep changing under the twin
        self.dev = {name: torch.from_numpy(getattr(self, name)).to(
                        device, copy=True)
                    for name in ARENA_FIELDS}
        self.dev_cap = self.cap
        self.dev_token = self.token
        self.dirty.clear()
        self.full_uploads += 1
        return self.dev, sum(getattr(self, name).nbytes
                             for name in ARENA_FIELDS)

    def prepare_device(self, device):
        """Returns (device twin dict, uploaded bytes), current as of the
        host arrays: a full upload when the twin is missing/stale or the
        dirty set is large, else the rows dirtied since the last
        dispatch are scattered into the twin IN PLACE by
        kernel.scatter_arena_rows, padded to one of two fixed row
        buckets with the out-of-range slot `cap`, which the scatter
        drops."""
        self.last_scramble = None
        if (self.dev is None or self.dev_cap != self.cap
                or self.dev_token != self.token):
            return self._full_upload(device)
        if not self.dirty:
            return self.dev, 0
        rows = sorted(self.dirty)
        if len(rows) > _UPD_BUCKETS[-1]:
            # Mass churn: one wholesale upload.
            return self._full_upload(device)
        self.dirty.clear()
        for D in _UPD_BUCKETS:
            if len(rows) <= D:
                break
        upd_slots = np.full(D, self.cap, np.int32)
        upd_slots[: len(rows)] = rows
        upd_rows = {}
        nbytes = upd_slots.nbytes
        for name in ARENA_FIELDS:
            host = getattr(self, name)
            arr = np.zeros((D,) + host.shape[1:], host.dtype)
            arr[: len(rows)] = host[rows]
            upd_rows[name] = arr
            nbytes += arr.nbytes
        self.row_uploads += len(rows)
        # Fault site: a raise is a failed upload (the dispatch's fault
        # path owns it: the twin is dropped and re-uploaded whole from
        # the host rows, which faults never touch); CORRUPT mangles the
        # rows in transit, and K7a scatters the mangled rows.
        sent = upd_rows
        upd_rows = faultinject.site(faultinject.SITE_SCATTER, upd_rows,
                                    corrupt=_scramble_rows)
        if upd_rows is not sent:
            injector = faultinject.active(faultinject.current_scope())
            self.last_scramble = injector.hits[faultinject.SITE_SCATTER] - 1
        from kueue_tpu_torch.solver.kernel import scatter_arena_rows
        scatter_arena_rows(self.dev, torch.from_numpy(upd_slots).to(device),
                           {name: torch.from_numpy(a).to(device)
                            for name, a in upd_rows.items()})
        return self.dev, nbytes
