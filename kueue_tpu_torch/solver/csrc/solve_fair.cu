// solve_fair: batched fair-sharing preemption (fairPreemptions,
// preemption.go:312-437) for every fair preempt-mode head of a cycle.
// Replaces kueue_tpu/solver/fairpreempt.py:210 solve_fair_impl with
// make_problem_sim's fits, remove_usage and add_usage
// (kueue_tpu/solver/preempt.py:307-421); the plain version is
// kernel.solve_fair_plain.
//
// Per problem (solver/fairpreempt.py encodes them):
//  1. gather the problem's quota and usage planes by its global indices
//     (gq, gf, gr, gc) and build the (local CQ, rank) -> candidate table
//     from cand_ql and cand_rank (a CSR over cq_count);
//  2. the DRF-heap loop: pop the eligible CQ (still in the heap, with a
//     candidate left) of the largest share, ties to the lowest cq_order,
//     then the lowest slot; take its candidate of the next rank; remove it
//     when it is the preemptor's own, under the borrowWithinCohort
//     threshold, or when the first strategy holds (S2-a: the preemptor's
//     share with its request <= the preemptee's share after the removal;
//     S2-b: < its share before); update that CQ's share, and the
//     preemptor's on an own removal; the pop advances the CQ's rank even
//     when nothing was removed; another CQ that removed stays in the heap
//     only while it still borrows on a needs-preemption slot; stop when
//     the preemptor fits, the heap is empty or after K pops;
//  3. the retry pass (with a second strategy): shares fixed at its entry,
//     QL steps, each the eligible CQ of the largest share and its first
//     refused candidate, S2-a comparing the preemptor's share with 0;
//  4. no fit: no targets; else fill-back in reverse removal order,
//     skipping the last removal, keeping a candidate returned where the
//     preemptor still fits.
// Shares: dominantResourceShare, max over resources of borrowed * 1000 //
// lendable (-1 where nothing is lent or borrowed), then * 1000 // weight,
// 2^62 for weight 0; both divisions floor (kq_floordiv), since drs can be
// -1. Limits clamp at 2^61 / 4, as the JAX program's. Outputs default to
// zero (the wrapper allocates them so): a padding problem or candidate
// is never written. Reason codes: 0 own CQ, 1 strategy, 2 threshold only.
// cq_count and cand_rank are taken as encode_fair_problems makes them:
// each CQ's candidates ranked 0 .. count - 1.
//
// Bound on the H100: latency. A problem is a chain of dependent pops,
// each a reduction over its CQs, a share over its slots and a walk of the
// preemptor's cohort chain; the bytes are a few rows per pop. Design: one
// warp per problem in a persistent grid (warp w takes problems w, w +
// warps, ...). Slot i of every per-slot row is owned by lane i % 32, so
// the usage bubbling and the fit check are lane-local with a warp vote
// per level; the lanes stride over the CQs for the pick (a warp max, then
// a lexicographic warp min) and over the slots for a share (a warp max).
// Per-warp scratch in device memory holds the problem's rows, the table
// and the removal log, which the fill-back walks backwards.
#include <climits>
#include "common.cuh"

#define SF_NOLIM (1LL << 61)
#define SF_LIM (SF_NOLIM / 4)
#define SF_MAXSHARE (1LL << 62)
#define SF_NONE (1LL << 30)
#define SF_WARPS 8
#define SF_FULL 0xffffffffu

struct FairProb {
  const long long *borrow_limit;
  const int *gq, *gf, *gr, *chain;  // chain: [QL][DC] local cohort ids
  const long long* req;
  const unsigned char* frs_np;
  const long long *base, *floor_ratio, *weight, *lendable;
  const unsigned char* floor_any;
  const int *count, *order;
  int QL, RF, CL, DC, K, F, R;
  bool has_cohort;
};

// Per-warp scratch. int64 rows [QL][RF]: U, NOM, GUAR; [CL][RF]: CU, CG,
// CSUB, CBL; SH [QL]; DEL [RF]; SAVE [1 + DC][RF]. int32: POS, ACT,
// FRETRY [QL], START [QL + 1], TABLE [K], LOG [K]
// (kernel.fair_scratch_words).
struct FairScratch {
  long long *U, *NOM, *GUAR, *CU, *CG, *CSUB, *CBL, *SH, *DEL, *SAVE;
  int *POS, *ACT, *FRETRY, *START, *TABLE, *LOG;
};

__device__ __forceinline__ long long sf_min(long long a, long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ long long sf_warp_max(long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long w = __shfl_xor_sync(SF_FULL, v, o);
    v = w > v ? w : v;
  }
  return v;
}

__device__ __forceinline__ int sf_warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(SF_FULL, v, o);
  return v;
}

// dominantResourceShare of local CQ q (its nominal row, base_other,
// floor, weight) with usage row(j) at slot j. Every lane returns it.
template <class Row>
__device__ long long sf_share(const FairProb& p, const FairScratch& s, int q,
                              Row row, int lane) {
  const long long* nom = s.NOM + (size_t)q * p.RF;
  long long best = LLONG_MIN;
  bool borrows = false;
  for (int i = lane; i < p.RF; i += 32) {
    long long br = p.base[(size_t)q * p.RF + i];
    if (p.gf[i] >= 0)
      for (int j = 0; j < p.RF; ++j)
        if (p.gf[j] >= 0 && p.gr[j] == p.gr[i]) br += kq_max0(row(j) - nom[j]);
    const long long lend = p.lendable[i];
    const long long ratio =
        (br > 0 && lend > 0) ? kq_floordiv(br * 1000, lend) : -1;
    best = ratio > best ? ratio : best;
    borrows |= br > 0;
  }
  best = sf_warp_max(best);
  borrows = __any_sync(SF_FULL, borrows) || p.floor_any[q];
  const long long fl = p.floor_ratio[q];
  const long long drs = fl > best ? fl : best;
  const long long w = p.weight[q];
  if (w == 0) return SF_MAXSHARE;
  return borrows ? kq_floordiv(drs * 1000, w > 1 ? w : 1) : 0;
}

// workload_fits with borrowing allowed (preemption.go:576-585): every
// requested slot within the availability of CQ 0, walked down its cohort
// chain from the root end (resource_node.go:89-104). Lane-local per
// slot, then a vote.
__device__ bool sf_fits(const FairProb& p, const FairScratch& s, int lane) {
  bool ok = true;
  for (int i = lane; i < p.RF; i += 32) {
    const long long req = p.req[i];
    if (req <= 0) continue;
    const long long u0 = s.U[i], nom0 = s.NOM[i], guar0 = s.GUAR[i];
    long long avail;
    if (p.has_cohort) {
      long long parent = 0;
      bool started = false;
      for (int d = p.DC - 1; d >= 0; --d) {
        const int c = p.chain[d];
        if (c < 0 || c >= p.CL) continue;
        const size_t ci = (size_t)c * p.RF + i;
        const long long cuc = s.CU[ci], sub = s.CSUB[ci], gua = s.CG[ci];
        const long long cap = (sub - gua) - kq_max0(cuc - gua) +
                              sf_min(s.CBL[ci], SF_LIM);
        const long long child = kq_max0(gua - cuc) + sf_min(parent, cap);
        parent = started ? child : sub - cuc;
        started = true;
      }
      const int f = p.gf[i];
      const long long bl0 =
          f >= 0 ? p.borrow_limit[((size_t)(p.gq[0] > 0 ? p.gq[0] : 0) * p.F +
                                   f) * p.R + p.gr[i]]
                 : SF_NOLIM;
      const long long cap0 = (nom0 - guar0) - kq_max0(u0 - guar0) +
                             sf_min(bl0, SF_LIM);
      avail = kq_max0(guar0 - u0) + sf_min(parent, cap0);
    } else {
      avail = nom0 - u0;
    }
    if (req > avail) ok = false;
  }
  return __all_sync(SF_FULL, ok);
}

// removeUsage (resource_node.go:133-143) of row val from local CQ q: the
// part above guaranteed quota climbs the chain while any of it is left.
__device__ void sf_remove(const FairProb& p, const FairScratch& s, int q,
                          const long long* val, int lane) {
  const int RF = p.RF;
  for (int i = lane; i < RF; i += 32) {
    const size_t qi = (size_t)q * RF + i;
    const long long stored = s.U[qi] - s.GUAR[qi];
    s.U[qi] -= val[i];
    s.DEL[i] = sf_min(val[i], kq_max0(stored));
  }
  for (int d = 0; d < p.DC; ++d) {
    const int c = p.chain[q * p.DC + d];
    const bool okc = c >= 0 && c < p.CL;
    bool pos = false;
    for (int i = lane; i < RF; i += 32) pos |= s.DEL[i] > 0;
    const bool ok = __any_sync(SF_FULL, pos) && okc;
    for (int i = lane; i < RF; i += 32) {
      const size_t ci = (size_t)(okc ? c : 0) * RF + i;
      const long long stored_c = okc ? s.CU[ci] - s.CG[ci] : 0;
      const long long dd = ok ? s.DEL[i] : 0;
      if (ok) s.CU[ci] -= dd;
      s.DEL[i] = sf_min(dd, kq_max0(stored_c));
    }
  }
}

// addUsage (resource_node.go:121-131) of row val to local CQ q, saving
// the rows it changes for sf_restore. Lane-local per slot.
__device__ void sf_add(const FairProb& p, const FairScratch& s, int q,
                       const long long* val, int lane) {
  const int RF = p.RF;
  for (int i = lane; i < RF; i += 32) {
    const size_t qi = (size_t)q * RF + i;
    s.SAVE[i] = s.U[qi];
    const long long local = kq_max0(s.GUAR[qi] - s.U[qi]);
    s.U[qi] += val[i];
    long long delta = kq_max0(val[i] - local);
    for (int d = 0; d < p.DC; ++d) {
      const int c = p.chain[q * p.DC + d];
      if (c < 0 || c >= p.CL) continue;
      const size_t ci = (size_t)c * RF + i;
      s.SAVE[(size_t)(1 + d) * RF + i] = s.CU[ci];
      const long long local_c = kq_max0(s.CG[ci] - s.CU[ci]);
      s.CU[ci] += delta;
      delta = kq_max0(delta - local_c);
    }
  }
}

__device__ void sf_restore(const FairProb& p, const FairScratch& s, int q,
                           int lane) {
  const int RF = p.RF;
  for (int i = lane; i < RF; i += 32) {
    s.U[(size_t)q * RF + i] = s.SAVE[i];
    for (int d = 0; d < p.DC; ++d) {
      const int c = p.chain[q * p.DC + d];
      if (c < 0 || c >= p.CL) continue;
      s.CU[(size_t)c * RF + i] = s.SAVE[(size_t)(1 + d) * RF + i];
    }
  }
}

// pick_cq: the eligible CQ of the largest share, ties to the lowest
// cq_order, then the lowest slot (slot 0 when none is eligible, as
// jnp.argmin of the tie values). elig(q) must be warp-uniform in
// meaning; returns whether any CQ is eligible.
template <class Elig>
__device__ bool sf_pick(const FairProb& p, const FairScratch& s, Elig elig,
                        int lane, int* qstar) {
  long long m = -SF_MAXSHARE;
  bool any = false;
  for (int q = lane; q < p.QL; q += 32)
    if (elig(q)) {
      any = true;
      m = s.SH[q] > m ? s.SH[q] : m;
    }
  any = __any_sync(SF_FULL, any);
  m = sf_warp_max(m);
  long long bt = LLONG_MAX;
  int bq = INT_MAX;
  for (int q = lane; q < p.QL; q += 32) {
    const long long tv = (elig(q) && s.SH[q] == m) ? (long long)p.order[q]
                                                   : SF_NONE;
    if (tv < bt || (tv == bt && q < bq)) {
      bt = tv;
      bq = q;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const long long ot = __shfl_xor_sync(SF_FULL, bt, o);
    const int oq = __shfl_xor_sync(SF_FULL, bq, o);
    if (ot < bt || (ot == bt && oq < bq)) {
      bt = ot;
      bq = oq;
    }
  }
  *qstar = bq;
  return any;
}

__global__ void solve_fair_kernel(
    const long long* __restrict__ nominal,
    const long long* __restrict__ guaranteed,
    const long long* __restrict__ borrow_limit,
    const long long* __restrict__ cohort_subtree,
    const long long* __restrict__ cohort_guaranteed,
    const long long* __restrict__ cohort_borrow_limit,
    const long long* __restrict__ usage,
    const long long* __restrict__ cohort_usage, const int* __restrict__ gq,
    const int* __restrict__ gf, const int* __restrict__ gr,
    const int* __restrict__ gc, const int* __restrict__ chain_local,
    const long long* __restrict__ requests,
    const unsigned char* __restrict__ frs_np,
    const int* __restrict__ cand_idx, const short* __restrict__ cand_ql,
    const long long* __restrict__ cand_usage,
    const int* __restrict__ cand_prio,
    const unsigned char* __restrict__ threshold_active,
    const long long* __restrict__ threshold,
    const unsigned char* __restrict__ has_cohort,
    const int* __restrict__ cand_rank, const int* __restrict__ cq_count,
    const int* __restrict__ cq_order,
    const long long* __restrict__ base_other,
    const long long* __restrict__ floor_ratio,
    const unsigned char* __restrict__ floor_any,
    const long long* __restrict__ weight,
    const long long* __restrict__ lendable, long long* scratch64,
    int* scratch32, unsigned char* __restrict__ targets,
    unsigned char* __restrict__ feasible, signed char* __restrict__ reasons,
    int* __restrict__ stats, int B, int K, int QL, int RF, int CL, int DC,
    int F, int R, int warps, int s0, int has_retry, int s1) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp >= warps) return;  // uniform per warp
  const size_t w64 = 3 * (size_t)QL * RF + 4 * (size_t)CL * RF + QL + RF +
                     (size_t)(1 + DC) * RF;
  const size_t w32 = 4 * (size_t)QL + 1 + 2 * (size_t)K;
  FairScratch s;
  s.U = scratch64 + warp * w64;
  s.NOM = s.U + (size_t)QL * RF;
  s.GUAR = s.NOM + (size_t)QL * RF;
  s.CU = s.GUAR + (size_t)QL * RF;
  s.CG = s.CU + (size_t)CL * RF;
  s.CSUB = s.CG + (size_t)CL * RF;
  s.CBL = s.CSUB + (size_t)CL * RF;
  s.SH = s.CBL + (size_t)CL * RF;
  s.DEL = s.SH + QL;
  s.SAVE = s.DEL + RF;
  s.POS = scratch32 + warp * w32;
  s.ACT = s.POS + QL;
  s.FRETRY = s.ACT + QL;
  s.START = s.FRETRY + QL;
  s.TABLE = s.START + QL + 1;
  s.LOG = s.TABLE + K;

  for (int b = warp; b < B; b += warps) {
    FairProb p;
    p.borrow_limit = borrow_limit;
    p.gq = gq + (size_t)b * QL;
    p.gf = gf + (size_t)b * RF;
    p.gr = gr + (size_t)b * RF;
    p.chain = chain_local + (size_t)b * QL * DC;
    p.req = requests + (size_t)b * RF;
    p.frs_np = frs_np + (size_t)b * RF;
    p.base = base_other + (size_t)b * QL * RF;
    p.floor_ratio = floor_ratio + (size_t)b * QL;
    p.floor_any = floor_any + (size_t)b * QL;
    p.weight = weight + (size_t)b * QL;
    p.lendable = lendable + (size_t)b * RF;
    p.count = cq_count + (size_t)b * QL;
    p.order = cq_order + (size_t)b * QL;
    p.QL = QL; p.RF = RF; p.CL = CL; p.DC = DC; p.K = K; p.F = F; p.R = R;
    p.has_cohort = has_cohort[b] != 0;
    const bool th_act = threshold_active[b] != 0;
    const long long th = threshold[b];
    const short* cq_b = cand_ql + (size_t)b * K;
    const int* ci_b = cand_idx + (size_t)b * K;
    const int* rank_b = cand_rank + (size_t)b * K;

    int nvalid = 0;
    for (int k = lane; k < K; k += 32) nvalid += cq_b[k] >= 0;
    nvalid = sf_warp_sum(nvalid);
    if (nvalid == 0) {
      // no candidate: nothing is ever removed; the heap pops in vain
      // until K when a CQ claims candidates (it never does as encoded)
      bool claims = false;
      for (int q = lane; q < QL; q += 32)
        claims |= p.gq[q] >= 0 && p.count[q] > 0;
      if (__any_sync(SF_FULL, claims) && lane == 0) stats[(size_t)b * 4 + 1] = K;
      continue;
    }

    // 1. the planes, the heap state and the (CQ, rank) table
    for (int q = 0; q < QL; ++q) {
      const int g = p.gq[q] > 0 ? p.gq[q] : 0;
      for (int i = lane; i < RF; i += 32) {
        const int f = p.gf[i];
        const size_t qi = (size_t)q * RF + i;
        const size_t e = ((size_t)g * F + (f > 0 ? f : 0)) * R + p.gr[i];
        s.U[qi] = f >= 0 ? usage[e] : 0;
        s.NOM[qi] = f >= 0 ? nominal[e] : 0;
        s.GUAR[qi] = f >= 0 ? guaranteed[e] : 0;
      }
    }
    for (int c = 0; c < CL; ++c) {
      const int g = gc[(size_t)b * CL + c];
      for (int i = lane; i < RF; i += 32) {
        const int f = p.gf[i];
        const bool v = f >= 0 && g >= 0;
        const size_t ci = (size_t)c * RF + i;
        const size_t e = v ? ((size_t)g * F + f) * R + p.gr[i] : 0;
        s.CU[ci] = v ? cohort_usage[e] : 0;
        s.CG[ci] = v ? cohort_guaranteed[e] : 0;
        s.CSUB[ci] = v ? cohort_subtree[e] : 0;
        s.CBL[ci] = v ? cohort_borrow_limit[e] : SF_NOLIM;
      }
    }
    if (lane == 0) {
      int acc = 0;
      for (int q = 0; q < QL; ++q) {
        s.START[q] = acc;
        acc += p.count[q] > 0 ? p.count[q] : 0;
      }
      s.START[QL] = acc;
    }
    for (int q = lane; q < QL; q += 32) {
      s.POS[q] = 0;
      s.ACT[q] = 1;
      s.FRETRY[q] = -1;
    }
    for (int k = lane; k < K; k += 32) s.TABLE[k] = -1;
    __syncwarp();
    for (int k = lane; k < K; k += 32) {
      const int q = cq_b[k], r = rank_b[k];
      if (q >= 0 && q < QL && r >= 0 && r < p.count[q]) {
        const int slot = s.START[q] + r;
        if (slot < K) s.TABLE[slot] = k;
      }
    }
    __syncwarp();
    for (int q = 0; q < QL; ++q) {
      if (p.gq[q] < 0) continue;  // never eligible: its share is unread
      const long long sh = sf_share(p, s, q, [&](int j) {
        return s.U[(size_t)q * RF + j];
      }, lane);
      if (lane == 0) s.SH[q] = sh;
    }
    long long nom_share =
        sf_share(p, s, 0, [&](int j) { return s.U[j] + p.req[j]; }, lane);
    __syncwarp();

    // 2. the DRF-heap loop
    bool done = false;
    int t = 0, L = 0;
    for (;;) {
      int qstar;
      const bool any = sf_pick(p, s, [&](int q) {
        return s.ACT[q] && p.gq[q] >= 0 && s.POS[q] < p.count[q];
      }, lane, &qstar);
      if (done || !any || t >= K) break;
      const int pos_q = s.POS[qstar];
      int k = -1;
      if (pos_q >= 0 && pos_q < p.count[qstar] && s.START[qstar] + pos_q < K)
        k = s.TABLE[s.START[qstar] + pos_q];
      const bool k_valid = k >= 0;
      const long long* crow = nullptr;
      long long cand_p = 0;
      if (k_valid) {
        crow = cand_usage + (size_t)ci_b[k] * RF;
        cand_p = cand_prio[ci_b[k]];
      }
      const bool own = qstar == 0;
      const long long new_share = sf_share(p, s, qstar, [&](int j) {
        return s.U[(size_t)qstar * RF + j] - (crow ? crow[j] : 0);
      }, lane);
      const bool strat_ok = s0 ? nom_share <= new_share
                               : nom_share < s.SH[qstar];
      const bool passed = own || (th_act && cand_p < th) || strat_ok;
      const bool removes = k_valid && passed;
      __syncwarp();
      if (removes) sf_remove(p, s, qstar, crow, lane);
      if (removes && lane == 0) s.SH[qstar] = new_share;
      __syncwarp();
      if (own && removes)
        nom_share =
            sf_share(p, s, 0, [&](int j) { return s.U[j] + p.req[j]; }, lane);
      if (removes && lane == 0) {
        targets[(size_t)b * K + k] = 1;
        reasons[(size_t)b * K + k] = own ? 0 : (strat_ok ? 1 : 2);
        s.LOG[L] = k;
      }
      if (removes) ++L;
      if (k_valid && !passed && lane == 0 && s.FRETRY[qstar] < 0)
        s.FRETRY[qstar] = k;
      const int new_pos = pos_q + (k_valid ? 1 : 0);
      const bool exhausted = new_pos >= p.count[qstar];
      bool borrowing = false;
      for (int i = lane; i < RF; i += 32)
        borrowing |= p.frs_np[i] && s.U[(size_t)qstar * RF + i] >
                                        s.NOM[(size_t)qstar * RF + i];
      borrowing = __any_sync(SF_FULL, borrowing);
      const bool keep = (own || !removes) ? !exhausted
                                          : (!exhausted && borrowing);
      if (lane == 0) {
        s.POS[qstar] = new_pos;
        if (k_valid) s.ACT[qstar] = keep;
      }
      if (removes) done = sf_fits(p, s, lane);
      ++t;
      __syncwarp();
    }
    const int pops = t;

    // 3. the retry pass: the second strategy, shares fixed at its entry
    if (has_retry && !done) {
      for (int q = 0; q < QL; ++q) {
        if (p.gq[q] < 0) continue;
        const long long sh = sf_share(p, s, q, [&](int j) {
          return s.U[(size_t)q * RF + j];
        }, lane);
        if (lane == 0) s.SH[q] = sh;
      }
      const long long nom_r =
          sf_share(p, s, 0, [&](int j) { return s.U[j] + p.req[j]; }, lane);
      for (int q = lane; q < QL; q += 32) s.ACT[q] = 0;  // processed
      __syncwarp();
      for (int step = 0; step < QL; ++step) {
        int qstar;
        const bool any = sf_pick(p, s, [&](int q) {
          return s.FRETRY[q] >= 0 && !s.ACT[q] && p.gq[q] >= 0;
        }, lane, &qstar);
        if (!any) break;  // every later step is the same no-op
        const int k = s.FRETRY[qstar];
        const bool removes = s1 ? nom_r <= 0 : nom_r < s.SH[qstar];
        __syncwarp();
        if (removes) {
          sf_remove(p, s, qstar, cand_usage + (size_t)ci_b[k] * RF, lane);
          if (lane == 0) {
            targets[(size_t)b * K + k] = 1;
            reasons[(size_t)b * K + k] = 1;
            s.LOG[L] = k;
          }
          ++L;
        }
        if (lane == 0) s.ACT[qstar] = 1;
        __syncwarp();
        if (removes && (done = sf_fits(p, s, lane))) break;
      }
    }

    // 4. feasibility, then fill-back in reverse removal order
    __syncwarp();
    if (!done) {
      for (int j = lane; j < L; j += 32) targets[(size_t)b * K + s.LOG[j]] = 0;
      if (lane == 0) {
        stats[(size_t)b * 4 + 0] = nvalid;
        stats[(size_t)b * 4 + 1] = pops;
      }
      continue;
    }
    int kept = 0;
    for (int j = L - 2; j >= 0; --j) {
      const int k = s.LOG[j];
      const int q = cq_b[k];
      sf_add(p, s, q, cand_usage + (size_t)ci_b[k] * RF, lane);
      if (sf_fits(p, s, lane)) {
        ++kept;
        if (lane == 0) targets[(size_t)b * K + k] = 0;
      } else {
        sf_restore(p, s, q, lane);
      }
    }
    __syncwarp();
    if (lane == 0) {
      feasible[b] = 1;
      stats[(size_t)b * 4 + 0] = nvalid;
      stats[(size_t)b * 4 + 1] = pops;
      stats[(size_t)b * 4 + 2] = L;
      stats[(size_t)b * 4 + 3] = kept;
    }
  }
}

extern "C" int solve_fair_launch(
    const void* nominal, const void* guaranteed, const void* borrow_limit,
    const void* cohort_subtree, const void* cohort_guaranteed,
    const void* cohort_borrow_limit, const void* usage,
    const void* cohort_usage, const void* gq, const void* gf, const void* gr,
    const void* gc, const void* chain_local, const void* requests,
    const void* frs_np, const void* cand_idx, const void* cand_ql,
    const void* cand_usage, const void* cand_prio,
    const void* threshold_active, const void* threshold,
    const void* has_cohort, const void* cand_rank, const void* cq_count,
    const void* cq_order, const void* base_other, const void* floor_ratio,
    const void* floor_any, const void* weight, const void* lendable,
    void* scratch64, void* scratch32, void* targets, void* feasible,
    void* reasons, void* stats, long long B, long long K, long long QL,
    long long RF, long long CL, long long DC, long long F, long long R,
    long long warps, long long s0, long long has_retry, long long s1,
    void* stream) {
  if (B > 0 && K > 0 && warps > 0) {
    const unsigned blocks = (unsigned)((warps + SF_WARPS - 1) / SF_WARPS);
    solve_fair_kernel<<<blocks, SF_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const long long*)nominal, (const long long*)guaranteed,
        (const long long*)borrow_limit, (const long long*)cohort_subtree,
        (const long long*)cohort_guaranteed,
        (const long long*)cohort_borrow_limit, (const long long*)usage,
        (const long long*)cohort_usage, (const int*)gq, (const int*)gf,
        (const int*)gr, (const int*)gc, (const int*)chain_local,
        (const long long*)requests, (const unsigned char*)frs_np,
        (const int*)cand_idx, (const short*)cand_ql,
        (const long long*)cand_usage, (const int*)cand_prio,
        (const unsigned char*)threshold_active, (const long long*)threshold,
        (const unsigned char*)has_cohort, (const int*)cand_rank,
        (const int*)cq_count, (const int*)cq_order,
        (const long long*)base_other, (const long long*)floor_ratio,
        (const unsigned char*)floor_any, (const long long*)weight,
        (const long long*)lendable, (long long*)scratch64, (int*)scratch32,
        (unsigned char*)targets, (unsigned char*)feasible,
        (signed char*)reasons, (int*)stats, (int)B, (int)K, (int)QL, (int)RF,
        (int)CL, (int)DC, (int)F, (int)R, (int)warps, (int)s0,
        (int)has_retry, (int)s1);
  }
  return (int)cudaGetLastError();
}
