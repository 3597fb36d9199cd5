// solve_preempt: batched minimal preemption (minimalPreemptions,
// preemption.go:237-310) for every preempt-mode head of a cycle.
// Replaces kueue_tpu/solver/preempt.py:598 solve_preempt_impl (jit :758)
// with make_problem_sim :307, _avail_cq0_prefix :425, _fits_prefix :468,
// _own_cq_cumsum :481, _chain_flows_fwd :500 and _fillback_ok :539; the
// plain version is kernel.solve_preempt_plain.
//
// Per problem (the JAX package's solver/PREEMPT.md section 2 derives the
// closed forms):
//  1. expand the deduplicated candidate table and gather the problem's
//     quota planes by its global indices (gq, gf, gr, gc);
//  2. the do-mask: a candidate is removed if it is in the preemptor's CQ
//     or its CQ still borrows on a needs-preemption slot after ALL its
//     earlier same-CQ candidates (skipped ones too: the condition is
//     monotone, so the over-subtraction is exact);
//  3. the borrowWithinCohort threshold flip, a running OR;
//  4. each removal's marginal against its CQ's running state, routed up
//     the cohort tree by node DEPTH (a node shared by CQs attached at
//     different depths sees all its arrivals in one step);
//  5. the fit check of every prefix; k* = the first done candidate whose
//     prefix fits;
//  6. the fill-back auction: hi = the eligible set, lo = ok(hi), then
//     rounds of hi' = ok(lo), lo' = ok(hi') until lo == hi or K+2 rounds;
//  7. targets = forward targets minus lo; stats = (candidates, k*+1 or
//     0, rounds, |lo|).
// All arithmetic is int64; limits clamp at 2^61 / 4 as the JAX program's.
//
// Bound on the H100: latency. Each problem is a chain of dependent block
// scans (the per-CQ and per-node prefix sums, then every auction round);
// the bytes (expanded candidate rows, gathered planes, outputs) are small.
// Design: a persistent grid of blocks, each walking problems blockIdx,
// blockIdx + grid, ...; a block's threads own contiguous chunks of the
// candidates, so every per-candidate row is read and written by its owner
// only; a keyed prefix sum (per local CQ, per cohort node) is a masked
// block scan (thread-serial over the chunk, a warp-shuffle scan of the
// thread sums, one more over the warp sums), skipped for keys no
// candidate holds. Per-block scratch in device memory: the candidate
// rows, the flows, and for each chain depth the arrivals and (for the
// preemptor's own chain) the prefix planes, all [K, RF] int64.
//
// With problem slots (the sharded solve, kueue_tpu/parallel/mesh.py:335
// solve over the planner's problem axis), the grid walks slots[0..n) in
// place of problems 0..B: slot s solves problem slots[s] from the full
// arguments and writes its outputs at that problem's row; a padding slot
// (B or -1) writes nothing. Scratch stays the block's own.
#include <climits>
#include "common.cuh"

#define SP_NOLIM (1LL << 61)
#define SP_LIM (SP_NOLIM / 4)

enum : int {
  F_VALID = 1, F_INCQ = 2, F_DO = 4, F_ABK = 8, F_ELIG = 16, F_LO = 32,
  F_HI = 64, F_TMP = 128, F_TFWD = 256
};

struct Prob {
  const long long *nominal, *guaranteed, *borrow_limit, *usage;
  const long long *c_subtree, *c_guar, *c_bl, *cohort_usage;
  const int* cohort_depth;
  const int *gq, *gf, *gr, *gc, *chain;  // chain: [QL][DC] local ids
  const long long* req;
  const unsigned char* frs_np;
  int QL, RF, CL, DC, K, F, R;
  bool has_cohort;
};

// plane(t)[ql, i]: the quota plane of local CQ ql at slot i (0 or `fill`
// on a padding slot; a padding CQ row gathers CQ 0 as the JAX program).
__device__ __forceinline__ long long sp_plane(const Prob& p,
                                              const long long* t, int ql,
                                              int i, long long fill) {
  const int f = p.gf[i];
  if (f < 0) return fill;
  int q = p.gq[ql];
  if (q < 0) q = 0;
  return t[((size_t)q * p.F + f) * p.R + p.gr[i]];
}

__device__ __forceinline__ long long sp_cplane(const Prob& p,
                                               const long long* t, int c,
                                               int i, long long fill) {
  const int f = p.gf[i];
  const int g = p.gc[c];
  if (f < 0 || g < 0) return fill;
  return t[((size_t)g * p.F + f) * p.R + p.gr[i]];
}

__device__ __forceinline__ int sp_dep(const Prob& p, int c) {
  const int g = p.gc[c];
  return g >= 0 ? p.cohort_depth[g] : -1;
}

__device__ __forceinline__ long long sp_min(long long a, long long b) {
  return a < b ? a : b;
}

// Exclusive scan of one int64 per thread, in thread order; *total is the
// block's sum. blockDim.x is a multiple of 32.
__device__ long long block_excl_scan(long long x, long long* total) {
  __shared__ long long warp_tot[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  long long incl = x;
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < nwarps ? warp_tot[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    if (lane < nwarps) warp_tot[lane] = s;
  }
  __syncthreads();
  const long long before = warp > 0 ? warp_tot[warp - 1] : 0;
  *total = warp_tot[nwarps - 1];
  __syncthreads();
  return before + incl - x;
}

// A prefix sum over the candidates in index order: each thread scans its
// chunk [k0, k1). emit(k, excl, x, total) sees candidate k's exclusive
// prefix, its own value and the total; emit may only write k's own rows,
// val(k) only read them.
template <class Val, class Emit>
__device__ void chunk_scan(int k0, int k1, Val val, Emit emit) {
  long long s = 0;
  for (int k = k0; k < k1; ++k) s += val(k);
  long long total;
  long long run = block_excl_scan(s, &total);
  for (int k = k0; k < k1; ++k) {
    const long long x = val(k);
    emit(k, run, x, total);
    run += x;
  }
}

template <class Val>
__device__ long long block_sum(int k0, int k1, Val val) {
  long long s = 0;
  for (int k = k0; k < k1; ++k) s += val(k);
  long long total;
  block_excl_scan(s, &total);
  return total;
}

// workload_fits (preemption.go:576-585) for one hypothesis: u0row(i) is
// the preemptor CQ's usage at slot i, cu(d, i) the usage of the cohort at
// position d of its chain; the availability walks the chain from the
// root end (resource_node.go:89-104).
template <class U0, class CU>
__device__ bool sp_fits(const Prob& p, bool ab, U0 u0row, CU cu) {
  bool borrow_all = true, avail_ok = true;
  for (int i = 0; i < p.RF; ++i) {
    const long long req = p.req[i];
    if (req <= 0) continue;
    const long long u = u0row(i);
    const long long nom0 = sp_plane(p, p.nominal, 0, i, 0);
    if (u + req > nom0) borrow_all = false;
    long long avail;
    if (p.has_cohort) {
      long long parent = 0;
      bool started = false;
      for (int d = p.DC - 1; d >= 0; --d) {
        const int c = p.chain[d];
        if (c < 0) continue;
        const long long cuc = cu(d, i);
        const long long sub = sp_cplane(p, p.c_subtree, c, i, 0);
        const long long gua = sp_cplane(p, p.c_guar, c, i, 0);
        const long long bl = sp_cplane(p, p.c_bl, c, i, SP_NOLIM);
        const long long cap = (sub - gua) - kq_max0(cuc - gua) +
                              sp_min(bl, SP_LIM);
        const long long child = kq_max0(gua - cuc) + sp_min(parent, cap);
        parent = started ? child : sub - cuc;
        started = true;
      }
      const long long guar0 = sp_plane(p, p.guaranteed, 0, i, 0);
      const long long bl0 = sp_plane(p, p.borrow_limit, 0, i, SP_NOLIM);
      const long long cap0 = (nom0 - guar0) - kq_max0(u - guar0) +
                             sp_min(bl0, SP_LIM);
      avail = kq_max0(guar0 - u) + sp_min(parent, cap0);
    } else {
      avail = nom0 - u;
    }
    if (req > avail) avail_ok = false;
  }
  return (ab || borrow_all) && avail_ok;
}

struct Scratch {
  long long *V, *T, *FL, *ARR, *INC, *UF, *CUF;
  int *CQ, *PRIO, *ED, *FLAGS, *CUR, *NODE;
};

// One fill-back round (_fillback_ok): for every eligible candidate, would
// the reverse greedy take it back given that exactly the candidates
// marked `mbit` (those after it) came back first? Sets `obit` to the
// answer. RIN and OWN (the member arrivals strictly after the candidate,
// and its own arrival, at each node of the preemptor's chain) reuse the
// forward pass's ARR and INC rows.
__device__ void sp_fillback_ok(const Prob& p, const Scratch& s, int k0,
                               int k1, int mbit, int obit, bool ab_fb) {
  const int K = p.K, RF = p.RF, DC = p.DC;
  long long* RIN = s.ARR;
  long long* OWN = s.INC;
  // the CQ-level add marginal against the member suffix of its own CQ
  for (int k = k0; k < k1; ++k)
    for (int i = 0; i < RF; ++i) s.T[(size_t)k * RF + i] = 0;
  for (int q = 0; q < p.QL; ++q) {
    bool here = false;
    for (int k = k0; k < k1; ++k) here |= s.CQ[k] == q;
    if (!__syncthreads_or(here)) continue;
    for (int i = 0; i < RF; ++i)
      chunk_scan(k0, k1,
          [&](int k) -> long long {
            return (s.CQ[k] == q && (s.FLAGS[k] & mbit))
                       ? s.V[(size_t)k * RF + i] : 0;
          },
          [&](int k, long long ex, long long x, long long tot) {
            if (s.CQ[k] == q) s.T[(size_t)k * RF + i] = tot - ex - x;
          });
  }
  for (int k = k0; k < k1; ++k) {
    const int qs = s.CQ[k] > 0 ? s.CQ[k] : 0;
    for (int i = 0; i < RF; ++i) {
      const size_t ki = (size_t)k * RF + i;
      const long long tp = s.UF[qs * RF + i] + s.T[ki] -
                           sp_plane(p, p.guaranteed, qs, i, 0);
      s.FL[ki] = kq_max0(tp + s.V[ki]) - kq_max0(tp);
    }
    for (int d = 0; d < DC; ++d)
      for (int i = 0; i < RF; ++i) {
        const size_t di = ((size_t)d * K + k) * RF + i;
        RIN[di] = 0;
        OWN[di] = 0;
      }
  }
  for (int dlt = DC - 1; dlt >= 0; --dlt) {
    for (int k = k0; k < k1; ++k) {
      const int e = s.ED[k];
      int node = -1;
      if (e >= 0 && e - dlt >= 0 && (s.FLAGS[k] & F_ELIG)) {
        const int qs = s.CQ[k] > 0 ? s.CQ[k] : 0;
        int pos = e - dlt;
        if (pos > DC - 1) pos = DC - 1;
        const int nd = p.chain[qs * DC + pos];
        if (nd >= 0) node = nd;
      }
      s.CUR[k] = node;
    }
    for (int c = 0; c < p.CL; ++c) {
      bool here = false;
      for (int k = k0; k < k1; ++k) here |= s.CUR[k] == c;
      if (!__syncthreads_or(here)) continue;
      const bool rin = sp_dep(p, c) == dlt;
      for (int i = 0; i < RF; ++i) {
        const long long cuf = s.CUF[c * RF + i];
        const long long cg = sp_cplane(p, p.c_guar, c, i, 0);
        chunk_scan(k0, k1,
            [&](int k) -> long long {
              return (s.CUR[k] == c && (s.FLAGS[k] & mbit))
                         ? s.FL[(size_t)k * RF + i] : 0;
            },
            [&](int k, long long ex, long long x, long long tot) {
              const long long rex = tot - ex - x;  // members after k
              const size_t ki = (size_t)k * RF + i;
              const bool at = s.CUR[k] == c;
              for (int d = 0; d < DC; ++d) {
                if (p.chain[d] != c) continue;
                const size_t di = ((size_t)d * K + k) * RF + i;
                if (rin) RIN[di] = rex;
                if (at) OWN[di] = s.FL[ki];
              }
              if (at) {
                const long long local_c = kq_max0(cg - (cuf + rex));
                s.FL[ki] = kq_max0(s.FL[ki] - local_c);
              }
            });
      }
    }
  }
  // the preemptor CQ's row: members of CQ 0 after k, plus k itself
  for (int i = 0; i < RF; ++i)
    chunk_scan(k0, k1,
        [&](int k) -> long long {
          return (s.CQ[k] == 0 && (s.FLAGS[k] & mbit))
                     ? s.V[(size_t)k * RF + i] : 0;
        },
        [&](int k, long long ex, long long x, long long tot) {
          s.T[(size_t)k * RF + i] = tot - ex - x;
        });
  for (int k = k0; k < k1; ++k) {
    bool ok = false;
    if (s.FLAGS[k] & F_ELIG) {
      const bool in0 = s.CQ[k] == 0;
      ok = sp_fits(p, ab_fb,
          [&](int i) {
            const size_t ki = (size_t)k * RF + i;
            return s.UF[i] + s.T[ki] + (in0 ? s.V[ki] : 0);
          },
          [&](int d, int i) {
            const size_t di = ((size_t)d * K + k) * RF + i;
            return s.CUF[p.chain[d] * RF + i] + RIN[di] + OWN[di];
          });
    }
    s.FLAGS[k] = ok ? (s.FLAGS[k] | obit) : (s.FLAGS[k] & ~obit);
  }
}

__global__ void solve_preempt_kernel(
    const long long* __restrict__ nominal,
    const long long* __restrict__ guaranteed,
    const long long* __restrict__ borrow_limit,
    const long long* __restrict__ cohort_subtree,
    const long long* __restrict__ cohort_guaranteed,
    const long long* __restrict__ cohort_borrow_limit,
    const int* __restrict__ cohort_depth, const long long* __restrict__ usage,
    const long long* __restrict__ cohort_usage, const int* __restrict__ gq,
    const int* __restrict__ gf, const int* __restrict__ gr,
    const int* __restrict__ gc, const int* __restrict__ chain_local,
    const long long* __restrict__ requests,
    const unsigned char* __restrict__ frs_np,
    const int* __restrict__ cand_idx, const short* __restrict__ cand_ql,
    const long long* __restrict__ cand_usage,
    const int* __restrict__ cand_prio,
    const unsigned char* __restrict__ allow_borrowing,
    const unsigned char* __restrict__ threshold_active,
    const long long* __restrict__ threshold,
    const unsigned char* __restrict__ has_cohort, long long* scratch64,
    int* scratch32, unsigned char* __restrict__ targets,
    unsigned char* __restrict__ feasible, int* __restrict__ stats,
    const int* __restrict__ slots, int n_slots, int B, int K, int QL, int RF,
    int CL, int DC, int F, int R) {
  __shared__ int s_kstar;
  __shared__ int s_abk;
  const int T = blockDim.x;
  const int ipt = (K + T - 1) / T;
  const int k0 = min(K, (int)threadIdx.x * ipt);
  const int k1 = min(K, k0 + ipt);

  const size_t KR = (size_t)K * RF;
  const size_t wide = (3 + 2 * (size_t)DC) * KR + (size_t)(QL + CL) * RF;
  Scratch s;
  s.V = scratch64 + blockIdx.x * wide;
  s.T = s.V + KR;
  s.FL = s.T + KR;
  s.ARR = s.FL + KR;
  s.INC = s.ARR + DC * KR;
  s.UF = s.INC + DC * KR;
  s.CUF = s.UF + (size_t)QL * RF;
  s.CQ = scratch32 + blockIdx.x * (size_t)(5 + DC) * K;
  s.PRIO = s.CQ + K;
  s.ED = s.PRIO + K;
  s.FLAGS = s.ED + K;
  s.CUR = s.FLAGS + K;
  s.NODE = s.CUR + K;

  for (int slot = blockIdx.x; slot < n_slots; slot += gridDim.x) {
    const int b = slots ? slots[slot] : slot;
    if (b < 0 || b >= B) continue;  // a padding slot: uniform over the block
    Prob p;
    p.nominal = nominal; p.guaranteed = guaranteed;
    p.borrow_limit = borrow_limit; p.usage = usage;
    p.c_subtree = cohort_subtree; p.c_guar = cohort_guaranteed;
    p.c_bl = cohort_borrow_limit; p.cohort_usage = cohort_usage;
    p.cohort_depth = cohort_depth;
    p.gq = gq + (size_t)b * QL;
    p.gf = gf + (size_t)b * RF;
    p.gr = gr + (size_t)b * RF;
    p.gc = gc + (size_t)b * CL;
    p.chain = chain_local + (size_t)b * QL * DC;
    p.req = requests + (size_t)b * RF;
    p.frs_np = frs_np + (size_t)b * RF;
    p.QL = QL; p.RF = RF; p.CL = CL; p.DC = DC; p.K = K; p.F = F; p.R = R;
    p.has_cohort = has_cohort[b] != 0;
    const bool ab0 = allow_borrowing[b] != 0;
    const bool th_act = threshold_active[b] != 0;
    const long long th = threshold[b];

    // 1. candidates: the table rows expanded, the flags
    for (int k = k0; k < k1; ++k) {
      const int q = cand_ql[(size_t)b * K + k];
      const int u = cand_idx[(size_t)b * K + k];
      s.CQ[k] = q;
      s.PRIO[k] = cand_prio[u];
      s.FLAGS[k] = (q >= 0 ? F_VALID : 0) | (q == 0 ? F_INCQ : 0);
      for (int i = 0; i < RF; ++i) {
        s.V[(size_t)k * RF + i] = q >= 0 ? cand_usage[(size_t)u * RF + i] : 0;
        s.T[(size_t)k * RF + i] = 0;
      }
    }
    // 2. the do-mask: the CQ borrows after all its earlier candidates
    for (int q = 0; q < QL; ++q) {
      bool here = false;
      for (int k = k0; k < k1; ++k) here |= s.CQ[k] == q;
      if (!__syncthreads_or(here)) continue;
      for (int i = 0; i < RF; ++i)
        chunk_scan(k0, k1,
            [&](int k) -> long long {
              return s.CQ[k] == q ? s.V[(size_t)k * RF + i] : 0;
            },
            [&](int k, long long ex, long long, long long) {
              if (s.CQ[k] == q) s.T[(size_t)k * RF + i] = ex;
            });
    }
    for (int k = k0; k < k1; ++k) {
      const int qs = s.CQ[k] > 0 ? s.CQ[k] : 0;
      bool borrowing = false;
      for (int i = 0; i < RF; ++i)
        if (p.frs_np[i] && sp_plane(p, usage, qs, i, 0) -
                                   s.T[(size_t)k * RF + i] >
                               sp_plane(p, nominal, qs, i, 0))
          borrowing = true;
      const int fl = s.FLAGS[k];
      if ((fl & F_VALID) && ((fl & F_INCQ) || borrowing))
        s.FLAGS[k] = fl | F_DO;
    }
    // 3. the threshold flip, inclusive of the candidate's own
    chunk_scan(k0, k1,
        [&](int k) -> long long {
          const int fl = s.FLAGS[k];
          return (th_act && !(fl & F_INCQ) && (fl & F_DO) &&
                  (long long)s.PRIO[k] >= th) ? 1 : 0;
        },
        [&](int k, long long ex, long long x, long long) {
          if (ab0 && ex + x == 0) s.FLAGS[k] |= F_ABK;
        });
    // 4. removal marginals against each CQ's running state
    for (int k = k0; k < k1; ++k)
      for (int i = 0; i < RF; ++i) s.T[(size_t)k * RF + i] = 0;
    for (int q = 0; q < QL; ++q) {
      bool here = false;
      for (int k = k0; k < k1; ++k) here |= s.CQ[k] == q;
      if (!__syncthreads_or(here)) continue;
      for (int i = 0; i < RF; ++i)
        chunk_scan(k0, k1,
            [&](int k) -> long long {
              return (s.CQ[k] == q && (s.FLAGS[k] & F_DO))
                         ? s.V[(size_t)k * RF + i] : 0;
            },
            [&](int k, long long ex, long long, long long) {
              if (s.CQ[k] == q) s.T[(size_t)k * RF + i] = ex;
            });
    }
    for (int k = k0; k < k1; ++k) {
      const int qs = s.CQ[k] > 0 ? s.CQ[k] : 0;
      const bool dk = s.FLAGS[k] & F_DO;
      for (int i = 0; i < RF; ++i) {
        const size_t ki = (size_t)k * RF + i;
        s.FL[ki] = dk ? sp_min(s.V[ki],
                               kq_max0(sp_plane(p, usage, qs, i, 0) -
                                       sp_plane(p, guaranteed, qs, i, 0) -
                                       s.T[ki]))
                      : 0;
      }
      const int first = p.chain[qs * DC];
      s.ED[k] = (first >= 0 && dk) ? sp_dep(p, first) : -1;
    }
    // 5. the flows up the tree, deepest nodes first
    for (int dlt = DC - 1; dlt >= 0; --dlt) {
      int* node_d = s.NODE + (size_t)dlt * K;
      long long* arr_d = s.ARR + dlt * KR;
      for (int k = k0; k < k1; ++k) {
        const int e = s.ED[k];
        int node = -1;
        if (e >= 0 && e - dlt >= 0) {
          const int qs = s.CQ[k] > 0 ? s.CQ[k] : 0;
          int pos = e - dlt;
          if (pos > DC - 1) pos = DC - 1;
          const int nd = p.chain[qs * DC + pos];
          if (nd >= 0) node = nd;
        }
        node_d[k] = node;
        for (int i = 0; i < RF; ++i)
          arr_d[(size_t)k * RF + i] = node >= 0 ? s.FL[(size_t)k * RF + i] : 0;
      }
      for (int c = 0; c < CL; ++c) {
        bool here = false;
        for (int k = k0; k < k1; ++k) here |= node_d[k] == c;
        if (!__syncthreads_or(here)) continue;
        for (int i = 0; i < RF; ++i) {
          const long long s0 = sp_cplane(p, cohort_usage, c, i, 0) -
                               sp_cplane(p, cohort_guaranteed, c, i, 0);
          chunk_scan(k0, k1,
              [&](int k) -> long long {
                return node_d[k] == c ? s.FL[(size_t)k * RF + i] : 0;
              },
              [&](int k, long long ex, long long x, long long) {
                if (node_d[k] == c)
                  s.FL[(size_t)k * RF + i] = sp_min(x, kq_max0(s0 - ex));
              });
        }
      }
    }
    // 6. the arrivals at the preemptor's chain nodes over every prefix
    for (int d = 0; d < DC; ++d) {
      const int c = p.chain[d];
      if (c < 0) continue;
      const int dep = sp_dep(p, c);
      long long* inc_d = s.INC + d * KR;
      if (dep < 0 || dep >= DC) {
        for (int k = k0; k < k1; ++k)
          for (int i = 0; i < RF; ++i) inc_d[(size_t)k * RF + i] = 0;
        continue;
      }
      const int* node_e = s.NODE + (size_t)dep * K;
      const long long* arr_e = s.ARR + dep * KR;
      for (int i = 0; i < RF; ++i)
        chunk_scan(k0, k1,
            [&](int k) -> long long {
              return node_e[k] == c ? arr_e[(size_t)k * RF + i] : 0;
            },
            [&](int k, long long ex, long long x, long long) {
              inc_d[(size_t)k * RF + i] = ex + x;
            });
    }
    // 7. the fit of every prefix, and the first that fits
    for (int i = 0; i < RF; ++i) {
      const long long u00 = sp_plane(p, usage, 0, i, 0);
      chunk_scan(k0, k1,
          [&](int k) -> long long {
            const int fl = s.FLAGS[k];
            return ((fl & F_DO) && (fl & F_INCQ)) ? s.V[(size_t)k * RF + i] : 0;
          },
          [&](int k, long long ex, long long x, long long) {
            s.T[(size_t)k * RF + i] = u00 - (ex + x);
          });
    }
    if (threadIdx.x == 0) s_kstar = INT_MAX;
    __syncthreads();
    for (int k = k0; k < k1; ++k) {
      if (!(s.FLAGS[k] & F_DO)) continue;
      const bool fit = sp_fits(p, (s.FLAGS[k] & F_ABK) != 0,
          [&](int i) { return s.T[(size_t)k * RF + i]; },
          [&](int d, int i) {
            return sp_cplane(p, cohort_usage, p.chain[d], i, 0) -
                   s.INC[d * KR + (size_t)k * RF + i];
          });
      if (fit) {
        atomicMin(&s_kstar, k);
        break;  // this thread's first; later ones are larger
      }
    }
    __syncthreads();
    const bool done = s_kstar < K;
    const int kstar = done ? s_kstar : 0;
    for (int k = k0; k < k1; ++k) {
      int fl = s.FLAGS[k];
      if ((fl & F_DO) && k <= kstar && done) {
        fl |= F_TFWD;
        if (k != kstar) fl |= F_ELIG;
      }
      s.FLAGS[k] = fl;
      if (k == kstar) s_abk = (fl & F_ABK) != 0;
    }
    __syncthreads();
    const bool ab_fb = done ? s_abk != 0 : ab0;
    // 8. the state after the forward removals: each local CQ's row and
    // each local cohort's, at k*
    for (int q = 0; q < QL; ++q) {
      bool here = false;
      for (int k = k0; k < k1; ++k) here |= s.CQ[k] == q;
      const bool any = __syncthreads_or(here) && done;
      for (int i = 0; i < RF; ++i) {
        long long removed = 0;
        if (any)
          removed = block_sum(k0, k1, [&](int k) -> long long {
            return (s.CQ[k] == q && (s.FLAGS[k] & F_DO) && k <= kstar)
                       ? s.V[(size_t)k * RF + i] : 0;
          });
        if (threadIdx.x == 0)
          s.UF[q * RF + i] = sp_plane(p, usage, q, i, 0) - removed;
      }
    }
    for (int c = 0; c < CL; ++c) {
      const int dep = sp_dep(p, c);
      const bool any = done && dep >= 0 && dep < DC;
      const int* node_e = s.NODE + (size_t)(any ? dep : 0) * K;
      const long long* arr_e = s.ARR + (any ? dep : 0) * KR;
      for (int i = 0; i < RF; ++i) {
        long long in_star = 0;
        if (any)
          in_star = block_sum(k0, k1, [&](int k) -> long long {
            return (node_e[k] == c && k <= kstar)
                       ? arr_e[(size_t)k * RF + i] : 0;
          });
        if (threadIdx.x == 0)
          s.CUF[c * RF + i] = sp_cplane(p, cohort_usage, c, i, 0) - in_star;
      }
    }
    for (int k = k0; k < k1; ++k) {
      if (!(s.FLAGS[k] & F_ELIG)) s.ED[k] = -1;
      s.FLAGS[k] = (s.FLAGS[k] & ~(F_LO | F_HI | F_TMP)) |
                   ((s.FLAGS[k] & F_ELIG) ? F_HI : 0);
    }
    __syncthreads();
    // 9. the fill-back auction rounds
    sp_fillback_ok(p, s, k0, k1, F_HI, F_LO, ab_fb);
    int rounds = 1;
    for (;;) {
      bool differ = false;
      for (int k = k0; k < k1; ++k)
        differ |= ((s.FLAGS[k] & F_LO) != 0) != ((s.FLAGS[k] & F_HI) != 0);
      if (!__syncthreads_or(differ) || rounds >= K + 2) break;
      sp_fillback_ok(p, s, k0, k1, F_LO, F_TMP, ab_fb);   // hi' = ok(lo)
      sp_fillback_ok(p, s, k0, k1, F_TMP, F_LO, ab_fb);   // lo' = ok(hi')
      for (int k = k0; k < k1; ++k)
        s.FLAGS[k] = (s.FLAGS[k] & ~F_HI) | ((s.FLAGS[k] & F_TMP) ? F_HI : 0);
      ++rounds;
    }
    // 10. outputs
    for (int k = k0; k < k1; ++k) {
      const int fl = s.FLAGS[k];
      targets[(size_t)b * K + k] = (fl & F_TFWD) && !(fl & F_LO);
    }
    const long long nvalid = block_sum(k0, k1, [&](int k) -> long long {
      return (s.FLAGS[k] & F_VALID) ? 1 : 0;
    });
    const long long nback = block_sum(k0, k1, [&](int k) -> long long {
      return (s.FLAGS[k] & F_LO) ? 1 : 0;
    });
    if (threadIdx.x == 0) {
      feasible[b] = done;
      stats[(size_t)b * 4 + 0] = (int)nvalid;
      stats[(size_t)b * 4 + 1] = done ? kstar + 1 : 0;
      stats[(size_t)b * 4 + 2] = rounds;
      stats[(size_t)b * 4 + 3] = (int)nback;
    }
    __syncthreads();
  }
}

extern "C" int solve_preempt_launch(
    const void* nominal, const void* guaranteed, const void* borrow_limit,
    const void* cohort_subtree, const void* cohort_guaranteed,
    const void* cohort_borrow_limit, const void* cohort_depth,
    const void* usage, const void* cohort_usage, const void* gq,
    const void* gf, const void* gr, const void* gc, const void* chain_local,
    const void* requests, const void* frs_np, const void* cand_idx,
    const void* cand_ql, const void* cand_usage, const void* cand_prio,
    const void* allow_borrowing, const void* threshold_active,
    const void* threshold, const void* has_cohort, void* scratch64,
    void* scratch32, void* targets, void* feasible, void* stats,
    const void* slots, long long n_slots, long long B, long long K,
    long long QL, long long RF, long long CL, long long DC, long long F,
    long long R, long long grid, void* stream) {
  if (n_slots > 0 && K > 0) {
    long long threads = (K + 31) / 32 * 32;
    if (threads > 256) threads = 256;
    solve_preempt_kernel<<<(unsigned)grid, (unsigned)threads, 0,
                           (cudaStream_t)stream>>>(
        (const long long*)nominal, (const long long*)guaranteed,
        (const long long*)borrow_limit, (const long long*)cohort_subtree,
        (const long long*)cohort_guaranteed,
        (const long long*)cohort_borrow_limit, (const int*)cohort_depth,
        (const long long*)usage, (const long long*)cohort_usage,
        (const int*)gq, (const int*)gf, (const int*)gr, (const int*)gc,
        (const int*)chain_local, (const long long*)requests,
        (const unsigned char*)frs_np, (const int*)cand_idx,
        (const short*)cand_ql, (const long long*)cand_usage,
        (const int*)cand_prio, (const unsigned char*)allow_borrowing,
        (const unsigned char*)threshold_active, (const long long*)threshold,
        (const unsigned char*)has_cohort, (long long*)scratch64,
        (int*)scratch32, (unsigned char*)targets, (unsigned char*)feasible,
        (int*)stats, (const int*)slots, (int)n_slots, (int)B, (int)K,
        (int)QL, (int)RF, (int)CL, (int)DC, (int)F, (int)R);
  }
  return (int)cudaGetLastError();
}
