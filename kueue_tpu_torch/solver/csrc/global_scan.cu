// global_scan: the global W-step admit scan, the test oracle of the cycle.
// Replaces the lax.scan of kueue_tpu/solver/kernel.py:250 solve_cycle_impl
// (admit_step :279-303, with :82 _chain_avail and :106 _chain_add_usage).
//
// One thread block walks the global admit order, one workload a step, as
// the scan does: the step's CQ availability (its cohort chain walked from
// the root down, then the CQ's own level), "still fits" as a vote of the
// lanes, then the admitted usage added to the CQ row and the chain's
// over-guaranteed part bubbled up level by level. The steps form one
// dependent chain across every conflict domain, so there is one block,
// a thread per (f, r) lane; a lane only ever reads and writes its own
// (f, r) column of usage and cohort_usage, so the lanes share nothing but
// the step's decision. A workload that did not fit never admits (admit =
// fit & still_fits).
//
// Bound on the H100: latency, one dependent step a fit workload. Only
// usage and cohort_usage depend on earlier steps; every index and every
// quota is known before the walk. So:
// - a prologue, in the same launch, compacts the fit steps of `order`
//   (a block-wide scan, the order kept) into a scratch list of (w, q,
//   has_cohort, chain): the non-fit steps cost nothing and the index
//   chain order -> fit -> wl_cq -> cq_chain leaves the step;
// - cohort_usage lives in shared memory for the whole walk where C*F*R*8
//   bytes fit (the "shared" form; kernel.global_scan_plan), else in
//   global memory (the "global" form);
// - the register form (F*R <= 256, chains of at most 8 levels): a thread
//   a lane walks, holding the next fit step's constants in registers (its
//   assignment, the CQ's quota, the chain's subtree, guaranteed and limit,
//   and its usage[q] value, forwarded when the next step's CQ is this
//   one's), loaded while this step runs, and the list entry two steps
//   ahead. A step is then the chain state's reads, the chain's dependent
//   arithmetic, one vote (__all_sync for one warp of lanes, else a
//   barrier's AND over the walking warps) and the writes, with selects
//   and predicated stores in place of branches, so that the compiler
//   interleaves the next step's loads and addresses with this step's
//   chain (a step took ~0.72 of the branching version's time on the
//   H100). Past those shapes every thread walks, looping over the
//   columns, and loads a step's constants in the step, still from the
//   compacted list.
#include "common.cuh"

#define KQ_SCAN_FULL 0xffffffffu

// The compacted fit steps: the prologue's list in a scratch of
// W * (3 + DC) ints.
struct KqScanList {
  int* w;      // [W]: the workload
  int* q;      // [W]: its CQ
  int* hc;     // [W]: whether the CQ has a cohort
  int* chain;  // [W * DC]: the CQ's cq_chain row
};

// Stable compaction of order's fit steps into `list`; returns their
// count. Each thread takes a contiguous segment of order: it counts its
// fit steps, a block scan gives each segment its first slot, and the
// segment writes its steps there, so the list keeps order's order.
__device__ int kq_scan_prologue(
    const unsigned char* __restrict__ fit, const int* __restrict__ wl_cq,
    const int* __restrict__ order, const int* __restrict__ cq_cohort,
    const int* __restrict__ cq_chain, KqScanList list, int W, int DC) {
  __shared__ int warp_sums[32];
  const int T = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5, warps = (T + 31) >> 5;
  const int per = (W + T - 1) / T;
  const int lo = min(W, t * per), hi = min(W, lo + per);
  int count = 0;
  for (int i0 = lo; i0 < hi; i0 += 8) {
    int w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = i0 + j < hi ? order[i0 + j] : -1;
#pragma unroll
    for (int j = 0; j < 8; ++j) count += w[j] >= 0 && fit[w[j]];
  }
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(KQ_SCAN_FULL, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int x = lane < warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(KQ_SCAN_FULL, x, o);
      if (lane >= o) x += y;
    }
    warp_sums[lane] = x;
  }
  __syncthreads();
  int slot = incl - count + (warp ? warp_sums[warp - 1] : 0);
  const int total = warp_sums[warps - 1];
  for (int i0 = lo; i0 < hi; i0 += 8) {
    int w[8], q[8];
    bool f[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = i0 + j < hi ? order[i0 + j] : -1;
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = w[j] >= 0 && fit[w[j]];
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = f[j] ? wl_cq[w[j]] : 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!f[j]) continue;
      list.w[slot] = w[j];
      list.q[slot] = q[j];
      list.hc[slot] = cq_cohort[q[j]] >= 0;
      for (int d = 0; d < DC; ++d)
        list.chain[(size_t)slot * DC + d] = cq_chain[(size_t)q[j] * DC + d];
      ++slot;
    }
  }
  __syncthreads();  // the list is the block's
  return total;
}

// A list entry with its chain, up to DCT levels (-1 past the root).
template <int DCT> struct KqScanEntry {
  int w, q, hc;
  int chain[DCT];
};

// A lane's constants of one step: its assignment, the CQ's quota and
// usage, the chain levels' subtree, guaranteed and borrow limit.
template <int DCT> struct KqScanConst {
  long long au, nom, guar, blim, uq;
  long long sub[DCT], cg[DCT], cl[DCT];
};

// The AND of `pred` over the first `threads` threads of the block, on
// barrier 1 (the others do not take part).
__device__ __forceinline__ bool kq_bar_and(bool pred, int threads) {
  int out;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.s32 p, %1, 0;\n\t"
      "bar.red.and.pred q, 1, %2, p;\n\t"
      "selp.s32 %0, 1, 0, q;\n\t}"
      : "=r"(out) : "r"((int)pred), "r"(threads) : "memory");
  return out != 0;
}

template <int DCT>
__device__ __forceinline__ KqScanEntry<DCT> kq_scan_entry(
    const KqScanList& list, int n, int DC) {
  KqScanEntry<DCT> e;
  e.w = list.w[n];
  e.q = list.q[n];
  e.hc = list.hc[n];
#pragma unroll
  for (int d = 0; d < DCT; ++d)
    e.chain[d] = d < DC ? list.chain[(size_t)n * DC + d] : -1;
  return e;
}

// Every load of a lane's constants of a step is independent of the
// others and of the walk's state but usage[q] (read before this step's
// write: the caller forwards it when the CQs match). A column past F*R,
// or a chain level past the root, reads zeros.
template <int DCT>
__device__ __forceinline__ KqScanConst<DCT> kq_scan_const(
    const KqScanEntry<DCT>& e, int col, int FR,
    const long long* __restrict__ asg, const long long* __restrict__ nominal,
    const long long* __restrict__ guaranteed,
    const long long* __restrict__ borrow_limit, const long long* usage,
    const long long* __restrict__ cohort_subtree,
    const long long* __restrict__ cohort_guaranteed,
    const long long* __restrict__ cohort_borrow_limit) {
  KqScanConst<DCT> c;
  const bool act = col < FR;
  const size_t qe = (size_t)e.q * FR + col;
  c.au = act ? asg[(size_t)e.w * FR + col] : 0;
  c.nom = act ? nominal[qe] : 0;
  c.guar = act ? guaranteed[qe] : 0;
  c.blim = act ? borrow_limit[qe] : 0;
  c.uq = act ? usage[qe] : 0;
#pragma unroll
  for (int d = 0; d < DCT; ++d) {
    const bool on = act && e.chain[d] >= 0;
    const size_t ce = (size_t)(on ? e.chain[d] : 0) * FR + col;
    c.sub[d] = on ? cohort_subtree[ce] : 0;
    c.cg[d] = on ? cohort_guaranteed[ce] : 0;
    c.cl[d] = on ? cohort_borrow_limit[ce] : 0;
  }
  return c;
}

// A lane's availability test of one column (still_fits: au == 0 or au <=
// avail_q, _chain_avail from the root, the first valid entry from the
// end, down); the chain's cohort_usage values it read go to cu for the
// update. Selects, not branches, so that the compiler may interleave the
// next step's loads with this chain.
template <int D>
__device__ __forceinline__ bool kq_scan_fits(
    const KqScanEntry<D>& e, const KqScanConst<D>& c, const long long* state,
    int FR, int col, long long (&cu)[D]) {
  long long parent = 0;
  bool started = false;
#pragma unroll
  for (int d = D - 1; d >= 0; --d) {
    const int k = e.chain[d];
    const bool valid = k >= 0;
    // a lane past F*R reads nothing: its row would be the next cohort's
    cu[d] = valid && col < FR ? state[(size_t)k * FR + col] : 0;
    const long long level =
        started ? kq_avail_level(c.sub[d], c.cg[d], c.cl[d], cu[d], parent)
                : c.sub[d] - cu[d];
    parent = valid ? level : parent;
    started = started || valid;
  }
  const long long avail =
      e.hc ? kq_avail_level(c.nom, c.guar, c.blim, c.uq, parent)
           : c.nom - c.uq;
  return c.au == 0 || c.au <= avail;
}

// The admit of one column when `write`: the CQ's usage, then
// _chain_add_usage of the over-guaranteed delta. Returns the CQ's usage
// after the step were it admitted (uq + au).
template <int D>
__device__ __forceinline__ long long kq_scan_admit(
    const KqScanEntry<D>& e, const KqScanConst<D>& c, long long* state,
    long long* usage, int FR, int col, const long long (&cu)[D],
    bool write) {
  const long long nq = c.uq + c.au;
  if (write) usage[(size_t)e.q * FR + col] = nq;
  long long delta = kq_max0(nq - c.guar) - kq_max0(c.uq - c.guar);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int k = e.chain[d];
    const long long nc = cu[d] + delta;
    if (write && k >= 0) state[(size_t)k * FR + col] = nc;
    delta = kq_max0(nc - c.cg[d]) - kq_max0(cu[d] - c.cg[d]);
  }
  return nq;
}

// DCT > 0: the register form. The block's threads run the prologue; the
// first NL = F*R rounded up to a warp walk, a lane a column, a chain of
// <= DCT levels. DCT == 0: the looping form (any F*R and chain): every
// thread walks, a lane a column at a time, voting with __syncthreads_and
// (or __all_sync when the block is one warp). SHARED: cohort_usage in
// dynamic shared memory for the walk.
template <int DCT, bool SHARED>
__global__ void __launch_bounds__(DCT == 0 ? 1024 : 256) global_scan_kernel(
    const int* __restrict__ cq_cohort, const int* __restrict__ cq_chain,
    const long long* __restrict__ nominal,
    const long long* __restrict__ guaranteed,
    const long long* __restrict__ borrow_limit,
    const long long* __restrict__ cohort_subtree,
    const long long* __restrict__ cohort_guaranteed,
    const long long* __restrict__ cohort_borrow_limit,
    long long* usage, long long* cohort_usage,
    const long long* __restrict__ asg, const unsigned char* __restrict__ fit,
    const int* __restrict__ wl_cq, const int* __restrict__ order,
    unsigned char* __restrict__ admitted, int* steps, int W, int FR, int DC,
    int C) {
  extern __shared__ long long kq_scan_smem[];
  const int T = blockDim.x, t = threadIdx.x;
  const KqScanList list = {steps, steps + W, steps + 2 * W, steps + 3 * W};
  long long* state = SHARED ? kq_scan_smem : cohort_usage;
  if (SHARED)
    for (int i = t; i < C * FR; i += T) state[i] = cohort_usage[i];
  const int nfit = kq_scan_prologue(fit, wl_cq, order, cq_cohort, cq_chain,
                                    list, W, DC);

  if constexpr (DCT > 0) {
    const int NL = (FR + 31) & ~31;
    if (t < NL) {
      const int col = t;
#define KQ_CONST(e)                                                        \
  kq_scan_const<DCT>(e, col, FR, asg, nominal, guaranteed, borrow_limit,   \
                     usage, cohort_subtree, cohort_guaranteed,             \
                     cohort_borrow_limit)
      KqScanEntry<DCT> e_cur, e_nxt, e_far;
      KqScanConst<DCT> c_cur, c_nxt;
      // the value of usage[q] this step wrote, for the next step when its
      // CQ is this one's: its copy was loaded before the write
      bool fv = false;
      long long fq = 0;
      if (nfit > 0) {
        e_nxt = kq_scan_entry<DCT>(list, 0, DC);
        c_nxt = KQ_CONST(e_nxt);
        e_far = kq_scan_entry<DCT>(list, min(1, nfit - 1), DC);
      }
      for (int n = 0; n < nfit; ++n) {
        e_cur = e_nxt;
        c_cur = c_nxt;
        if (fv) c_cur.uq = fq;
        // the next step's constants load while this step runs, the list
        // entry after it too (past the last step, the last step's again:
        // no branch between them and this step's chain)
        e_nxt = e_far;
        c_nxt = KQ_CONST(e_nxt);
        e_far = kq_scan_entry<DCT>(list, min(n + 2, nfit - 1), DC);
        long long cu[DCT];
        const bool fits = kq_scan_fits<DCT>(e_cur, c_cur, state, FR, col, cu);
        const bool admit = NL == 32 ? __all_sync(KQ_SCAN_FULL, fits)
                                    : kq_bar_and(fits, NL);
        fq = kq_scan_admit<DCT>(e_cur, c_cur, state, usage, FR, col, cu,
                                admit && c_cur.au != 0);
        fv = admit && e_nxt.q == e_cur.q;
        if (admit && t == 0) admitted[e_cur.w] = 1;
      }
#undef KQ_CONST
    }
  } else {
    const bool warp_vote = T == 32;
    for (int n = 0; n < nfit; ++n) {
      const int w = list.w[n], q = list.q[n];
      const bool has_cohort = list.hc[n];
      const int* chain = list.chain + (size_t)n * DC;
      const long long* au_w = asg + (size_t)w * FR;
      bool fits = true;
      for (int e = t; e < FR; e += T) {
        const long long au = au_w[e];
        if (au == 0) continue;
        const size_t qe = (size_t)q * FR + e;
        long long avail_q;
        if (has_cohort) {
          long long parent = 0;
          bool started = false;
          for (int d = DC - 1; d >= 0; --d) {
            const int c = chain[d];
            if (c < 0) continue;
            const size_t ce = (size_t)c * FR + e;
            const long long cu = state[ce];
            parent = started ? kq_avail_level(cohort_subtree[ce],
                                              cohort_guaranteed[ce],
                                              cohort_borrow_limit[ce], cu,
                                              parent)
                             : cohort_subtree[ce] - cu;
            started = true;
          }
          avail_q = kq_avail_level(nominal[qe], guaranteed[qe],
                                   borrow_limit[qe], usage[qe], parent);
        } else {
          avail_q = nominal[qe] - usage[qe];
        }
        fits = fits && au <= avail_q;
      }
      if (!(warp_vote ? __all_sync(KQ_SCAN_FULL, fits)
                      : __syncthreads_and(fits)))
        continue;
      for (int e = t; e < FR; e += T) {
        const long long au = au_w[e];
        if (au == 0) continue;
        const size_t qe = (size_t)q * FR + e;
        const long long old_q = usage[qe], new_q = old_q + au;
        usage[qe] = new_q;
        if (!has_cohort) continue;
        long long delta = kq_max0(new_q - guaranteed[qe]) - kq_max0(old_q - guaranteed[qe]);
        for (int d = 0; d < DC; ++d) {
          const int c = chain[d];
          if (c < 0) continue;
          const size_t ce = (size_t)c * FR + e;
          const long long old_c = state[ce], new_c = old_c + delta;
          state[ce] = new_c;
          delta = kq_max0(new_c - cohort_guaranteed[ce]) - kq_max0(old_c - cohort_guaranteed[ce]);
        }
      }
      if (t == 0) admitted[w] = 1;
    }
  }
  if (SHARED) {
    __syncthreads();
    for (int i = t; i < C * FR; i += T) cohort_usage[i] = state[i];
  }
}

template <int DCT, bool SHARED>
static int kq_global_scan(const void* const* p, int* steps, int W, int FR,
                          int DC, int C, int threads, long long smem,
                          cudaStream_t s) {
  if (smem > 0) {  // the static 128 bytes count against the default 48 KB
    const int rc = (int)cudaFuncSetAttribute(
        global_scan_kernel<DCT, SHARED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
  }
  global_scan_kernel<DCT, SHARED><<<1, (unsigned)threads, (size_t)smem, s>>>(
      (const int*)p[0], (const int*)p[1], (const long long*)p[2],
      (const long long*)p[3], (const long long*)p[4], (const long long*)p[5],
      (const long long*)p[6], (const long long*)p[7], (long long*)p[8],
      (long long*)p[9], (const long long*)p[10], (const unsigned char*)p[11],
      (const int*)p[12], (const int*)p[13], (unsigned char*)p[14], steps, W,
      FR, DC, C);
  return (int)cudaGetLastError();
}

template <bool SHARED>
static int kq_global_scan_dc(int dct, const void* const* p, int* steps, int W,
                             int FR, int DC, int C, int threads,
                             long long smem, cudaStream_t s) {
#define KQ_SCAN(D) \
  kq_global_scan<D, SHARED>(p, steps, W, FR, DC, C, threads, smem, s)
  switch (dct) {
    case 0: return KQ_SCAN(0);
    case 1: return KQ_SCAN(1);
    case 2: return KQ_SCAN(2);
    case 4: return KQ_SCAN(4);
    case 8: return KQ_SCAN(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef KQ_SCAN
}

// kernel.global_scan_plan gives shared (1: the shared form), dct (the
// register form's chain depth; 0 for the looping form), threads and smem
// (C * FR * 8 bytes in the shared form).
extern "C" int global_scan_launch(
    const void* cq_cohort, const void* cq_chain, const void* nominal,
    const void* guaranteed, const void* borrow_limit,
    const void* cohort_subtree, const void* cohort_guaranteed,
    const void* cohort_borrow_limit, void* usage, void* cohort_usage,
    const void* asg, const void* fit, const void* wl_cq, const void* order,
    void* admitted, void* steps, long long W, long long FR, long long DC,
    long long C, long long shared, long long dct, long long threads,
    long long smem, void* stream) {
  if (W <= 0 || FR <= 0) return (int)cudaGetLastError();
  if ((dct && (DC > dct || FR > threads || threads > 256)) || threads < 32 ||
      threads > 1024 || threads % 32 ||
      (shared && smem < C * FR * 8))
    return (int)cudaErrorInvalidValue;
  const void* p[15] = {cq_cohort, cq_chain, nominal, guaranteed,
                       borrow_limit, cohort_subtree, cohort_guaranteed,
                       cohort_borrow_limit, usage, cohort_usage, asg, fit,
                       wl_cq, order, admitted};
  cudaStream_t s = (cudaStream_t)stream;
  return shared ? kq_global_scan_dc<true>((int)dct, p, (int*)steps, (int)W,
                                          (int)FR, (int)DC, (int)C,
                                          (int)threads, smem, s)
                : kq_global_scan_dc<false>((int)dct, p, (int*)steps, (int)W,
                                           (int)FR, (int)DC, (int)C,
                                           (int)threads, smem, s);
}
