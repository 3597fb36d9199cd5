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
//  3. the borrowWithinCohort threshold flip: the first candidate that
//     flips it;
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
// Bound on the H100: latency. Each problem is a chain of dependent
// block-wide passes (the keyed prefix sums of steps 2-6, then every
// auction round); the bytes it must move (the problem arrays, the
// candidate-table rows and quota elements it gathers, the outputs) take
// about 0.005 ms at the reclaim cell's batch. What the design does:
//  - Active slots only. A slot with no request and no needs-preemption
//    flag changes no output: the fit (sp_fits) skips req <= 0, the
//    do-mask reads only frs_np slots, and every other quantity is per
//    slot. Each problem compacts its slots to the active ones; the rows
//    hold A of them (the batch's active_slots rounded up to the group
//    width G), the slots past a problem's own count zero (no request, no
//    flag, no usage: inert). The kernel is compiled for G = 2, 4 and 8
//    with the stride A = G, and for G = 8 over a stride given at launch:
//    a scan keeps a candidate's G values in registers and walks the
//    A / G groups in turn.
//  - Every key in one pass. A keyed prefix sum (per local CQ, per cohort
//    node at one depth) is one segmented block scan over the candidates
//    sorted by key (a stable counting sort, built once per key kind: the
//    CQ order once a problem, one node order per depth after the
//    do-mask; the fill-back reuses the forward node orders with the
//    non-eligible candidates' values masked out), a group of G slots
//    between the same two barriers. A sum over every candidate up to k
//    of one key (the preemptor CQ's row, the arrivals at its chain nodes)
//    is read from the keyed scan at the last candidate of that key at or
//    before k (or the first after k for a suffix), found once a problem
//    by a binary search in the key's sorted run; the state at k* (each
//    CQ's and node's) at the last candidate of each key at or before k*.
//  - The problem's rows in shared memory: the candidate rows (V, T, FL
//    and 1 + DC more, [K, A] int64 each), the per-candidate words, the
//    sort tables and the gathered quota planes form one arena, in
//    dynamic shared memory when it fits a block (the "shared" rule), else
//    in a per-block slice of global scratch (the "global" rule).
//    solve_preempt_plan chooses the rule and sizes the persistent grid by
//    the occupancy the rule leaves. CQs and flags are 16-bit; candidate
//    indices and sort keys (the sorted orders and their keys) are 16-bit
//    for K <= SP_NARROW_K, which keeps 3 arenas an SM at the reclaim
//    cell's shape, and 32-bit above it (the kernel's index type IX; an
//    arena that large takes the global rule). A position in a sorted run,
//    which reaches K, is 32-bit.
//  - 3 blocks of 256 threads an SM: the launch bounds hold a thread to
//    80 registers (ptxas spills a few hundred bytes; 2 blocks at 128
//    registers ran slower on the reclaim batch).
//  - Problems with no valid candidate (padding rows) write their outputs
//    (0 targets, infeasible, stats 0, 0, 1, 0) and go on. A problem with
//    more active slots than the launch's A writes 0 targets, infeasible
//    and stats of -1, which the host side refuses (service.preempt_aux).
// A forward pass is 2 sorts and 2 + DC scans; a fill-back evaluation is
// 1 + DC scans; a scan is, per group, two barriers and one warp-shuffle
// scan of G values.
//
// Ownership: the elementwise steps give each thread a contiguous chunk of
// the candidates (their rows are read and written by that thread only);
// a scan gives it a contiguous chunk of the sorted positions, and only
// that thread reads and writes the rows of the candidates at them until
// the next barrier.
//
// With problem slots (the sharded solve, kueue_tpu/parallel/mesh.py:335
// solve over the planner's problem axis), the grid walks slots[0..n) in
// place of problems 0..B: slot s solves problem slots[s] from the full
// arguments and writes its outputs at that problem's row; a padding slot
// (B or -1) writes nothing. The arena stays the block's own.
#include <climits>
#include "common.cuh"

#define SP_NOLIM (1LL << 61)
#define SP_LIM (SP_NOLIM / 4)
#define SP_THREADS 256
#define SP_FULL 0xffffffffu
// the most candidates a problem the 16-bit index form takes
#define SP_NARROW_K 32768

enum : short {
  F_VALID = 1, F_INCQ = 2, F_DO = 4, F_ELIG = 8, F_LO = 16, F_HI = 32,
  F_TMP = 64, F_TFWD = 128
};

// The slot group width the kernel is compiled for (G values of a candidate
// in registers at once) and the row stride A, a multiple of G at or above
// the batch's active slots.
__host__ __device__ inline int sp_group(long long active) {
  return active <= 2 ? 2 : active <= 4 ? 4 : 8;
}

__host__ __device__ inline long long sp_stride(long long active) {
  const long long g = sp_group(active);
  return active <= g ? g : (active + g - 1) / g * g;
}

__host__ __device__ inline long long sp_threads(long long K) {
  const long long t = (K + 31) / 32 * 32;
  return t < 32 ? 32 : (t > SP_THREADS ? SP_THREADS : t);
}

// The arena: int64 arrays, then int arrays, then short arrays, then the
// sorted orders and keys in the index type of `ix` bytes (offsets in
// elements from the region's first byte). Host and device share it.
// pnx: each candidate's place in the preemptor CQ's run and in the runs
// of the preemptor's DC chain nodes, up to K, so int.
struct SpLayout {
  long long rows, nom, guar, bl, usg, uf, sub, cg, cbl, cu0, cuf, req, ws,
      wp;
  long long ibase, uidx, prio, dep, chain, sgq, sgc, act, sgf, sgr, frs, wf,
      tab, startq, start, pnx;
  long long sbase, cq, flags, ed;
  long long xbase, permq, skeyq, perm, skey;
  long long bytes;
};

__host__ __device__ inline int sp_index_bytes(long long K) {
  return K <= SP_NARROW_K ? 2 : 4;
}

__host__ __device__ inline SpLayout sp_layout(long long K, long long QL,
                                              long long A, long long CL,
                                              long long DC, long long T) {
  SpLayout L;
  long long o = 0;
  L.rows = o; o += (4 + DC) * K * A;  // V, T, FL, X[0..DC]
  L.nom = o; o += QL * A;
  L.guar = o; o += QL * A;
  L.bl = o; o += QL * A;
  L.usg = o; o += QL * A;
  L.uf = o; o += QL * A;
  L.sub = o; o += CL * A;
  L.cg = o; o += CL * A;
  L.cbl = o; o += CL * A;
  L.cu0 = o; o += CL * A;
  L.cuf = o; o += CL * A;
  L.req = o; o += A;
  L.ws = o; o += 32 * sp_group(A);
  L.wp = o; o += 32 * sp_group(A);
  L.ibase = o * 8;
  const long long NK = (QL > CL ? QL : CL) + 1;
  const long long trows = (K + T - 1) / T * (T / 32);
  long long i = 0;
  L.uidx = i; i += K;
  L.prio = i; i += K;
  L.dep = i; i += CL;
  L.chain = i; i += QL * DC;
  L.sgq = i; i += QL;
  L.sgc = i; i += CL;
  L.act = i; i += A;
  L.sgf = i; i += A;
  L.sgr = i; i += A;
  L.frs = i; i += A;
  L.wf = i; i += 32;
  L.tab = i; i += (DC > 1 ? DC : 1) * trows * NK;
  L.startq = i; i += NK + 1;
  L.start = i; i += DC * (NK + 1);
  L.pnx = i; i += (1 + DC) * K;
  L.sbase = L.ibase + i * 4;
  long long s = 0;
  L.cq = s; s += K;
  L.flags = s; s += K;
  L.ed = s; s += K;
  L.xbase = (L.sbase + s * 2 + 3) / 4 * 4;
  long long x = 0;
  L.permq = x; x += K;
  L.skeyq = x; x += K;
  L.perm = x; x += DC * K;
  L.skey = x; x += DC * K;
  L.bytes = (L.xbase + x * sp_index_bytes(K) + 15) / 16 * 16;
  return L;
}

// The block's view of its problem: pointers into the arena, the sizes and
// the problem's scalars, in shared memory; each step copies what it uses
// into registers.
struct SpCtx {
  long long *V, *T, *FL, *X;
  long long *nom, *guar, *bl, *usg, *uf, *sub, *cg, *cbl, *cu0, *cuf, *req;
  long long *ws, *wp;
  int *uidx, *prio, *dep, *chain, *sgq, *sgc, *act, *sgf, *sgr, *frs, *wf;
  int *tab, *startq, *start, *pnx;
  short *cq, *flags, *ed;
  void *permq, *skeyq, *perm, *skey;  // of the kernel's index type
  long long th;
  int NK, na, has_cohort, ab0, th_act, kth, kstar, nvalid, nback;
};
__shared__ SpCtx cx;

__device__ __forceinline__ long long sp_min(long long a, long long b) {
  return a < b ? a : b;
}

// an order or key array of the context as the kernel's index type
template <class IX>
__device__ __forceinline__ IX* sp_ix(void* p) {
  return (IX*)p;
}

// workload_fits (preemption.go:576-585) for one hypothesis: u0row(a) is
// the preemptor CQ's usage at slot a, cu(d, a) the usage of the cohort at
// position d of its chain; the availability walks the chain from the root
// end (resource_node.go:89-104).
template <class U0, class CU>
__device__ __forceinline__ bool sp_fits(bool ab, int A, int DC, U0 u0row,
                                        CU cu) {
  const long long *req = cx.req, *nom = cx.nom, *guar = cx.guar,
                  *bl = cx.bl, *sub = cx.sub, *cg = cx.cg, *cbl = cx.cbl;
  const int* chain = cx.chain;
  const bool has_cohort = cx.has_cohort != 0;
  bool borrow_all = true, avail_ok = true;
  for (int a = 0; a < A; ++a) {
    const long long r = req[a];
    if (r <= 0) continue;
    const long long u = u0row(a);
    const long long nom0 = nom[a];
    if (u + r > nom0) borrow_all = false;
    long long avail;
    if (has_cohort) {
      long long parent = 0;
      bool started = false;
      for (int d = DC - 1; d >= 0; --d) {
        const int c = chain[d];
        if (c < 0) continue;
        const long long cuc = cu(d, a);
        const size_t ca = (size_t)c * A + a;
        const long long s = sub[ca], gua = cg[ca];
        const long long cap = (s - gua) - kq_max0(cuc - gua) +
                              sp_min(cbl[ca], SP_LIM);
        const long long child = kq_max0(gua - cuc) + sp_min(parent, cap);
        parent = started ? child : s - cuc;
        started = true;
      }
      const long long guar0 = guar[a];
      const long long cap0 = (nom0 - guar0) - kq_max0(u - guar0) +
                             sp_min(bl[a], SP_LIM);
      avail = kq_max0(guar0 - u) + sp_min(parent, cap0);
    } else {
      avail = nom0 - u;
    }
    if (r > avail) avail_ok = false;
  }
  return (ab || borrow_all) && avail_ok;
}

// The warp's inclusive scan of (flag, sums[G]): a flag restarts the sums.
template <int G>
__device__ __forceinline__ void sp_warp_scan(int& f, long long (&s)[G]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int fy = __shfl_up_sync(SP_FULL, f, off);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const long long y = __shfl_up_sync(SP_FULL, s[g], off);
      if (lane >= off && !f) s[g] += y;
    }
    if (lane >= off) f |= fy;
  }
}

// A segmented scan over the block: the positions 0..K-1 of `perm`
// (walked from K-1 down with `rev`), a segment a run of equal skey[p]
// (the sorted keys), the A slots in groups of G. val(k, key, a0, x) fills
// the values of slots a0..a0+G-1 of the candidate k = perm[p]; emit(k,
// key, a0, ex, x) gets them and ex, their sums over the earlier positions
// of its segment in the walk. Thread t owns positions t*ipt ..
// (t+1)*ipt - 1 of the walk: only it calls val and emit for them, and
// emit may write only k's own entries. Two barriers a group.
template <int G, class IX, class Val, class Emit>
__device__ __forceinline__ void seg_pass(int K, int A, const IX* perm,
                                         const IX* skey, bool rev,
                                         Val val, Emit emit) {
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const int ipt = (K + T - 1) / T;
  const int j0 = min(K, tid * ipt), j1 = min(K, j0 + ipt);
  long long* ws = cx.ws;
  long long* wp = cx.wp;
  int* wf = cx.wf;
  for (int a0 = 0; a0 < A; a0 += G) {
    long long s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0;
    int f = 0;
    for (int j = j0; j < j1; ++j) {
      const int p = rev ? K - 1 - j : j;
      const int key = skey[p];
      const bool h = j == 0 || key != skey[rev ? p + 1 : p - 1];
      long long x[G];
      val(perm[p], key, a0, x);
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = (h ? 0 : s[g]) + x[g];
      f |= h;
    }
    sp_warp_scan<G>(f, s);
    int fe = __shfl_up_sync(SP_FULL, f, 1);
    long long c[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      c[g] = __shfl_up_sync(SP_FULL, s[g], 1);
      if (lane == 0) c[g] = 0;
    }
    if (lane == 0) fe = 0;
    if (lane == 31) {
      wf[warp] = f;
#pragma unroll
      for (int g = 0; g < G; ++g) ws[g * 32 + warp] = s[g];
    }
    __syncthreads();
    if (warp == 0) {
      int h = lane < nw ? wf[lane] : 0;
      long long v[G];
#pragma unroll
      for (int g = 0; g < G; ++g) v[g] = lane < nw ? ws[g * 32 + lane] : 0;
      sp_warp_scan<G>(h, v);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const long long y = __shfl_up_sync(SP_FULL, v[g], 1);
        wp[g * 32 + lane] = lane == 0 ? 0 : y;
      }
    }
    __syncthreads();
    if (!fe) {
#pragma unroll
      for (int g = 0; g < G; ++g) c[g] += wp[g * 32 + warp];
    }
    for (int j = j0; j < j1; ++j) {
      const int p = rev ? K - 1 - j : j;
      const int key = skey[p];
      const bool h = j == 0 || key != skey[rev ? p + 1 : p - 1];
      const int k = perm[p];
      long long x[G];
      val(k, key, a0, x);
      if (h) {
#pragma unroll
        for (int g = 0; g < G; ++g) c[g] = 0;
      }
      emit(k, key, a0, c, x);
#pragma unroll
      for (int g = 0; g < G; ++g) c[g] += x[g];
    }
  }
}

// A stable counting sort of the candidates 0..K-1 by ns keys at once:
// key(s, k) in [-1, NK - 1), -1 sorted last. perms[s * K + p] is the
// candidate at position p of order s and skeys[s * K + p] its key,
// starts[s * (NK + 1) + key] the first position of a key (key -1 at
// NK - 1). A candidate's rank among its key's is its warp's count of
// earlier equal keys (__match_any_sync) plus the counts of the earlier
// warps and tiles. Starts and ends with a barrier.
template <class IX, class Key>
__device__ void sort_keys(int ns, int K, Key key, IX* perms, IX* skeys,
                          int* starts) {
  const int NK = cx.NK, T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  const int ntiles = (K + T - 1) / T, trows = ntiles * nw;
  int* tab = cx.tab;
  const unsigned lt = (1u << lane) - 1;
  for (int i = tid; i < ns * trows * NK; i += T) tab[i] = 0;
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int k = t * T + tid;
    for (int s = 0; s < ns; ++s) {
      int kk = NK;  // past the table: no candidate
      if (k < K) {
        kk = key(s, k);
        if (kk < 0) kk = NK - 1;
      }
      const unsigned peers = __match_any_sync(SP_FULL, kk);
      if (k < K && (peers & lt) == 0)
        tab[((size_t)s * trows + t * nw + warp) * NK + kk] = __popc(peers);
    }
  }
  __syncthreads();
  for (int col = tid; col < ns * NK; col += T) {
    const int s = col / NK, kk = col % NK;
    int run = 0;
    for (int r = 0; r < trows; ++r) {
      int* c = &tab[((size_t)s * trows + r) * NK + kk];
      const int x = *c;
      *c = run;
      run += x;
    }
    starts[s * (NK + 1) + kk + 1] = run;
  }
  __syncthreads();
  if (tid < ns) {
    int* st = starts + tid * (NK + 1);
    st[0] = 0;
    for (int kk = 1; kk <= NK; ++kk) st[kk] += st[kk - 1];
  }
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const int k = t * T + tid;
    for (int s = 0; s < ns; ++s) {
      int kk = NK, raw = -1;
      if (k < K) {
        raw = key(s, k);
        kk = raw < 0 ? NK - 1 : raw;
      }
      const unsigned peers = __match_any_sync(SP_FULL, kk);
      if (k < K) {
        const int p = starts[s * (NK + 1) + kk] +
                      tab[((size_t)s * trows + t * nw + warp) * NK + kk] +
                      __popc(peers & lt);
        perms[(size_t)s * K + p] = (IX)k;
        skeys[(size_t)s * K + p] = (IX)raw;
      }
    }
  }
  __syncthreads();
}

// the number of entries <= k in the ascending run seg[0..len)
template <class IX>
__device__ __forceinline__ int sp_upper(const IX* seg, int len, int k) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg[mid] <= k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One fill-back round (_fillback_ok): for every eligible candidate, would
// the reverse greedy take it back given that exactly the candidates
// marked `mbit` (those after it) came back first? Sets `obit` to the
// answer. Rows: T the same-CQ member suffix (inclusive), FL the add
// marginal on its way up, X[0] a node's member suffix (inclusive) at the
// depth in hand, X[1 + d] what chain node d of the preemptor holds on top
// of the forward state (members after the candidate, and its own flow).
template <int G, int AF, class IX>
__device__ void sp_fillback_ok(int K, int A_arg, int DC, int k0, int k1,
                               int mbit, int obit, bool ab_fb) {
  const int A = AF > 0 ? AF : A_arg;
  const size_t KA = (size_t)K * A;
  // the members of each local CQ after k
  {
    const long long* V = cx.V;
    long long* Tr = cx.T;
    const short* flags = cx.flags;
    seg_pass<G>(K, A, sp_ix<IX>(cx.permq), sp_ix<IX>(cx.skeyq), true,
        [&](int k, int, int a0, long long (&x)[G]) {
          const bool m = (flags[k] & mbit) != 0;
#pragma unroll
          for (int g = 0; g < G; ++g)
            x[g] = m ? V[(size_t)k * A + a0 + g] : 0;
        },
        [&](int k, int, int a0, const long long (&ex)[G],
            const long long (&x)[G]) {
#pragma unroll
          for (int g = 0; g < G; ++g)
            Tr[(size_t)k * A + a0 + g] = ex[g] + x[g];
        });
  }
  __syncthreads();
  // the CQ-level add marginal against the members after k in its own CQ
  {
    const long long *V = cx.V, *Tr = cx.T, *uf = cx.uf, *guar = cx.guar;
    long long *FL = cx.FL, *X = cx.X;
    const short *cq = cx.cq, *flags = cx.flags;
    for (int k = k0; k < k1; ++k) {
      const int qs = cq[k] > 0 ? cq[k] : 0;
      const bool mem = (flags[k] & mbit) != 0;
      for (int a = 0; a < A; ++a) {
        const size_t ka = (size_t)k * A + a;
        const long long v = V[ka];
        const size_t qa = (size_t)qs * A + a;
        const long long tp = uf[qa] + Tr[ka] - (mem ? v : 0) - guar[qa];
        FL[ka] = kq_max0(tp + v) - kq_max0(tp);
        for (int d = 0; d < DC; ++d) X[(1 + d) * KA + ka] = 0;
      }
    }
  }
  __syncthreads();
  for (int dlt = DC - 1; dlt >= 0; --dlt) {
    const IX* perm = sp_ix<IX>(cx.perm) + (size_t)dlt * K;
    {
      long long *FL = cx.FL, *X = cx.X;
      const long long *cg = cx.cg, *cuf = cx.cuf;
      const short* flags = cx.flags;
      const int* chain = cx.chain;  // the preemptor's (local CQ 0's)
      seg_pass<G>(K, A, perm, sp_ix<IX>(cx.skey) + (size_t)dlt * K, true,
          [&](int k, int key, int a0, long long (&x)[G]) {
            const bool m = key >= 0 && (flags[k] & mbit);
#pragma unroll
            for (int g = 0; g < G; ++g)
              x[g] = m ? FL[(size_t)k * A + a0 + g] : 0;
          },
          [&](int k, int c, int a0, const long long (&ex)[G],
              const long long (&x)[G]) {
            if (c < 0) return;
            const bool elig = (flags[k] & F_ELIG) != 0;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const size_t ka = (size_t)k * A + a0 + g;
              X[ka] = ex[g] + x[g];
              if (!elig) continue;
              const long long fl = FL[ka];
              for (int d = 0; d < DC; ++d)
                if (chain[d] == c) X[(1 + d) * KA + ka] = fl;
              const size_t ca = (size_t)c * A + a0 + g;
              FL[ka] = kq_max0(fl - kq_max0(cg[ca] - (cuf[ca] + ex[g])));
            }
          });
    }
    __syncthreads();
    // the members after k at the preemptor's chain node of this depth
    long long* X = cx.X;
    for (int d = 0; d < DC; ++d) {
      const int c = cx.chain[d];
      if (c < 0 || cx.dep[c] != dlt) continue;
      const int end = cx.start[dlt * (cx.NK + 1) + c + 1];
      const int* pnx = cx.pnx + (size_t)(1 + d) * K;
      for (int k = k0; k < k1; ++k) {
        const int p = pnx[k];
        if (p < 0 || p >= end) continue;
        const size_t na = (size_t)perm[p] * A, ka = (size_t)k * A;
        for (int a = 0; a < A; ++a) X[(1 + d) * KA + ka + a] += X[na + a];
      }
    }
  }
  // the fit of each eligible candidate's hypothesis
  {
    const int e0 = cx.startq[1];
    const int* pnx0 = cx.pnx;
    const IX* permq = sp_ix<IX>(cx.permq);
    const short* cq = cx.cq;
    short* flags = cx.flags;
    const long long *V = cx.V, *Tr = cx.T, *X = cx.X, *uf = cx.uf,
                    *cuf = cx.cuf;
    const int* chain = cx.chain;
    for (int k = k0; k < k1; ++k) {
      bool ok = false;
      if (flags[k] & F_ELIG) {
        const int pn = pnx0[k];
        const int n0 = pn < e0 ? permq[pn] : -1;
        const bool in0 = cq[k] == 0;
        ok = sp_fits(ab_fb, A, DC,
            [&](int a) {
              return uf[a] + (n0 >= 0 ? Tr[(size_t)n0 * A + a] : 0) +
                     (in0 ? V[(size_t)k * A + a] : 0);
            },
            [&](int d, int a) {
              return cuf[(size_t)chain[d] * A + a] +
                     X[(1 + d) * KA + (size_t)k * A + a];
            });
      }
      flags[k] = (short)(ok ? (flags[k] | obit) : (flags[k] & ~obit));
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void sp_count(int c, int* total) {
  const int w = __reduce_add_sync(SP_FULL, c);
  if ((threadIdx.x & 31) == 0 && w) atomicAdd(total, w);
}

template <int G, int AF, class IX>
__global__ void __launch_bounds__(SP_THREADS, 3) solve_preempt_kernel(
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
    const unsigned char* __restrict__ has_cohort, unsigned char* scratch,
    long long arena_bytes, int in_smem, unsigned char* __restrict__ targets,
    unsigned char* __restrict__ feasible, int* __restrict__ stats,
    const int* __restrict__ slots, int n_slots, int B, int K, int QL, int RF,
    int CL, int DC, int F, int R, int A_arg) {
  extern __shared__ __align__(16) unsigned char sp_dyn[];
  const int A = AF > 0 ? AF : A_arg;  // the row stride
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ipt = (K + T - 1) / T;
  const int k0 = min(K, tid * ipt);
  const int k1 = min(K, k0 + ipt);
  const size_t KA = (size_t)K * A;
  if (tid == 0) {
    unsigned char* base = in_smem ? sp_dyn
                                  : scratch + (size_t)blockIdx.x * arena_bytes;
    const SpLayout L = sp_layout(K, QL, A, CL, DC, T);
    long long* w = (long long*)base;
    int* iw = (int*)(base + L.ibase);
    short* sw = (short*)(base + L.sbase);
    IX* xw = (IX*)(base + L.xbase);
    cx.V = w + L.rows; cx.T = cx.V + KA; cx.FL = cx.T + KA; cx.X = cx.FL + KA;
    cx.nom = w + L.nom; cx.guar = w + L.guar; cx.bl = w + L.bl;
    cx.usg = w + L.usg; cx.uf = w + L.uf; cx.sub = w + L.sub;
    cx.cg = w + L.cg; cx.cbl = w + L.cbl; cx.cu0 = w + L.cu0;
    cx.cuf = w + L.cuf; cx.req = w + L.req; cx.ws = w + L.ws;
    cx.wp = w + L.wp;
    cx.uidx = iw + L.uidx; cx.prio = iw + L.prio; cx.dep = iw + L.dep;
    cx.chain = iw + L.chain; cx.sgq = iw + L.sgq; cx.sgc = iw + L.sgc;
    cx.act = iw + L.act; cx.sgf = iw + L.sgf; cx.sgr = iw + L.sgr;
    cx.frs = iw + L.frs; cx.wf = iw + L.wf; cx.tab = iw + L.tab;
    cx.startq = iw + L.startq; cx.start = iw + L.start;
    cx.pnx = iw + L.pnx;
    cx.cq = sw + L.cq; cx.flags = sw + L.flags; cx.ed = sw + L.ed;
    cx.permq = xw + L.permq; cx.skeyq = xw + L.skeyq; cx.perm = xw + L.perm;
    cx.skey = xw + L.skey;
    cx.NK = (QL > CL ? QL : CL) + 1;
  }
  __syncthreads();

  for (int slot = blockIdx.x; slot < n_slots; slot += gridDim.x) {
    const int b = slots ? slots[slot] : slot;
    if (b < 0 || b >= B) continue;  // a padding slot: uniform over the block
    const size_t bK = (size_t)b * K;

    // 1. the problem's small arrays, its active slots and the candidates'
    // CQs and table rows; a problem with no valid candidate goes to its
    // outputs
    if (tid == 0) {
      cx.has_cohort = has_cohort[b] != 0;
      cx.ab0 = allow_borrowing[b] != 0;
      cx.th_act = threshold_active[b] != 0;
      cx.th = threshold[b];
      cx.kth = INT_MAX;
      cx.kstar = INT_MAX;
      cx.nvalid = 0;
      cx.nback = 0;
    }
    if (warp == 0) {
      int n = 0;
      for (int i0 = 0; i0 < RF; i0 += 32) {
        const int i = i0 + lane;
        const size_t bi = (size_t)b * RF + i;
        const long long r = i < RF ? requests[bi] : 0;
        const bool fr = i < RF && frs_np[bi];
        const bool on = r > 0 || fr;
        const unsigned m = __ballot_sync(SP_FULL, on);
        const int at = n + __popc(m & ((1u << lane) - 1));
        if (on && at < A) {
          cx.act[at] = i;
          cx.req[at] = r;
          cx.frs[at] = fr;
          cx.sgf[at] = gf[bi];
          cx.sgr[at] = gr[bi];
        }
        n += __popc(m);
      }
      for (int a = n + lane; a < A; a += 32) {  // inert padding slots
        cx.req[a] = 0;
        cx.frs[a] = 0;
        cx.sgf[a] = -1;
      }
      if (lane == 0) cx.na = n;
    }
    for (int x = tid; x < QL; x += T) {
      const int q = gq[(size_t)b * QL + x];
      cx.sgq[x] = q < 0 ? 0 : q;  // a padding CQ row gathers CQ 0
    }
    for (int x = tid; x < CL; x += T) {
      const int g = gc[(size_t)b * CL + x];
      cx.sgc[x] = g;
      cx.dep[x] = g >= 0 ? cohort_depth[g] : -1;
    }
    for (int x = tid; x < QL * DC; x += T)
      cx.chain[x] = chain_local[(size_t)b * QL * DC + x];
    bool any = false;
    for (int k = k0; k < k1; ++k) {
      const int q = cand_ql[bK + k];
      cx.cq[k] = (short)q;
      cx.uidx[k] = cand_idx[bK + k];
      any |= q >= 0;
    }
    if (!__syncthreads_or(any)) {
      for (int k = k0; k < k1; ++k) targets[bK + k] = 0;
      if (tid == 0) {
        feasible[b] = 0;
        stats[(size_t)b * 4 + 0] = 0;
        stats[(size_t)b * 4 + 1] = 0;
        stats[(size_t)b * 4 + 2] = 1;
        stats[(size_t)b * 4 + 3] = 0;
      }
      continue;
    }
    if (cx.na > A) {  // the launch's active_slots was below this problem's
      for (int k = k0; k < k1; ++k) targets[bK + k] = 0;
      if (tid == 0) {
        feasible[b] = 0;
        for (int j = 0; j < 4; ++j) stats[(size_t)b * 4 + j] = -1;
      }
      __syncthreads();
      continue;
    }
    // 2. the quota planes of the slots (a padding slot: 0, no limit) and
    // the candidates' rows
    for (int x = tid; x < QL * A; x += T) {
      const int ql = x / A, a = x % A, f = cx.sgf[a];
      const size_t e = ((size_t)cx.sgq[ql] * F + (f < 0 ? 0 : f)) * R +
                       (f < 0 ? 0 : cx.sgr[a]);
      cx.nom[x] = f < 0 ? 0 : nominal[e];
      cx.guar[x] = f < 0 ? 0 : guaranteed[e];
      cx.bl[x] = f < 0 ? SP_NOLIM : borrow_limit[e];
      cx.usg[x] = cx.uf[x] = f < 0 ? 0 : usage[e];
    }
    for (int x = tid; x < CL * A; x += T) {
      const int c = x / A, a = x % A, f = cx.sgf[a], g = cx.sgc[c];
      const bool ok = f >= 0 && g >= 0;
      const size_t e = ok ? ((size_t)g * F + f) * R + cx.sgr[a] : 0;
      cx.sub[x] = ok ? cohort_subtree[e] : 0;
      cx.cg[x] = ok ? cohort_guaranteed[e] : 0;
      cx.cbl[x] = ok ? cohort_borrow_limit[e] : SP_NOLIM;
      cx.cu0[x] = cx.cuf[x] = ok ? cohort_usage[e] : 0;
    }
    {
      const int na = cx.na;
      const int* act = cx.act;
      long long* V = cx.V;
      short *cq = cx.cq, *flags = cx.flags;
      int nvalid = 0;
      for (int k = k0; k < k1; ++k) {
        const int q = cq[k];
        const int u = cx.uidx[k];
        cx.prio[k] = q >= 0 ? cand_prio[u] : 0;
        flags[k] = (short)((q >= 0 ? F_VALID : 0) | (q == 0 ? F_INCQ : 0));
        nvalid += q >= 0;
        for (int a = 0; a < A; ++a)
          V[(size_t)k * A + a] =
              (q >= 0 && a < na) ? cand_usage[(size_t)u * RF + act[a]] : 0;
      }
      sp_count(nvalid, &cx.nvalid);
    }
    // 3. the candidates by local CQ (starts and ends with a barrier)
    {
      const short* cq = cx.cq;
      sort_keys(1, K, [&](int, int k) { return (int)cq[k]; },
                sp_ix<IX>(cx.permq), sp_ix<IX>(cx.skeyq), cx.startq);
    }
    // 4. the do-mask: the CQ borrows after all its earlier candidates
    {
      const long long* V = cx.V;
      long long* Tr = cx.T;
      seg_pass<G>(K, A, sp_ix<IX>(cx.permq), sp_ix<IX>(cx.skeyq), false,
          [&](int k, int, int a0, long long (&x)[G]) {
#pragma unroll
            for (int g = 0; g < G; ++g) x[g] = V[(size_t)k * A + a0 + g];
          },
          [&](int k, int, int a0, const long long (&ex)[G],
              const long long (&)[G]) {
#pragma unroll
            for (int g = 0; g < G; ++g) Tr[(size_t)k * A + a0 + g] = ex[g];
          });
    }
    __syncthreads();
    {
      const int* frs = cx.frs;
      const long long *usg = cx.usg, *nom = cx.nom, *Tr = cx.T;
      const short* cq = cx.cq;
      short* flags = cx.flags;
      const bool th_act = cx.th_act != 0;
      const long long th = cx.th;
      bool th_found = false;
      for (int k = k0; k < k1; ++k) {
        const int fl = flags[k];
        if (!(fl & F_VALID)) continue;
        const int qs = cq[k];
        bool borrowing = false;
        for (int a = 0; a < A; ++a) {
          const size_t qa = (size_t)qs * A + a;
          if (frs[a] && usg[qa] - Tr[(size_t)k * A + a] > nom[qa])
            borrowing = true;
        }
        if ((fl & F_INCQ) || borrowing) {
          flags[k] = (short)(fl | F_DO);
          // the threshold flip, inclusive of the candidate's own
          if (!th_found && th_act && !(fl & F_INCQ) &&
              (long long)cx.prio[k] >= th) {
            atomicMin(&cx.kth, k);
            th_found = true;
          }
        }
      }
    }
    __syncthreads();
    // 5. removal marginals against each CQ's running state (T: the
    // inclusive same-CQ sum of the removals, kept for k*'s state)
    {
      const long long* V = cx.V;
      long long* Tr = cx.T;
      const short* flags = cx.flags;
      seg_pass<G>(K, A, sp_ix<IX>(cx.permq), sp_ix<IX>(cx.skeyq), false,
          [&](int k, int, int a0, long long (&x)[G]) {
            const bool dk = (flags[k] & F_DO) != 0;
#pragma unroll
            for (int g = 0; g < G; ++g)
              x[g] = dk ? V[(size_t)k * A + a0 + g] : 0;
          },
          [&](int k, int, int a0, const long long (&ex)[G],
              const long long (&x)[G]) {
#pragma unroll
            for (int g = 0; g < G; ++g)
              Tr[(size_t)k * A + a0 + g] = ex[g] + x[g];
          });
    }
    __syncthreads();
    {
      const long long *V = cx.V, *Tr = cx.T, *usg = cx.usg, *guar = cx.guar;
      long long* FL = cx.FL;
      const short *cq = cx.cq, *flags = cx.flags;
      const int *chain = cx.chain, *dep = cx.dep;
      short* ed = cx.ed;
      for (int k = k0; k < k1; ++k) {
        const int qs = cq[k] > 0 ? cq[k] : 0;
        const bool dk = (flags[k] & F_DO) != 0;
        for (int a = 0; a < A; ++a) {
          const size_t qa = (size_t)qs * A + a, ka = (size_t)k * A + a;
          const long long v = V[ka];
          FL[ka] = dk ? sp_min(v, kq_max0(usg[qa] - guar[qa] - (Tr[ka] - v)))
                      : 0;
        }
        const int first = DC > 0 ? chain[qs * DC] : -1;
        ed[k] = (short)((first >= 0 && dk) ? dep[first] : -1);
      }
    }
    // 6. the candidates by cohort node at each depth (the sort starts
    // with a barrier): the node at depth s of a removal whose CQ's first
    // cohort sits at depth e is its chain's entry e - s
    if (DC > 0) {
      const short *ed = cx.ed, *cq = cx.cq;
      const int* chain = cx.chain;
      sort_keys(DC, K,
          [&](int s, int k) -> int {
            const int e = ed[k];
            if (e < 0 || e - s < 0) return -1;
            const int qs = cq[k] > 0 ? cq[k] : 0;
            const int nd = chain[qs * DC + min(e - s, DC - 1)];
            return nd < 0 ? -1 : nd;
          },
          sp_ix<IX>(cx.perm), sp_ix<IX>(cx.skey), cx.start);
    } else {
      __syncthreads();
    }
    // each candidate's place in the preemptor CQ's run and in the runs of
    // the preemptor's chain nodes: the count of that run's candidates <= k
    {
      const int *startq = cx.startq, *start = cx.start, *chain = cx.chain,
                *dep = cx.dep;
      const int NK = cx.NK;
      int* pnx = cx.pnx;
      for (int k = k0; k < k1; ++k) {
        pnx[k] = startq[0] + sp_upper(sp_ix<IX>(cx.permq) + startq[0],
                                      startq[1] - startq[0], k);
        for (int d = 0; d < DC; ++d) {
          const int c = chain[d];
          const int dl = c >= 0 ? dep[c] : -1;
          int p = -1;
          if (dl >= 0 && dl < DC) {
            const int* st = start + dl * (NK + 1);
            p = st[c] + sp_upper(sp_ix<IX>(cx.perm) + (size_t)dl * K + st[c],
                                 st[c + 1] - st[c], k);
          }
          pnx[(size_t)(1 + d) * K + k] = p;
        }
      }
    }
    // 7. the flows up the tree, deepest nodes first; X[dlt] holds the
    // arrivals at each candidate's node up to it, inclusive
    for (int dlt = DC - 1; dlt >= 0; --dlt) {
      long long* FL = cx.FL;
      long long* arr = cx.X + dlt * KA;
      const long long *cu0 = cx.cu0, *cg = cx.cg;
      seg_pass<G>(K, A, sp_ix<IX>(cx.perm) + (size_t)dlt * K,
          sp_ix<IX>(cx.skey) + (size_t)dlt * K, false,
          [&](int k, int key, int a0, long long (&x)[G]) {
#pragma unroll
            for (int g = 0; g < G; ++g)
              x[g] = key >= 0 ? FL[(size_t)k * A + a0 + g] : 0;
          },
          [&](int k, int c, int a0, const long long (&ex)[G],
              const long long (&x)[G]) {
            if (c < 0) return;
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const size_t ca = (size_t)c * A + a0 + g;
              const size_t ka = (size_t)k * A + a0 + g;
              FL[ka] = sp_min(x[g], kq_max0(cu0[ca] - cg[ca] - ex[g]));
              arr[ka] = ex[g] + x[g];
            }
          });
      __syncthreads();
    }
    // 8. the fit of every prefix, and the first that fits: the preemptor
    // CQ's row and each chain node's arrivals up to k are the keyed sums
    // at the last candidate of that key at or before k
    {
      const bool ab0 = cx.ab0 != 0;
      const int kth = cx.kth, sq0 = cx.startq[0], NK = cx.NK;
      const int *start = cx.start, *chain = cx.chain, *dep = cx.dep;
      const int* pnx = cx.pnx;
      const IX *permq = sp_ix<IX>(cx.permq), *perm = sp_ix<IX>(cx.perm);
      const short* flags = cx.flags;
      const long long *usg = cx.usg, *Tr = cx.T, *X = cx.X, *cu0 = cx.cu0;
      for (int k = k0; k < k1; ++k) {
        if (!(flags[k] & F_DO)) continue;
        const int p0 = pnx[k];
        const int r0 = p0 > sq0 ? permq[p0 - 1] : -1;
        const bool fit = sp_fits(ab0 && k < kth, A, DC,
            [&](int a) {
              return usg[a] - (r0 >= 0 ? Tr[(size_t)r0 * A + a] : 0);
            },
            [&](int d, int a) {
              const int c = chain[d];
              const int p = pnx[(size_t)(1 + d) * K + k];
              long long in = 0;
              if (p >= 0) {
                const int dl = dep[c];
                if (p > start[dl * (NK + 1) + c])
                  in = X[dl * KA +
                         (size_t)perm[(size_t)dl * K + p - 1] * A + a];
              }
              return cu0[(size_t)c * A + a] - in;
            });
        if (fit) {
          atomicMin(&cx.kstar, k);
          break;  // this thread's first; later ones are larger
        }
      }
    }
    __syncthreads();
    const bool done = cx.kstar < K;
    const int kstar = done ? cx.kstar : 0;
    const bool ab_fb = done ? (cx.ab0 && kstar < cx.kth) : cx.ab0 != 0;
    // 9. the state after the forward removals: each local CQ's row and
    // each local cohort's at k*, from the keyed sums at the last
    // candidate of the key at or before k*
    if (done) {
      const IX *permq = sp_ix<IX>(cx.permq), *skeyq = sp_ix<IX>(cx.skeyq);
      const long long *usg = cx.usg, *Tr = cx.T, *cu0 = cx.cu0, *X = cx.X;
      long long *uf = cx.uf, *cuf = cx.cuf;
      const int* dep = cx.dep;
      for (int p = tid; p < K; p += T) {
        const int k = permq[p], q = skeyq[p];
        if (q < 0 || k > kstar) continue;
        if (p + 1 < K && skeyq[p + 1] == q && permq[p + 1] <= kstar)
          continue;
        for (int a = 0; a < A; ++a) {
          const size_t qa = (size_t)q * A + a;
          uf[qa] = usg[qa] - Tr[(size_t)k * A + a];
        }
      }
      for (int x = tid; x < DC * K; x += T) {
        const int dl = x / K, p = x % K;
        const IX* perm = sp_ix<IX>(cx.perm) + (size_t)dl * K;
        const IX* skey = sp_ix<IX>(cx.skey) + (size_t)dl * K;
        const int k = perm[p], c = skey[p];
        if (c < 0 || dep[c] != dl || k > kstar) continue;
        if (p + 1 < K && skey[p + 1] == c && perm[p + 1] <= kstar) continue;
        for (int a = 0; a < A; ++a) {
          const size_t ca = (size_t)c * A + a;
          cuf[ca] = cu0[ca] - X[dl * KA + (size_t)k * A + a];
        }
      }
    }
    {
      short* flags = cx.flags;
      for (int k = k0; k < k1; ++k) {
        int fl = flags[k] & ~(F_LO | F_HI | F_TMP | F_TFWD | F_ELIG);
        if ((fl & F_DO) && done && k <= kstar) {
          fl |= F_TFWD;
          if (k != kstar) fl |= F_ELIG | F_HI;
        }
        flags[k] = (short)fl;
      }
    }
    __syncthreads();
    // 10. the fill-back auction rounds
    sp_fillback_ok<G, AF, IX>(K, A, DC, k0, k1, F_HI, F_LO, ab_fb);
    int rounds = 1;
    for (;;) {
      const short* flags = cx.flags;
      bool differ = false;
      for (int k = k0; k < k1; ++k)
        differ |= ((flags[k] & F_LO) != 0) != ((flags[k] & F_HI) != 0);
      if (!__syncthreads_or(differ) || rounds >= K + 2) break;
      // hi' = ok(lo), lo' = ok(hi')
      sp_fillback_ok<G, AF, IX>(K, A, DC, k0, k1, F_LO, F_TMP, ab_fb);
      sp_fillback_ok<G, AF, IX>(K, A, DC, k0, k1, F_TMP, F_LO, ab_fb);
      short* fw = cx.flags;
      for (int k = k0; k < k1; ++k)
        fw[k] = (short)((fw[k] & ~F_HI) | ((fw[k] & F_TMP) ? F_HI : 0));
      ++rounds;
    }
    // 11. outputs
    {
      const short* flags = cx.flags;
      int nback = 0;
      for (int k = k0; k < k1; ++k) {
        const int fl = flags[k];
        targets[bK + k] = (fl & F_TFWD) && !(fl & F_LO);
        nback += (fl & F_LO) != 0;
      }
      sp_count(nback, &cx.nback);
    }
    __syncthreads();
    if (tid == 0) {
      feasible[b] = done;
      stats[(size_t)b * 4 + 0] = cx.nvalid;
      stats[(size_t)b * 4 + 1] = done ? kstar + 1 : 0;
      stats[(size_t)b * 4 + 2] = rounds;
      stats[(size_t)b * 4 + 3] = cx.nback;
    }
    __syncthreads();
  }
}

typedef decltype(&solve_preempt_kernel<2, 2, short>) SpKernel;

template <class IX>
static SpKernel sp_kernel_ix(long long RFA) {
  return RFA <= 2 ? solve_preempt_kernel<2, 2, IX>
         : RFA <= 4 ? solve_preempt_kernel<4, 4, IX>
         : RFA <= 8 ? solve_preempt_kernel<8, 8, IX>
                    : solve_preempt_kernel<8, 0, IX>;
}

// the instantiation for a batch with at most RFA active slots and K
// candidates a problem: the row stride fixed at G up to 8 slots, beyond
// that groups of 8 over a stride given at launch; 16-bit indices up to
// SP_NARROW_K candidates, 32-bit above
static SpKernel sp_kernel(long long RFA, long long K) {
  return sp_index_bytes(K) == 2 ? sp_kernel_ix<short>(RFA)
                                : sp_kernel_ix<int>(RFA);
}

// The launch plan for a batch whose problems have at most RFA active
// slots: out = {threads, arena bytes a block, 1 if the arena is in shared
// memory (else a per-block slice of global scratch, grid x bytes), blocks
// an SM, grid, registers a thread, local bytes a thread, the row stride
// A, the group width G, the index bits (16 or 32)}. The shared rule holds when the arena fits the
// block's opt-in shared memory beside the static part.
extern "C" int solve_preempt_plan(void* out, long long n_slots, long long K,
                                  long long QL, long long RFA, long long CL,
                                  long long DC, void* /*stream*/) {
  long long* o = (long long*)out;
  const long long A = sp_stride(RFA);
  const SpKernel kern = sp_kernel(RFA, K);
  cudaFuncAttributes attr;
  int rc = (int)cudaFuncGetAttributes(&attr, kern);
  if (rc != 0) return rc;
  int dev = 0, optin = 0, sms = 0;
  if ((rc = (int)cudaGetDevice(&dev)) != 0) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != 0)
    return rc;
  if ((rc = (int)cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev)) != 0)
    return rc;
  const int max_dyn = optin - (int)attr.sharedSizeBytes;
  if (attr.maxDynamicSharedSizeBytes < max_dyn) {
    rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_dyn);
    if (rc != 0) return rc;
  }
  const long long T = sp_threads(K);
  const SpLayout L = sp_layout(K, QL, A, CL, DC, T);
  const bool in_smem = L.bytes <= max_dyn;
  int per_sm = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, (int)T, in_smem ? (size_t)L.bytes : 0);
  if (rc != 0) return rc;
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > n_slots) grid = n_slots;
  if (grid < 1) grid = 1;
  o[0] = T;
  o[1] = L.bytes;
  o[2] = in_smem ? 1 : 0;
  o[3] = per_sm;
  o[4] = grid;
  o[5] = attr.numRegs;
  o[6] = (long long)attr.localSizeBytes;
  o[7] = A;
  o[8] = sp_group(RFA);
  o[9] = 8 * sp_index_bytes(K);
  return 0;
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
    const void* threshold, const void* has_cohort, void* scratch,
    void* targets, void* feasible, void* stats, const void* slots,
    long long n_slots, long long B, long long K, long long QL, long long RF,
    long long CL, long long DC, long long F, long long R, long long RFA,
    long long grid, long long threads, long long arena_bytes,
    long long in_smem, void* stream) {
  if (n_slots > 0 && K > 0) {
    sp_kernel(RFA, K)<<<(unsigned)grid, (unsigned)threads,
                              in_smem ? (size_t)arena_bytes : 0,
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
        (const unsigned char*)has_cohort, (unsigned char*)scratch,
        arena_bytes, (int)in_smem, (unsigned char*)targets,
        (unsigned char*)feasible, (int*)stats, (const int*)slots,
        (int)n_slots, (int)B, (int)K, (int)QL, (int)RF, (int)CL, (int)DC,
        (int)F, (int)R, (int)sp_stride(RFA));
  }
  return (int)cudaGetLastError();
}
