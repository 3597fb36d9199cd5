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
// Bound on the H100: latency. A problem is a chain of dependent pops
// (34 at the fair cell, 236 on the nested batch), each a pick over its
// CQs, a share over its slots, a removal up a cohort chain and a fit
// check; the bytes are a few rows per pop. A clock64 probe of the first
// kernel (one warp a problem, rows in global scratch) found the chain's
// cost in its instructions, not in its memory: its rows in shared memory
// saved 1.5% of a problem's cycles. The prologue's loops over the CQs
// and cohorts (a dependent global round trip each) and its QL warp-wide
// shares were a third of a problem; a pick (two 5-level 64-bit shuffle
// trees, eligibility re-read from memory) and a share (an RF x RF loop of
// global loads a lane) were 1.8k and 2.4k cycles.
//
// Design: one warp a problem, a block a warp (so a batch of B problems
// spreads over every SM), each problem staged once into an arena
// (sf_layout): its quota and usage rows, share constants, per-slot
// constants (the slot's resource, a mask of the same-resource slots, the
// preemptor CQ's clamped borrow limit, the divisors' multipliers), its
// cohort chains, the table and the removal log, and the candidate rows
// and priorities its candidates point at. The arena is in shared memory
// when it fits (the "shared" form), else in a per-block slice of global
// scratch without the candidate rows, which are read in place from the
// table (the "global" form; kernel.fair_plan). Staging reads element e of every problem array in
// one pass, then what those index in a second, then the candidate rows,
// each lane's loads of a batch before its stores. Where QL <= 32 and RF
// <= 32 (the narrow instance) lane q holds CQ q's heap state (share,
// position, heap flag, count, order, first refused candidate, table
// start) and lane i slot i's constants in registers: only the popped
// CQ's lane changes the state, the pick is four warp reductions
// (__reduce_max_sync on the share's high word, then its low word;
// __reduce_min_sync on cq_order, then the slot), a share sums each
// slot's resource by its mask over RF shuffles, and the initial shares
// (and the retry pass's) are a lane a CQ, all at once. Past that (the
// general instance) the state is in the arena, each lane offers its best
// CQ to the same reductions, and the lanes stride over the slots. Both
// divisions of a share take a multiply and a shift by the divisor's
// precomputed multiplier while the dividend fits in 32 bits, exactly
// (sf_fdiv), else kq_floordiv. Every step is inlined: a call's saved
// registers spilled, and the inlined kernel is the fastest form that
// ptxas fits in 255 registers without a spill.
#include <climits>
#include "common.cuh"

#define SF_NOLIM (1LL << 61)
#define SF_LIM (SF_NOLIM / 4)
#define SF_MAXSHARE (1LL << 62)
#define SF_NONE (1 << 30)
#define SF_FULL 0xffffffffu
#define SF_THREADS 32  // a block: one warp
#define SF_BATCH 2     // staging elements a lane loads before it stores
// the arena's forms (kernel.fair_form)
#define SF_SHARED 0  // all in shared memory, the candidate rows staged
#define SF_GLOBAL 1  // in a per-block slice of global scratch, the
                     // candidate rows read in place

// The arena of one problem: int64 words, then int32 words, then bytes
// (kernel.fair_arena_bytes mirrors it; SfCtx's accessors follow it).
// CAND and CPRIO only when the candidate rows are staged.
struct SfLayout {
  long long w64, w32, bytes;
};

__host__ __device__ inline SfLayout sf_layout(long long QL, long long RF,
                                              long long CL, long long DC,
                                              long long K, bool stage) {
  SfLayout L;
  // U, NOM, GUAR, BASE [QL][RF]; CU, CG, CSUB, CBL [CL][RF]; LEND, REQ,
  // BL0, DEL, LMAG [RF]; SAVE [1 + DC][RF]; SH, WGT, FLR, WMAG [QL];
  // CAND [K][RF]
  L.w64 = 4 * QL * RF + 4 * CL * RF + 5 * RF + (1 + DC) * RF + 4 * QL +
          (stage ? K * RF : 0);
  // SLOTF, SLOTR, SAME, LSH [RF]; GQ [QL]; GC [CL]; CHAIN [QL][DC]; START
  // [QL + 1]; POS, ACT, FRETRY, CNT, ORD, WSH [QL]; TABLE, LOGK, LOGQ,
  // CIDX, CQL [K]; CPRIO [K]
  L.w32 = 4 * RF + QL + CL + QL * DC + QL + 1 + 6 * QL + 5 * K +
          (stage ? K : 0);
  // FRS [RF]; FANY [QL]
  L.bytes = (8 * L.w64 + 4 * L.w32 + RF + QL + 15) / 16 * 16;
  return L;
}

struct SfArgs {
  const long long *nominal, *guaranteed, *borrow_limit, *cohort_subtree,
      *cohort_guaranteed, *cohort_borrow_limit, *usage, *cohort_usage;
  const int *gq, *gf, *gr, *gc, *chain_local;
  const long long* requests;
  const unsigned char* frs_np;
  const int* cand_idx;
  const short* cand_ql;
  const long long* cand_usage;
  const int* cand_prio;
  const unsigned char* threshold_active;
  const long long* threshold;
  const unsigned char* has_cohort;
  const int *cand_rank, *cq_count, *cq_order;
  const long long *base_other, *floor_ratio;
  const unsigned char* floor_any;
  const long long *weight, *lendable;
  unsigned char* scratch;  // the global form's arenas, one a block
  unsigned char* targets;
  unsigned char* feasible;
  signed char* reasons;
  int* stats;
  int B, K, QL, RF, CL, DC, F, R, s0, has_retry, s1;
  long long arena_bytes;
};

extern __shared__ __align__(16) unsigned char sf_smem[];

// One problem's arena. Each array's place is recomputed from the shape
// where it is used, so no register holds an array's address; in the
// shared form every access goes to sf_smem, a shared access.
template <int FORM>
struct SfCtx {
  unsigned char* gbase;  // the global form's slice of scratch
  const long long* cand_usage;
  const int* cand_prio;
  int QL, RF, CL, DC, K, w64, w32;
  bool has_cohort;
  __device__ __forceinline__ long long* w() const {
    return FORM == SF_GLOBAL ? (long long*)gbase : (long long*)sf_smem;
  }
  __device__ __forceinline__ int* n() const { return (int*)(w() + w64); }
  __device__ __forceinline__ unsigned char* by() const {
    return (unsigned char*)(n() + w32);
  }
  __device__ __forceinline__ int qr() const { return QL * RF; }
  __device__ __forceinline__ int cr() const { return CL * RF; }
  __device__ __forceinline__ long long* U() const { return w(); }
  __device__ __forceinline__ long long* NOM() const { return w() + qr(); }
  __device__ __forceinline__ long long* GUAR() const { return w() + 2 * qr(); }
  __device__ __forceinline__ long long* BASE() const { return w() + 3 * qr(); }
  __device__ __forceinline__ long long* CU() const { return w() + 4 * qr(); }
  __device__ __forceinline__ long long* CG() const { return CU() + cr(); }
  __device__ __forceinline__ long long* CSUB() const { return CU() + 2 * cr(); }
  __device__ __forceinline__ long long* CBL() const { return CU() + 3 * cr(); }
  __device__ __forceinline__ long long* LEND() const { return CU() + 4 * cr(); }
  __device__ __forceinline__ long long* REQ() const { return LEND() + RF; }
  __device__ __forceinline__ long long* BL0() const { return LEND() + 2 * RF; }
  __device__ __forceinline__ long long* DEL() const { return LEND() + 3 * RF; }
  __device__ __forceinline__ long long* LMAG() const { return LEND() + 4 * RF; }
  __device__ __forceinline__ long long* SAVE() const { return LEND() + 5 * RF; }
  __device__ __forceinline__ long long* SH() const {
    return SAVE() + (1 + DC) * RF;
  }
  __device__ __forceinline__ long long* WGT() const { return SH() + QL; }
  __device__ __forceinline__ long long* FLR() const { return SH() + 2 * QL; }
  __device__ __forceinline__ long long* WMAG() const { return SH() + 3 * QL; }
  __device__ __forceinline__ long long* CAND() const { return SH() + 4 * QL; }
  __device__ __forceinline__ int* SLOTF() const { return n(); }
  __device__ __forceinline__ int* SLOTR() const { return n() + RF; }
  __device__ __forceinline__ int* SAME() const { return n() + 2 * RF; }
  __device__ __forceinline__ int* LSH() const { return n() + 3 * RF; }
  __device__ __forceinline__ int* GQ() const { return n() + 4 * RF; }
  __device__ __forceinline__ int* GC() const { return GQ() + QL; }
  __device__ __forceinline__ int* CHAIN() const { return GC() + CL; }
  __device__ __forceinline__ int* START() const { return CHAIN() + QL * DC; }
  __device__ __forceinline__ int* POS() const { return START() + QL + 1; }
  __device__ __forceinline__ int* ACT() const { return POS() + QL; }
  __device__ __forceinline__ int* FRETRY() const { return POS() + 2 * QL; }
  __device__ __forceinline__ int* CNT() const { return POS() + 3 * QL; }
  __device__ __forceinline__ int* ORD() const { return POS() + 4 * QL; }
  __device__ __forceinline__ int* WSH() const { return POS() + 5 * QL; }
  __device__ __forceinline__ int* TABLE() const { return POS() + 6 * QL; }
  __device__ __forceinline__ int* LOGK() const { return TABLE() + K; }
  __device__ __forceinline__ int* LOGQ() const { return TABLE() + 2 * K; }
  __device__ __forceinline__ int* CIDX() const { return TABLE() + 3 * K; }
  __device__ __forceinline__ int* CQL() const { return TABLE() + 4 * K; }
  __device__ __forceinline__ int* CPRIO() const { return TABLE() + 5 * K; }
  __device__ __forceinline__ unsigned char* FRS() const { return by(); }
  __device__ __forceinline__ unsigned char* FANY() const { return by() + RF; }
  // candidate k's usage at slot i, and its priority
  __device__ __forceinline__ long long cand(int k, int i) const {
    if (FORM == SF_SHARED) return CAND()[k * RF + i];
    return cand_usage[(size_t)CIDX()[k] * RF + i];
  }
  __device__ __forceinline__ long long prio(int k) const {
    if (FORM == SF_SHARED) return CPRIO()[k];
    return cand_prio[CIDX()[k]];
  }
};

// Slot `lane`'s constants, held in its lane's registers by the narrow
// instance (QL <= 32 and RF <= 32): its resource (-1 where the slot is
// padding), the mask of its same-resource slots, lendable and its
// multiplier, the request, the preemptor CQ's clamped borrow limit and
// whether it needs preemption.
struct SfSlotReg {
  long long lend, lmag, req, bl0;
  int r, lsh;
  unsigned same;
  bool frs;
};

__device__ __forceinline__ long long sf_min(long long a, long long b) {
  return a < b ? a : b;
}

// The warp's largest int64: the high words' signed max, then the low
// words' unsigned max among the lanes that hold it (two redux.sync).
__device__ __forceinline__ long long sf_warp_max64(long long v) {
  const int hi = __reduce_max_sync(SF_FULL, (int)(v >> 32));
  const unsigned lo =
      __reduce_max_sync(SF_FULL, (int)(v >> 32) == hi ? (unsigned)v : 0u);
  return (long long)(((unsigned long long)(unsigned)hi << 32) | lo);
}

// The keyed pick. Each lane offers its best CQ: the largest eligible share
// (-2^62 if none), then, at the warp's largest share m, its tie value
// (cq_order where eligible at m, SF_NONE where not, INT_MAX from a lane
// with no CQ) and slot. Returns the eligible CQ of the largest share,
// ties to the lowest cq_order, then the lowest slot, as the JAX program's
// max and argmin of the tie values: slot 0 when none is eligible.
template <class Tie>
__device__ __forceinline__ int sf_pick_keyed(long long key, Tie tie) {
  const long long m = sf_warp_max64(key);
  int tv, slot;
  tie(m, &tv, &slot);
  const int mt = __reduce_min_sync(SF_FULL, tv);
  return (int)__reduce_min_sync(SF_FULL,
                                tv == mt ? (unsigned)slot : 0xffffffffu);
}

// The divisor d's multiplier for sf_fdiv (0 when d is outside [1, 2^31)),
// and its shift through *sh: m = floor(2^(31 + l) / d) + 1, l = ceil(log2
// d). For 0 <= n < 2^31, floor(n / d) = n * m >> (31 + l) (Granlund and
// Montgomery's theorem 4.2 with N = 31: m * d - 2^(31 + l) is in (0, d]).
__device__ __forceinline__ long long sf_magic(long long d, int* sh) {
  if (d < 1 || d >= (1LL << 31)) {
    *sh = 0;
    return 0;
  }
  const int l = 32 - __clz((unsigned)(d - 1));
  *sh = 31 + l;
  return (long long)((1ULL << (31 + l)) / (unsigned long long)d + 1);
}

// floor(n / d) (JAX's //), by the divisor's multiplier where n is in
// [-2^31, 2^31) (a negative n through floor(n / d) = ~floor(~n / d)), by
// kq_floordiv otherwise. d > 0.
__device__ __forceinline__ long long sf_fdiv(long long n, long long d,
                                             long long m, int sh) {
  if (m != 0 && (unsigned long long)n + (1ULL << 31) < (1ULL << 32)) {
    const unsigned long long u = (unsigned long long)(n >= 0 ? n : ~n);
    const long long q = (long long)((u * (unsigned long long)m) >> sh);
    return n >= 0 ? q : ~q;
  }
  return kq_floordiv(n, d);
}

// The last step of dominantResourceShare: drs = max(ratio, floor), then
// drs * 1000 // weight where it borrows, 2^62 for weight 0.
template <int FORM>
__device__ __forceinline__ long long sf_share_of(const SfCtx<FORM>& c, int q,
                                                 long long best,
                                                 bool borrows) {
  const long long w = c.WGT()[q];
  if (w == 0) return SF_MAXSHARE;
  const long long fl = c.FLR()[q];
  const long long drs = fl > best ? fl : best;
  return borrows ? sf_fdiv(drs * 1000, w > 1 ? w : 1, c.WMAG()[q], c.WSH()[q])
                 : 0;
}

// The ratio of slot i at borrowed amount br: br * 1000 // lendable, -1
// where nothing is lent or borrowed.
template <int FORM>
__device__ __forceinline__ long long sf_ratio(const SfCtx<FORM>& c, int i,
                                              long long br) {
  const long long lend = c.LEND()[i];
  return (br > 0 && lend > 0)
             ? sf_fdiv(br * 1000, lend, c.LMAG()[i], c.LSH()[i]) : -1;
}

// The row a share is taken at: CQ q's usage less candidate k's (k >= 0),
// plus the request (k == SF_ROW_REQ, q = 0), or as it is (SF_ROW_NONE).
#define SF_ROW_NONE -1
#define SF_ROW_REQ -2

// ---- the narrow instance: lane i holds slot i, lane q holds CQ q ----

// dominantResourceShare of CQ q at a row (above): each lane its slot's
// borrowed amount, each slot's resource sum by its mask over RF
// shuffles, the ratios' max in two reductions. Every lane returns it.
template <int FORM>
__device__ __forceinline__ long long sf_share_n(const SfCtx<FORM> c,
                                             const SfSlotReg s, int q, int k,
                                             int lane) {
  const int RF = c.RF;
  const bool on = lane < RF;
  const int x = q * RF + (on ? lane : 0);
  long long u = c.U()[x];
  if (k >= 0) u -= c.cand(k, on ? lane : 0);
  if (k == SF_ROW_REQ) u += s.req;
  const long long b = on && s.r >= 0 ? kq_max0(u - c.NOM()[x]) : 0;
  long long br = c.BASE()[x];
  for (int j = 0; j < RF; ++j) {
    const long long v = __shfl_sync(SF_FULL, b, j);
    br += (s.same >> j) & 1u ? v : 0;
  }
  const long long ratio =
      !on ? LLONG_MIN
          : (br > 0 && s.lend > 0) ? sf_fdiv(br * 1000, s.lend, s.lmag, s.lsh)
                                   : -1;
  const long long best = sf_warp_max64(ratio);
  const bool borrows = __any_sync(SF_FULL, on && br > 0) || c.FANY()[q];
  return sf_share_of(c, q, best, borrows);
}

// Lane q's CQ's share at U, every lane at once (the initial shares and
// the retry pass's); slot i's constants come from lane i.
template <int FORM>
__device__ __forceinline__ long long sf_shares_n(const SfCtx<FORM> c,
                                              const SfSlotReg s, int lane) {
  const int RF = c.RF, q = lane < c.QL ? lane : 0, row = q * RF;
  long long best = LLONG_MIN;
  bool borrows = false;
  for (int i = 0; i < RF; ++i) {
    const unsigned same = __shfl_sync(SF_FULL, s.same, i);
    const long long lend = __shfl_sync(SF_FULL, s.lend, i);
    const long long lmag = __shfl_sync(SF_FULL, s.lmag, i);
    const int lsh = __shfl_sync(SF_FULL, s.lsh, i);
    long long br = c.BASE()[row + i];
    for (unsigned m = same; m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      br += kq_max0(c.U()[row + j] - c.NOM()[row + j]);
    }
    const long long ratio =
        (br > 0 && lend > 0) ? sf_fdiv(br * 1000, lend, lmag, lsh) : -1;
    best = ratio > best ? ratio : best;
    borrows |= br > 0;
  }
  return sf_share_of(c, q, best, borrows || c.FANY()[q]);
}

// workload_fits with borrowing allowed (preemption.go:576-585): every
// requested slot within the availability of CQ 0, walked down its cohort
// chain from the root end (resource_node.go:89-104); a vote.
template <int FORM>
__device__ __forceinline__ bool sf_fits_n(const SfCtx<FORM> c,
                                       const SfSlotReg s, int lane) {
  bool ok = true;
  if (lane < c.RF && s.req > 0) {
    const int RF = c.RF, i = lane;
    const long long u0 = c.U()[i], nom0 = c.NOM()[i], guar0 = c.GUAR()[i];
    long long avail;
    if (c.has_cohort) {
      long long parent = 0;
      bool started = false;
      for (int d = c.DC - 1; d >= 0; --d) {
        const int ch = c.CHAIN()[d];
        if (ch < 0 || ch >= c.CL) continue;
        const int ci = ch * RF + i;
        const long long cuc = c.CU()[ci], sub = c.CSUB()[ci], gua = c.CG()[ci];
        const long long cap = (sub - gua) - kq_max0(cuc - gua) +
                              sf_min(c.CBL()[ci], SF_LIM);
        const long long child = kq_max0(gua - cuc) + sf_min(parent, cap);
        parent = started ? child : sub - cuc;
        started = true;
      }
      const long long cap0 = (nom0 - guar0) - kq_max0(u0 - guar0) + s.bl0;
      avail = kq_max0(guar0 - u0) + sf_min(parent, cap0);
    } else {
      avail = nom0 - u0;
    }
    ok = s.req <= avail;
  }
  return __all_sync(SF_FULL, ok);
}

// removeUsage (resource_node.go:133-143) of candidate k's row from CQ q:
// the part above guaranteed quota climbs the chain while any of it is
// left; each lane its slot, a vote a level.
template <int FORM>
__device__ __forceinline__ void sf_remove_n(const SfCtx<FORM> c, int q, int k,
                                         int lane) {
  const int RF = c.RF;
  const bool on = lane < RF;
  const int i = on ? lane : 0, qi = q * RF + i;
  const long long v = on ? c.cand(k, i) : 0;
  const long long u = c.U()[qi];
  if (on) c.U()[qi] = u - v;
  long long del = sf_min(v, kq_max0(u - c.GUAR()[qi]));
  for (int d = 0; d < c.DC; ++d) {
    const int ch = c.CHAIN()[q * c.DC + d];
    const bool okc = ch >= 0 && ch < c.CL;
    const bool ok = __any_sync(SF_FULL, del > 0) && okc;
    const int ci = (okc ? ch : 0) * RF + i;
    const long long cu = c.CU()[ci];
    const long long dd = ok ? del : 0;
    if (ok && on) c.CU()[ci] = cu - dd;
    del = sf_min(dd, okc ? kq_max0(cu - c.CG()[ci]) : 0);
  }
}

// addUsage (resource_node.go:121-131) of candidate k's row to CQ q,
// saving the rows it changes (lane-local columns of SAVE) for sf_restore.
template <int FORM>
__device__ __forceinline__ void sf_add_n(const SfCtx<FORM> c, int q, int k,
                                      int lane) {
  const int RF = c.RF;
  if (lane >= RF) return;
  const int i = lane, qi = q * RF + i;
  const long long u = c.U()[qi], v = c.cand(k, i);
  c.SAVE()[i] = u;
  const long long local = kq_max0(c.GUAR()[qi] - u);
  c.U()[qi] = u + v;
  long long delta = kq_max0(v - local);
  for (int d = 0; d < c.DC; ++d) {
    const int ch = c.CHAIN()[q * c.DC + d];
    if (ch < 0 || ch >= c.CL) continue;
    const int ci = ch * RF + i;
    const long long cu = c.CU()[ci];
    c.SAVE()[(1 + d) * RF + i] = cu;
    const long long local_c = kq_max0(c.CG()[ci] - cu);
    c.CU()[ci] = cu + delta;
    delta = kq_max0(delta - local_c);
  }
}

template <int FORM>
__device__ __forceinline__ void sf_restore_n(const SfCtx<FORM> c, int q,
                                          int lane) {
  const int RF = c.RF;
  if (lane >= RF) return;
  const int i = lane;
  c.U()[q * RF + i] = c.SAVE()[i];
  for (int d = 0; d < c.DC; ++d) {
    const int ch = c.CHAIN()[q * c.DC + d];
    if (ch < 0 || ch >= c.CL) continue;
    c.CU()[ch * RF + i] = c.SAVE()[(1 + d) * RF + i];
  }
}

// ---- the general instance: lanes stride over the slots and the CQs ----

template <int FORM>
__device__ __forceinline__ long long sf_share_g(const SfCtx<FORM> c, int q,
                                             int k, int lane) {
  const int RF = c.RF, row = q * RF;
  for (int i = lane; i < RF; i += 32) {
    long long ui = c.U()[row + i];
    if (k >= 0) ui -= c.cand(k, i);
    if (k == SF_ROW_REQ) ui += c.REQ()[i];
    c.DEL()[i] = c.SLOTR()[i] >= 0 ? kq_max0(ui - c.NOM()[row + i]) : 0;
  }
  __syncwarp();
  long long best = LLONG_MIN;
  bool borrows = false;
  for (int i = lane; i < RF; i += 32) {
    long long br = c.BASE()[row + i];
    const int r = c.SLOTR()[i];
    if (r >= 0)
      for (int j = 0; j < RF; ++j)
        if (c.SLOTR()[j] == r) br += c.DEL()[j];
    const long long ratio = sf_ratio(c, i, br);
    best = ratio > best ? ratio : best;
    borrows |= br > 0;
  }
  best = sf_warp_max64(best);
  borrows = __any_sync(SF_FULL, borrows) || c.FANY()[q];
  __syncwarp();
  return sf_share_of(c, q, best, borrows);
}

// CQ q's share at U, computed by one lane alone.
template <int FORM>
__device__ __forceinline__ long long sf_share_lane_g(const SfCtx<FORM> c,
                                                  int q) {
  const int RF = c.RF, row = q * RF;
  long long best = LLONG_MIN;
  bool borrows = false;
  for (int i = 0; i < RF; ++i) {
    long long br = c.BASE()[row + i];
    const int r = c.SLOTR()[i];
    if (r >= 0)
      for (int j = 0; j < RF; ++j)
        if (c.SLOTR()[j] == r) br += kq_max0(c.U()[row + j] - c.NOM()[row + j]);
    const long long ratio = sf_ratio(c, i, br);
    best = ratio > best ? ratio : best;
    borrows |= br > 0;
  }
  return sf_share_of(c, q, best, borrows || c.FANY()[q]);
}

template <int FORM>
__device__ __forceinline__ bool sf_fits_g(const SfCtx<FORM> c, int lane) {
  const int RF = c.RF;
  bool ok = true;
  for (int i = lane; i < RF; i += 32) {
    const long long req = c.REQ()[i];
    if (req <= 0) continue;
    const long long u0 = c.U()[i], nom0 = c.NOM()[i], guar0 = c.GUAR()[i];
    long long avail;
    if (c.has_cohort) {
      long long parent = 0;
      bool started = false;
      for (int d = c.DC - 1; d >= 0; --d) {
        const int ch = c.CHAIN()[d];
        if (ch < 0 || ch >= c.CL) continue;
        const int ci = ch * RF + i;
        const long long cuc = c.CU()[ci], sub = c.CSUB()[ci], gua = c.CG()[ci];
        const long long cap = (sub - gua) - kq_max0(cuc - gua) +
                              sf_min(c.CBL()[ci], SF_LIM);
        const long long child = kq_max0(gua - cuc) + sf_min(parent, cap);
        parent = started ? child : sub - cuc;
        started = true;
      }
      const long long cap0 = (nom0 - guar0) - kq_max0(u0 - guar0) + c.BL0()[i];
      avail = kq_max0(guar0 - u0) + sf_min(parent, cap0);
    } else {
      avail = nom0 - u0;
    }
    if (req > avail) ok = false;
  }
  return __all_sync(SF_FULL, ok);
}

template <int FORM>
__device__ __forceinline__ void sf_remove_g(const SfCtx<FORM> c, int q, int k,
                                         int lane) {
  const int RF = c.RF;
  for (int i = lane; i < RF; i += 32) {
    const int qi = q * RF + i;
    const long long v = c.cand(k, i);
    const long long stored = c.U()[qi] - c.GUAR()[qi];
    c.U()[qi] -= v;
    c.DEL()[i] = sf_min(v, kq_max0(stored));
  }
  for (int d = 0; d < c.DC; ++d) {
    const int ch = c.CHAIN()[q * c.DC + d];
    const bool okc = ch >= 0 && ch < c.CL;
    bool pos = false;
    for (int i = lane; i < RF; i += 32) pos |= c.DEL()[i] > 0;
    const bool ok = __any_sync(SF_FULL, pos) && okc;
    for (int i = lane; i < RF; i += 32) {
      const int ci = (okc ? ch : 0) * RF + i;
      const long long stored_c = okc ? c.CU()[ci] - c.CG()[ci] : 0;
      const long long dd = ok ? c.DEL()[i] : 0;
      if (ok) c.CU()[ci] -= dd;
      c.DEL()[i] = sf_min(dd, kq_max0(stored_c));
    }
  }
}

template <int FORM>
__device__ __forceinline__ void sf_add_g(const SfCtx<FORM> c, int q, int k,
                                      int lane) {
  const int RF = c.RF;
  for (int i = lane; i < RF; i += 32) {
    const int qi = q * RF + i;
    const long long u = c.U()[qi], v = c.cand(k, i);
    c.SAVE()[i] = u;
    const long long local = kq_max0(c.GUAR()[qi] - u);
    c.U()[qi] = u + v;
    long long delta = kq_max0(v - local);
    for (int d = 0; d < c.DC; ++d) {
      const int ch = c.CHAIN()[q * c.DC + d];
      if (ch < 0 || ch >= c.CL) continue;
      const int ci = ch * RF + i;
      const long long cu = c.CU()[ci];
      c.SAVE()[(1 + d) * RF + i] = cu;
      const long long local_c = kq_max0(c.CG()[ci] - cu);
      c.CU()[ci] = cu + delta;
      delta = kq_max0(delta - local_c);
    }
  }
}

template <int FORM>
__device__ __forceinline__ void sf_restore_g(const SfCtx<FORM> c, int q,
                                          int lane) {
  const int RF = c.RF;
  for (int i = lane; i < RF; i += 32) {
    c.U()[q * RF + i] = c.SAVE()[i];
    for (int d = 0; d < c.DC; ++d) {
      const int ch = c.CHAIN()[q * c.DC + d];
      if (ch < 0 || ch >= c.CL) continue;
      c.CU()[ch * RF + i] = c.SAVE()[(1 + d) * RF + i];
    }
  }
}

// Whether CQ q still borrows on a needs-preemption slot.
template <int FORM>
__device__ __forceinline__ bool sf_borrowing(const SfCtx<FORM> c, int q,
                                          int lane) {
  bool b = false;
  for (int i = lane; i < c.RF; i += 32)
    b |= c.FRS()[i] && c.U()[q * c.RF + i] > c.NOM()[q * c.RF + i];
  return __any_sync(SF_FULL, b);
}

// ---- staging ----

struct SfIn1 {  // what a staging element reads of the problem's own arrays
  long long w, fl, req, lend, base;
  int gq, cnt, ord, f, r, ch, gc, cq, rank, idx;
  unsigned char fany, frs;
};
struct SfIn2 {  // ... and of what they index
  long long u, nom, guar, cu, cg, csub, cbl, bl0;
  int prio;
};

// Stage problem b into the arena: the problem's own arrays, element e of
// every array read in one pass (a round trip a batch of 32 * SF_BATCH
// elements), then the planes, cohort rows, borrow limits and priorities
// they index the same way, then the candidates' rows (8 slots of
// SF_BATCH candidates a lane in flight), then the slots' masks and the
// divisors' multipliers. Returns the problem's candidate count.
template <int FORM>
__device__ __forceinline__ int sf_stage(const SfCtx<FORM> c, const SfArgs& a,
                                     int b, int lane) {
  const int QL = c.QL, RF = c.RF, CL = c.CL, DC = c.DC, K = c.K;
  const int qr = QL * RF, cr = CL * RF, qd = QL * DC;
  int n1 = K > qr ? K : qr;
  n1 = n1 > qd ? n1 : qd;
  n1 = n1 > QL ? n1 : QL;
  n1 = n1 > RF ? n1 : RF;
  n1 = n1 > CL ? n1 : CL;
  int nvalid = 0;
  for (int e0 = lane; e0 < n1; e0 += 32 * SF_BATCH) {
    SfIn1 v[SF_BATCH];
#pragma unroll
    for (int j = 0; j < SF_BATCH; ++j) {
      const int e = e0 + 32 * j;
      SfIn1& x = v[j];
      if (e < QL) {
        const size_t bq = (size_t)b * QL + e;
        x.gq = a.gq[bq];
        x.cnt = a.cq_count[bq];
        x.ord = a.cq_order[bq];
        x.w = a.weight[bq];
        x.fl = a.floor_ratio[bq];
        x.fany = a.floor_any[bq];
      }
      if (e < RF) {
        const size_t bi = (size_t)b * RF + e;
        x.f = a.gf[bi];
        x.r = a.gr[bi];
        x.req = a.requests[bi];
        x.lend = a.lendable[bi];
        x.frs = a.frs_np[bi];
      }
      if (e < qd) x.ch = a.chain_local[(size_t)b * qd + e];
      if (e < CL) x.gc = a.gc[(size_t)b * CL + e];
      if (e < K) {
        const size_t bk = (size_t)b * K + e;
        x.cq = a.cand_ql[bk];
        x.rank = a.cand_rank[bk];
        x.idx = a.cand_idx[bk];
      }
      if (e < qr) x.base = a.base_other[(size_t)b * qr + e];
    }
#pragma unroll
    for (int j = 0; j < SF_BATCH; ++j) {
      const int e = e0 + 32 * j;
      const SfIn1& x = v[j];
      if (e < QL) {
        c.GQ()[e] = x.gq;
        c.CNT()[e] = x.cnt;
        c.ORD()[e] = x.ord;
        c.WGT()[e] = x.w;
        c.FLR()[e] = x.fl;
        c.FANY()[e] = x.fany;
      }
      if (e < RF) {
        c.SLOTF()[e] = x.f;
        c.SLOTR()[e] = x.f >= 0 ? x.r : -1;
        c.REQ()[e] = x.req;
        c.LEND()[e] = x.lend;
        c.FRS()[e] = x.frs;
      }
      if (e < qd) c.CHAIN()[e] = x.ch;
      if (e < CL) c.GC()[e] = x.gc;
      if (e < K) {
        c.CQL()[e] = x.cq;
        c.LOGK()[e] = x.rank;  // the ranks, until the table is built
        c.CIDX()[e] = x.idx;
        nvalid += x.cq >= 0;
      }
      if (e < qr) c.BASE()[e] = x.base;
    }
  }
  __syncwarp();
  int n2 = qr > cr ? qr : cr;
  n2 = n2 > K ? n2 : K;
  for (int e0 = lane; e0 < n2; e0 += 32 * SF_BATCH) {
    SfIn2 v[SF_BATCH];
#pragma unroll
    for (int j = 0; j < SF_BATCH; ++j) {
      const int e = e0 + 32 * j;
      SfIn2& x = v[j];
      if (e < qr) {
        const int q = e / RF, i = e - q * RF;
        const int g = c.GQ()[q] > 0 ? c.GQ()[q] : 0, f = c.SLOTF()[i];
        const size_t y = ((size_t)g * a.F + (f > 0 ? f : 0)) * a.R +
                         (f >= 0 ? c.SLOTR()[i] : 0);
        x.u = f >= 0 ? a.usage[y] : 0;
        x.nom = f >= 0 ? a.nominal[y] : 0;
        x.guar = f >= 0 ? a.guaranteed[y] : 0;
        if (q == 0) {
          const size_t z = ((size_t)g * a.F + (f > 0 ? f : 0)) * a.R +
                           (f >= 0 ? c.SLOTR()[i] : 0);
          x.bl0 = f >= 0 ? a.borrow_limit[z] : SF_NOLIM;
        }
      }
      if (e < cr) {
        const int h = e / RF, i = e - h * RF;
        const int g = c.GC()[h], f = c.SLOTF()[i];
        const bool ok = f >= 0 && g >= 0;
        const size_t y = ok ? ((size_t)g * a.F + f) * a.R + c.SLOTR()[i] : 0;
        x.cu = ok ? a.cohort_usage[y] : 0;
        x.cg = ok ? a.cohort_guaranteed[y] : 0;
        x.csub = ok ? a.cohort_subtree[y] : 0;
        x.cbl = ok ? a.cohort_borrow_limit[y] : SF_NOLIM;
      }
      if (FORM == SF_SHARED && e < K)
        x.prio = c.CQL()[e] >= 0 ? a.cand_prio[c.CIDX()[e]] : 0;
    }
#pragma unroll
    for (int j = 0; j < SF_BATCH; ++j) {
      const int e = e0 + 32 * j;
      const SfIn2& x = v[j];
      if (e < qr) {
        c.U()[e] = x.u;
        c.NOM()[e] = x.nom;
        c.GUAR()[e] = x.guar;
        if (e < RF) c.BL0()[e] = sf_min(x.bl0, SF_LIM);
      }
      if (e < cr) {
        c.CU()[e] = x.cu;
        c.CG()[e] = x.cg;
        c.CSUB()[e] = x.csub;
        c.CBL()[e] = x.cbl;
      }
      if (FORM == SF_SHARED && e < K) c.CPRIO()[e] = x.prio;
    }
  }
  if (FORM == SF_SHARED) {
    // the candidates' rows: a lane SF_BATCH candidates, 8 slots of each
    // at a time, every load of a batch before its stores
    for (int k0 = lane; k0 < K; k0 += 32 * SF_BATCH) {
      const long long* row[SF_BATCH];
#pragma unroll
      for (int j = 0; j < SF_BATCH; ++j) {
        const int k = k0 + 32 * j;
        row[j] = k < K && c.CQL()[k] >= 0
                     ? a.cand_usage + (size_t)c.CIDX()[k] * RF : nullptr;
      }
      for (int i0 = 0; i0 < RF; i0 += 8) {
        long long v[SF_BATCH][8];
#pragma unroll
        for (int j = 0; j < SF_BATCH; ++j)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            v[j][i] = row[j] && i0 + i < RF ? row[j][i0 + i] : 0;
#pragma unroll
        for (int j = 0; j < SF_BATCH; ++j) {
          const int k = k0 + 32 * j;
          if (k < K)
#pragma unroll
            for (int i = 0; i < 8; ++i)
              if (i0 + i < RF) c.CAND()[k * RF + i0 + i] = v[j][i];
        }
      }
    }
  }
  // the slots' same-resource masks and the divisors' multipliers
  const int nm = QL > RF ? QL : RF;
  for (int x = lane; x < nm; x += 32) {
    int lsh = 0, wsh = 0;
    long long lmag = 0, wmag = 0;
    if (x < RF) lmag = sf_magic(c.LEND()[x], &lsh);
    if (x < QL) {
      const long long w = c.WGT()[x];
      wmag = sf_magic(w > 1 ? w : 1, &wsh);
    }
    if (x < RF) {
      unsigned same = 0;
      const int r = c.SLOTR()[x];
      if (r >= 0 && RF <= 32)
        for (int j = 0; j < RF; ++j) same |= (c.SLOTR()[j] == r ? 1u : 0u) << j;
      c.SAME()[x] = (int)same;
      c.LMAG()[x] = lmag;
      c.LSH()[x] = lsh;
    }
    if (x < QL) {
      c.WMAG()[x] = wmag;
      c.WSH()[x] = wsh;
    }
  }
  __syncwarp();
  return (int)__reduce_add_sync(SF_FULL, (unsigned)nvalid);
}

// The (CQ, rank) -> candidate table over the CSR of the CQs' counts
// (START, with START[QL] the total), from the staged ranks.
template <int FORM>
__device__ __forceinline__ void sf_table(const SfCtx<FORM> c, int lane) {
  const int K = c.K, QL = c.QL;
  for (int k = lane; k < K; k += 32) c.TABLE()[k] = -1;
  __syncwarp();
  for (int k = lane; k < K; k += 32) {
    const int q = c.CQL()[k], r = c.LOGK()[k];
    if (q >= 0 && q < QL && r >= 0 && r < c.CNT()[q]) {
      const int slot = c.START()[q] + r;
      if (slot < K) c.TABLE()[slot] = k;
    }
  }
  __syncwarp();
}

// One step of a problem's chain in either instance.
template <bool N, int FORM>
__device__ __forceinline__ long long sf_share(const SfCtx<FORM>& c,
                                              const SfSlotReg& s, int q,
                                              int k, int lane) {
  if (N) return sf_share_n(c, s, q, k, lane);
  return sf_share_g(c, q, k, lane);
}
template <bool N, int FORM>
__device__ __forceinline__ bool sf_fits(const SfCtx<FORM>& c,
                                        const SfSlotReg& s, int lane) {
  if (N) return sf_fits_n(c, s, lane);
  return sf_fits_g(c, lane);
}
template <bool N, int FORM>
__device__ __forceinline__ void sf_remove(const SfCtx<FORM>& c, int q, int k,
                                          int lane) {
  if (N) sf_remove_n(c, q, k, lane);
  else sf_remove_g(c, q, k, lane);
}

template <bool N, int FORM>
__global__ void __launch_bounds__(SF_THREADS, 1)
solve_fair_kernel(const __grid_constant__ SfArgs a) {
  const int lane = threadIdx.x & 31;
  const SfLayout L =
      sf_layout(a.QL, a.RF, a.CL, a.DC, a.K, FORM == SF_SHARED);
  SfCtx<FORM> c;
  c.gbase = FORM == SF_GLOBAL
                ? a.scratch + (size_t)blockIdx.x * a.arena_bytes : nullptr;
  c.cand_usage = a.cand_usage;
  c.cand_prio = a.cand_prio;
  c.QL = a.QL; c.RF = a.RF; c.CL = a.CL; c.DC = a.DC; c.K = a.K;
  c.w64 = (int)L.w64;
  c.w32 = (int)L.w32;
  c.has_cohort = false;
  const int QL = a.QL, K = a.K;
  const bool qon = lane < QL;  // N: lane q holds CQ q

  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const int nvalid = sf_stage(c, a, b, lane);
    c.has_cohort = a.has_cohort[b] != 0;
    if (nvalid == 0) {
      // no candidate: nothing is ever removed; the heap pops in vain
      // until K when a CQ claims candidates (it never does as encoded)
      bool claims = false;
      for (int q = lane; q < QL; q += 32)
        claims |= c.GQ()[q] >= 0 && c.CNT()[q] > 0;
      if (__any_sync(SF_FULL, claims) && lane == 0)
        a.stats[(size_t)b * 4 + 1] = K;
      __syncwarp();
      continue;
    }
    const bool th_act = a.threshold_active[b] != 0;
    const long long th = a.threshold[b];
    unsigned char* targets = a.targets + (size_t)b * K;
    signed char* reasons = a.reasons + (size_t)b * K;

    // slot `lane`'s constants (the narrow instance), the table's CSR and
    // the CQs' heap state
    SfSlotReg s{0, 0, 0, 0, -1, 0, 0u, false};
    long long sh = 0;
    int pos = 0, act = 0, fretry = -1, cnt = 0, ord = 0, start = 0;
    if (N) {
      if (lane < c.RF) {
        s.lend = c.LEND()[lane];
        s.lmag = c.LMAG()[lane];
        s.lsh = c.LSH()[lane];
        s.req = c.REQ()[lane];
        s.bl0 = c.BL0()[lane];
        s.r = c.SLOTR()[lane];
        s.same = (unsigned)c.SAME()[lane];
        s.frs = c.FRS()[lane];
      }
      cnt = qon ? c.CNT()[lane] : 0;
      ord = qon ? c.ORD()[lane] : 0;
      act = qon && c.GQ()[lane] >= 0;  // an invalid CQ is never eligible
      int x = cnt > 0 ? cnt : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(SF_FULL, x, o);
        if (lane >= o) x += y;
      }
      start = x - (cnt > 0 ? cnt : 0);
      if (qon) c.START()[lane] = start;
      if (lane == QL - 1) c.START()[QL] = x;
      __syncwarp();
      sf_table(c, lane);
      sh = sf_shares_n(c, s, lane);
      if (!act) sh = 0;
    } else {
      if (lane == 0) {
        int acc = 0;
        for (int q = 0; q < QL; ++q) {
          c.START()[q] = acc;
          acc += c.CNT()[q] > 0 ? c.CNT()[q] : 0;
        }
        c.START()[QL] = acc;
      }
      for (int q = lane; q < QL; q += 32) {
        c.POS()[q] = 0;
        c.ACT()[q] = c.GQ()[q] >= 0;
        c.FRETRY()[q] = -1;
        c.SH()[q] = c.GQ()[q] >= 0 ? sf_share_lane_g(c, q) : 0;
      }
      __syncwarp();
      sf_table(c, lane);
    }
    long long nom_share = sf_share<N>(c, s, 0, SF_ROW_REQ, lane);

    // 2. the DRF-heap loop
    bool done = false;
    int t = 0, L_ = 0;
    while (!done && t < K) {
      int qs;
      bool any;
      if (N) {
        const bool e = act && pos < cnt;
        any = __any_sync(SF_FULL, e);
        qs = sf_pick_keyed(e ? sh : -SF_MAXSHARE,
                           [&](long long m, int* tv, int* slot) {
          *tv = qon ? (e && sh == m ? ord : SF_NONE) : INT_MAX;
          *slot = lane;
        });
      } else {
        long long km = -SF_MAXSHARE;
        bool e_any = false;
        for (int q = lane; q < QL; q += 32) {
          const bool e = c.ACT()[q] && c.POS()[q] < c.CNT()[q];
          e_any |= e;
          if (e && c.SH()[q] > km) km = c.SH()[q];
        }
        any = __any_sync(SF_FULL, e_any);
        qs = sf_pick_keyed(km, [&](long long m, int* tv, int* slot) {
          *tv = INT_MAX;
          *slot = INT_MAX;
          for (int q = lane; q < QL; q += 32) {
            const bool e = c.ACT()[q] && c.POS()[q] < c.CNT()[q];
            const int v = e && c.SH()[q] == m ? c.ORD()[q] : SF_NONE;
            if (v < *tv) {
              *tv = v;
              *slot = q;
            }
          }
        });
      }
      if (!any) break;
      // the popped CQ's candidate of the next rank
      int k, pos_q, cnt_q;
      long long sh_q;
      if (N) {
        int kk = -1;
        if (lane == qs && pos < cnt && start + pos < K)
          kk = c.TABLE()[start + pos];
        k = __shfl_sync(SF_FULL, kk, qs);
        sh_q = __shfl_sync(SF_FULL, sh, qs);
        pos_q = __shfl_sync(SF_FULL, pos, qs);
        cnt_q = __shfl_sync(SF_FULL, cnt, qs);
      } else {
        pos_q = c.POS()[qs];
        cnt_q = c.CNT()[qs];
        sh_q = c.SH()[qs];
        k = (pos_q >= 0 && pos_q < cnt_q && c.START()[qs] + pos_q < K)
                ? c.TABLE()[c.START()[qs] + pos_q] : -1;
      }
      const bool k_valid = k >= 0;
      const long long cand_p = k_valid ? c.prio(k) : 0;
      const bool own = qs == 0;
      const long long new_share =
          sf_share<N>(c, s, qs, k_valid ? k : SF_ROW_NONE, lane);
      const bool strat_ok = a.s0 ? nom_share <= new_share : nom_share < sh_q;
      const bool passed = own || (th_act && cand_p < th) || strat_ok;
      const bool removes = k_valid && passed;
      if (removes) {
        sf_remove<N>(c, qs, k, lane);
        if (own) nom_share = sf_share<N>(c, s, 0, SF_ROW_REQ, lane);
        if (lane == 0) {
          targets[k] = 1;
          reasons[k] = own ? 0 : (strat_ok ? 1 : 2);
          c.LOGK()[L_] = k;
          c.LOGQ()[L_] = qs;
        }
        ++L_;
      }
      const int new_pos = pos_q + (k_valid ? 1 : 0);
      const bool exhausted = new_pos >= cnt_q;
      const bool keep = (own || !removes)
                            ? !exhausted
                            : (!exhausted && sf_borrowing(c, qs, lane));
      if (N) {
        if (lane == qs) {
          if (k_valid && !passed && fretry < 0) fretry = k;
          pos = new_pos;
          if (k_valid) act = keep;
          if (removes) sh = new_share;
        }
      } else {
        __syncwarp();
        if (lane == 0) {
          if (k_valid && !passed && c.FRETRY()[qs] < 0) c.FRETRY()[qs] = k;
          c.POS()[qs] = new_pos;
          if (k_valid) c.ACT()[qs] = keep;
          if (removes) c.SH()[qs] = new_share;
        }
        __syncwarp();
      }
      if (removes) done = sf_fits<N>(c, s, lane);
      ++t;
    }
    const int pops = t;

    // 3. the retry pass: the second strategy, shares fixed at its entry
    if (a.has_retry && !done) {
      if (N) {
        sh = sf_shares_n(c, s, lane);
        if (!(qon && c.GQ()[lane] >= 0)) sh = 0;
      } else {
        for (int q = lane; q < QL; q += 32) {
          c.SH()[q] = c.GQ()[q] >= 0 ? sf_share_lane_g(c, q) : 0;
          c.ACT()[q] = 0;  // processed
        }
        __syncwarp();
      }
      const long long nom_r = sf_share<N>(c, s, 0, SF_ROW_REQ, lane);
      bool processed = false;
      for (int step = 0; step < QL; ++step) {
        int qs;
        bool any;
        if (N) {
          const bool e = fretry >= 0 && !processed;
          any = __any_sync(SF_FULL, e);
          qs = sf_pick_keyed(e ? sh : -SF_MAXSHARE,
                             [&](long long m, int* tv, int* slot) {
            *tv = qon ? (e && sh == m ? ord : SF_NONE) : INT_MAX;
            *slot = lane;
          });
        } else {
          long long km = -SF_MAXSHARE;
          bool e_any = false;
          for (int q = lane; q < QL; q += 32) {
            const bool e = c.FRETRY()[q] >= 0 && !c.ACT()[q];
            e_any |= e;
            if (e && c.SH()[q] > km) km = c.SH()[q];
          }
          any = __any_sync(SF_FULL, e_any);
          qs = sf_pick_keyed(km, [&](long long m, int* tv, int* slot) {
            *tv = INT_MAX;
            *slot = INT_MAX;
            for (int q = lane; q < QL; q += 32) {
              const bool e = c.FRETRY()[q] >= 0 && !c.ACT()[q];
              const int v = e && c.SH()[q] == m ? c.ORD()[q] : SF_NONE;
              if (v < *tv) {
                *tv = v;
                *slot = q;
              }
            }
          });
        }
        if (!any) break;  // every later step is the same no-op
        int k;
        long long sh_q;
        if (N) {
          k = __shfl_sync(SF_FULL, fretry, qs);
          sh_q = __shfl_sync(SF_FULL, sh, qs);
          if (lane == qs) processed = true;
        } else {
          k = c.FRETRY()[qs];
          sh_q = c.SH()[qs];
          __syncwarp();
          if (lane == 0) c.ACT()[qs] = 1;
          __syncwarp();
        }
        const bool removes = a.s1 ? nom_r <= 0 : nom_r < sh_q;
        if (removes) {
          sf_remove<N>(c, qs, k, lane);
          if (lane == 0) {
            targets[k] = 1;
            reasons[k] = 1;
            c.LOGK()[L_] = k;
            c.LOGQ()[L_] = qs;
          }
          ++L_;
          if ((done = sf_fits<N>(c, s, lane))) break;
        }
      }
    }

    // 4. feasibility, then fill-back in reverse removal order
    __syncwarp();
    if (!done) {
      for (int j = lane; j < L_; j += 32) targets[c.LOGK()[j]] = 0;
      if (lane == 0) {
        a.stats[(size_t)b * 4 + 0] = nvalid;
        a.stats[(size_t)b * 4 + 1] = pops;
      }
      __syncwarp();
      continue;
    }
    int kept = 0;
    for (int j = L_ - 2; j >= 0; --j) {
      const int k = c.LOGK()[j], q = c.LOGQ()[j];
      if (N) sf_add_n(c, q, k, lane);
      else sf_add_g(c, q, k, lane);
      if (sf_fits<N>(c, s, lane)) {
        ++kept;
        if (lane == 0) targets[k] = 0;
      } else if (N) {
        sf_restore_n(c, q, lane);
      } else {
        sf_restore_g(c, q, lane);
      }
    }
    if (lane == 0) {
      a.feasible[b] = 1;
      a.stats[(size_t)b * 4 + 0] = nvalid;
      a.stats[(size_t)b * 4 + 1] = pops;
      a.stats[(size_t)b * 4 + 2] = L_;
      a.stats[(size_t)b * 4 + 3] = kept;
    }
    __syncwarp();
  }
}

// The least step of a pop in clock cycles (kernel.fair_tick): the keyed
// pick (four dependent reductions) and a share's 64-bit max (two), each
// on the last one's result, on one warp; out = {cycles, the result}.
__global__ void solve_fair_tick_kernel(long long* out, int iters) {
  const int lane = threadIdx.x & 31;
  long long v = lane;
  __syncwarp();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    const long long key = v * 3 + lane;
    const int q = sf_pick_keyed(key, [&](long long m, int* tv, int* slot) {
      *tv = key == m ? lane : SF_NONE;
      *slot = lane;
    });
    v = sf_warp_max64(v + q + lane);
  }
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = t1 - t0;
    out[1] = v;
  }
}

extern "C" int solve_fair_tick_launch(void* out, long long iters,
                                      void* stream) {
  solve_fair_tick_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (long long*)out, (int)iters);
  return (int)cudaGetLastError();
}

typedef decltype(&solve_fair_kernel<true, SF_SHARED>) SfKernel;

static SfKernel sf_kernel(long long QL, long long RF, long long form) {
  const bool lq = QL <= 32 && RF <= 32;
  if (form == SF_SHARED)
    return lq ? solve_fair_kernel<true, SF_SHARED>
              : solve_fair_kernel<false, SF_SHARED>;
  return lq ? solve_fair_kernel<true, SF_GLOBAL>
            : solve_fair_kernel<false, SF_GLOBAL>;
}

// The launch plan's card-side numbers for a batch of this shape in a form
// (SF_SHARED, SF_GLOBAL): out = {the arena's bytes, the
// instance's registers a thread, its local bytes a thread, blocks an SM by
// occupancy (with the arena as its dynamic shared memory but in the global
// form), the largest dynamic shared memory a block may opt in to, 1 if the
// narrow instance runs (QL <= 32 and RF <= 32)}.
extern "C" int solve_fair_plan(void* out, long long QL, long long RF,
                               long long CL, long long DC, long long K,
                               long long form, void* /*stream*/) {
  long long* o = (long long*)out;
  const SfKernel kern = sf_kernel(QL, RF, form);
  cudaFuncAttributes attr;
  int rc = (int)cudaFuncGetAttributes(&attr, kern);
  if (rc != 0) return rc;
  int dev = 0, optin = 0;
  if ((rc = (int)cudaGetDevice(&dev)) != 0) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != 0)
    return rc;
  const long long max_dyn = optin - (long long)attr.sharedSizeBytes;
  const SfLayout L = sf_layout(QL, RF, CL, DC, K, form == SF_SHARED);
  const bool smem = form == SF_SHARED && L.bytes <= max_dyn;
  if (smem && L.bytes > attr.maxDynamicSharedSizeBytes) {
    rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_dyn);
    if (rc != 0) return rc;
  }
  int per_sm = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, SF_THREADS, smem ? (size_t)L.bytes : 0);
  if (rc != 0) return rc;
  o[0] = L.bytes;
  o[1] = attr.numRegs;
  o[2] = (long long)attr.localSizeBytes;
  o[3] = per_sm;
  o[4] = max_dyn;
  o[5] = QL <= 32 && RF <= 32 ? 1 : 0;
  return 0;
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
    void* scratch, void* targets, void* feasible, void* reasons, void* stats,
    long long B, long long K, long long QL, long long RF, long long CL,
    long long DC, long long F, long long R, long long s0,
    long long has_retry, long long s1, long long grid, long long form,
    long long arena_bytes, void* stream) {
  if (B <= 0 || K <= 0 || grid <= 0) return (int)cudaGetLastError();
  const SfLayout L = sf_layout(QL, RF, CL, DC, K, form == SF_SHARED);
  if (L.bytes != arena_bytes || form < SF_SHARED || form > SF_GLOBAL)
    return (int)cudaErrorInvalidValue;
  SfArgs a;
  a.nominal = (const long long*)nominal;
  a.guaranteed = (const long long*)guaranteed;
  a.borrow_limit = (const long long*)borrow_limit;
  a.cohort_subtree = (const long long*)cohort_subtree;
  a.cohort_guaranteed = (const long long*)cohort_guaranteed;
  a.cohort_borrow_limit = (const long long*)cohort_borrow_limit;
  a.usage = (const long long*)usage;
  a.cohort_usage = (const long long*)cohort_usage;
  a.gq = (const int*)gq;
  a.gf = (const int*)gf;
  a.gr = (const int*)gr;
  a.gc = (const int*)gc;
  a.chain_local = (const int*)chain_local;
  a.requests = (const long long*)requests;
  a.frs_np = (const unsigned char*)frs_np;
  a.cand_idx = (const int*)cand_idx;
  a.cand_ql = (const short*)cand_ql;
  a.cand_usage = (const long long*)cand_usage;
  a.cand_prio = (const int*)cand_prio;
  a.threshold_active = (const unsigned char*)threshold_active;
  a.threshold = (const long long*)threshold;
  a.has_cohort = (const unsigned char*)has_cohort;
  a.cand_rank = (const int*)cand_rank;
  a.cq_count = (const int*)cq_count;
  a.cq_order = (const int*)cq_order;
  a.base_other = (const long long*)base_other;
  a.floor_ratio = (const long long*)floor_ratio;
  a.floor_any = (const unsigned char*)floor_any;
  a.weight = (const long long*)weight;
  a.lendable = (const long long*)lendable;
  a.scratch = (unsigned char*)scratch;
  a.targets = (unsigned char*)targets;
  a.feasible = (unsigned char*)feasible;
  a.reasons = (signed char*)reasons;
  a.stats = (int*)stats;
  a.B = (int)B; a.K = (int)K; a.QL = (int)QL; a.RF = (int)RF;
  a.CL = (int)CL; a.DC = (int)DC; a.F = (int)F; a.R = (int)R;
  a.s0 = (int)s0; a.has_retry = (int)has_retry; a.s1 = (int)s1;
  a.arena_bytes = arena_bytes;
  const SfKernel kern = sf_kernel(QL, RF, form);
  const size_t smem = form == SF_SHARED ? (size_t)arena_bytes : 0;
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != 0) return rc;
  }
  kern<<<(unsigned)grid, SF_THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
