// phase_b: the order-dependent admit with intra-cycle quota accounting.
// Replaces kueue_tpu/solver/kernel.py:420 solve_phase_b_domains_impl with
// :82 _chain_avail and :106 _chain_add_usage.
//
// Bound on the H100: latency. A conflict domain (a root cohort's tree, or
// a CQ with no cohort) walks its members in admit order, and each step
// (the availability walk up the member's cohort chain, the still-fits
// vote, the usage bubble-up) reads what the last step wrote. Domains
// touch disjoint usage state (kueue_tpu/solver/kernel.py:396-403), so
// blocks never wait on each other.
//
// Design: one block of PB_THREADS threads per domain; no global load on
// the chain of steps where the domain's rows fit shared memory.
// - Rows: every CQ and cohort of the domain (kernel.domain_tables, derived
//   once per topology), FR int64 columns a field. A CQ row is its usage
//   and, in the shared form, its constants (guaranteed and B); a cohort
//   row is its usage, guaranteed and B. B folds the level's constants:
//   (quota - guaranteed) + min(borrow limit, KQ_NO_LIMIT / 4), so a level
//   is max0(g - u) + min(parent, B - max0(u - g)) (kq_avail_level, the
//   same int64 sums in another order: equal bits); for a root, or a CQ
//   with no cohort, B is the quota itself and its availability B - u.
// - Forms, by the domain's rows against the launch's shared state
//   (state_cap bytes): shared (every row, staged whole in the prologue);
//   hybrid (the usage and cohort rows in shared memory, each CQ's
//   constants read from the topology a step ahead; in the warp form staged
//   lazily: only the elements the members touch, claimed in a bitmap as
//   each chunk is staged, and only those written back); global (the rows
//   staged whole into a global scratch indexed by CQ q and cohort c;
//   domains are disjoint).
// - Members, a chunk of MC at a time, staged a chunk ahead of the walk:
//   each member's workload, CQ row and cohort chain rows (a CQ row of -1
//   for a head that did not fit); in the warp form its nonzero assignment
//   columns compacted in order with their values, in the block form its
//   assignment row whole. The prologue stages the first chunk beside the
//   rows (independent loads, on the two halves of the block).
// - Walk, where FR <= PB_WARP_FR: one warp. A step hands the member's
//   nonzero columns to the lanes, one a lane (a second pass past 32); for
//   chains up to PB_DMAX deep each lane loads its column's rows up the
//   chain into registers at once (the rows are distinct, so no load waits
//   on a store), walks them, __all_sync votes, the admitted member's usage
//   bubbles up on registers and stores once, and __syncwarp orders the
//   step's writes before the next; deeper chains walk the rows as they
//   read them. The step's entry, column and CQ constants are loaded a step
//   ahead. The other warps write out the last chunk's admitted bits and
//   stage the next chunk meanwhile. Wider FR walks on the whole block, a
//   thread owning the columns e = t (mod nt), with __syncthreads_and.
// - Write-back: the usage rows once, at the end; the admitted bits a chunk
//   at a time.
//
// With a column list (the sharded cycle, kueue_tpu/parallel/mesh.py:314
// grid[:, my_cols]), block b walks domain cols[b] only; a padding lane
// holds the sentinel D (or -1) and returns before it reads offsets, which
// has D + 1 entries; domains outside the list keep their usage and admit
// nothing (the wrapper zeroes admitted). Without one, block b walks the
// b-th root (b < NR) or the (b - NR)-th CQ with no cohort: every domain
// that can hold members, so every member's admitted bit is written.
#include "common.cuh"

#define PB_THREADS 256
#define PB_WARP_FR 256
#define PB_FULL 0xffffffffu
#define PB_BATCH 8  // elements a staging thread loads before it stores
#define PB_DMAX 4   // chain levels a warp-form step keeps in registers

enum { PB_SHARED = 0, PB_HYBRID = 1, PB_GLOBAL = 2 };

struct PbArgs {
  const long long *nominal, *guaranteed, *borrow_limit;
  const long long *cohort_subtree, *cohort_guaranteed, *cohort_borrow_limit;
  const int *cq_chain, *dom_roots, *dom_solo, *dom_row, *dom_cqs,
      *dom_cohorts, *dom_nq, *dom_nc, *cq_slot, *cq_chain_slot;
  // copies of the inputs: the rows are staged from them and written back
  long long *usage, *cohort_usage;
  long long* scratch;  // [Q][FR] usage, then [C][3][FR] cohort rows; or null
  const long long* asg;
  const unsigned char* fit;
  const int *wl_cq, *offsets, *members, *cols;
  unsigned char* admitted;
  int D, NR, Q, C, FR, DC, SQ, SC, MC, stage_asg;
  long long state_cap;  // bytes of rows a block keeps in shared memory
};

// A domain's rows: CQ usage uq[row][FR]; CQ constants kq[row][2][FR]
// (guaranteed, B; null: read from the topology); cohort rows
// co[row][3][FR] (usage, guaranteed, B).
struct PbRows {
  long long *uq, *kq, *co;
};

__device__ __forceinline__ long long pb_b(long long quota, long long g,
                                          long long bl) {
  return (quota - g) + (bl < KQ_NO_LIMIT / 4 ? bl : KQ_NO_LIMIT / 4);
}

// One level below the root: max0(g - u) + min(parent, B - max0(u - g)).
__device__ __forceinline__ long long pb_level(long long u, long long g,
                                              long long b, long long parent) {
  const long long x = u - g, cap = b - kq_max0(x);
  return kq_max0(g - u) + (parent < cap ? parent : cap);
}

// The constants (guaranteed, B) of CQ q's row crow at column e.
__device__ __forceinline__ void pb_cq_consts(const PbArgs& a, const PbRows& s,
                                             int crow, int q, bool solo,
                                             int e, long long& g,
                                             long long& b) {
  const int FR = a.FR;
  if (s.kq) {
    g = s.kq[((size_t)crow * 2) * FR + e];
    b = s.kq[((size_t)crow * 2 + 1) * FR + e];
  } else {
    const size_t o = (size_t)q * FR + e;
    const long long nom = a.nominal[o];
    g = a.guaranteed[o];
    b = solo ? nom : pb_b(nom, g, a.borrow_limit[o]);
  }
}

// Availability of the member's CQ at column e, given its constants (g, b):
// the chain's rows ch[0..depth) from its direct cohort to the root, then
// the CQ's level.
__device__ __forceinline__ long long pb_walk_up(const PbRows& s, int FR, int e,
                                                int crow, int depth,
                                                const int* ch, long long g,
                                                long long b) {
  const long long u = s.uq[(size_t)crow * FR + e];
  if (depth == 0) return b - u;
  const long long* top = s.co + (size_t)ch[depth - 1] * 3 * FR;
  long long p = top[2 * FR + e] - top[e];
#pragma unroll 4
  for (int k = depth - 2; k >= 0; --k) {
    const long long* lv = s.co + (size_t)ch[k] * 3 * FR;
    p = pb_level(lv[e], lv[FR + e], lv[2 * FR + e], p);
  }
  return pb_level(u, g, b, p);
}

// An admitted member's usage at column e (the CQ's guaranteed g), bubbled
// up its chain past each level's guaranteed quota
// (kueue_tpu/solver/kernel.py:106).
__device__ __forceinline__ void pb_add(const PbArgs& a, const PbRows& s,
                                       int e, int crow, int depth,
                                       const int* ch, long long g,
                                       long long au) {
  const int FR = a.FR;
  long long* u = s.uq + (size_t)crow * FR + e;
  const long long old = *u, nw = old + au;
  *u = nw;
  long long delta = kq_max0(nw - g) - kq_max0(old - g);
  for (int k = 0; k < depth && delta != 0; ++k) {
    long long* lv = s.co + (size_t)ch[k] * 3 * FR + e;
    const long long oc = lv[0], nc = oc + delta, cg = lv[FR];
    lv[0] = nc;
    delta = kq_max0(nc - cg) - kq_max0(oc - cg);
  }
}

// A member entry: workload, CQ row (-1: did not fit), CQ, chain depth,
// its nonzero columns (the warp form), then the chain's cohort rows (DC
// ints). After a chunk's MC entries, MC ints of walked members (the warp
// form): w if admitted, else -1 - w.
#define PB_ENT 5
__device__ __forceinline__ int pb_entry_ints(int DC) { return PB_ENT + DC; }

// Stages the entry of member w into ent.
template <int MODE>
__device__ __forceinline__ void pb_stage_entry(const PbArgs& a, int w,
                                               int* ent) {
  const int DC = a.DC;
  ent[0] = w;
  if (!a.fit[w]) {
    ent[1] = -1;
    return;
  }
  const int q = a.wl_cq[w];
  ent[1] = MODE == PB_GLOBAL ? q : a.cq_slot[q];
  ent[2] = q;
  int depth = 0;
#pragma unroll 4
  for (int k = 0; k < DC; ++k) {
    const int c = MODE == PB_GLOBAL ? a.cq_chain[(size_t)q * DC + k]
                                    : a.cq_chain_slot[(size_t)q * DC + k];
    ent[PB_ENT + k] = c;
    depth += c >= 0;  // the chain is -1 padded past the root
  }
  ent[3] = depth;
}

// A lazily staged domain's element (the hybrid form's: no CQ constants):
// the bit of (row, e) in the domain's bitmap claims it, and the one lane
// that claims it copies its fields in from the topology and the usage
// copies (row ids kept for the write-back). Members of one chunk touch an element only after the chunk
// that first touched it was staged, so no claim overwrites a step's write.
struct PbLazy {
  unsigned* bits;  // (nq + nc)·FR bits: CQ rows, then cohort rows
  int* rowid;      // the row's CQ q or cohort c
  int nq, d;       // CQ rows; the domain (its root cohort, or C + q)
};

__device__ __forceinline__ bool pb_claim(unsigned* bits, int bit) {
  const unsigned m = 1u << (bit & 31);
  return !(atomicOr(bits + (bit >> 5), m) & m);
}

__device__ __forceinline__ void pb_touch_cq(const PbArgs& a, const PbRows& s,
                                            const PbLazy& z, int crow, int q,
                                            int e) {
  const int FR = a.FR;
  if (!pb_claim(z.bits, crow * FR + e)) return;
  z.rowid[crow] = q;
  s.uq[(size_t)crow * FR + e] = a.usage[(size_t)q * FR + e];
}

__device__ __forceinline__ void pb_touch_cohort(const PbArgs& a,
                                                const PbRows& s,
                                                const PbLazy& z, int cs, int c,
                                                int e) {
  const int FR = a.FR;
  if (!pb_claim(z.bits, (z.nq + cs) * FR + e)) return;
  z.rowid[z.nq + cs] = c;
  const size_t o = (size_t)c * FR + e;
  const long long sub = a.cohort_subtree[o], g = a.cohort_guaranteed[o];
  long long* p = s.co + (size_t)cs * 3 * FR + e;
  p[0] = a.cohort_usage[o], p[FR] = g;
  p[2 * FR] = c == z.d ? sub : pb_b(sub, g, a.cohort_borrow_limit[o]);
}

// The warp form's staging: warps wid (of nw) stage members [c0, c0 + m),
// PB_UNROLL at once: the entries (a lane a member), and the members'
// nonzero assignment columns compacted in order, sel[j][i] the i-th
// nonzero column of member j and auc[j][i] its value (rows of FRp, FR
// rounded up to a multiple of 32), their count in the entry. LAZY: each
// fitting member's rows at its nonzero columns are staged too
// (pb_touch_cq, pb_touch_cohort).
#define PB_UNROLL 4
template <int MODE, bool LAZY>
__device__ __forceinline__ void pb_stage_compact(const PbArgs& a, int c0,
                                                 int m, int* ent, int* sel,
                                                 long long* auc, int wid,
                                                 int nw, int lane,
                                                 const PbRows& s,
                                                 const PbLazy& z) {
  const int FR = a.FR, words = (FR + 31) / 32, FRp = 32 * words;
  const int ME = pb_entry_ints(a.DC);
  const unsigned below = (1u << lane) - 1u;
  for (int j0 = wid * PB_UNROLL; j0 < m; j0 += nw * PB_UNROLL) {
    int w[PB_UNROLL];
#pragma unroll
    for (int x = 0; x < PB_UNROLL; ++x)
      w[x] = j0 + x < m ? a.members[c0 + j0 + x] : -1;
    if (lane < PB_UNROLL && j0 + lane < m) {
      const int wl = a.members[c0 + j0 + lane];
      pb_stage_entry<MODE>(a, wl, ent + (j0 + lane) * ME);
    }
    int total[PB_UNROLL] = {};
#pragma unroll 2
    for (int k = 0; k < words; ++k) {
      const int e = 32 * k + lane;
      long long v[PB_UNROLL];
#pragma unroll
      for (int x = 0; x < PB_UNROLL; ++x)
        v[x] = w[x] >= 0 && e < FR ? a.asg[(size_t)w[x] * FR + e] : 0;
#pragma unroll
      for (int x = 0; x < PB_UNROLL; ++x) {
        const bool nz = v[x] != 0;
        const unsigned mask = __ballot_sync(PB_FULL, nz);
        if (nz) {
          const int r = total[x] + __popc(mask & below);
          sel[(j0 + x) * FRp + r] = e;
          auc[(size_t)(j0 + x) * FRp + r] = v[x];
        }
        total[x] += __popc(mask);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int x = 0; x < PB_UNROLL; ++x)
        if (j0 + x < m) ent[(j0 + x) * ME + 4] = total[x];
    }
    if (!LAZY) continue;
    __syncwarp();  // the group's entries and columns
#pragma unroll
    for (int x = 0; x < PB_UNROLL; ++x) {
      if (j0 + x >= m) continue;
      const int* en = ent + (j0 + x) * ME;
      const int crow = en[1];
      if (crow < 0) continue;
      const int q = en[2], depth = en[3];
      for (int i = lane; i < total[x]; i += 32) {
        const int e = sel[(j0 + x) * FRp + i];
        pb_touch_cq(a, s, z, crow, q, e);
        for (int k = 0; k < depth; ++k)
          pb_touch_cohort(a, s, z, en[PB_ENT + k],
                          a.cq_chain[(size_t)q * a.DC + k], e);
      }
    }
  }
}

// The block form's staging: threads t (of nt) stage members [c0, c0 + m):
// entries into ent and, with ab, their assignment rows whole. With two
// warps or more the entries take the first warp and the rows the rest, so
// the two chains of loads overlap.
template <int MODE>
__device__ __forceinline__ void pb_stage_dense(const PbArgs& a, int c0, int m,
                                               int* ent, long long* ab, int t,
                                               int nt) {
  const int ME = pb_entry_ints(a.DC), FR = a.FR;
  const bool split = ab != nullptr && nt >= 64;
  if (!split || t < 32) {
    for (int j = t; j < m; j += split ? 32 : nt)
      pb_stage_entry<MODE>(a, a.members[c0 + j], ent + j * ME);
    if (split) return;
  }
  if (ab == nullptr) return;
  // every member's row, fitting or not (an unfit member's is never read)
  const int t2 = split ? t - 32 : t, n2 = split ? nt - 32 : nt;
  for (int i0 = t2; i0 < m * FR; i0 += PB_BATCH * n2) {
    int w[PB_BATCH];
#pragma unroll
    for (int x = 0; x < PB_BATCH; ++x) {
      const int i = i0 + x * n2;
      w[x] = i < m * FR ? a.members[c0 + (int)((unsigned)i / (unsigned)FR)] : -1;
    }
    long long v[PB_BATCH];
#pragma unroll
    for (int x = 0; x < PB_BATCH; ++x) {
      const int i = i0 + x * n2;
      v[x] = w[x] >= 0 ? a.asg[(size_t)w[x] * FR + (unsigned)i % (unsigned)FR]
                       : 0;
    }
#pragma unroll
    for (int x = 0; x < PB_BATCH; ++x)
      if (w[x] >= 0) ab[i0 + x * n2] = v[x];
  }
}

// What a warp-form step needs before it walks, loaded a step ahead: the
// entry, the lane's nonzero column (-1: none) with its value, and the CQ's
// constants at that column (from the topology in the hybrid and global
// forms, so their round trip overlaps the step before).
struct PbStep {
  int w, crow, depth, total, e;
  int ch[PB_DMAX];
  long long au, g, b;
};

__device__ __forceinline__ PbStep pb_load_step(const PbArgs& a,
                                               const PbRows& s,
                                               const int* en, const int* sel,
                                               const long long* auc,
                                               int lane) {
  PbStep st;
  st.w = en[0], st.crow = en[1], st.depth = en[3], st.total = en[4];
#pragma unroll
  for (int k = 0; k < PB_DMAX; ++k) st.ch[k] = k < a.DC ? en[PB_ENT + k] : -1;
  const int e = sel[lane];
  st.au = auc[lane];
  st.e = st.crow >= 0 && lane < st.total ? e : -1;
  st.g = 0, st.b = 0;
  if (st.e >= 0)
    pb_cq_consts(a, s, st.crow, en[2], st.depth == 0, st.e, st.g, st.b);
  return st;
}

// A walked chunk's admitted bits (its walked-member ints, which the
// staging of the next chunk into the buffer leaves alone) to admitted, on
// threads t of nt: the chunk's first m members.
__device__ __forceinline__ void pb_write_admitted(const PbArgs& a,
                                                  const int* ent, int m, int t,
                                                  int nt) {
  const int* done = ent + a.MC * pb_entry_ints(a.DC);
  for (int j = t; j < m; j += nt) {
    const int v = done[j];
    a.admitted[v >= 0 ? v : -1 - v] = v >= 0 ? 1 : 0;
  }
}

// One warp-form step of a member whose chain is D cohorts deep (D <=
// PB_DMAX; D = -1: any depth, the rows read as the walk needs them). The
// lane's column of pass 0: the CQ's usage and each level's usage,
// guaranteed and B load at once into registers (the rows are distinct, so
// no load waits on a store); the walk and the bubble-up run on registers
// and store once. Columns past the 32nd (pass 1 on) take the generic
// walk. Returns the vote.
template <int D>
__device__ __forceinline__ bool pb_warp_step(const PbArgs& a, const PbRows& s,
                                             const PbStep& st, const int* en,
                                             const int* sel,
                                             const long long* auc, int lane) {
  const int FR = a.FR;
  const int* ch = en + PB_ENT;
  const bool on = st.e >= 0;
  long long u0 = 0, lu[PB_DMAX], lg[PB_DMAX], lb[PB_DMAX];
  bool ok = true;
  if (on) {
    if (D >= 0) {
      u0 = s.uq[(size_t)st.crow * FR + st.e];
#pragma unroll
      for (int k = 0; k < (D > 0 ? D : 0); ++k) {
        const long long* p = s.co + (size_t)st.ch[k] * 3 * FR + st.e;
        lu[k] = p[0], lg[k] = p[FR], lb[k] = p[2 * FR];
      }
      long long av = st.b - u0;
      if (D > 0) {
        long long pa = lb[D - 1] - lu[D - 1];
#pragma unroll
        for (int k = D - 2; k >= 0; --k) pa = pb_level(lu[k], lg[k], lb[k], pa);
        av = pb_level(u0, st.g, st.b, pa);
      }
      ok = st.au <= av;
    } else {
      ok = st.au <= pb_walk_up(s, FR, st.e, st.crow, st.depth, ch, st.g, st.b);
    }
  }
  for (int i = 32 + lane; i < st.total; i += 32) {
    const int e = sel[i];
    long long g, b;
    pb_cq_consts(a, s, st.crow, en[2], st.depth == 0, e, g, b);
    ok &= auc[i] <= pb_walk_up(s, FR, e, st.crow, st.depth, ch, g, b);
  }
  const bool admit = __all_sync(PB_FULL, ok) != 0;
  if (!admit) return false;
  if (on) {
    if (D >= 0) {
      const long long nw = u0 + st.au;
      s.uq[(size_t)st.crow * FR + st.e] = nw;
      long long delta = kq_max0(nw - st.g) - kq_max0(u0 - st.g);
#pragma unroll
      for (int k = 0; k < (D > 0 ? D : 0); ++k) {
        if (delta == 0) break;
        const long long nc = lu[k] + delta;
        s.co[(size_t)st.ch[k] * 3 * FR + st.e] = nc;
        delta = kq_max0(nc - lg[k]) - kq_max0(lu[k] - lg[k]);
      }
    } else {
      pb_add(a, s, st.e, st.crow, st.depth, ch, st.g, st.au);
    }
  }
  for (int i = 32 + lane; i < st.total; i += 32) {
    const int e = sel[i];
    long long g, b;
    pb_cq_consts(a, s, st.crow, en[2], st.depth == 0, e, g, b);
    pb_add(a, s, e, st.crow, st.depth, ch, g, auc[i]);
  }
  __syncwarp();  // the next step's lanes read these columns
  return true;
}

// One warp's steps of a chunk's m members (FR <= PB_WARP_FR): a step's
// nonzero columns one a lane (a second pass past 32), the next step's
// loads issued before this one walks.
__device__ __forceinline__ void pb_walk_warp(const PbArgs& a,
                                             const PbRows& s, int* ent,
                                             const int* sel,
                                             const long long* auc, int m,
                                             int lane) {
  const int FR = a.FR, FRp = 32 * ((FR + 31) / 32), ME = pb_entry_ints(a.DC);
  PbStep cur = pb_load_step(a, s, ent, sel, auc, lane);
  for (int j = 0; j < m; ++j) {
    PbStep nxt = cur;
    if (j + 1 < m)
      nxt = pb_load_step(a, s, ent + (j + 1) * ME, sel + (j + 1) * FRp,
                         auc + (size_t)(j + 1) * FRp, lane);
    bool admit = false;
    if (cur.crow >= 0) {  // uniform; else keeps its place, never admits
      const int* en = ent + j * ME;
      const int* sj = sel + j * FRp;
      const long long* aj = auc + (size_t)j * FRp;
      switch (cur.depth) {
        case 0: admit = pb_warp_step<0>(a, s, cur, en, sj, aj, lane); break;
        case 1: admit = pb_warp_step<1>(a, s, cur, en, sj, aj, lane); break;
        case 2: admit = pb_warp_step<2>(a, s, cur, en, sj, aj, lane); break;
        case 3: admit = pb_warp_step<3>(a, s, cur, en, sj, aj, lane); break;
        case 4: admit = pb_warp_step<4>(a, s, cur, en, sj, aj, lane); break;
        default: admit = pb_warp_step<-1>(a, s, cur, en, sj, aj, lane); break;
      }
    }
    if (lane == 0) ent[a.MC * ME + j] = admit ? cur.w : -1 - cur.w;
    cur = nxt;
  }
}

// The block's steps of a chunk's m members (FR > PB_WARP_FR): thread t of
// nt owns the columns e = t (mod nt).
__device__ __forceinline__ void pb_walk_block(const PbArgs& a,
                                              const PbRows& s, const int* ent,
                                              const long long* ab, int m,
                                              int t, int nt) {
  const int FR = a.FR, ME = pb_entry_ints(a.DC);
  for (int j = 0; j < m; ++j) {
    const int* en = ent + j * ME;
    const int w = en[0], crow = en[1];
    if (crow < 0) {
      if (t == 0) a.admitted[w] = 0;
      continue;
    }
    const int q = en[2], depth = en[3];
    const int* ch = en + PB_ENT;
    const long long* au_row = ab ? ab + (size_t)j * FR : a.asg + (size_t)w * FR;
    bool ok = true;
    for (int e = t; e < FR; e += nt) {
      const long long au = au_row[e];
      if (au == 0) continue;
      long long g, b;
      pb_cq_consts(a, s, crow, q, depth == 0, e, g, b);
      ok &= au <= pb_walk_up(s, FR, e, crow, depth, ch, g, b);
    }
    if (__syncthreads_and(ok)) {
      for (int e = t; e < FR; e += nt) {
        const long long au = au_row[e];
        if (au == 0) continue;
        long long g, b;
        pb_cq_consts(a, s, crow, q, depth == 0, e, g, b);
        pb_add(a, s, e, crow, depth, ch, g, au);
      }
      if (t == 0) a.admitted[w] = 1;
    } else if (t == 0) {
      a.admitted[w] = 0;
    }
  }
}

// The lazy header's bytes for a domain of `rows` rows: the bitmap of its
// elements and the rows' ids, 16-aligned.
__host__ __device__ inline long long pb_lazy_bytes(int rows, int FR) {
  return (((long long)rows * FR + 31) / 32 * 4 + (long long)rows * 4 + 15) / 16 *
         16;
}

// The chunk buffers' bytes: entries and walked members, then (warp form)
// the nonzero columns
// and their values, or (block form, staged) the rows whole.
__host__ __device__ inline long long pb_chunk_bytes(int MC, int FR, int DC,
                                                    bool warp, bool staged) {
  const long long FRp = 32LL * ((FR + 31) / 32);
  const long long ent = ((long long)MC * (PB_ENT + DC + 1) * 4 + 15) / 16 * 16;
  if (warp) return ent + (long long)MC * FRp * 12;
  return ent + (staged ? (long long)MC * FR * 8 : 0);
}

// One domain in form MODE: its nq CQ rows and nc cohort rows at s, the
// two chunk buffers at bufs. The warp form in shared memory stages the rows
// lazily (z: the bitmap and row ids): only the elements its members touch,
// as their chunk is staged, and writes back only those; the other forms
// stage every row in the prologue and write every row back.
template <bool WARP_VOTE, int MODE>
__device__ __forceinline__ void pb_domain(const PbArgs& a, PbRows s,
                                          const PbLazy& z,
                                          unsigned char* bufs, int d, int row,
                                          int q_solo, int beg, int end,
                                          int nq, int nc) {
  constexpr bool LAZY = WARP_VOTE && MODE == PB_HYBRID;
  const int FR = a.FR, MC = a.MC, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nt >> 5;
  const long long FRp = 32LL * ((FR + 31) / 32);
  const long long cb = pb_chunk_bytes(MC, FR, a.DC, WARP_VOTE, a.stage_asg);
  const long long ent_bytes =
      ((long long)MC * (pb_entry_ints(a.DC) + 1) * 4 + 15) / 16 * 16;
  // buffer i: entries, then (warp form) auc and sel, or (block form) ab
  auto ent = [&](int i) { return (int*)(bufs + i * cb); };
  auto ab = [&](int i) {
    return a.stage_asg || WARP_VOTE ? (long long*)(bufs + i * cb + ent_bytes)
                                    : (long long*)nullptr;
  };
  auto sel = [&](int i) {
    return (int*)(bufs + i * cb + ent_bytes + (size_t)MC * FRp * 8);
  };
  // prologue, one set of loads: the first chunk of members (lazy: with
  // the elements they touch, on every warp once the bitmap is clear;
  // else on the first half of the block, the domain's rows on the second)
  const int half = nt / 2;
  if (LAZY) {
    for (int i = tid; i < ((nq + nc) * FR + 31) / 32; i += nt) z.bits[i] = 0;
    __syncthreads();
    pb_stage_compact<MODE, true>(a, beg, min(MC, end - beg), ent(0), sel(0),
                                 ab(0), warp, nwarps, lane, s, z);
  } else if (tid < half) {
    if (WARP_VOTE)
      pb_stage_compact<MODE, false>(a, beg, min(MC, end - beg), ent(0),
                                    sel(0), ab(0), warp, half >> 5, lane, s,
                                    z);
    else
      pb_stage_dense<MODE>(a, beg, min(MC, end - beg), ent(0), ab(0), tid,
                           half);
  } else {
    // the rows: element i < nq·FR of a CQ row, else of a cohort row
    const int n_el = (nq + nc) * FR;
    for (int i0 = tid - half; i0 < n_el; i0 += PB_BATCH * half) {
      long long v[PB_BATCH][3];
      int id[PB_BATCH], r[PB_BATCH], e[PB_BATCH];
#pragma unroll
      for (int x = 0; x < PB_BATCH; ++x) {
        const int i = i0 + x * half;
        id[x] = -1;
        if (i >= n_el) continue;
        const int sl = (unsigned)i / (unsigned)FR;
        e[x] = i - sl * FR;
        if (sl < nq) {
          id[x] = row >= 0 ? a.dom_cqs[(size_t)row * a.SQ + sl] : q_solo;
          r[x] = MODE == PB_GLOBAL ? id[x] : sl;
        } else {
          id[x] = a.dom_cohorts[(size_t)row * a.SC + (sl - nq)];
          r[x] = -1 - (MODE == PB_GLOBAL ? id[x] : sl - nq);
        }
      }
#pragma unroll
      for (int x = 0; x < PB_BATCH; ++x) {
        if (id[x] < 0) continue;
        const size_t o = (size_t)id[x] * FR + e[x];
        if (r[x] >= 0) {
          v[x][0] = a.usage[o];
          if (s.kq) {
            const long long nom = a.nominal[o];
            v[x][1] = a.guaranteed[o];
            v[x][2] = row < 0 ? nom : pb_b(nom, v[x][1], a.borrow_limit[o]);
          }
        } else {
          const long long sub = a.cohort_subtree[o];
          v[x][0] = a.cohort_usage[o];
          v[x][1] = a.cohort_guaranteed[o];
          v[x][2] = id[x] == d ? sub
                               : pb_b(sub, v[x][1], a.cohort_borrow_limit[o]);
        }
      }
#pragma unroll
      for (int x = 0; x < PB_BATCH; ++x) {
        if (id[x] < 0) continue;
        if (r[x] >= 0) {
          s.uq[(size_t)r[x] * FR + e[x]] = v[x][0];
          if (s.kq) {
            s.kq[((size_t)r[x] * 2) * FR + e[x]] = v[x][1];
            s.kq[((size_t)r[x] * 2 + 1) * FR + e[x]] = v[x][2];
          }
        } else {
          long long* p = s.co + (size_t)(-1 - r[x]) * 3 * FR + e[x];
          p[0] = v[x][0], p[FR] = v[x][1], p[2 * FR] = v[x][2];
        }
      }
    }
  }
  __syncthreads();
  const int chunks = (end - beg + MC - 1) / MC;
  for (int k = 0; k < chunks; ++k) {
    const int c0 = beg + k * MC, m = min(MC, end - c0), b = k & 1;
    const int c1 = c0 + MC, m1 = min(MC, end - c1);
    if (WARP_VOTE) {
      // warp 0 walks this chunk while the others write out the last one's
      // admitted bits and stage the next in its buffer
      if (warp == 0) {
        pb_walk_warp(a, s, ent(b), sel(b), ab(b), m, lane);
      } else {
        if (k > 0) pb_write_admitted(a, ent(b ^ 1), MC, tid - 32, nt - 32);
        if (m1 > 0)
          pb_stage_compact<MODE, LAZY>(a, c1, m1, ent(b ^ 1), sel(b ^ 1),
                                       ab(b ^ 1), warp - 1, nwarps - 1, lane,
                                       s, z);
      }
    } else {
      pb_walk_block(a, s, ent(b), ab(b), m, tid, nt);
      if (m1 > 0)
        pb_stage_dense<MODE>(a, c1, m1, ent(b ^ 1), ab(b ^ 1), tid, nt);
    }
    __syncthreads();
  }
  if (WARP_VOTE)
    pb_write_admitted(a, ent((chunks - 1) & 1), end - beg - (chunks - 1) * MC,
                      tid, nt);
  if (LAZY) {
    // write-back: the usage of every element a member touched
    for (int i = tid; i < (nq + nc) * FR; i += nt) {
      if (!((z.bits[i >> 5] >> (i & 31)) & 1u)) continue;
      const int sl = (unsigned)i / (unsigned)FR, e = i - sl * FR;
      const int id = z.rowid[sl];
      if (sl < nq)
        a.usage[(size_t)id * FR + e] = s.uq[(size_t)sl * FR + e];
      else
        a.cohort_usage[(size_t)id * FR + e] =
            s.co[(size_t)(sl - nq) * 3 * FR + e];
    }
    return;
  }
  // write-back: the usage of every row, PB_BATCH elements a thread at once
  for (int i0 = tid; i0 < (nq + nc) * FR; i0 += PB_BATCH * nt) {
    long long v[PB_BATCH];
    long long* dst[PB_BATCH];
#pragma unroll
    for (int x = 0; x < PB_BATCH; ++x) {
      const int i = i0 + x * nt;
      dst[x] = nullptr;
      if (i >= (nq + nc) * FR) continue;
      const int sl = (unsigned)i / (unsigned)FR, e = i - sl * FR;
      if (sl < nq) {
        const int q = row >= 0 ? a.dom_cqs[(size_t)row * a.SQ + sl] : q_solo;
        dst[x] = a.usage + (size_t)q * FR + e;
        v[x] = s.uq[(size_t)(MODE == PB_GLOBAL ? q : sl) * FR + e];
      } else {
        const int c = a.dom_cohorts[(size_t)row * a.SC + (sl - nq)];
        dst[x] = a.cohort_usage + (size_t)c * FR + e;
        v[x] = s.co[(size_t)(MODE == PB_GLOBAL ? c : sl - nq) * 3 * FR + e];
      }
    }
#pragma unroll
    for (int x = 0; x < PB_BATCH; ++x)
      if (dst[x]) *dst[x] = v[x];
  }
}

template <bool WARP_VOTE>
__global__ void __launch_bounds__(PB_THREADS, 2) phase_b_kernel(const PbArgs a) {
  extern __shared__ __align__(16) unsigned char pb_smem[];
  int d, row, q_solo = -1;
  if (a.cols) {
    d = a.cols[blockIdx.x];
    if (d < 0 || d >= a.D) return;  // a padding lane: uniform over the block
    if (d < a.C) {
      row = a.dom_row[d];
      if (row < 0) return;  // a cohort below a root: never holds members
    } else {
      row = -1, q_solo = d - a.C;
    }
  } else if ((int)blockIdx.x < a.NR) {
    row = blockIdx.x, d = a.dom_roots[row];
  } else {
    row = -1, q_solo = a.dom_solo[blockIdx.x - a.NR], d = a.C + q_solo;
  }
  const int beg = a.offsets[d], end = a.offsets[d + 1];
  if (beg >= end) return;
  const int nq = row >= 0 ? a.dom_nq[row] : 1;
  const int nc = row >= 0 ? a.dom_nc[row] : 0;
  const long long col = (long long)a.FR * 8;
  unsigned char* bufs = pb_smem + a.state_cap;
  // the warp form's lazy header: the bitmap and the row ids
  const long long head =
      WARP_VOTE ? pb_lazy_bytes(nq + nc, a.FR) : 0;
  long long* sm = (long long*)(pb_smem + head);
  const PbLazy z = {(unsigned*)pb_smem, (int*)(pb_smem + ((long long)(nq + nc) * a.FR + 31) / 32 * 4), nq, d};
  if (head + (3 * nq + 3 * nc) * col <= a.state_cap) {
    const PbRows s = {sm, sm + (size_t)nq * a.FR, sm + (size_t)3 * nq * a.FR};
    pb_domain<WARP_VOTE, PB_SHARED>(a, s, z, bufs, d, row, q_solo, beg, end,
                                    nq, nc);
  } else if (head + (nq + 3 * nc) * col <= a.state_cap) {
    const PbRows s = {sm, nullptr, sm + (size_t)nq * a.FR};
    pb_domain<WARP_VOTE, PB_HYBRID>(a, s, z, bufs, d, row, q_solo, beg, end,
                                    nq, nc);
  } else {
    const PbRows s = {a.scratch, nullptr, a.scratch + (size_t)a.Q * a.FR};
    pb_domain<WARP_VOTE, PB_GLOBAL>(a, s, z, bufs, d, row, q_solo, beg, end,
                                    nq, nc);
  }
}

template <bool WARP_VOTE>
static int pb_launch(const PbArgs& a, long long n_blocks, long long smem,
                     cudaStream_t s) {
  static long long raised = 48 * 1024;  // the dynamic shared memory allowed
  if (smem > raised) {
    const int rc = (int)cudaFuncSetAttribute(
        phase_b_kernel<WARP_VOTE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != 0) return rc;
    raised = smem;
  }
  phase_b_kernel<WARP_VOTE><<<(unsigned)n_blocks, PB_THREADS, (size_t)smem, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int phase_b_launch(
    const void* nominal, const void* guaranteed, const void* borrow_limit,
    const void* cohort_subtree, const void* cohort_guaranteed,
    const void* cohort_borrow_limit, const void* cq_chain,
    const void* dom_roots, const void* dom_solo, const void* dom_row,
    const void* dom_cqs, const void* dom_cohorts, const void* dom_nq,
    const void* dom_nc, const void* cq_slot, const void* cq_chain_slot,
    void* usage, void* cohort_usage, void* scratch, const void* asg,
    const void* fit, const void* wl_cq, const void* offsets,
    const void* members, const void* cols, void* admitted, long long D,
    long long NR, long long n_blocks, long long Q, long long C, long long FR,
    long long DC, long long SQ, long long SC, long long MC,
    long long stage_asg, long long state_cap, long long smem,
    long long warp_vote, void* stream) {
  if (n_blocks <= 0 || FR <= 0) return (int)cudaGetLastError();
  if (warp_vote && FR > PB_WARP_FR) return (int)cudaErrorInvalidValue;
  if (state_cap + 2 * pb_chunk_bytes((int)MC, (int)FR, (int)DC, warp_vote != 0,
                                     stage_asg != 0) > smem)
    return (int)cudaErrorInvalidValue;
  PbArgs a;
  a.nominal = (const long long*)nominal;
  a.guaranteed = (const long long*)guaranteed;
  a.borrow_limit = (const long long*)borrow_limit;
  a.cohort_subtree = (const long long*)cohort_subtree;
  a.cohort_guaranteed = (const long long*)cohort_guaranteed;
  a.cohort_borrow_limit = (const long long*)cohort_borrow_limit;
  a.cq_chain = (const int*)cq_chain;
  a.dom_roots = (const int*)dom_roots;
  a.dom_solo = (const int*)dom_solo;
  a.dom_row = (const int*)dom_row;
  a.dom_cqs = (const int*)dom_cqs;
  a.dom_cohorts = (const int*)dom_cohorts;
  a.dom_nq = (const int*)dom_nq;
  a.dom_nc = (const int*)dom_nc;
  a.cq_slot = (const int*)cq_slot;
  a.cq_chain_slot = (const int*)cq_chain_slot;
  a.usage = (long long*)usage;
  a.cohort_usage = (long long*)cohort_usage;
  a.scratch = (long long*)scratch;
  a.asg = (const long long*)asg;
  a.fit = (const unsigned char*)fit;
  a.wl_cq = (const int*)wl_cq;
  a.offsets = (const int*)offsets;
  a.members = (const int*)members;
  a.cols = (const int*)cols;
  a.admitted = (unsigned char*)admitted;
  a.D = (int)D, a.NR = (int)NR, a.Q = (int)Q, a.C = (int)C, a.FR = (int)FR;
  a.DC = (int)DC, a.SQ = (int)SQ, a.SC = (int)SC, a.MC = (int)MC;
  a.stage_asg = (int)stage_asg;
  a.state_cap = state_cap;
  const cudaStream_t s = (cudaStream_t)stream;
  return warp_vote ? pb_launch<true>(a, n_blocks, smem, s)
                   : pb_launch<false>(a, n_blocks, smem, s);
}

// The least step of the walk, for the latency bound: one warp runs `iters`
// steps of a member with one nonzero column a lane (32 columns) whose chain
// is `depth` cohorts deep, over rows in shared memory, as the warp form's
// fast path runs a step once its loads ahead are in: the rows' fetch, the
// availability walk, the __all_sync vote, the bubble-up and the
// __syncwarp, each step reading what the last one wrote. out[0] gets the
// clock cycles they took, out[1] keeps the chain live; out[2] the cycles
// of `iters` dependent global loads of a chain this kernel lays in `chase`
// (n_chase ints, read past L1); out[4] the SM clock in kHz the runtime
// reports.
template <int D>
__device__ __forceinline__ long long pb_tick_steps(const PbArgs& a,
                                                  const PbRows& s,
                                                  const PbStep& st,
                                                  const int* en, int iters) {
  long long admitted = 0;
  for (int it = 0; it < iters; ++it)
    admitted += pb_warp_step<D>(a, s, st, en, nullptr, nullptr, threadIdx.x);
  return admitted;
}

__global__ void phase_b_tick_kernel(long long* out, int* chase, int n_chase,
                                    int iters, int depth, int clock_khz) {
  __shared__ long long uq[32], co[PB_DMAX * 3 * 32];
  __shared__ int en[PB_ENT + PB_DMAX];
  const int lane = threadIdx.x, FR = 32;
  PbArgs a;
  a.FR = FR;
  const PbRows s = {uq, nullptr, co};
  uq[lane] = 0;
  for (int r = 0; r < depth; ++r) {
    long long* p = co + (size_t)r * 3 * FR + lane;
    p[0] = 0, p[FR] = r, p[2 * FR] = 1LL << 40;
  }
  PbStep st;
  st.w = 0, st.crow = 0, st.depth = depth, st.total = 32, st.e = lane;
#pragma unroll
  for (int k = 0; k < PB_DMAX; ++k) st.ch[k] = k;
  st.au = 1, st.g = 0, st.b = 1LL << 40;
  __syncwarp();
  long long admitted = 0;
  const long long t0 = clock64();
  switch (depth) {
    case 0: admitted = pb_tick_steps<0>(a, s, st, en, iters); break;
    case 1: admitted = pb_tick_steps<1>(a, s, st, en, iters); break;
    case 2: admitted = pb_tick_steps<2>(a, s, st, en, iters); break;
    case 3: admitted = pb_tick_steps<3>(a, s, st, en, iters); break;
    default: admitted = pb_tick_steps<4>(a, s, st, en, iters); break;
  }
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = t1 - t0;
    out[1] = admitted;
    for (int i = 0; i < n_chase; ++i) chase[i] = (i + 33) % n_chase;
    __threadfence();
    int idx = 0;
    const long long t2 = clock64();
    for (int it = 0; it < iters; ++it) idx = __ldcg(chase + idx);
    const long long t3 = clock64();
    out[2] = t3 - t2;
    out[3] = idx;
    out[4] = clock_khz;
  }
}

extern "C" int phase_b_tick_launch(void* out, void* chase, long long n_chase,
                                   long long iters, long long depth,
                                   void* stream) {
  if (depth < 0 || depth > PB_DMAX) return (int)cudaErrorInvalidValue;
  int dev = 0, khz = 0, rc;
  if ((rc = (int)cudaGetDevice(&dev)) != 0) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev)) != 0)
    return rc;
  phase_b_tick_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (long long*)out, (int*)chase, (int)n_chase, (int)iters, (int)depth, khz);
  return (int)cudaGetLastError();
}
