// phase_a: flavor assignment for every head of the cycle.
// Replaces kueue_tpu/solver/kernel.py:128 _choose_flavors_one_podset and
// :221 _phase_a.
//
// Bound on the H100: latency. The bytes (a head's request rows and its
// CQ's [F,R] rows) are ~1 us of the card's rate at the north star, but a
// head is a chain of dependent steps: podsets one after another (each
// sees the assignment of the earlier ones), and per podset and resource
// a reduction over the flavors for the best rank, then the lowest
// flavor index at the chosen rank (jnp.argmax on bool picks the first).
//
// Design: one warp per head, one lane per flavor (strided when F > 32).
// - Reductions: one __reduce_min_sync (redux.sync) on a 32-bit key
//   rank * 2^fb + f, fb = the bits of a flavor index, gives the best
//   rank and the lowest fitting index at it; a second, over the
//   non-borrowing candidates, the best non-borrowing rank of a CQ that
//   prefers no borrowing; only when that rank is the target and differs
//   from the best does a third find the lowest fitting index at it,
//   borrowing or not (kueue_tpu/solver/kernel.py:170-186). A rank of
//   KQ_INF_RANK or more chooses nothing, and the start_rank cut applies.
//   The key packs ranks in [-2^(31-fb), 2^(31-fb) - 2] (fb = 5: about
//   +-6.7e7; KQ_INF_RANK is 1e6); a warp whose CQ holds a rank outside
//   that range takes two reductions instead (the least rank, then the
//   least index at the target).
// - The register form (F <= 32, R <= 16, P <= 32; R padded to RT = 1, 2,
//   4, 8 or 16 as cluster_cols.cu pads it): after wl_cq, one set of
//   independent loads brings the lane's flavor's nominal/avail/usage/
//   offered elements of every resource, its group and rank, the CQ's
//   group ids and prefer_no_borrow, and the head's requests and start
//   ranks of every podset (into the warp's slice of shared memory),
//   eligibility and active bits (into bit masks). The assignment stays in
//   registers across podsets and is written once at the end; the chosen
//   flavors stay in registers (every lane holds the reduction's result).
// - The general form (any F, R, P): the lane's flavors strided, the rows
//   read from global memory each podset as they are needed, the
//   assignment accumulated in place in the output, the chosen flavors and
//   per-flavor flags in the warp's shared slice (4R + 2F bytes), with the
//   same reductions.
#include <climits>
#include "common.cuh"

#define KQ_WARPS_PER_BLOCK 4
#define PA_FULL 0xffffffffu

struct PaArgs {
  const int *group_id, *flavor_group, *flavor_rank;  // [Q,R], [Q,F], [Q,F]
  const long long* nominal;                           // [Q,F,R]
  const unsigned char* offered;                       // [Q,F,R]
  const unsigned char* prefer_no_borrow;              // [Q]
  const long long *avail, *usage;                     // [Q,F,R]
  const long long* requests;                          // [W,P,R]
  const unsigned char* podset_active;                 // [W,P]
  const int* wl_cq;                                   // [W]
  const unsigned char* eligible;                      // [W,P,F]
  const unsigned char* solvable;                      // [W]
  const int* start_rank;                              // [W,P,R] or null
  unsigned char *fit, *borrows;                       // [W]
  int* chosen;                                        // [W,NP,R]
  unsigned char* chosen_borrow;                       // [W,NP,R]
  long long* asg;                                     // [W,F,R]
  int W, P, NP, F, R, fb;
};

// Whether a rank packs into a key with fb bits of flavor index.
__device__ __forceinline__ bool pa_packs(int rank, int fb) {
  const int lim = 1 << (31 - fb);
  return rank >= -lim && rank <= lim - 2;
}

// The flavor one resource takes: -1 for none. low(nb, packed) is the
// lane's least key (rank * 2^fb + f if packed, else the rank) over its
// candidate flavors (nb: the non-borrowing ones only), INT_MAX for none;
// first_at(rank) the lane's least candidate index at that rank, INT_MAX
// for none.
template <class Low, class FirstAt>
__device__ __forceinline__ int pa_pick(bool packed, int fb, bool pnb, Low low,
                                       FirstAt first_at) {
  const int k1 = __reduce_min_sync(PA_FULL, low(false, packed));
  const int best =
      k1 == INT_MAX ? KQ_INF_RANK : min(KQ_INF_RANK, packed ? k1 >> fb : k1);
  int target = best;
  if (pnb) {
    const int k2 = __reduce_min_sync(PA_FULL, low(true, packed));
    const int best_nb =
        k2 == INT_MAX ? KQ_INF_RANK : min(KQ_INF_RANK, packed ? k2 >> fb : k2);
    if (best_nb < KQ_INF_RANK) target = best_nb;
  }
  if (target >= KQ_INF_RANK) return -1;
  if (packed && target == best) return k1 & ((1 << fb) - 1);
  return __reduce_min_sync(PA_FULL, first_at(target));
}

template <int RT>
__global__ void __launch_bounds__(32 * KQ_WARPS_PER_BLOCK)
    phase_a_reg_kernel(const PaArgs a) {
  extern __shared__ long long pa_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * KQ_WARPS_PER_BLOCK + warp;
  if (w >= a.W) return;  // uniform per warp
  const int R = a.R, P = a.P, NP = a.NP, F = a.F;
  // the warp's slice: requests [NP,R] int64, then start ranks [NP,R]
  long long* req = pa_smem + (size_t)warp * NP * R * (a.start_rank ? 2 : 1);
  int* srk = (int*)(req + NP * R);
  // loads that need only w
  const size_t wP = (size_t)w * P;
  for (int i = lane; i < NP * R; i += 32) {
    req[i] = a.requests[wP * R + i];
    if (a.start_rank) srk[i] = a.start_rank[wP * R + i];
  }
  const bool on = lane < F;
  const unsigned active =
      __ballot_sync(PA_FULL, lane < NP && a.podset_active[wP + lane]);
  const bool any_active =
      __any_sync(PA_FULL, lane < P && a.podset_active[wP + lane]);
  unsigned elig = 0;
  if (on)
    for (int p = 0; p < NP; ++p)
      elig |= (a.eligible[(wP + p) * F + lane] ? 1u : 0u) << p;
  const bool solvable = a.solvable[w] != 0;
  // loads that need the CQ
  const int q = a.wl_cq[w];
  const bool pnb = a.prefer_no_borrow[q] != 0;
  const int fg = on ? a.flavor_group[(size_t)q * F + lane] : -1;
  const int rank = on ? a.flavor_rank[(size_t)q * F + lane] : 0;
  int grp[RT];
  long long av[RT], us[RT], nm[RT], asg[RT];
  unsigned off = 0, rel_base = 0;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    asg[r] = 0, av[r] = 0, us[r] = 0, nm[r] = 0, grp[r] = -1;
    if (r >= R) continue;
    grp[r] = a.group_id[(size_t)q * R + r];
    if (!on) continue;
    const size_t e = ((size_t)q * F + lane) * R + r;
    av[r] = a.avail[e], us[r] = a.usage[e], nm[r] = a.nominal[e];
    off |= (a.offered[e] ? 1u : 0u) << r;
  }
#pragma unroll
  for (int r = 0; r < RT; ++r)
    if (fg >= 0 && grp[r] == fg) rel_base |= 1u << r;
  const bool packed = __all_sync(PA_FULL, !on || pa_packs(rank, 5));
  __syncwarp();  // the slice is staged
  bool ok_all = true, borrow_any = false;
  for (int p = 0; p < NP; ++p) {
    const long long* rq = req + p * R;
    const bool act = (active >> p) & 1u;
    unsigned has = 0;
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (r < R && rq[r] > 0) has |= 1u << r;
    // this lane's flavor: fits every relevant resource, borrows on any
    const unsigned rel = rel_base & has;
    bool fit_all = true, br = false;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (!((rel >> r) & 1u)) continue;
      const long long val = rq[r] + asg[r];
      fit_all &= ((off >> r) & 1u) && val <= av[r];
      br |= us[r] + val > nm[r];
    }
    const bool fit_f = on && fit_all && rel != 0 && ((elig >> p) & 1u);
    const unsigned bmask = __ballot_sync(PA_FULL, on && br);
    bool ok = true;
    int ch[RT], mine_c = -1;
    bool mine_b = false;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      ch[r] = -1;
      if (r >= R || !((has >> r) & 1u)) continue;  // uniform
      const int sr = a.start_rank ? srk[p * R + r] : INT_MIN;
      const bool cand = fit_f && grp[r] >= 0 && fg == grp[r] && rank >= sr;
      const int c = pa_pick(
          packed, 5, pnb,
          [&](bool nb, bool pk) {
            return cand && !(nb && br) ? (pk ? rank * 32 + lane : rank)
                                       : INT_MAX;
          },
          [&](int t) { return cand && rank == t ? lane : INT_MAX; });
      const bool cb = c >= 0 && ((bmask >> c) & 1u);
      ok &= c >= 0;
      borrow_any |= act && cb;
      ch[r] = c;
      if (lane == r) mine_c = c, mine_b = cb;
    }
    if (lane < R) {
      const size_t o = ((size_t)w * NP + p) * R + lane;
      a.chosen[o] = act ? mine_c : -1;
      a.chosen_borrow[o] = (act && mine_b) ? 1 : 0;
    }
    if (act) {
      ok_all &= ok;
#pragma unroll
      for (int r = 0; r < RT; ++r)
        if (ch[r] == lane) asg[r] += rq[r];
    }
  }
  if (lane == 0) {
    a.fit[w] = (ok_all && solvable && any_active) ? 1 : 0;
    a.borrows[w] = borrow_any ? 1 : 0;
  }
  if (on) {
    long long* out = a.asg + ((size_t)w * F + lane) * R;
#pragma unroll
    for (int r = 0; r < RT; ++r)
      if (r < R) out[r] = asg[r];
  }
}

// a warp's shared-memory slice in the general form, in ints: ch[R], then
// fit_f[F], borrow_f[F]
__host__ __device__ inline int kq_warp_ints(int F, int R) {
  return R + (2 * F + 3) / 4;
}

__global__ void __launch_bounds__(32 * KQ_WARPS_PER_BLOCK)
    phase_a_kernel(const PaArgs a) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * KQ_WARPS_PER_BLOCK + warp;
  if (w >= a.W) return;  // uniform per warp
  const int F = a.F, R = a.R, P = a.P, NP = a.NP, fb = a.fb;
  int* ch = smem + (size_t)warp * kq_warp_ints(F, R);
  unsigned char* fit_f = (unsigned char*)(ch + R);
  unsigned char* borrow_f = fit_f + F;
  const int q = a.wl_cq[w];
  const int FR = F * R;
  long long* asg_w = a.asg + (size_t)w * FR;
  const int* grp = a.group_id + (size_t)q * R;
  const int* fgrp = a.flavor_group + (size_t)q * F;
  const int* frank = a.flavor_rank + (size_t)q * F;
  const size_t qoff = (size_t)q * FR;
  bool packs = true;
  for (int f = lane; f < F; f += 32) {
    packs &= pa_packs(frank[f], fb);
    for (int r = 0; r < R; ++r) asg_w[f * R + r] = 0;
  }
  const bool packed = __all_sync(PA_FULL, packs);
  const bool pnb = a.prefer_no_borrow[q] != 0;
  bool any_active = false;
  for (int p = 0; p < P; ++p) any_active |= a.podset_active[(size_t)w * P + p] != 0;
  bool ok_all = true, borrow_any = false;
  for (int p = 0; p < NP; ++p) {
    const size_t wp = (size_t)w * P + p;
    const long long* req = a.requests + wp * R;
    const bool active = a.podset_active[wp] != 0;
    // per flavor: fits every relevant resource, and borrows on any
    for (int f = lane; f < F; f += 32) {
      const int fg = fgrp[f];
      bool rel_any = false, fit_all = true, br_any = false;
      for (int r = 0; r < R; ++r) {
        const long long rq = req[r];
        if (!(fg >= 0 && grp[r] == fg && rq > 0)) continue;
        const size_t qe = qoff + (size_t)f * R + r;
        const long long val = rq + asg_w[f * R + r];
        rel_any = true;
        fit_all &= a.offered[qe] && val <= a.avail[qe];
        br_any |= a.usage[qe] + val > a.nominal[qe];
      }
      fit_f[f] = (fit_all && rel_any && a.eligible[wp * F + f]) ? 1 : 0;
      borrow_f[f] = br_any ? 1 : 0;
    }
    __syncwarp();
    bool ok = true;
    for (int r = 0; r < R; ++r) {
      const bool has_req = req[r] > 0;
      int c = -1;
      if (has_req) {  // uniform
        const int gid = grp[r];
        const int sr = a.start_rank ? a.start_rank[wp * R + r] : INT_MIN;
        auto cand = [&](int f) {
          return gid >= 0 && fgrp[f] == gid && frank[f] >= sr && fit_f[f];
        };
        c = pa_pick(
            packed, fb, pnb,
            [&](bool nb, bool pk) {
              int best = INT_MAX;
              for (int f = lane; f < F; f += 32)
                if (cand(f) && !(nb && borrow_f[f]))
                  best = min(best, pk ? frank[f] * (1 << fb) + f : frank[f]);
              return best;
            },
            [&](int t) {
              for (int f = lane; f < F; f += 32)
                if (cand(f) && frank[f] == t) return f;
              return INT_MAX;
            });
      }
      const bool cb = c >= 0 && borrow_f[c];
      ok &= !has_req || c >= 0;
      if (lane == 0) {
        ch[r] = c;
        const size_t o = ((size_t)w * NP + p) * R + r;
        a.chosen[o] = active ? c : -1;
        a.chosen_borrow[o] = (active && cb) ? 1 : 0;
      }
      borrow_any |= active && cb;
    }
    __syncwarp();  // ch[] is complete
    if (active) {
      ok_all &= ok;
      for (int f = lane; f < F; f += 32)
        for (int r = 0; r < R; ++r)
          if (ch[r] == f) asg_w[f * R + r] += req[r];
    }
    __syncwarp();  // ch, fit_f and borrow_f are rewritten by the next podset
  }
  if (lane == 0) {
    a.fit[w] = (ok_all && a.solvable[w] && any_active) ? 1 : 0;
    a.borrows[w] = borrow_any ? 1 : 0;
  }
}

// The register form's resource pad (cluster_cols.cu's), or 0 for the
// general form.
__host__ __device__ inline int pa_register_r(long long F, long long R,
                                             long long P) {
  if (F > 32 || P > 32) return 0;
  for (int rt = 1; rt <= 16; rt *= 2)
    if (R <= rt) return rt;
  return 0;
}

extern "C" int phase_a_launch(
    const void* group_id, const void* flavor_group, const void* flavor_rank,
    const void* nominal, const void* offered, const void* prefer_no_borrow,
    const void* avail, const void* usage, const void* requests,
    const void* podset_active, const void* wl_cq, const void* eligible,
    const void* solvable, const void* start_rank, void* fit, void* borrows,
    void* chosen, void* chosen_borrow, void* asg, long long W, long long P,
    long long NP, long long F, long long R, void* stream) {
  if (W <= 0) return (int)cudaGetLastError();
  PaArgs a;
  a.group_id = (const int*)group_id;
  a.flavor_group = (const int*)flavor_group;
  a.flavor_rank = (const int*)flavor_rank;
  a.nominal = (const long long*)nominal;
  a.offered = (const unsigned char*)offered;
  a.prefer_no_borrow = (const unsigned char*)prefer_no_borrow;
  a.avail = (const long long*)avail;
  a.usage = (const long long*)usage;
  a.requests = (const long long*)requests;
  a.podset_active = (const unsigned char*)podset_active;
  a.wl_cq = (const int*)wl_cq;
  a.eligible = (const unsigned char*)eligible;
  a.solvable = (const unsigned char*)solvable;
  a.start_rank = (const int*)start_rank;
  a.fit = (unsigned char*)fit;
  a.borrows = (unsigned char*)borrows;
  a.chosen = (int*)chosen;
  a.chosen_borrow = (unsigned char*)chosen_borrow;
  a.asg = (long long*)asg;
  a.W = (int)W, a.P = (int)P, a.NP = (int)NP, a.F = (int)F, a.R = (int)R;
  a.fb = 5;
  while ((1LL << a.fb) < F) ++a.fb;
  const int threads = 32 * KQ_WARPS_PER_BLOCK;
  const unsigned blocks =
      (unsigned)((W + KQ_WARPS_PER_BLOCK - 1) / KQ_WARPS_PER_BLOCK);
  const cudaStream_t s = (cudaStream_t)stream;
  const int rt = pa_register_r(F, R, P);
  if (rt > 0) {
    const size_t smem = (size_t)KQ_WARPS_PER_BLOCK * NP * R *
                        (start_rank ? 16 : 8);
    switch (rt) {
      case 1: phase_a_reg_kernel<1><<<blocks, threads, smem, s>>>(a); break;
      case 2: phase_a_reg_kernel<2><<<blocks, threads, smem, s>>>(a); break;
      case 4: phase_a_reg_kernel<4><<<blocks, threads, smem, s>>>(a); break;
      case 8: phase_a_reg_kernel<8><<<blocks, threads, smem, s>>>(a); break;
      default: phase_a_reg_kernel<16><<<blocks, threads, smem, s>>>(a); break;
    }
    return (int)cudaGetLastError();
  }
  const size_t smem =
      (size_t)KQ_WARPS_PER_BLOCK * kq_warp_ints((int)F, (int)R) * 4;
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        phase_a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != 0) return rc;
  }
  phase_a_kernel<<<blocks, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// One reduction of the chain, for the latency bound: one warp runs `iters`
// __reduce_min_sync, each on a value that depends on the last result;
// out[0] gets the clock cycles they took, out[1] keeps the chain live.
__global__ void phase_a_tick_kernel(long long* out, int iters) {
  const int lane = threadIdx.x;
  int v = lane;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
    v = __reduce_min_sync(PA_FULL, (v + lane) ^ it) + lane;
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = t1 - t0;
    out[1] = v;
  }
}

extern "C" int phase_a_tick_launch(void* out, long long iters, void* stream) {
  phase_a_tick_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((long long*)out,
                                                         (int)iters);
  return (int)cudaGetLastError();
}
