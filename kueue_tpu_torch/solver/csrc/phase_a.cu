// phase_a: flavor assignment for every head of the cycle.
// Replaces kueue_tpu/solver/kernel.py:128 _choose_flavors_one_podset and
// :221 _phase_a. One warp per workload, one lane per flavor (strided when
// F > 32), a serial loop over podsets. Per podset and resource the warp
// min-reduces the best fitting rank (and the best non-borrowing rank for
// TryNextFlavor CQs), then the lowest flavor index among the candidates
// at that rank: the first index, as jnp.argmax on bool returns it.
// asg_usage[w] accumulates across podsets in place; each lane owns the
// entries of its own flavors. A warp's slice of shared memory holds the
// chosen flavor of each resource (4R bytes: any R) and the per-flavor
// fit and borrow flags (2F bytes).
#include <climits>
#include "common.cuh"

#define KQ_WARPS_PER_BLOCK 4

// a warp's shared-memory slice, in ints: ch[R], then fit_f[F], borrow_f[F]
__host__ __device__ inline int kq_warp_ints(int F, int R) {
  return R + (2 * F + 3) / 4;
}

__device__ __forceinline__ int kq_warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void phase_a_kernel(
    const int* __restrict__ group_id,            // [Q,R]
    const int* __restrict__ flavor_group,        // [Q,F]
    const int* __restrict__ flavor_rank,         // [Q,F]
    const long long* __restrict__ nominal,       // [Q,F,R]
    const unsigned char* __restrict__ offered,   // [Q,F,R]
    const unsigned char* __restrict__ prefer_no_borrow,  // [Q]
    const long long* __restrict__ avail,         // [Q,F,R]
    const long long* __restrict__ usage,         // [Q,F,R]
    const long long* __restrict__ requests,      // [W,P,R]
    const unsigned char* __restrict__ podset_active,  // [W,P]
    const int* __restrict__ wl_cq,               // [W]
    const unsigned char* __restrict__ eligible,  // [W,P,F]
    const unsigned char* __restrict__ solvable,  // [W]
    const int* __restrict__ start_rank,          // [W,P,R] or null
    unsigned char* __restrict__ fit,             // [W]
    unsigned char* __restrict__ borrows,         // [W]
    int* __restrict__ chosen,                    // [W,NP,R]
    unsigned char* __restrict__ chosen_borrow,   // [W,NP,R]
    long long* __restrict__ asg,                 // [W,F,R]
    int W, int P, int NP, int F, int R) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * KQ_WARPS_PER_BLOCK + warp;
  if (w >= W) return;  // uniform per warp
  int* ch = smem + (size_t)warp * kq_warp_ints(F, R);
  unsigned char* fit_f = (unsigned char*)(ch + R);
  unsigned char* borrow_f = fit_f + F;
  const int q = wl_cq[w];
  const int FR = F * R;
  long long* asg_w = asg + (size_t)w * FR;
  const int* grp = group_id + (size_t)q * R;
  const int* fgrp = flavor_group + (size_t)q * F;
  const int* frank = flavor_rank + (size_t)q * F;
  const size_t qoff = (size_t)q * FR;
  for (int f = lane; f < F; f += 32)
    for (int r = 0; r < R; ++r) asg_w[f * R + r] = 0;
  const bool pnb = prefer_no_borrow[q] != 0;
  bool any_active = false;
  for (int p = 0; p < P; ++p) any_active |= podset_active[(size_t)w * P + p] != 0;
  bool ok_all = true, borrow_any = false;
  for (int p = 0; p < NP; ++p) {
    const size_t wp = (size_t)w * P + p;
    const long long* req = requests + wp * R;
    const bool active = podset_active[wp] != 0;
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
        fit_all &= offered[qe] && val <= avail[qe];
        br_any |= usage[qe] + val > nominal[qe];
      }
      fit_f[f] = (fit_all && rel_any && eligible[wp * F + f]) ? 1 : 0;
      borrow_f[f] = br_any ? 1 : 0;
    }
    __syncwarp();
    bool ok = true;
    for (int r = 0; r < R; ++r) {
      const bool has_req = req[r] > 0;
      const int gid = grp[r];
      const int sr = start_rank ? start_rank[wp * R + r] : INT_MIN;
      int best = KQ_INF_RANK, best_nb = KQ_INF_RANK;
      for (int f = lane; f < F; f += 32) {
        const int rk = frank[f];
        if (gid >= 0 && fgrp[f] == gid && rk >= sr && fit_f[f]) {
          best = min(best, rk);
          if (!borrow_f[f]) best_nb = min(best_nb, rk);
        }
      }
      best = kq_warp_min(best);
      best_nb = kq_warp_min(best_nb);
      const int target = (pnb && best_nb < KQ_INF_RANK) ? best_nb : best;
      int first = INT_MAX;
      for (int f = lane; f < F; f += 32) {
        const int rk = frank[f];
        if (gid >= 0 && fgrp[f] == gid && rk >= sr && rk == target && fit_f[f])
          first = min(first, f);
      }
      first = kq_warp_min(first);
      const int c = (target < KQ_INF_RANK && has_req) ? first : -1;
      const bool cb = c >= 0 && borrow_f[c];
      ok &= !has_req || c >= 0;
      if (lane == 0) {
        ch[r] = c;
        const size_t o = ((size_t)w * NP + p) * R + r;
        chosen[o] = active ? c : -1;
        chosen_borrow[o] = (active && cb) ? 1 : 0;
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
    fit[w] = (ok_all && solvable[w] && any_active) ? 1 : 0;
    borrows[w] = borrow_any ? 1 : 0;
  }
}

extern "C" int phase_a_launch(
    const void* group_id, const void* flavor_group, const void* flavor_rank,
    const void* nominal, const void* offered, const void* prefer_no_borrow,
    const void* avail, const void* usage, const void* requests,
    const void* podset_active, const void* wl_cq, const void* eligible,
    const void* solvable, const void* start_rank, void* fit, void* borrows,
    void* chosen, void* chosen_borrow, void* asg, long long W, long long P,
    long long NP, long long F, long long R, void* stream) {
  if (W > 0) {
    const int threads = 32 * KQ_WARPS_PER_BLOCK;
    const long long blocks = (W + KQ_WARPS_PER_BLOCK - 1) / KQ_WARPS_PER_BLOCK;
    const size_t smem =
        (size_t)KQ_WARPS_PER_BLOCK * kq_warp_ints((int)F, (int)R) * 4;
    if (smem > 48 * 1024) {
      const int rc = (int)cudaFuncSetAttribute(
          phase_a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (rc != 0) return rc;
    }
    phase_a_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
        (const int*)group_id, (const int*)flavor_group, (const int*)flavor_rank,
        (const long long*)nominal, (const unsigned char*)offered,
        (const unsigned char*)prefer_no_borrow, (const long long*)avail,
        (const long long*)usage, (const long long*)requests,
        (const unsigned char*)podset_active, (const int*)wl_cq,
        (const unsigned char*)eligible, (const unsigned char*)solvable,
        (const int*)start_rank, (unsigned char*)fit, (unsigned char*)borrows,
        (int*)chosen, (unsigned char*)chosen_borrow, (long long*)asg, (int)W,
        (int)P, (int)NP, (int)F, (int)R);
  }
  return (int)cudaGetLastError();
}
