// drf_share: the dominant resource share of every head of the cycle, the
// fair-sharing sort key of the admit order.
// Replaces kueue_tpu/solver/kernel.py:197 _drf_share (reference:
// dominantResourceShare, clusterqueue.go:529-564 with m=1). For workload
// w in CQ q:
//   b[f,r]       = asg_usage[w,f,r] - (nominal[q,f,r] - usage[q,f,r])
//                  where offered[q,f,r], else 0
//   borrowing[r] = sum_f max(0, b[f,r])
//   ratio[r]     = borrowing[r] * 1000 // lendable[root(q), r] when that
//                  lendable > 0, else -1
//   drs          = max_r ratio[r]
//   dws          = drs * 1000 // weight[q] when weight > 0, else NO_LIMIT
//   share[w]     = dws when w borrows anywhere and q has a cohort, else 0
// "//" is a floor division, as in JAX: drs is -1 when the root lends
// nothing in every resource the workload borrows, and -1000 // 3000 is
// -1, where C's "/" would give 0.
//
// Bound on the H100: bytes. Per workload it reads its [F,R] assignment
// row and its CQ's nominal, offered and usage rows once and does a few
// integer ops per element. Design: one warp per workload; for each
// resource the lanes stride over the flavors and the warp sums their
// clamped excesses with shuffles, so every lane ends with the same
// ratios and lane 0 writes the share. All arithmetic is int64.
#include "common.cuh"

#define KQ_DRF_WARPS 8

__device__ __forceinline__ long long kq_warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void drf_share_kernel(
    const long long* __restrict__ nominal,          // [Q,F,R]
    const unsigned char* __restrict__ offered,      // [Q,F,R]
    const int* __restrict__ cq_cohort,              // [Q]
    const int* __restrict__ cohort_root,            // [C]
    const long long* __restrict__ cohort_lendable,  // [C,R]
    const long long* __restrict__ fair_weight,      // [Q]
    const long long* __restrict__ usage,            // [Q,F,R]
    const long long* __restrict__ asg,              // [W,F,R]
    const int* __restrict__ wl_cq,                  // [W]
    long long* __restrict__ share,                  // [W]
    int W, int F, int R) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * KQ_DRF_WARPS + (threadIdx.x >> 5);
  if (w >= W) return;  // uniform per warp
  const int q = wl_cq[w];
  const int c = cq_cohort[q];
  const long long* lendable =
      cohort_lendable + (size_t)cohort_root[c >= 0 ? c : 0] * R;
  const size_t FR = (size_t)F * R;
  const size_t qoff = (size_t)q * FR, woff = (size_t)w * FR;
  bool borrows = false;
  long long drs = 0;
  for (int r = 0; r < R; ++r) {
    long long part = 0;
    for (int f = lane; f < F; f += 32) {
      const size_t e = (size_t)f * R + r;
      if (!offered[qoff + e]) continue;
      part += kq_max0(asg[woff + e] - (nominal[qoff + e] - usage[qoff + e]));
    }
    const long long borrowing = kq_warp_sum(part);
    borrows |= borrowing > 0;
    const long long lend = lendable[r];
    const long long ratio = lend > 0 ? kq_floordiv(borrowing * 1000, lend) : -1;
    drs = (r == 0 || ratio > drs) ? ratio : drs;
  }
  if (lane != 0) return;
  const long long weight = fair_weight[q];
  const long long dws =
      weight > 0 ? kq_floordiv(drs * 1000, weight) : KQ_NO_LIMIT;
  share[w] = (borrows && c >= 0) ? dws : 0;
}

extern "C" int drf_share_launch(const void* nominal, const void* offered,
                                const void* cq_cohort, const void* cohort_root,
                                const void* cohort_lendable,
                                const void* fair_weight, const void* usage,
                                const void* asg, const void* wl_cq,
                                void* share, long long W, long long F,
                                long long R, void* stream) {
  if (W <= 0) return 0;
  drf_share_kernel<<<(unsigned)((W + KQ_DRF_WARPS - 1) / KQ_DRF_WARPS),
                     KQ_DRF_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const long long*)nominal, (const unsigned char*)offered,
      (const int*)cq_cohort, (const int*)cohort_root,
      (const long long*)cohort_lendable, (const long long*)fair_weight,
      (const long long*)usage, (const long long*)asg, (const int*)wl_cq,
      (long long*)share, (int)W, (int)F, (int)R);
  return (int)cudaGetLastError();
}
