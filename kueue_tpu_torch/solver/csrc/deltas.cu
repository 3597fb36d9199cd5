// deltas: sparse usage corrections applied in place to the resident state.
// Replaces kueue_tpu/solver/kernel.py:765 apply_state_deltas_impl. Input:
// D unique (q, f, r) coords with their net deltas (dq = -1 pads), and per
// cohort-chain level the level's unique cohort coords lvl_c[L,D,3] with
// lvl_seg[L,D], which maps row d of the level below (level 0: the delta
// coords) to its row in lvl_c[l] (-1: the chain ends, or padding).
// Each coord's change of usage above its guaranteed quota (a difference
// of clamps, so the old value is read before the add) becomes the next
// level's delta; several children can feed one cohort coord, so a
// level's deltas are segment sums: 64-bit atomic adds into shared memory
// (an unsigned add wraps correctly for negative deltas). One block; the
// levels are sequential, separated by barriers.
#include "common.cuh"

__global__ void deltas_kernel(const long long* __restrict__ guaranteed,
                              const long long* __restrict__ cohort_guaranteed,
                              long long* usage, long long* cohort_usage,
                              const int* __restrict__ dq,
                              const int* __restrict__ df,
                              const int* __restrict__ dr,
                              const long long* __restrict__ dv,
                              const int* __restrict__ lvl_c,
                              const int* __restrict__ lvl_seg, int D, int L,
                              int F, int R) {
  extern __shared__ long long shared[];
  long long* dover = shared;                                       // [D]
  unsigned long long* delta = (unsigned long long*)(shared + D);   // [D]
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    long long over = 0;
    if (dq[d] >= 0) {
      const size_t e = ((size_t)dq[d] * F + df[d]) * R + dr[d];
      const long long old = usage[e], nw = old + dv[d], g = guaranteed[e];
      usage[e] = nw;
      over = kq_max0(nw - g) - kq_max0(old - g);
    }
    dover[d] = over;
  }
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    for (int k = threadIdx.x; k < D; k += blockDim.x) delta[k] = 0ULL;
    __syncthreads();
    const int* seg = lvl_seg + (size_t)l * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      const int s = seg[d];
      if (s >= 0 && dover[d] != 0)
        atomicAdd(&delta[s], (unsigned long long)dover[d]);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < D; k += blockDim.x) {
      const int* c = lvl_c + ((size_t)l * D + k) * 3;
      long long over = 0;
      if (c[0] >= 0) {
        const size_t e = ((size_t)c[0] * F + c[1]) * R + c[2];
        const long long old = cohort_usage[e], add = (long long)delta[k];
        const long long nw = old + add, g = cohort_guaranteed[e];
        cohort_usage[e] = nw;
        over = kq_max0(nw - g) - kq_max0(old - g);
      }
      dover[k] = over;
    }
    __syncthreads();
  }
}

extern "C" int deltas_launch(const void* guaranteed,
                             const void* cohort_guaranteed, void* usage,
                             void* cohort_usage, const void* dq,
                             const void* df, const void* dr, const void* dv,
                             const void* lvl_c, const void* lvl_seg,
                             long long D, long long L, long long F,
                             long long R, void* stream) {
  if (D > 0) {
    long long threads = (D + 31) / 32 * 32;
    if (threads > 512) threads = 512;
    const size_t smem = (size_t)D * 2 * sizeof(long long);
    deltas_kernel<<<1, (unsigned)threads, smem, (cudaStream_t)stream>>>(
        (const long long*)guaranteed, (const long long*)cohort_guaranteed,
        (long long*)usage, (long long*)cohort_usage, (const int*)dq,
        (const int*)df, (const int*)dr, (const long long*)dv,
        (const int*)lvl_c, (const int*)lvl_seg, (int)D, (int)L, (int)F,
        (int)R);
  }
  return (int)cudaGetLastError();
}
