// cluster_cols: MultiKueue placement, scored in the cycle's admit order.
// Replaces kueue_tpu/solver/kernel.py:614 score_cluster_columns_impl.
// Remote worker clusters are K capacity columns [K,F,R]: for each row of
// the global admit order that was admitted and whose CQ carries a
// MultiKueue check, the first active cluster k with a flavor f whose
// remaining column covers every requested resource (and offers at least
// one of them) takes the row; the first such f within k is debited by the
// row's total request for later rows. Rows not placed get -1.
//
// Bound on the H100: latency. The bytes are a few KB; every row that takes
// part reads the capacity the placed rows before it left, so the scan is
// one chain of steps, one per such row (a placed one changes the state).
// Design: one warp. The
// remaining capacity and the offer mask (coffer with cactive folded in)
// live in shared memory, and lane l owns the columns c = k*F + f with
// c = l (mod 32): only the owner ever reads or writes a column, so the
// scan needs no barrier. The warp reads the admit order 32 rows at a time;
// each lane gathers its row's flags and total request (the sum over the
// active podsets) in parallel, and a ballot gives the participating rows.
// For each of them in order the row's request is broadcast with shuffles,
// every lane finds its first fitting column (in ascending c, so the first
// fit is the lowest c it owns), and a warp min picks the lowest c overall:
// argmax over k, then over f, as the JAX scan takes it. The owner
// debits the column. A single warp hides no latency, so the step is made
// short: R is a template parameter (the resource loops unroll exactly),
// each column's offer is one bit mask in shared memory, and a lane tests
// all its columns without an early exit, so their loads are independent.
#include <climits>

#include "common.cuh"

#define CC_FULL 0xffffffffu

template <int R>
__global__ void cluster_cols_kernel(
    const long long* __restrict__ ccap, const unsigned char* __restrict__ coffer,
    const unsigned char* __restrict__ cactive,
    const unsigned char* __restrict__ mk_cq,
    const long long* __restrict__ requests,
    const unsigned char* __restrict__ podset_active,
    const int* __restrict__ wl_cq, const int* __restrict__ order,
    const unsigned char* __restrict__ admitted, int* __restrict__ out, int W,
    int P, int K, int F) {
  extern __shared__ long long cc_shared[];
  const int KF = K * F;
  long long* rem = cc_shared;                                   // [KF*R]
  unsigned* offer = (unsigned*)(cc_shared + (size_t)KF * R);    // [KF] bits
  const int lane = threadIdx.x;
  for (int c = lane; c < KF; c += 32) {
    const bool on = cactive[c / F] != 0;
    unsigned bits = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rem[c * R + r] = ccap[c * R + r];
      if (on && coffer[c * R + r]) bits |= 1u << r;
    }
    offer[c] = bits;
  }
  __syncwarp();
  for (int base = 0; base < W; base += 32) {
    const int pos = base + lane;
    int w = -1;
    bool part = false;
    if (pos < W) {
      w = order[pos];
      part = admitted[w] && mk_cq[wl_cq[w]];
      if (!part) out[w] = -1;
    }
    long long treq[R];
#pragma unroll
    for (int r = 0; r < R; ++r) treq[r] = 0;
    if (part) {
      for (int p = 0; p < P; ++p) {
        if (!podset_active[(size_t)w * P + p]) continue;
        const long long* row = requests + ((size_t)w * P + p) * R;
#pragma unroll
        for (int r = 0; r < R; ++r) treq[r] += row[r];
      }
    }
    unsigned todo = __ballot_sync(CC_FULL, part);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int wj = __shfl_sync(CC_FULL, w, j);
      long long req[R];
      unsigned need = 0;  // the requested resources
#pragma unroll
      for (int r = 0; r < R; ++r) {
        req[r] = __shfl_sync(CC_FULL, treq[r], j);
        if (req[r] > 0) need |= 1u << r;
      }
      int best = INT_MAX;
#pragma unroll 4
      for (int c = lane; c < KF; c += 32) {
        // offered in every requested resource and covering it; at least
        // one resource requested
        bool fits = need != 0 && (offer[c] & need) == need;
#pragma unroll
        for (int r = 0; r < R; ++r)
          fits &= req[r] <= 0 || req[r] <= rem[c * R + r];
        if (fits && best == INT_MAX) best = c;
      }
      const int first = __reduce_min_sync(CC_FULL, best);
      if (first != INT_MAX && best == first) {
#pragma unroll
        for (int r = 0; r < R; ++r) rem[first * R + r] -= req[r];
      }
      if (lane == 0) out[wj] = first == INT_MAX ? -1 : first / F;
    }
  }
}

template <int R>
static int cluster_cols_run(const void* ccap, const void* coffer,
                            const void* cactive, const void* mk_cq,
                            const void* requests, const void* podset_active,
                            const void* wl_cq, const void* order,
                            const void* admitted, void* out, int W, int P,
                            int K, int F, cudaStream_t stream) {
  const size_t smem = (size_t)K * F * (R * sizeof(long long) + sizeof(unsigned));
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        cluster_cols_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != 0) return rc;
  }
  cluster_cols_kernel<R><<<1, 32, smem, stream>>>(
      (const long long*)ccap, (const unsigned char*)coffer,
      (const unsigned char*)cactive, (const unsigned char*)mk_cq,
      (const long long*)requests, (const unsigned char*)podset_active,
      (const int*)wl_cq, (const int*)order, (const unsigned char*)admitted,
      (int*)out, W, P, K, F);
  return (int)cudaGetLastError();
}

#define CC_CASE(n)                                                        \
  case n:                                                                 \
    return cluster_cols_run<n>(ccap, coffer, cactive, mk_cq, requests,    \
                               podset_active, wl_cq, order, admitted, out, \
                               (int)W, (int)P, (int)K, (int)F, s);

extern "C" int cluster_cols_launch(const void* ccap, const void* coffer,
                                   const void* cactive, const void* mk_cq,
                                   const void* requests,
                                   const void* podset_active,
                                   const void* wl_cq, const void* order,
                                   const void* admitted, void* out,
                                   long long W, long long P, long long R,
                                   long long K, long long F, void* stream) {
  if (W <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (R) {
    CC_CASE(1) CC_CASE(2) CC_CASE(3) CC_CASE(4) CC_CASE(5) CC_CASE(6)
    CC_CASE(7) CC_CASE(8) CC_CASE(9) CC_CASE(10) CC_CASE(11) CC_CASE(12)
    CC_CASE(13) CC_CASE(14) CC_CASE(15) CC_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
}
