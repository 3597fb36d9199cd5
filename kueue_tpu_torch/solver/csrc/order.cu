// order: the admit order and the conflict-domain CSR of it.
// Replaces kueue_tpu/solver/kernel.py:498-525 (the lexsort of the admit
// order, the stable sort by conflict domain and the [L,D] order grid).
// Outputs offsets[D+1] and members[W]: members[offsets[d]:offsets[d+1]]
// are domain d's workloads in admit order. That is one stable sort on the
// composite key (domain, ~fit, borrows, share, -priority, timestamp,
// index), computed as a counting rank: the rank of workload i is the
// number of workloads whose key is smaller, and members[rank] = i. When
// asked (order != null), the same tile loop also counts the rank without
// the domain key and writes the global admit order, order[rank2] = i: the
// JAX lexsort across all domains, which the MultiKueue scan
// (cluster_cols) walks because remote capacity is shared by every domain.
//
// Bound on the H100: latency. The bytes are a few KB; the W^2 key
// comparisons (4M at W = 2048) are the work. Design: one warp per
// workload, so a rank is 32 lanes' partial counts summed with shuffles
// rather than one thread's chain of W dependent compares; a block's eight
// warps share the keys, staged through shared memory a tile at a time.
// The rank pass also writes each rank's domain (sorted_dom); a second
// kernel on the same stream gives one thread to each domain boundary d,
// whose lower bound in sorted_dom is offsets[d]. Timestamps compare as
// doubles (NaN last, as torch.sort places it) and -priority as int64
// (two's complement wrap, as torch negates), nothing packed.
#include "common.cuh"

#define ORDER_TILE 256
#define ORDER_WARPS (ORDER_TILE / 32)  // workloads ranked per block

struct OrderKey {
  int dom;
  int nfit;  // ~fit: 0 sorts first
  int borrows;
  long long share;
  long long negp;  // -priority
  double ts;
};

__device__ __forceinline__ OrderKey kq_order_key(
    int i, int C, const int* __restrict__ cq_cohort,
    const int* __restrict__ cohort_root, const unsigned char* __restrict__ fit,
    const unsigned char* __restrict__ borrows,
    const long long* __restrict__ share, const long long* __restrict__ priority,
    const double* __restrict__ timestamp, const int* __restrict__ wl_cq) {
  OrderKey k;
  const int q = wl_cq[i];
  const int c = cq_cohort[q];
  k.dom = c >= 0 ? cohort_root[c] : C + q;
  k.nfit = fit[i] ? 0 : 1;
  k.borrows = borrows[i] ? 1 : 0;
  k.share = share ? share[i] : 0;
  k.negp = (long long)(0ULL - (unsigned long long)priority[i]);
  k.ts = timestamp[i];
  return k;
}

// a < b in (ts), NaN after every number and equal to NaN
__device__ __forceinline__ int kq_cmp_ts(double a, double b) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na == nb ? 0 : (na ? 1 : -1);
  return a < b ? -1 : (b < a ? 1 : 0);
}

// global admit key of (a, ia) below that of (b, ib): no domain
__device__ __forceinline__ bool kq_order_less(const OrderKey& a, int ia,
                                              const OrderKey& b, int ib) {
  if (a.nfit != b.nfit) return a.nfit < b.nfit;
  if (a.borrows != b.borrows) return a.borrows < b.borrows;
  if (a.share != b.share) return a.share < b.share;
  if (a.negp != b.negp) return a.negp < b.negp;
  const int t = kq_cmp_ts(a.ts, b.ts);
  if (t != 0) return t < 0;
  return ia < ib;
}

// composite key of (a, ia) below that of (b, ib): the domain first
__device__ __forceinline__ bool kq_key_less(const OrderKey& a, int ia,
                                            const OrderKey& b, int ib) {
  if (a.dom != b.dom) return a.dom < b.dom;
  return kq_order_less(a, ia, b, ib);
}

__global__ void order_rank_kernel(
    const int* __restrict__ cq_cohort, const int* __restrict__ cohort_root,
    const unsigned char* __restrict__ fit,
    const unsigned char* __restrict__ borrows,
    const long long* __restrict__ share, const long long* __restrict__ priority,
    const double* __restrict__ timestamp, const int* __restrict__ wl_cq,
    int* __restrict__ members, int* __restrict__ sorted_dom,
    int* __restrict__ order, int W, int C) {
  __shared__ OrderKey tile[ORDER_TILE];
  const int lane = threadIdx.x & 31;
  const int me = blockIdx.x * ORDER_WARPS + (threadIdx.x >> 5);
  const bool active = me < W;  // uniform across the warp
  OrderKey mine{};
  if (active)
    mine = kq_order_key(me, C, cq_cohort, cohort_root, fit, borrows, share,
                        priority, timestamp, wl_cq);
  int count = 0, count2 = 0;
  for (int base = 0; base < W; base += ORDER_TILE) {
    const int j = base + threadIdx.x;
    __syncthreads();
    if (j < W)
      tile[threadIdx.x] = kq_order_key(j, C, cq_cohort, cohort_root, fit,
                                       borrows, share, priority, timestamp,
                                       wl_cq);
    __syncthreads();
    const int n = min(ORDER_TILE, W - base);
    if (active)
      for (int t = lane; t < n; t += 32) {
        count += kq_key_less(tile[t], base + t, mine, me) ? 1 : 0;
        if (order) count2 += kq_order_less(tile[t], base + t, mine, me) ? 1 : 0;
      }
  }
  if (!active) return;
  for (int o = 16; o > 0; o >>= 1) {
    count += __shfl_down_sync(0xffffffffu, count, o);
    count2 += __shfl_down_sync(0xffffffffu, count2, o);
  }
  if (lane == 0) {
    members[count] = me;
    sorted_dom[count] = mine.dom;
    if (order) order[count2] = me;
  }
}

// offsets[d] = the number of workloads whose domain is below d: the lower
// bound of d in the sorted domains.
__global__ void order_offsets_kernel(const int* __restrict__ sorted_dom,
                                     int* __restrict__ offsets, int W, int D) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d > D) return;
  int lo = 0, hi = W;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sorted_dom[mid] < d)
      lo = mid + 1;
    else
      hi = mid;
  }
  offsets[d] = lo;
}

extern "C" int order_launch(const void* cq_cohort, const void* cohort_root,
                            const void* fit, const void* borrows,
                            const void* share, const void* priority,
                            const void* timestamp, const void* wl_cq,
                            void* offsets, void* members, void* sorted_dom,
                            void* order, long long W, long long C, long long D,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (W > 0) {
    order_rank_kernel<<<(unsigned)((W + ORDER_WARPS - 1) / ORDER_WARPS),
                        ORDER_TILE, 0, s>>>(
        (const int*)cq_cohort, (const int*)cohort_root,
        (const unsigned char*)fit, (const unsigned char*)borrows,
        (const long long*)share, (const long long*)priority,
        (const double*)timestamp, (const int*)wl_cq, (int*)members,
        (int*)sorted_dom, (int*)order, (int)W, (int)C);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  order_offsets_kernel<<<(unsigned)((D + 1 + 255) / 256), 256, 0, s>>>(
      (const int*)sorted_dom, (int*)offsets, (int)W, (int)D);
  return (int)cudaGetLastError();
}
