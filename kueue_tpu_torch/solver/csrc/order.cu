// order: the admit order and the conflict-domain CSR of it.
// Replaces kueue_tpu/solver/kernel.py:498-525 (the lexsort of the admit
// order, the stable sort by conflict domain and the [L,D] order grid).
// Outputs offsets[D+1] and members[W]: members[offsets[d]:offsets[d+1]]
// are domain d's workloads in admit order, every workload once. When asked
// (order != null), also the global admit order: the JAX lexsort across all
// domains, which the MultiKueue scan (cluster_cols) walks because remote
// capacity is shared by every domain.
//
// The key. Each workload's admit key (~fit, borrows, share, -priority,
// timestamp, index) is packed once into four 64-bit words whose unsigned
// order is the key's order: ~fit and borrows a bit each, share and
// -priority with the sign bit flipped (so NO_LIMIT and negative shares
// keep their signed order; -priority wraps in two's complement, so
// INT64_MIN stays first, as torch and JAX negate), the timestamp mapped
// from double to an order-preserving uint64 (-0.0 and every subnormal as
// 0.0, as the JAX package's CPU backend flushes them; every NaN one
// code above +inf, so NaNs tie and go last, as torch.sort places them),
// the index last. A compare is one 256-bit subtraction's borrow, with no
// branch over fields; keys are unique, so a workload's rank is the number
// of keys below its own.
//
// Bound on the H100: latency, and the launch. The bytes are ~70 KB at
// the north star. A one-block sort of 32-byte keys is bound by the SM's
// shared-memory rate (each bitonic stage moves every key through it), and
// a grid-wide barrier costs microseconds, so the work is spread over
// blocks that share nothing.
//
// Design, the staged form (order_staged_kernel, one launch; W <= 4096 and
// the keys, the workloads, a histogram of the domains and the
// topology's cq_cohort and cohort_root in a block's shared memory:
// kernel.order_plan). Every block finds every workload's domain in one round
// trip (the CQs and the two tables loaded together, then looked up in shared
// memory), counts the domains in shared memory, scans the counts into the
// CSR's offsets and lists the workloads in domain order (a domain's
// contiguous, in no order within it). Each block then ranks its own slice of
// the workloads, a warp a workload, against its domain's keys only:
// members[offsets[d] + rank] = i. Domains are disjoint, so the north star's
// 256 domains of ~8 compare ~8 keys each, which the lanes load from global
// memory (the direct path, while every domain of the block's workloads has at
// most ORDER_DIRECT members and no global order is asked). Otherwise the block
// stages every key in shared memory in domain order first: one domain of every
// workload compares all W, spread over the blocks, and the global order counts
// against all W keys, each lane's loaded key held against ORDER_GROUP
// workloads. Each block writes its share of the offsets.
//
// The global form (W above that, or the histogram past shared memory):
// order_keys_kernel packs each key once into a global scratch (planes of
// words), order_rank_kernel counts ranks over tiles of those words (the
// composite key (domain, key) for members, the key for the order; the next
// tile loaded while the current one is compared) and order_offsets_kernel
// gives each domain boundary d its lower bound in the sorted domains.
#include "common.cuh"

typedef unsigned long long kq_u64;

#define ORDER_THREADS 512      // the staged form's block
#define ORDER_ILP 8            // workloads a thread stages: W <= 4096
#define ORDER_GROUP 4          // workloads a lane holds each loaded key to
#define ORDER_DIRECT 256       // the largest domain ranked from global memory
#define ORDER_RANK_THREADS 256 // the global form's rank block
#define ORDER_RANK_WARPS (ORDER_RANK_THREADS / 32)

__device__ __forceinline__ kq_u64 kq_ord_i64(long long v) {
  return (kq_u64)v ^ (1ULL << 63);
}

__device__ __forceinline__ kq_u64 kq_ord_f64(double t) {
  kq_u64 b = (kq_u64)__double_as_longlong(t);
  if (t != t) return ~0ULL;      // every NaN, after +inf and tied
  if (((b >> 52) & 0x7ff) == 0) b = 0;  // -0.0 and subnormals are 0.0
  return (b >> 63) ? ~b : (b | (1ULL << 63));
}

struct KqKey {
  kq_u64 w0, w1, w2, w3;  // w0 the most significant
};

__device__ __forceinline__ KqKey kq_pack_key(unsigned char fit,
                                             unsigned char borrows,
                                             long long share,
                                             long long priority, double ts,
                                             kq_u64 idx) {
  const kq_u64 nf = fit ? 0 : 1, bo = borrows ? 1 : 0;
  const kq_u64 s = kq_ord_i64(share);
  const kq_u64 n = kq_ord_i64((long long)(0ULL - (kq_u64)priority));
  const kq_u64 t = kq_ord_f64(ts);
  KqKey k;
  k.w0 = nf << 63 | bo << 62 | s >> 2;
  k.w1 = s << 62 | n >> 2;
  k.w2 = n << 62 | t >> 2;
  k.w3 = t << 62 | idx;
  return k;
}

// 1 when a < b: the borrow out of a - b over 256 bits
__device__ __forceinline__ unsigned kq_key_less(const KqKey& a,
                                                const KqKey& b) {
  unsigned r;
  asm("{\n\t.reg .u64 t;\n\t.reg .u32 z;\n\t"
      "mov.u32 z, 0;\n\t"
      "sub.cc.u64 t, %4, %8;\n\t"
      "subc.cc.u64 t, %3, %7;\n\t"
      "subc.cc.u64 t, %2, %6;\n\t"
      "subc.cc.u64 t, %1, %5;\n\t"
      "subc.u32 %0, z, z;\n\t}"
      : "=r"(r)
      : "l"(a.w0), "l"(a.w1), "l"(a.w2), "l"(a.w3), "l"(b.w0), "l"(b.w1),
        "l"(b.w2), "l"(b.w3));
  return r & 1u;
}

__device__ __forceinline__ KqKey kq_key_at(const kq_u64* k0, int n, int i) {
  KqKey k;
  k.w0 = k0[i];
  k.w1 = k0[n + i];
  k.w2 = k0[2 * n + i];
  k.w3 = k0[3 * n + i];
  return k;
}

__device__ __forceinline__ void kq_key_put(kq_u64* k0, int n, int i,
                                           const KqKey& k) {
  k0[i] = k.w0;
  k0[n + i] = k.w1;
  k0[2 * n + i] = k.w2;
  k0[3 * n + i] = k.w3;
}

// Exclusive prefix sum of a[0..n) in place, by the whole block.
__device__ void kq_block_scan(int* a, int n, int* warp_tot) {
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31,
            wid = tid >> 5;
  const int per = (n + T - 1) / T;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int x = s;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  if (wid == 0) {
    const int v = lane < (T >> 5) ? warp_tot[lane] : 0;
    int z = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, z, o);
      if (lane >= o) z += y;
    }
    warp_tot[lane] = z - v;
  }
  __syncthreads();
  int run = x - s + warp_tot[wid];
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
}

// A workload's packed key, from the fields in global memory.
__device__ __forceinline__ KqKey kq_load_key(
    const unsigned char* __restrict__ fit,
    const unsigned char* __restrict__ borrows,
    const long long* __restrict__ share,
    const long long* __restrict__ priority,
    const double* __restrict__ timestamp, int j) {
  return kq_pack_key(fit[j], borrows[j], share ? share[j] : 0, priority[j],
                     timestamp[j], (kq_u64)j);
}

__global__ void __launch_bounds__(ORDER_THREADS, 1) order_staged_kernel(
    const int* __restrict__ cq_cohort, const int* __restrict__ cohort_root,
    const unsigned char* __restrict__ fit,
    const unsigned char* __restrict__ borrows,
    const long long* __restrict__ share,
    const long long* __restrict__ priority,
    const double* __restrict__ timestamp, const int* __restrict__ wl_cq,
    int* __restrict__ offsets, int* __restrict__ members,
    int* __restrict__ order, int W, int C, int D, int mines) {
  extern __shared__ __align__(16) unsigned char kq_smem[];
  kq_u64* keys = (kq_u64*)kq_smem;  // [4][W] planes, in domain order
  int* widx = (int*)(keys + 4 * (size_t)W);  // [W] workloads, domain order
  int* hist = widx + W;                      // [D + 1]
  int* tab = hist + D + 1;                   // [Q + C]: cq_cohort, cohort_root
  int* mine_pos = tab + D;                   // [mines]
  int* mine_dom = mine_pos + mines;          // [mines]
  unsigned* mine_cnt = (unsigned*)(mine_dom + mines);  // [mines]
  __shared__ int warp_tot[32];
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31,
            warp = tid >> 5, NW = T >> 5, Q = D - C;
  const int m_lo = blockIdx.x * mines;
  const int n_m = max(0, min(mines, W - m_lo));

  // One round trip: the workloads' CQs, the topology's two tables into
  // shared memory, and each warp's first workload's key.
  int q[ORDER_ILP], dq[ORDER_ILP], pos[ORDER_ILP];
#pragma unroll
  for (int u = 0; u < ORDER_ILP; ++u)
    if (tid + u * T < W) q[u] = wl_cq[tid + u * T];
  for (int i = tid; i < D; i += T)
    tab[i] = i < Q ? cq_cohort[i] : cohort_root[i - Q];
  KqKey first = {0, 0, 0, 0};
  if (warp < n_m)
    first = kq_load_key(fit, borrows, share, priority, timestamp, m_lo + warp);
  for (int d = tid; d <= D; d += T) hist[d] = 0;
  for (int u = tid; u < n_m; u += T) mine_cnt[u] = 0;
  __syncthreads();
  // Every workload's domain (its CQ's root cohort, or C + q), counted.
#pragma unroll
  for (int u = 0; u < ORDER_ILP; ++u)
    if (tid + u * T < W) {
      const int c = tab[q[u]];
      dq[u] = c >= 0 ? tab[Q + c] : C + q[u];
      atomicAdd(&hist[dq[u]], 1);
    }
  __syncthreads();
  // Whether a domain of this block's workloads is past ORDER_DIRECT.
  bool big = false;
#pragma unroll
  for (int u = 0; u < ORDER_ILP; ++u) {
    const int mi = tid + u * T - m_lo;
    if (tid + u * T < W && mi >= 0 && mi < n_m)
      big |= hist[dq[u]] > ORDER_DIRECT;
  }
  kq_block_scan(hist, D + 1, warp_tot);
  // The workloads in domain order: hist[d] ends as the end of d.
#pragma unroll
  for (int u = 0; u < ORDER_ILP; ++u) {
    const int j = tid + u * T;
    if (j < W) {
      pos[u] = atomicAdd(&hist[dq[u]], 1);
      widx[pos[u]] = j;
      const int mi = j - m_lo;
      if (mi >= 0 && mi < n_m) {
        mine_pos[mi] = pos[u];
        mine_dom[mi] = dq[u];
      }
    }
  }
  // Small domains (every one of this block's workloads in a domain of at
  // most ORDER_DIRECT members) and no global order: the direct path.
  const bool wide = __syncthreads_or(big) || order;

  // This block's share of the offsets.
  const int per = (D + 1 + gridDim.x - 1) / gridDim.x;
  const int d_hi = min(D + 1, (int)(blockIdx.x + 1) * per);
  for (int d = blockIdx.x * per + tid; d < d_hi; d += T)
    offsets[d] = d ? hist[d - 1] : 0;

  // The direct path: a warp a workload, its lanes loading its domain's
  // keys from global memory.
  if (!wide) {
    for (int mi = warp; mi < n_m; mi += NW) {
      const int d = mine_dom[mi];
      const int lo = d ? hist[d - 1] : 0, hi = hist[d];
      const KqKey mine = mi == warp ? first
                                    : kq_load_key(fit, borrows, share,
                                                  priority, timestamp,
                                                  m_lo + mi);
      unsigned cnt = 0;
#pragma unroll 2
      for (int x = lo + lane; x < hi; x += 32)
        cnt += kq_key_less(kq_load_key(fit, borrows, share, priority,
                                       timestamp, widx[x]),
                           mine);
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if (lane == 0) members[lo + cnt] = m_lo + mi;
    }
    return;
  }

  // Otherwise every key, staged in domain order.
#pragma unroll
  for (int u = 0; u < ORDER_ILP; ++u) {
    const int j = tid + u * T;
    if (j < W)
      kq_key_put(keys, W, pos[u],
                 kq_load_key(fit, borrows, share, priority, timestamp, j));
  }
  __syncthreads();
  // Members: a warp a workload, its lanes over its domain's keys.
  for (int mi = warp; mi < n_m; mi += NW) {
    const int d = mine_dom[mi];
    const int lo = d ? hist[d - 1] : 0, hi = hist[d];
    const KqKey mine = kq_key_at(keys, W, mine_pos[mi]);
    unsigned cnt = 0;
    for (int x = lo + lane; x < hi; x += 32)
      cnt += kq_key_less(kq_key_at(keys, W, x), mine);
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) members[lo + cnt] = m_lo + mi;
  }
  if (!order) return;

  // The global order: units of (a group of ORDER_GROUP workloads, a slice
  // of the keys); each lane holds a loaded key to the group's keys.
  const int groups = (n_m + ORDER_GROUP - 1) / ORDER_GROUP;
  const int slices = groups ? max(1, NW / groups) : 0;
  for (int unit = warp; unit < groups * slices; unit += NW) {
    const int g = unit % groups, sl = unit / groups;
    KqKey mine[ORDER_GROUP];
    unsigned cnt[ORDER_GROUP];
#pragma unroll
    for (int u = 0; u < ORDER_GROUP; ++u) {
      const int mi = min(g * ORDER_GROUP + u, n_m - 1);
      mine[u] = kq_key_at(keys, W, mine_pos[mi]);
      cnt[u] = 0;
    }
    for (int x = sl * 32 + lane; x < W; x += slices * 32) {
      const KqKey k = kq_key_at(keys, W, x);
#pragma unroll
      for (int u = 0; u < ORDER_GROUP; ++u) cnt[u] += kq_key_less(k, mine[u]);
    }
#pragma unroll
    for (int u = 0; u < ORDER_GROUP; ++u) {
      const unsigned c = __reduce_add_sync(0xffffffffu, cnt[u]);
      if (lane == 0 && g * ORDER_GROUP + u < n_m)
        atomicAdd(&mine_cnt[g * ORDER_GROUP + u], c);
    }
  }
  __syncthreads();
  for (int mi = tid; mi < n_m; mi += T) order[mine_cnt[mi]] = m_lo + mi;
}

// The global form: each key packed once into the scratch's planes.
__global__ void order_keys_kernel(
    const int* __restrict__ cq_cohort, const int* __restrict__ cohort_root,
    const unsigned char* __restrict__ fit,
    const unsigned char* __restrict__ borrows,
    const long long* __restrict__ share,
    const long long* __restrict__ priority,
    const double* __restrict__ timestamp, const int* __restrict__ wl_cq,
    kq_u64* __restrict__ keys, int* __restrict__ dom, int W, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= W) return;
  const int q = wl_cq[i];
  const KqKey k = kq_load_key(fit, borrows, share, priority, timestamp, i);
  const int c = cq_cohort[q];
  dom[i] = c >= 0 ? cohort_root[c] : C + q;
  kq_key_put(keys, W, i, k);
}

// The global form's ranks: a warp ranks ORDER_GROUP workloads over tiles
// of the packed keys, the next tile in registers while one is compared.
__global__ void __launch_bounds__(ORDER_RANK_THREADS) order_rank_kernel(
    const kq_u64* __restrict__ keys, const int* __restrict__ dom,
    int* __restrict__ members, int* __restrict__ sorted_dom,
    int* __restrict__ order, int W) {
  __shared__ kq_u64 tile[4][ORDER_RANK_THREADS];
  __shared__ int tile_dom[ORDER_RANK_THREADS];
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * ORDER_RANK_WARPS + (threadIdx.x >> 5)) *
                    ORDER_GROUP;
  KqKey mine[ORDER_GROUP];
  int md[ORDER_GROUP];
  unsigned cnt[ORDER_GROUP], cnt2[ORDER_GROUP];
#pragma unroll
  for (int u = 0; u < ORDER_GROUP; ++u) {
    const int m = min(first + u, W - 1);
    mine[u] = kq_key_at(keys, W, m);
    md[u] = dom[m];
    cnt[u] = cnt2[u] = 0;
  }
  KqKey next = {0, 0, 0, 0};
  int next_dom = 0;
  if ((int)threadIdx.x < W) {
    next = kq_key_at(keys, W, threadIdx.x);
    next_dom = dom[threadIdx.x];
  }
  for (int base = 0; base < W; base += ORDER_RANK_THREADS) {
    __syncthreads();
    tile[0][threadIdx.x] = next.w0;
    tile[1][threadIdx.x] = next.w1;
    tile[2][threadIdx.x] = next.w2;
    tile[3][threadIdx.x] = next.w3;
    tile_dom[threadIdx.x] = next_dom;
    __syncthreads();
    const int j = base + ORDER_RANK_THREADS + threadIdx.x;
    if (j < W) {
      next = kq_key_at(keys, W, j);
      next_dom = dom[j];
    }
    const int n = min(ORDER_RANK_THREADS, W - base);
    for (int x = lane; x < n; x += 32) {
      KqKey k;
      k.w0 = tile[0][x];
      k.w1 = tile[1][x];
      k.w2 = tile[2][x];
      k.w3 = tile[3][x];
      const int d = tile_dom[x];
#pragma unroll
      for (int u = 0; u < ORDER_GROUP; ++u) {
        const unsigned lt = kq_key_less(k, mine[u]);
        cnt[u] += (unsigned)(d < md[u]) | ((unsigned)(d == md[u]) & lt);
        cnt2[u] += lt;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < ORDER_GROUP; ++u) {
    const unsigned c = __reduce_add_sync(0xffffffffu, cnt[u]);
    const unsigned c2 = __reduce_add_sync(0xffffffffu, cnt2[u]);
    if (lane == 0 && first + u < W) {
      members[c] = first + u;
      sorted_dom[c] = md[u];
      if (order) order[c2] = first + u;
    }
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

// form 0 (staged): one launch of `blocks` blocks, each ranking `mines`
// workloads, `smem` bytes of dynamic shared memory (kernel.order_plan).
// form 1 (global): scratch holds 4W words of keys, then W domains and W
// sorted domains; three launches (the offsets alone when W is 0).
extern "C" int order_launch(const void* cq_cohort, const void* cohort_root,
                            const void* fit, const void* borrows,
                            const void* share, const void* priority,
                            const void* timestamp, const void* wl_cq,
                            void* offsets, void* members, void* order,
                            void* scratch, long long W, long long C,
                            long long D, long long form, long long blocks,
                            long long mines, long long smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 0) {
    static long long smem_set = 0;
    if (smem > 48 * 1024 && smem > smem_set) {
      const cudaError_t rc = cudaFuncSetAttribute(
          order_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (rc != cudaSuccess) return (int)rc;
      smem_set = smem;
    }
    order_staged_kernel<<<(unsigned)blocks, ORDER_THREADS, (size_t)smem, s>>>(
        (const int*)cq_cohort, (const int*)cohort_root,
        (const unsigned char*)fit, (const unsigned char*)borrows,
        (const long long*)share, (const long long*)priority,
        (const double*)timestamp, (const int*)wl_cq, (int*)offsets,
        (int*)members, (int*)order, (int)W, (int)C, (int)D, (int)mines);
    return (int)cudaGetLastError();
  }
  kq_u64* keys = (kq_u64*)scratch;
  int* dom = (int*)(keys + 4 * W);
  int* sorted_dom = dom + W;
  if (W > 0) {
    order_keys_kernel<<<(unsigned)((W + 255) / 256), 256, 0, s>>>(
        (const int*)cq_cohort, (const int*)cohort_root,
        (const unsigned char*)fit, (const unsigned char*)borrows,
        (const long long*)share, (const long long*)priority,
        (const double*)timestamp, (const int*)wl_cq, keys, dom, (int)W,
        (int)C);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    const long long per_block = (long long)ORDER_RANK_WARPS * ORDER_GROUP;
    order_rank_kernel<<<(unsigned)((W + per_block - 1) / per_block),
                        ORDER_RANK_THREADS, 0, s>>>(
        keys, dom, (int*)members, sorted_dom, (int*)order, (int)W);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  order_offsets_kernel<<<(unsigned)((D + 1 + 255) / 256), 256, 0, s>>>(
      sorted_dom, (int*)offsets, (int)W, (int)D);
  return (int)cudaGetLastError();
}

// The card's least costs for the latency bounds and the launch floor:
// mode 0, an empty kernel (the floor); mode 1, one load and one store;
// mode 2, one block of ORDER_THREADS timing `iters` dependent steps of a
// shared load and a __syncthreads (out[0], cycles).
__global__ void kq_empty_kernel() {}

__global__ void kq_load_store_kernel(const int* __restrict__ a,
                                     int* __restrict__ b) {
  if (threadIdx.x == 0) b[0] = a[0] + 1;
}

__global__ void kq_step_kernel(long long* out, int iters) {
  __shared__ int ring[ORDER_THREADS];
  ring[threadIdx.x] = (threadIdx.x + 1) % ORDER_THREADS;
  __syncthreads();
  int v = threadIdx.x;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    v = ring[v];
    __syncthreads();
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = v;
  }
}

extern "C" int order_tick_launch(void* out, const void* src, long long mode,
                                 long long iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 0)
    kq_empty_kernel<<<1, 32, 0, s>>>();
  else if (mode == 1)
    kq_load_store_kernel<<<1, 32, 0, s>>>((const int*)src, (int*)out);
  else
    kq_step_kernel<<<1, ORDER_THREADS, 0, s>>>((long long*)out, (int)iters);
  return (int)cudaGetLastError();
}
