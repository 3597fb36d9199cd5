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
// Bound on the H100: latency. The bytes (the heads' [F,R] rows and their
// CQs' nominal, offered and usage rows, ~2.5 MB at the north star) take
// under a microsecond; a head's chain is three dependent global round
// trips (its CQ; the CQ's rows and root cohort, cq_root, a table derived
// at topology upload; the root's lendable row), a few shuffles and two
// 64-bit floor divisions.
// Design: a group of G lanes a head, 32/G heads a warp, G the least power
// of two >= R whose lanes load the head's row in one chunk of
// KQ_DRF_CHUNK passes (at most 32; kernel.py drf_share_plan): F*R = 2
// (the fair cell) puts 16 heads on a warp, F*R = 64 (the north star) 2
// heads and 4 elements on each lane. Lane i of a group takes elements i,
// i+m, i+2m, ... of the head's contiguous [F,R] row, m = R * (G/R)
// (R <= G), so its resource is fixed (i % R). Every load of a chunk of
// passes is issued before any arithmetic and none is predicated (a lane
// past the row reads element 0 and drops it; offered is a select, not a
// skip): predicated loads let the compiler consume the first before it
// issued the rest, a round trip more. A shuffle tree at offsets R, 2R,
// 4R, ... sums each resource's borrowing into lanes 0..R-1. Past 32
// resources each lane owns resources i, i+32, ... and walks their
// flavors. Both divisions go through double precision when
// the operands are below 2^53 (the correctly rounded quotient floors to
// the exact one or one above it, which a multiply-back corrects) and
// through the int64 division otherwise, so every int64 input is exact.
// All other arithmetic is int64.
#include <climits>

#include "common.cuh"

#define KQ_DRF_THREADS 128
#define KQ_DRF_CHUNK 4  // passes a lane loads before it adds

// floor(a / b) for b > 0, exact for every int64 a and b. A zero a (a
// head that borrows nothing in the resource) skips the division.
__device__ __forceinline__ long long kq_floordiv_pos(long long a,
                                                     long long b) {
  if (a == 0) return 0;
  const long long lim = 1LL << 53;
  if (a > -lim && a < lim && b < lim) {
    long long q = (long long)floor((double)a / (double)b);
    if (q * b > a) --q;
    return q;
  }
  return kq_floordiv(a, b);
}

// x * 1000 with int64 wrap-around, as JAX and torch compute it.
__device__ __forceinline__ long long kq_mul1000(long long x) {
  return (long long)((unsigned long long)x * 1000ULL);
}

struct KqDrfArgs {
  const long long* nominal;          // [Q,F,R]
  const unsigned char* offered;      // [Q,F,R]
  const int* cq_root;                // [Q] the CQ's root cohort, -1: none
  const long long* cohort_lendable;  // [C,R]
  const long long* fair_weight;      // [Q]
  const long long* usage;            // [Q,F,R]
  const long long* asg;              // [W,F,R]
  const int* wl_cq;                  // [W]
  long long* share;                  // [W]
  int W, F, R, G, P;  // P: a lane's passes over the row (R <= G)
};

// CH passes of a lane: elements e0, e0 + m, ... below `end`. Every load
// is issued before any arithmetic and none is predicated: a lane past
// the row reads element 0 and drops it.
template <int CH>
__device__ __forceinline__ long long kq_drf_chunk(const KqDrfArgs& a,
                                                  size_t woff, size_t qoff,
                                                  int e0, int m, int end,
                                                  bool on) {
  long long av[CH], nv[CH], uv[CH];
  bool in[CH], ov[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int e = e0 + j * m;
    in[j] = on && e < end;
    const int c = in[j] ? e : 0;
    av[j] = a.asg[woff + c];
    nv[j] = a.nominal[qoff + c];
    uv[j] = a.usage[qoff + c];
    ov[j] = a.offered[qoff + c];
  }
  long long part = 0;
#pragma unroll
  for (int j = 0; j < CH; ++j)
    part += (in[j] && ov[j]) ? kq_max0(av[j] - (nv[j] - uv[j])) : 0;
  return part;
}

__global__ void __launch_bounds__(KQ_DRF_THREADS)
drf_share_kernel(const KqDrfArgs a) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31, G = a.G, sub = lane & (G - 1);
  const int gs = __ffs(G) - 1;  // G is a power of two: shifts
  const int warp = blockIdx.x * (KQ_DRF_THREADS / 32) + (threadIdx.x >> 5);
  if ((long long)warp << (5 - gs) >= a.W) return;  // uniform per warp
  const int w = (warp << (5 - gs)) + (lane >> gs);
  const bool head = w < a.W;
  const int F = a.F, R = a.R, FR = F * R;
  const size_t woff = (size_t)(head ? w : 0) * FR;
  const int q = head ? a.wl_cq[w] : 0;
  const size_t qoff = (size_t)q * FR;
  // the head's CQ keys its root, weight and rows: one round trip
  const int root = head ? a.cq_root[q] : -1;
  const long long weight = a.fair_weight[q];
  long long drs;
  bool borrows;
  if (R <= G) {
    // per = G / R lanes a resource, lane sub = j * R + r: quotients of
    // numbers below 64 by R, exact through a float reciprocal
    const float rcp = __fdividef(1.0f, (float)R);
    const int per = (int)((G + 0.5f) * rcp), m = per * R;
    const int j = (int)((sub + 0.5f) * rcp), r = sub - j * R;
    const bool on = head && sub < m;
    long long part;
    switch (a.P < KQ_DRF_CHUNK ? a.P : KQ_DRF_CHUNK) {  // uniform
      case 1: part = kq_drf_chunk<1>(a, woff, qoff, sub, m, FR, on); break;
      case 2: part = kq_drf_chunk<2>(a, woff, qoff, sub, m, FR, on); break;
      case 3: part = kq_drf_chunk<3>(a, woff, qoff, sub, m, FR, on); break;
      default:
        part = kq_drf_chunk<KQ_DRF_CHUNK>(a, woff, qoff, sub, m, FR, on);
    }
    const long long lend = (root >= 0 && sub < R)
        ? a.cohort_lendable[(size_t)root * R + r] : 0;
    for (int k = KQ_DRF_CHUNK; k < a.P; k += KQ_DRF_CHUNK)
      part += kq_drf_chunk<KQ_DRF_CHUNK>(a, woff, qoff, sub + k * m, m, FR,
                                         on);
    // each resource's lanes sub, sub+R, ... into lane sub (< R)
    for (int t = 1; t < per; t <<= 1) {
      const long long v = __shfl_down_sync(FULL, part, t * R, G);
      if (j + t < per) part += v;
    }
    const bool lead = sub < R;
    const unsigned group =
        G == 32 ? FULL : ((1u << G) - 1) << (lane & ~(G - 1));
    borrows = (__ballot_sync(FULL, on && lead && part > 0) & group) != 0;
    drs = lend > 0 ? kq_floordiv_pos(kq_mul1000(part), lend) : -1;
    for (int o = 1; o < R; o <<= 1) {
      const long long v = __shfl_down_sync(FULL, drs, o, G);
      if (sub + o < R && v > drs) drs = v;
    }
  } else {
    // G = 32: lane `sub` owns resources sub, sub + 32, ...
    drs = LLONG_MIN;
    bool any = false;
    for (int r = sub; r < R; r += 32) {
      long long part = 0;
      for (int f0 = 0; f0 < F; f0 += KQ_DRF_CHUNK)
        part += kq_drf_chunk<KQ_DRF_CHUNK>(a, woff, qoff, f0 * R + r, R, FR,
                                           head);
      any |= part > 0;
      const long long lend =
          root >= 0 ? a.cohort_lendable[(size_t)root * R + r] : 0;
      const long long ratio =
          lend > 0 ? kq_floordiv_pos(kq_mul1000(part), lend) : -1;
      if (ratio > drs) drs = ratio;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const long long v = __shfl_xor_sync(FULL, drs, o);
      if (v > drs) drs = v;
    }
    borrows = __any_sync(FULL, any);
  }
  if (!head || sub != 0) return;
  const long long dws =
      weight > 0 ? kq_floordiv_pos(kq_mul1000(drs), weight) : KQ_NO_LIMIT;
  a.share[w] = (borrows && root >= 0) ? dws : 0;
}

// The latency bound's steps, one warp: out[0] the cycles of `iters`
// dependent floor divisions by `divisor` (the double-precision path),
// out[1] of `iters` dependent shuffle-adds, out[2] a sink.
__global__ void drf_share_tick_kernel(long long* out, int iters,
                                      long long divisor) {
  long long v = 123456789 + threadIdx.x;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) v = kq_floordiv_pos(v * 1000 + 7, divisor);
  const long long t1 = clock64();
  long long s = v;
  for (int i = 0; i < iters; ++i) s += __shfl_down_sync(0xffffffffu, s, 1);
  const long long t2 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = t2 - t1;
    out[2] = s;
  }
}

extern "C" int drf_share_launch(const void* nominal, const void* offered,
                                const void* cq_root,
                                const void* cohort_lendable,
                                const void* fair_weight, const void* usage,
                                const void* asg, const void* wl_cq,
                                void* share, long long W, long long F,
                                long long R, long long G, long long P,
                                void* stream) {
  if (W <= 0) return 0;
  const KqDrfArgs a = {
      (const long long*)nominal, (const unsigned char*)offered,
      (const int*)cq_root, (const long long*)cohort_lendable,
      (const long long*)fair_weight, (const long long*)usage,
      (const long long*)asg, (const int*)wl_cq, (long long*)share, (int)W,
      (int)F, (int)R, (int)G, (int)P};
  const long long heads = (KQ_DRF_THREADS / 32) * (32 / G);
  drf_share_kernel<<<(unsigned)((W + heads - 1) / heads), KQ_DRF_THREADS, 0,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int drf_share_tick_launch(void* out, long long iters,
                                     long long divisor, void* stream) {
  drf_share_tick_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (long long*)out, (int)iters, divisor);
  return (int)cudaGetLastError();
}
