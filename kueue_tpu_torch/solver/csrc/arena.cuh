// The encode arena twin's row copies, shared by arena_scatter.cu (K7a)
// and arena_gather.cu (K7b): the seven fields' rows (solver/arena.py
// ARENA_FIELDS; bools are bytes) as vectors, one copy kernel for both
// index rules, and the launch over its vector widths.
//
// Bound on the H100: latency. A row is a few hundred bytes (217 at the
// north star's P=4, F=32, R=2), so the launch and the dependent round
// trips are the time. A warp a row, 8 rows a block. Every lane loads the
// row's slot (one transaction), then its share of every field's vectors,
// all loads before any store and with no branch between them (the vector
// widths are template arguments), so a row costs two round trips. Each
// field moves in the widest vector it has an instance for (16, 8, 4 or 1
// bytes) that divides its row bytes and the alignment of its source and
// destination (chosen on the host: kernel.arena_copy_plan), a lane a
// vector, 32 vectors a pass; a row of more passes takes up to 8 warps, a
// pass each, so its passes' round trips overlap.
#pragma once
#include "common.cuh"

#define KQ_ARENA_FIELDS 7

// A field's rows as vectors: n a row.
struct KqArenaVecRows {
  const unsigned char* src[KQ_ARENA_FIELDS];
  unsigned char* dst[KQ_ARENA_FIELDS];
  int n[KQ_ARENA_FIELDS];
  int passes;         // ceil(max n / 32)
  int warps_per_row;  // 1, 2, 4 or 8: min(passes, 8) rounded up
};

// A vector of 2^LG bytes.
template <int LG> struct KqVec;
template <> struct KqVec<0> { typedef unsigned char T; };
template <> struct KqVec<2> { typedef unsigned T; };
template <> struct KqVec<3> { typedef uint2 T; };
template <> struct KqVec<4> { typedef uint4 T; };

// Vector v of row `row` of a field of n vectors a row, or zeros when `on`
// is false. Plain pointers: the same copy through __restrict__ ones read
// up to 1.12x slower on the H100 (the loads come first in any case: every
// store takes a loaded value).
template <int LG>
__device__ __forceinline__ typename KqVec<LG>::T kq_get(
    const unsigned char* src, int n, int row, int v, bool on) {
  typedef typename KqVec<LG>::T T;
  return on ? ((const T*)src)[(size_t)row * n + v] : T();
}

template <int LG>
__device__ __forceinline__ void kq_put(unsigned char* dst, int n, int row,
                                       int v, typename KqVec<LG>::T x) {
  if (v < n) ((typename KqVec<LG>::T*)dst)[(size_t)row * n + v] = x;
}

// Row i of the launch. SCATTER (K7a, kueue_tpu/solver/kernel.py:863,
// `.at[upd_slots].set(mode="drop")`): source row i into the twin's row
// slots[i], a slot in [-cap, 0) wrapped to cap + slot, any other slot
// outside [0, cap) dropped before a field is loaded. Gather (K7b, :892):
// the twin's row min(slots[i], cap - 1) into batch row i; a slot < 0
// gives zeros (False for the bool fields) without a load.
//
// The fields' vector widths are template arguments: requests 2^RQ bytes
// (8 or 16), podset_active 2^PA and eligible 2^EL (1, 4 or 16); wl_cq 4,
// priority and timestamp 8 and solvable 1 always (their dtypes' sizes, the
// whole row).
template <bool SCATTER, int RQ, int PA, int EL>
__device__ __forceinline__ void kq_arena_copy_row(
    const int* __restrict__ slots, const KqArenaVecRows rows, int count,
    int cap) {
  const int wr = rows.warps_per_row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * (8 / wr) + warp / wr;
  if (i >= count) return;
  const int slot = slots[i];
  int from, to;
  bool on;
  if (SCATTER) {
    const int s = slot < 0 ? slot + cap : slot;
    if (s < 0 || s >= cap) return;
    from = i, to = s, on = true;
  } else {
    on = slot >= 0 && cap > 0;
    from = slot < cap ? slot : cap - 1, to = i;
  }
  for (int pass = warp % wr; pass < rows.passes; pass += wr) {
    const int v = pass * 32 + lane;
#define KQ_GET(LG, k) \
  kq_get<LG>(rows.src[k], rows.n[k], from, v, on && v < rows.n[k])
    const auto rq = KQ_GET(RQ, 0);
    const auto pa = KQ_GET(PA, 1);
    const auto wq = KQ_GET(2, 2);
    const auto pr = KQ_GET(3, 3);
    const auto ts = KQ_GET(3, 4);
    const auto el = KQ_GET(EL, 5);
    const auto sv = KQ_GET(0, 6);
#undef KQ_GET
    kq_put<RQ>(rows.dst[0], rows.n[0], to, v, rq);
    kq_put<PA>(rows.dst[1], rows.n[1], to, v, pa);
    kq_put<2>(rows.dst[2], rows.n[2], to, v, wq);
    kq_put<3>(rows.dst[3], rows.n[3], to, v, pr);
    kq_put<3>(rows.dst[4], rows.n[4], to, v, ts);
    kq_put<EL>(rows.dst[5], rows.n[5], to, v, el);
    kq_put<0>(rows.dst[6], rows.n[6], to, v, sv);
  }
}

// The two kernels, named for their files (the profiler's records).
template <int RQ, int PA, int EL>
__global__ void __launch_bounds__(256) arena_scatter_kernel(
    const int* __restrict__ slots, const KqArenaVecRows rows, int count,
    int cap) {
  kq_arena_copy_row<true, RQ, PA, EL>(slots, rows, count, cap);
}

template <int RQ, int PA, int EL>
__global__ void __launch_bounds__(256) arena_gather_kernel(
    const int* __restrict__ slots, const KqArenaVecRows rows, int count,
    int cap) {
  kq_arena_copy_row<false, RQ, PA, EL>(slots, rows, count, cap);
}

template <bool SCATTER, int RQ, int PA, int EL>
static void kq_arena_copy(const int* slots, const KqArenaVecRows& rows,
                          int count, int cap, cudaStream_t s) {
  const int per_block = 8 / rows.warps_per_row;
  const unsigned blocks = (unsigned)((count + per_block - 1) / per_block);
  if constexpr (SCATTER)
    arena_scatter_kernel<RQ, PA, EL><<<blocks, 256, 0, s>>>(slots, rows,
                                                             count, cap);
  else
    arena_gather_kernel<RQ, PA, EL><<<blocks, 256, 0, s>>>(slots, rows,
                                                            count, cap);
}

template <bool SCATTER, int RQ, int PA>
static void kq_arena_copy_el(int el, const int* slots,
                             const KqArenaVecRows& rows, int count, int cap,
                             cudaStream_t s) {
  if (el == 4)
    kq_arena_copy<SCATTER, RQ, PA, 4>(slots, rows, count, cap, s);
  else if (el == 2)
    kq_arena_copy<SCATTER, RQ, PA, 2>(slots, rows, count, cap, s);
  else
    kq_arena_copy<SCATTER, RQ, PA, 0>(slots, rows, count, cap, s);
}

template <bool SCATTER, int RQ>
static void kq_arena_copy_pa(int pa, int el, const int* slots,
                             const KqArenaVecRows& rows, int count, int cap,
                             cudaStream_t s) {
  if (pa == 4)
    kq_arena_copy_el<SCATTER, RQ, 4>(el, slots, rows, count, cap, s);
  else if (pa == 2)
    kq_arena_copy_el<SCATTER, RQ, 2>(el, slots, rows, count, cap, s);
  else
    kq_arena_copy_el<SCATTER, RQ, 0>(el, slots, rows, count, cap, s);
}

// The launchers' body: src, dst, rb (row bytes) and lg (each field's
// vector width, log2: requests 3 or 4, podset_active and eligible 0, 2
// or 4, wl_cq 2, priority and timestamp 3, solvable 0) in ARENA_FIELDS
// order; `count` rows.
template <bool SCATTER>
static int kq_arena_launch(const void* slots, const void* const* src,
                           void* const* dst, const long long* rb,
                           const long long* lg, long long count,
                           long long cap, void* stream) {
  const auto bool_lg = [](long long x) { return x == 0 || x == 2 || x == 4; };
  if ((lg[0] != 3 && lg[0] != 4) || !bool_lg(lg[1]) || lg[2] != 2 ||
      lg[3] != 3 || lg[4] != 3 || !bool_lg(lg[5]) || lg[6] != 0)
    return (int)cudaErrorInvalidValue;
  KqArenaVecRows rows;
  int most = 0;
  for (int k = 0; k < KQ_ARENA_FIELDS; ++k) {
    rows.src[k] = (const unsigned char*)src[k];
    rows.dst[k] = (unsigned char*)dst[k];
    rows.n[k] = (int)(rb[k] >> lg[k]);
    most = rows.n[k] > most ? rows.n[k] : most;
  }
  rows.passes = (most + 31) / 32;
  rows.warps_per_row = 1;
  while (rows.warps_per_row < rows.passes && rows.warps_per_row < 8)
    rows.warps_per_row <<= 1;
  if (count > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (lg[0] == 4)
      kq_arena_copy_pa<SCATTER, 4>((int)lg[1], (int)lg[5], (const int*)slots,
                                   rows, (int)count, (int)cap, s);
    else
      kq_arena_copy_pa<SCATTER, 3>((int)lg[1], (int)lg[5], (const int*)slots,
                                   rows, (int)count, (int)cap, s);
  }
  return (int)cudaGetLastError();
}
