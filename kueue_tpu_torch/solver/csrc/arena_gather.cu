// arena_gather: this cycle's heads' rows out of the encode arena's device
// twin. Replaces kueue_tpu/solver/kernel.py:892 gather_arena_impl: batch
// row w takes the twin's row slots[w] of each of the seven fields; a
// padding slot (-1, or any slot outside [0, cap)) gives a row of zeros
// (False for the bool fields) without reading the twin, bit-identical to
// the host-assembled padded batch.
//
// Bound on the H100: latency. A row is a few hundred bytes (217 at the
// north star's P=4, F=32, R=2), so the launch and the dependent round trips
// are the time. Design: a warp a row, 8 rows a block. Every lane loads the
// row's slot (one transaction), then its share of every field's bytes, all
// loads before any store and with no branch between them (the vector
// widths are template arguments), so a row costs two round trips. Each
// field moves in the widest vector it has an instance for (16, 8, 4 or 1
// bytes) that divides its row bytes and the alignment of its source and
// destination (chosen at launch: kernel.arena_gather_plan), a lane a
// vector, 32 vectors a pass; a row of more passes takes up to 8 warps, a
// pass each, so its passes' round trips overlap.
#include "common.cuh"

// A field's rows as vectors: n a row.
struct KqGatherRows {
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
// is false.
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

// The fields' vector widths are template arguments: requests 2^RQ bytes
// (8 or 16), podset_active 2^PA and eligible 2^EL (1, 4 or 16); wl_cq 4,
// priority and timestamp 8 and solvable 1 always (their dtypes' sizes, the
// whole row). So a row's loads are plain loads with no branch between
// them.
template <int RQ, int PA, int EL>
__global__ void __launch_bounds__(256) arena_gather_kernel(
    const int* __restrict__ slots, const KqGatherRows rows, int W, int cap) {
  const int wr = rows.warps_per_row;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = blockIdx.x * (8 / wr) + warp / wr;
  if (w >= W) return;
  const int slot = slots[w];
  const bool valid = slot >= 0 && slot < cap;
  for (int pass = warp % wr; pass < rows.passes; pass += wr) {
    const int v = pass * 32 + lane;
#define KQ_GET(LG, k) \
  kq_get<LG>(rows.src[k], rows.n[k], slot, v, valid && v < rows.n[k])
    const auto rq = KQ_GET(RQ, 0);
    const auto pa = KQ_GET(PA, 1);
    const auto wq = KQ_GET(2, 2);
    const auto pr = KQ_GET(3, 3);
    const auto ts = KQ_GET(3, 4);
    const auto el = KQ_GET(EL, 5);
    const auto sv = KQ_GET(0, 6);
#undef KQ_GET
    kq_put<RQ>(rows.dst[0], rows.n[0], w, v, rq);
    kq_put<PA>(rows.dst[1], rows.n[1], w, v, pa);
    kq_put<2>(rows.dst[2], rows.n[2], w, v, wq);
    kq_put<3>(rows.dst[3], rows.n[3], w, v, pr);
    kq_put<3>(rows.dst[4], rows.n[4], w, v, ts);
    kq_put<EL>(rows.dst[5], rows.n[5], w, v, el);
    kq_put<0>(rows.dst[6], rows.n[6], w, v, sv);
  }
}

template <int RQ, int PA, int EL>
static void kq_gather(const int* slots, const KqGatherRows& rows, int W,
                      int cap, cudaStream_t s) {
  const int per_block = 8 / rows.warps_per_row;
  arena_gather_kernel<RQ, PA, EL>
      <<<(unsigned)((W + per_block - 1) / per_block), 256, 0, s>>>(
          slots, rows, W, cap);
}

template <int RQ, int PA>
static void kq_gather_el(int el, const int* slots, const KqGatherRows& rows,
                         int W, int cap, cudaStream_t s) {
  if (el == 4)
    kq_gather<RQ, PA, 4>(slots, rows, W, cap, s);
  else if (el == 2)
    kq_gather<RQ, PA, 2>(slots, rows, W, cap, s);
  else
    kq_gather<RQ, PA, 0>(slots, rows, W, cap, s);
}

template <int RQ>
static void kq_gather_pa(int pa, int el, const int* slots,
                         const KqGatherRows& rows, int W, int cap,
                         cudaStream_t s) {
  if (pa == 4)
    kq_gather_el<RQ, 4>(el, slots, rows, W, cap, s);
  else if (pa == 2)
    kq_gather_el<RQ, 2>(el, slots, rows, W, cap, s);
  else
    kq_gather_el<RQ, 0>(el, slots, rows, W, cap, s);
}

// lg0..lg6: each field's vector width, log2 (kernel.arena_gather_plan):
// requests 3 or 4, podset_active and eligible 0, 2 or 4, wl_cq 2, priority
// and timestamp 3, solvable 0.
extern "C" int arena_gather_launch(
    const void* slots, const void* src0, const void* src1, const void* src2,
    const void* src3, const void* src4, const void* src5, const void* src6,
    void* dst0, void* dst1, void* dst2, void* dst3, void* dst4, void* dst5,
    void* dst6, long long W, long long cap, long long rb0, long long rb1,
    long long rb2, long long rb3, long long rb4, long long rb5, long long rb6,
    long long lg0, long long lg1, long long lg2, long long lg3, long long lg4,
    long long lg5, long long lg6, void* stream) {
  const void* src[KQ_ARENA_FIELDS] = {src0, src1, src2, src3, src4, src5, src6};
  void* dst[KQ_ARENA_FIELDS] = {dst0, dst1, dst2, dst3, dst4, dst5, dst6};
  const long long rb[KQ_ARENA_FIELDS] = {rb0, rb1, rb2, rb3, rb4, rb5, rb6};
  const long long lg[KQ_ARENA_FIELDS] = {lg0, lg1, lg2, lg3, lg4, lg5, lg6};
  const auto bool_lg = [](long long x) { return x == 0 || x == 2 || x == 4; };
  if ((lg0 != 3 && lg0 != 4) || !bool_lg(lg1) || lg2 != 2 || lg3 != 3 ||
      lg4 != 3 || !bool_lg(lg5) || lg6 != 0)
    return (int)cudaErrorInvalidValue;
  KqGatherRows rows;
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
  if (W > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (lg0 == 4)
      kq_gather_pa<4>((int)lg1, (int)lg5, (const int*)slots, rows, (int)W,
                      (int)cap, s);
    else
      kq_gather_pa<3>((int)lg1, (int)lg5, (const int*)slots, rows, (int)W,
                      (int)cap, s);
  }
  return (int)cudaGetLastError();
}
