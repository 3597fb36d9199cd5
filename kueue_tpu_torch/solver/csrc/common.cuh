// Shared device helpers of the admission-solve kernels. Quantities are
// int64 throughout (memory is in bytes); nothing goes through float.
#pragma once
#include <cuda_runtime.h>

#define KQ_NO_LIMIT (1LL << 62)
#define KQ_INF_RANK 1000000

__device__ __forceinline__ long long kq_max0(long long v) { return v > 0 ? v : 0; }

// floor(a / b) for int64, b != 0: JAX's //, where C's / truncates toward
// zero (-1000 // 3000 is -1, -1000 / 3000 is 0).
__device__ __forceinline__ long long kq_floordiv(long long a, long long b) {
  const long long q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

// One level of the availability walk (reference: resource_node.go:89-104;
// kueue_tpu/solver/kernel.py:39 _avail_level): the guaranteed remainder
// plus the parent's availability, capped by the borrow limit.
__device__ __forceinline__ long long kq_avail_level(
    long long quota, long long guaranteed, long long borrow_limit,
    long long usage, long long parent_avail) {
  long long bl = borrow_limit < KQ_NO_LIMIT / 4 ? borrow_limit : KQ_NO_LIMIT / 4;
  long long cap = (quota - guaranteed) - kq_max0(usage - guaranteed) + bl;
  return kq_max0(guaranteed - usage) + (parent_avail < cap ? parent_avail : cap);
}

// Availability of CQ q at element e = f*R + r, walking cq_chain[q] from
// its root end (first valid entry from the end) down to the direct
// cohort, then the CQ's own level. cq_chain rows are -1 padded past the
// root. FR = F*R.
__device__ __forceinline__ long long kq_cq_avail(
    int q, int e, int FR, int DC,
    const int* __restrict__ cq_cohort, const int* __restrict__ cq_chain,
    const long long* __restrict__ nominal,
    const long long* __restrict__ guaranteed,
    const long long* __restrict__ borrow_limit, const long long* usage,
    const long long* __restrict__ cohort_subtree,
    const long long* __restrict__ cohort_guaranteed,
    const long long* __restrict__ cohort_borrow_limit,
    const long long* cohort_usage) {
  size_t qe = (size_t)q * FR + e;
  if (cq_cohort[q] < 0) return nominal[qe] - usage[qe];
  long long a = 0;
  bool started = false;
  for (int d = DC - 1; d >= 0; --d) {
    int c = cq_chain[(size_t)q * DC + d];
    if (c < 0) continue;
    size_t ce = (size_t)c * FR + e;
    long long sub = cohort_subtree[ce], cu = cohort_usage[ce];
    a = started ? kq_avail_level(sub, cohort_guaranteed[ce],
                                 cohort_borrow_limit[ce], cu, a)
                : sub - cu;
    started = true;
  }
  return kq_avail_level(nominal[qe], guaranteed[qe], borrow_limit[qe],
                        usage[qe], a);
}

// The encode arena's seven row fields (kueue_tpu_torch/solver/arena.py
// ARENA_FIELDS), as byte rows: a copy loop over bytes serves every dtype
// (bools are bytes).
#define KQ_ARENA_FIELDS 7

struct KqArenaRows {
  const unsigned char* src[KQ_ARENA_FIELDS];
  unsigned char* dst[KQ_ARENA_FIELDS];
  long long row_bytes[KQ_ARENA_FIELDS];
};

// Fill a KqArenaRows from the launchers' flat argument lists.
inline KqArenaRows kq_arena_rows(const void* const* src, void* const* dst,
                                 const long long* row_bytes) {
  KqArenaRows rows;
  for (int k = 0; k < KQ_ARENA_FIELDS; ++k) {
    rows.src[k] = (const unsigned char*)src[k];
    rows.dst[k] = (unsigned char*)dst[k];
    rows.row_bytes[k] = row_bytes[k];
  }
  return rows;
}
