// cluster_cols: MultiKueue placement, scored in the cycle's admit order.
// Replaces kueue_tpu/solver/kernel.py:614 score_cluster_columns_impl; the
// plain version is kernel.score_cluster_columns_plain.
// Remote worker clusters are K capacity columns [K,F,R]: for each row of
// the global admit order that was admitted and whose CQ carries a
// MultiKueue check, the first active cluster k with a flavor f whose
// remaining column covers every requested resource (and offers at least
// one of them) takes the row; the first such f within k is debited by the
// row's total request for later rows. Rows not placed get -1.
//
// Bound on the H100: latency. The bytes are a few KB; every row that takes
// part reads the capacity the rows before it left. The scan places a row
// on the lowest column index c = k*F + f (active cluster, offered in
// every requested resource) whose remaining amount covers the row's total
// request: argmax over k, then over f, as the JAX scan takes it. Column c
// sees the rows in admit order and takes a row only if no lower column
// took it first, so the scan is a pipeline, exact for any sign of the
// requests: column c is a stage holding its own remaining amounts, the
// rows flow through the stages in ascending c, and a stage takes a row
// that reaches it untaken and fits, debiting only itself. Row i reaches
// stage c after rows < i have passed c and after row i has passed every
// stage < c. Where the sequential scan is N long steps (N rows) of a fit
// test over all K*F columns, the pipeline moving one row a tick is a
// chain of N + S short ticks (S stages); moving chunks of 32 rows, as
// below, it is about S + N/32 chunk steps plus the takes.
//
// Design, one block:
//  1. Prologue (the whole block). The live columns (an active cluster's
//     (k, f) offering some resource), compacted in ascending c by a block
//     scan: the stages, with their remaining amounts stage-major and
//     their cluster k. Each order position's row is tested (admitted, of
//     a MultiKueue CQ, some resource requested in total); the others get
//     -1 in parallel, and the rows that take part are compacted in admit
//     order, with their total request (the sum over active podsets,
//     resource-major), by a block scan. A resource a column does not
//     offer gets a remaining amount of -2^62, which no positive request
//     fits (a row's debit on it is its own request there, <= 0), so the
//     fit test is one compare a requested resource.
//  2. Stage pipeline, in chunks of 32 rows. G warps, warp w owning a run
//     of consecutive stages (CC_WARP_STAGES each, more when the block's
//     warps run out). A warp takes the
//     chunks in admit order, lane l holding row 32k + l of chunk k and
//     its request. For each of its stages in ascending c it tests every
//     row of the chunk still untaken at once, one ballot; while some fit,
//     the first (the lowest lane: the earliest in admit order) is taken:
//     its request is broadcast with shuffles, the stage is debited, the
//     row's cluster written, and the later rows are tested again against
//     what is left. Then the chunk's untaken mask goes to the next warp:
//     one 64-bit word a chunk in the arena, the mask and the writing
//     warp's tag in one store (the data is the flag: no fence); the next
//     warp waits on the word only when it catches up. The last warp
//     writes -1 for the rows left untaken.
//  Two forms: with R <= 16 the rows' requests and the stage in hand live
//  in registers, R padded to RT = 1, 2, 4, 8 or 16 (a template parameter;
//  the padding resources are requested by no row, so every stage fits
//  them); otherwise (any R) they are read from the arena. RT = 16 runs 16
//  warps, so that its 64 registers of request and stage fit a thread. The
//  arena (stages, rows, requests, hand-off words; its resource stride is
//  RT in the register form) is in dynamic shared memory when it fits a
//  block, else in a slice of global scratch, as cluster_cols_plan
//  chooses. stats = (N, S, G, stages a warp at most).
#include <climits>

#include "common.cuh"

#define CC_FULL 0xffffffffu
// one block: up to 32 warps of stages, 16 for RT = 16
#define CC_THREADS(RT) ((RT) >= 16 ? 512 : 1024)
// the stages a warp owns: fewer make a warp's step over a chunk of rows
// shorter and add warps, each a chunk step of the pipeline's length
#define CC_WARP_STAGES 4
#define CC_NO_OFFER (-(1LL << 62))  // the remaining amount of an unoffered resource

// The arena, in bytes from its start.
struct CcLayout {
  long long srem, treq, hand, kcol, clist, rows, bytes;
};

__host__ __device__ inline CcLayout cc_layout(long long W, long long R,
                                              long long KF) {
  CcLayout L;
  long long o = 0;
  L.srem = o; o += KF * R * 8;          // [S][R]: a stage's remaining amounts
  L.treq = o; o += R * W * 8;           // [R][W]: the rows' total requests
  L.hand = o; o += (W + 31) / 32 * 8;   // a chunk's hand-off word
  L.kcol = o; o += KF * 4;              // [S]: a stage's cluster k
  L.clist = o; o += KF * 4;             // the live columns in ascending c
  L.rows = o; o += W * 4;               // the rows that take part, in order
  L.bytes = (o + 15) / 16 * 16;
  return L;
}

// The exclusive count of `flag` over the block's earlier threads, and the
// block's total; every thread calls it.
__device__ __forceinline__ int cc_prefix(bool flag, int* wcnt, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const unsigned b = __ballot_sync(CC_FULL, flag);
  __syncthreads();  // the last call's readers are done with wcnt
  if (lane == 0) wcnt[warp] = __popc(b);
  __syncthreads();
  if (warp == 0) {
    int v = lane < nw ? wcnt[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(CC_FULL, v, o);
      if (lane >= o) v += y;
    }
    if (lane < nw) wcnt[lane] = v;
  }
  __syncthreads();
  *total = wcnt[nw - 1];
  return (warp ? wcnt[warp - 1] : 0) + __popc(b & ((1u << lane) - 1));
}

// row w's total request in resource r: the sum over its active podsets
__device__ __forceinline__ long long cc_treq(
    const long long* __restrict__ requests,
    const unsigned char* __restrict__ podset_active, int w, int P, int R,
    int r) {
  long long s = 0;
  for (int p = 0; p < P; ++p)
    if (podset_active[(size_t)w * P + p])
      s += requests[((size_t)w * P + p) * R + r];
  return s;
}

// Chunk k's rows still untaken when they reach warp `warp`: every row of
// the chunk for warp 0, else the mask warp - 1 handed on (the word's high
// half is the tag of the warp that wrote it, warp for warp - 1).
__device__ __forceinline__ unsigned cc_arrived(
    volatile unsigned long long* hand, int warp, int k, bool valid) {
  if (warp == 0) return __ballot_sync(CC_FULL, valid);
  unsigned long long v;
  while ((v = hand[k]) >> 32 < (unsigned long long)warp) __nanosleep(32);
  return (unsigned)v;
}

__device__ __forceinline__ void cc_pass(volatile unsigned long long* hand,
                                        int* __restrict__ out, int row,
                                        int warp, int G, int k, int lane,
                                        bool valid, unsigned mask) {
  if (warp == G - 1) {
    if (valid && (mask >> lane & 1)) out[row] = -1;
  } else if (lane == 0) {
    hand[k] = (unsigned long long)(warp + 1) << 32 | mask;
  }
}

// The stages [s0, s1) of warp `warp`, chunk by chunk. RT > 0: R = RT, a
// lane's request and the stage in hand in registers; RT == 0: R at run
// time, both read from the arena.
template <int RT>
__device__ void cc_stage_pipeline(long long* srem, const long long* treq,
                                  const int* kcol, const int* rows,
                                  volatile unsigned long long* hand,
                                  int* __restrict__ out, int N, int W,
                                  int R_arg, int G, int s0, int s1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int R = RT > 0 ? RT : R_arg;
  constexpr int QN = RT > 0 ? RT : 1;
  for (int k = 0; k * 32 < N; ++k) {
    const int i = k * 32 + lane;
    const bool valid = i < N;
    const int row = valid ? rows[i] : -1;
    long long q[QN];
#pragma unroll
    for (int r = 0; r < QN; ++r)
      q[r] = RT > 0 && valid ? treq[(size_t)r * W + i] : 0;
    unsigned mask = cc_arrived(hand, warp, k, valid);
    for (int s = s0; s < s1 && mask; ++s) {
      long long* sr = srem + (size_t)s * R;
      long long rem[QN];
#pragma unroll
      for (int r = 0; r < QN; ++r) rem[r] = RT > 0 ? sr[r] : 0;
      const int kc = kcol[s];
      unsigned cand = 0;  // the rows after the last take that fit
      for (unsigned after = 0xffffffffu;;) {
        bool fits = (mask & after) >> lane & 1;
        if (RT > 0) {
#pragma unroll
          for (int r = 0; r < QN; ++r) fits &= q[r] <= 0 || q[r] <= rem[r];
        } else if (fits) {
          for (int r = 0; r < R; ++r) {
            const long long qr = treq[(size_t)r * W + i];
            fits &= qr <= 0 || qr <= sr[r];
          }
        }
        cand = __ballot_sync(CC_FULL, fits);
        if (!cand) break;
        const int j = __ffs(cand) - 1;  // the earliest row that fits
        if (RT > 0) {
#pragma unroll
          for (int r = 0; r < QN; ++r) rem[r] -= __shfl_sync(CC_FULL, q[r], j);
        } else {
          if (lane == j)
            for (int r = 0; r < R; ++r) sr[r] -= treq[(size_t)r * W + i];
          __syncwarp();
        }
        if (lane == j) out[row] = kc;
        mask &= ~(1u << j);
        after = ~((2u << j) - 1);  // the lanes above j
      }
      if (RT > 0) {
        if (lane == 0) {
#pragma unroll
          for (int r = 0; r < QN; ++r) sr[r] = rem[r];
        }
        __syncwarp();
      }
    }
    cc_pass(hand, out, row, warp, G, k, lane, valid, mask);
  }
}

template <int RT>
__global__ void __launch_bounds__(CC_THREADS(RT))
cluster_cols_kernel(
    const long long* __restrict__ ccap, const unsigned char* __restrict__ coffer,
    const unsigned char* __restrict__ cactive,
    const unsigned char* __restrict__ mk_cq,
    const long long* __restrict__ requests,
    const unsigned char* __restrict__ podset_active,
    const int* __restrict__ wl_cq, const int* __restrict__ order,
    const unsigned char* __restrict__ admitted, int* __restrict__ out,
    unsigned char* scratch, int in_smem, int* __restrict__ stats, int W,
    int P, int R, int K, int F) {
  extern __shared__ __align__(16) unsigned char cc_dyn[];
  __shared__ int wcnt[32];
  const int RA = RT > 0 ? RT : R;  // the arena's resource stride
  const int T = blockDim.x, tid = threadIdx.x, warp = tid >> 5;
  const int KF = K * F;
  const CcLayout Lo = cc_layout(W, RA, KF);
  unsigned char* base = in_smem ? cc_dyn : scratch;
  long long* srem = (long long*)(base + Lo.srem);
  long long* treq = (long long*)(base + Lo.treq);
  volatile unsigned long long* hand =
      (volatile unsigned long long*)(base + Lo.hand);
  int* kcol = (int*)(base + Lo.kcol);
  int* clist = (int*)(base + Lo.clist);
  int* rows = (int*)(base + Lo.rows);

  // 1a. the stages: the live columns in ascending c
  int S = 0;
  for (int c0 = 0; c0 < KF; c0 += T) {
    const int c = c0 + tid;
    bool live = false;
    if (c < KF && cactive[c / F])
      for (int r = 0; r < R; ++r) live |= coffer[(size_t)c * R + r] != 0;
    int n;
    const int j = cc_prefix(live, wcnt, &n);
    if (live) clist[S + j] = c;
    S += n;
  }
  __syncthreads();  // clist complete
  for (int s = tid; s < S; s += T) {
    const int c = clist[s];
    kcol[s] = c / F;
    for (int r = 0; r < RA; ++r) {
      const size_t cr = (size_t)c * R + r;
      srem[(size_t)s * RA + r] =
          r >= R ? 0 : coffer[cr] ? ccap[cr] : CC_NO_OFFER;
    }
  }
  for (int x = tid; x < (W + 31) / 32; x += T) hand[x] = 0;
  // 1b. the rows that take part, in admit order, with their total request
  constexpr int QN = RT > 0 ? RT : 1;
  int N = 0;
  for (int p0 = 0; p0 < W; p0 += T) {
    const int pos = p0 + tid;
    int w = -1;
    bool keep = false;
    long long s[QN];
#pragma unroll
    for (int r = 0; r < QN; ++r) s[r] = 0;
    if (pos < W) {
      w = order[pos];
      if (admitted[w] && mk_cq[wl_cq[w]]) {
        if (RT > 0) {
          for (int p = 0; p < P; ++p) {
            if (!podset_active[(size_t)w * P + p]) continue;
#pragma unroll
            for (int r = 0; r < QN; ++r)
              if (r < R) s[r] += requests[((size_t)w * P + p) * R + r];
          }
#pragma unroll
          for (int r = 0; r < QN; ++r) keep |= s[r] > 0;
        } else {
          for (int r = 0; r < R && !keep; ++r)
            keep = cc_treq(requests, podset_active, w, P, R, r) > 0;
        }
      }
      if (!keep) out[w] = -1;
    }
    int n;
    const int j = cc_prefix(keep, wcnt, &n);
    if (keep) {
      rows[N + j] = w;
      for (int r = 0; r < RA; ++r)
        treq[(size_t)r * W + N + j] =
            RT > 0 ? s[r < QN ? r : 0]
                   : cc_treq(requests, podset_active, w, P, R, r);
    }
    N += n;
  }
  // 2. G warps of CC_WARP_STAGES consecutive stages each
  int G = (S + CC_WARP_STAGES - 1) / CC_WARP_STAGES;
  G = G < 1 ? 1 : (G > (T >> 5) ? (T >> 5) : G);
  if (tid == 0) {
    stats[0] = N;
    stats[1] = S;
    stats[2] = G;
    stats[3] = (S + G - 1) / G;
  }
  __syncthreads();
  if (warp >= G || N == 0) return;
  const int s0 = (int)((long long)S * warp / G);
  const int s1 = (int)((long long)S * (warp + 1) / G);
  cc_stage_pipeline<RT>(srem, treq, kcol, rows, hand, out, N, W, RA, G, s0,
                        s1);
}

typedef decltype(&cluster_cols_kernel<0>) CcKernel;

// the register form's RT for R resources, 0 for the arena form
static int cc_register_r(long long R) {
  if (R < 1 || R > 16) return 0;
  int rt = 1;
  while (rt < R) rt <<= 1;
  return rt;
}

static CcKernel cc_kernel(int rt) {
  switch (rt) {
    case 1: return cluster_cols_kernel<1>;
    case 2: return cluster_cols_kernel<2>;
    case 4: return cluster_cols_kernel<4>;
    case 8: return cluster_cols_kernel<8>;
    case 16: return cluster_cols_kernel<16>;
    default: return cluster_cols_kernel<0>;
  }
}

// The launch plan: out = {threads, arena bytes, 1 if the arena is in
// shared memory (else global scratch of that many bytes), the register
// form's RT (0: the arena form), registers a thread, local bytes a
// thread, the SM clock in kHz, the stages a warp owns}.
extern "C" int cluster_cols_plan(void* out, long long W, long long R,
                                 long long K, long long F, void* /*stream*/) {
  long long* o = (long long*)out;
  const int rt = cc_register_r(R);
  const CcKernel kern = cc_kernel(rt);
  const long long T = CC_THREADS(rt);
  cudaFuncAttributes attr;
  int rc = (int)cudaFuncGetAttributes(&attr, kern);
  if (rc != 0) return rc;
  int dev = 0, optin = 0, khz = 0;
  if ((rc = (int)cudaGetDevice(&dev)) != 0) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) != 0)
    return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev)) !=
      0)
    return rc;
  const int max_dyn = optin - (int)attr.sharedSizeBytes;
  if (attr.maxDynamicSharedSizeBytes < max_dyn) {
    rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_dyn);
    if (rc != 0) return rc;
  }
  const CcLayout L = cc_layout(W, rt > 0 ? rt : R, K * F);
  o[0] = T;
  o[1] = L.bytes;
  o[2] = L.bytes <= max_dyn ? 1 : 0;
  o[3] = rt;
  o[4] = attr.numRegs;
  o[5] = (long long)attr.localSizeBytes;
  o[6] = khz;
  o[7] = CC_WARP_STAGES;
  return 0;
}

// threads and arena_bytes: cluster_cols_plan's for the same W, R, K, F.
extern "C" int cluster_cols_launch(
    const void* ccap, const void* coffer, const void* cactive,
    const void* mk_cq, const void* requests, const void* podset_active,
    const void* wl_cq, const void* order, const void* admitted, void* out,
    void* scratch, void* stats, long long W, long long P, long long R,
    long long K, long long F, long long threads, long long arena_bytes,
    long long in_smem, void* stream) {
  if (W <= 0) return (int)cudaGetLastError();
  cc_kernel(cc_register_r(R))<<<1, (unsigned)threads,
                        in_smem ? (size_t)arena_bytes : 0,
                        (cudaStream_t)stream>>>(
      (const long long*)ccap, (const unsigned char*)coffer,
      (const unsigned char*)cactive, (const unsigned char*)mk_cq,
      (const long long*)requests, (const unsigned char*)podset_active,
      (const int*)wl_cq, (const int*)order, (const unsigned char*)admitted,
      (int*)out, (unsigned char*)scratch, (int)in_smem, (int*)stats, (int)W,
      (int)P, (int)R, (int)K, (int)F);
  return (int)cudaGetLastError();
}

// The least tick of the pipeline, for its latency bound: one warp runs
// `iters` rounds, each one shared load, RT compares and one shuffle, every
// round's load address depending on the last round's shuffle; out[0] gets
// the clock cycles they took.
template <int RT>
__global__ void cluster_cols_tick_kernel(long long* out, int iters) {
  __shared__ volatile long long buf[256];
  const int lane = threadIdx.x;
  for (int x = lane; x < 256; x += 32) buf[x] = x;
  __syncwarp();
  int idx = lane;
  bool carry = false;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    const long long v = buf[idx];
    bool fits = true;
#pragma unroll
    for (int r = 0; r < RT; ++r) fits &= v + r <= (long long)it;
    carry = __shfl_up_sync(CC_FULL, carry != fits, 1);
    idx = (idx + (carry ? 2 : 1)) & 255;
  }
  const long long t1 = clock64();
  if (lane == 0) {
    out[0] = t1 - t0;
    out[1] = idx;  // keeps the chain live
  }
}

extern "C" int cluster_cols_tick_launch(void* out, long long iters,
                                        long long R, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  long long* o = (long long*)out;
  switch (R) {
    case 1: cluster_cols_tick_kernel<1><<<1, 32, 0, s>>>(o, (int)iters); break;
    case 2: cluster_cols_tick_kernel<2><<<1, 32, 0, s>>>(o, (int)iters); break;
    case 3: cluster_cols_tick_kernel<3><<<1, 32, 0, s>>>(o, (int)iters); break;
    case 4: cluster_cols_tick_kernel<4><<<1, 32, 0, s>>>(o, (int)iters); break;
    case 8: cluster_cols_tick_kernel<8><<<1, 32, 0, s>>>(o, (int)iters); break;
    case 16: cluster_cols_tick_kernel<16><<<1, 32, 0, s>>>(o, (int)iters); break;
    case 32: cluster_cols_tick_kernel<32><<<1, 32, 0, s>>>(o, (int)iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
