// deltas: sparse usage corrections applied in place to the resident state.
// Replaces kueue_tpu/solver/kernel.py:765 apply_state_deltas_impl. Input:
// D unique (q, f, r) coords with their net deltas (dq = -1 pads), and per
// cohort-chain level the level's unique cohort coords lvl_c[L,D,3] with
// lvl_seg[L,D], which maps row d of the level below (level 0: the delta
// coords) to its row in lvl_c[l] (-1: the chain ends, or padding).
// Each coord's change of usage above its guaranteed quota (a difference
// of clamps, so the old value is read before the add) becomes the next
// level's delta; several children can feed one cohort coord, so a
// level's deltas are segment sums of atomic adds (unsigned, so they wrap
// correctly for negative deltas).
//
// Bound on the H100: latency. The churn's 256 coords move ~30 KB; the
// chain is the coords, then the values at them, then one segment sum a
// level.
// Design. The register form (D <= 1024 rows, L <= 4 levels): one block,
// thread d owns row d of every level. One round trip loads every index
// that does not depend on the chain (the delta coords and deltas, every
// level's lvl_seg and lvl_c), a second the values at those coords (usage,
// guaranteed, cohort_usage, cohort_guaranteed) and each cohort's
// cohort_multilevel flag. Each level is then a barrier, a shared read of
// the row's segment sum (zeroed in the same pass: two buffers take
// turns), the clamp difference, and shared atomic adds into the next
// level's sum (three native 32-bit ones; see kq_sum_add). A cohort that
// the topology places at two chain levels (CQs attached under it at two
// depths; cohort_multilevel, derived at topology upload) can appear at
// two levels of one tuple, and its old
// usage is then the value after the earlier level's add, as the JAX
// program reads it: such a coord is read again at its level, after the
// barrier. Every other cohort coord sits at one level of any tuple, so
// its preloaded value is the old one.
// The staged form (any D, any L): one block of 1024 threads walks each
// level's rows in turn and reads the old values at their level; the two
// sum buffers lie in shared memory (opted in past 48 KB) or, past what
// the wrapper allows, in a global scratch (the global form).
#include "common.cuh"

#define KQ_DELTAS_THREADS 1024  // the staged form's block

struct KqDeltaArgs {
  const long long* guaranteed;         // [Q,F,R]
  const long long* cohort_guaranteed;  // [C,F,R]
  long long* usage;                    // [Q,F,R], in place
  long long* cohort_usage;             // [C,F,R], in place
  const int* dq;                       // [D]
  const int* df;
  const int* dr;
  const long long* dv;
  const int* lvl_c;                    // [L,D,3]
  const int* lvl_seg;                  // [L,D]
  const unsigned char* multilevel;     // [C]
  unsigned long long* scratch;         // [2,D] the global form's sums
  int D, L, F, R;
};

__device__ __forceinline__ size_t kq_coord(int c, int f, int r, int F,
                                           int R) {
  return ((size_t)c * F + f) * R + r;
}

// The register form's segment sums, a row's in three 32-bit words (bits
// 0-21, 22-43 and 44-63 of each addend, D words apart): the words of up
// to 1024 addends sum below 2^32, and a 32-bit shared atomic add is one
// instruction where a 64-bit one is a compare-and-swap loop.
__device__ __forceinline__ void kq_sum_add(unsigned* row, int D,
                                           long long v) {
  const unsigned long long x = (unsigned long long)v;
  atomicAdd(row, (unsigned)(x & 0x3fffffu));
  atomicAdd(row + D, (unsigned)((x >> 22) & 0x3fffffu));
  atomicAdd(row + 2 * D, (unsigned)(x >> 44));
}

// A row's sum, its words zeroed for the buffer's next level.
__device__ __forceinline__ long long kq_sum_take(unsigned* row, int D) {
  const unsigned long long s = (unsigned long long)row[0] +
                               ((unsigned long long)row[D] << 22) +
                               ((unsigned long long)row[2 * D] << 44);
  row[0] = row[D] = row[2 * D] = 0u;
  return (long long)s;
}

template <int LM>
__global__ void __launch_bounds__(1024)
deltas_register_kernel(const KqDeltaArgs a) {
  extern __shared__ unsigned sums[];  // [2,3,D]: two buffers of 3 words
  const int d = threadIdx.x, D = a.D, L = a.L;
  const bool live = d < D;
  if (live && L > 0)
    for (int k = 0; k < 6; ++k) sums[k * D + d] = 0u;
  // round trip 1: every index off the chain
  int q = -1, f = 0, r = 0;
  long long v = 0;
  if (live) {
    q = a.dq[d];
    f = a.df[d];
    r = a.dr[d];
    v = a.dv[d];
  }
  int seg[LM], cc[LM], cf[LM], cr[LM];
#pragma unroll
  for (int l = 0; l < LM; ++l) {
    const bool in = live && l < L;
    const size_t row = (size_t)l * D + d;
    seg[l] = in ? a.lvl_seg[row] : -1;
    cc[l] = in ? a.lvl_c[row * 3] : -1;
    cf[l] = in ? a.lvl_c[row * 3 + 1] : 0;
    cr[l] = in ? a.lvl_c[row * 3 + 2] : 0;
  }
  // round trip 2: the values at those coords
  const size_t e = q >= 0 ? kq_coord(q, f, r, a.F, a.R) : 0;
  const long long old = q >= 0 ? a.usage[e] : 0;
  const long long g = q >= 0 ? a.guaranteed[e] : 0;
  size_t ce[LM];
  long long cold[LM], cg[LM];
  bool again[LM];
#pragma unroll
  for (int l = 0; l < LM; ++l) {
    const bool in = cc[l] >= 0;
    ce[l] = in ? kq_coord(cc[l], cf[l], cr[l], a.F, a.R) : 0;
    cold[l] = in ? a.cohort_usage[ce[l]] : 0;
    cg[l] = in ? a.cohort_guaranteed[ce[l]] : 0;
    again[l] = in && a.multilevel[cc[l]];
  }
  long long over = 0;
  if (q >= 0) {
    const long long nw = old + v;
    a.usage[e] = nw;
    over = kq_max0(nw - g) - kq_max0(old - g);
  }
  if (L == 0) return;  // uniform: no cohort level
  __syncthreads();  // the sums are zeroed
  if (seg[0] >= 0 && over != 0) kq_sum_add(sums + seg[0], D, over);
  __syncthreads();
#pragma unroll
  for (int l = 0; l < LM; ++l) {
    if (l >= L) break;  // uniform
    long long up = 0;
    if (live) {
      // the buffer's words are zeroed for level l + 2's sums
      const long long add = kq_sum_take(sums + (l & 1) * 3 * D + d, D);
      if (cc[l] >= 0) {
        const long long o = again[l] ? a.cohort_usage[ce[l]] : cold[l];
        const long long nw = o + add;
        a.cohort_usage[ce[l]] = nw;
        up = kq_max0(nw - cg[l]) - kq_max0(o - cg[l]);
      }
    }
    if (l + 1 < LM && l + 1 < L && seg[l + 1] >= 0 && up != 0)
      kq_sum_add(sums + ((l + 1) & 1) * 3 * D + seg[l + 1], D, up);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(KQ_DELTAS_THREADS)
deltas_staged_kernel(const KqDeltaArgs a) {
  extern __shared__ unsigned long long staged[];  // [2,D] unless global
  unsigned long long* sums = a.scratch ? a.scratch : staged;
  const int D = a.D, L = a.L, T = blockDim.x;
  for (int k = threadIdx.x; k < 2 * D; k += T) sums[k] = 0ULL;
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += T) {
    const int q = a.dq[d];
    if (q < 0) continue;
    const size_t e = kq_coord(q, a.df[d], a.dr[d], a.F, a.R);
    const long long old = a.usage[e], g = a.guaranteed[e];
    const long long nw = old + a.dv[d];
    a.usage[e] = nw;
    const long long over = kq_max0(nw - g) - kq_max0(old - g);
    const int s = L > 0 ? a.lvl_seg[d] : -1;
    if (s >= 0 && over != 0) atomicAdd(&sums[s], (unsigned long long)over);
  }
  __syncthreads();
  for (int l = 0; l < L; ++l) {
    unsigned long long* cur = sums + (size_t)(l & 1) * D;
    unsigned long long* nxt = sums + (size_t)((l + 1) & 1) * D;
    for (int k = threadIdx.x; k < D; k += T) {
      const long long add = (long long)cur[k];
      cur[k] = 0ULL;
      const int* c = a.lvl_c + ((size_t)l * D + k) * 3;
      if (c[0] < 0) continue;
      const size_t e = kq_coord(c[0], c[1], c[2], a.F, a.R);
      const long long old = a.cohort_usage[e], g = a.cohort_guaranteed[e];
      const long long nw = old + add;
      a.cohort_usage[e] = nw;
      const long long up = kq_max0(nw - g) - kq_max0(old - g);
      const int s = l + 1 < L ? a.lvl_seg[(size_t)(l + 1) * D + k] : -1;
      if (s >= 0 && up != 0) atomicAdd(&nxt[s], (unsigned long long)up);
    }
    __syncthreads();
  }
}

// The latency bound's level step, one block of `threads`: a row's sum
// taken from its three shared words (kq_sum_take), three 32-bit atomic
// adds into the other buffer (kq_sum_add) and a barrier. out[0] the
// cycles of `iters` steps, out[1] a sink.
__global__ void deltas_tick_kernel(long long* out, int iters) {
  extern __shared__ unsigned ring[];  // [2,3,blockDim.x]
  const int t = threadIdx.x, n = blockDim.x;
  for (int k = 0; k < 6; ++k) ring[k * n + t] = 0u;
  __syncthreads();
  long long acc = 0;
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    const long long x = kq_sum_take(ring + (i & 1) * 3 * n + t, n);
    kq_sum_add(ring + ((i + 1) & 1) * 3 * n + (t * 7 + i) % n, n, x + 1);
    __syncthreads();
    acc += x;
  }
  const long long t1 = clock64();
  if (t == 0) {
    out[0] = t1 - t0;
    out[1] = acc;
  }
}

// form 0: the register form (`levels` its compiled levels, 1, 2 or 4);
// 1: the staged form, the sums in `smem` bytes of shared memory; 2:
// the staged form, the sums in `scratch` (2 * D int64).
extern "C" int deltas_launch(const void* guaranteed,
                             const void* cohort_guaranteed, void* usage,
                             void* cohort_usage, const void* dq,
                             const void* df, const void* dr, const void* dv,
                             const void* lvl_c, const void* lvl_seg,
                             const void* multilevel, void* scratch,
                             long long D, long long L, long long F,
                             long long R, long long form, long long levels,
                             long long smem, void* stream) {
  if (D <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const KqDeltaArgs a = {
      (const long long*)guaranteed, (const long long*)cohort_guaranteed,
      (long long*)usage, (long long*)cohort_usage, (const int*)dq,
      (const int*)df, (const int*)dr, (const long long*)dv,
      (const int*)lvl_c, (const int*)lvl_seg,
      (const unsigned char*)multilevel,
      form == 2 ? (unsigned long long*)scratch : nullptr,
      (int)D, (int)L, (int)F, (int)R};
  if (form == 0) {
    const unsigned threads = (unsigned)((D + 31) / 32 * 32);
    switch (levels) {
      case 1: deltas_register_kernel<1><<<1, threads, smem, s>>>(a); break;
      case 2: deltas_register_kernel<2><<<1, threads, smem, s>>>(a); break;
      case 4: deltas_register_kernel<4><<<1, threads, smem, s>>>(a); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    static long long raised = 48 * 1024;  // the dynamic shared memory allowed
    if (form == 1 && smem > raised) {
      const int rc = (int)cudaFuncSetAttribute(
          deltas_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (rc != 0) return rc;
      raised = smem;
    }
    deltas_staged_kernel<<<1, KQ_DELTAS_THREADS, form == 1 ? smem : 0, s>>>(
        a);
  }
  return (int)cudaGetLastError();
}

extern "C" int deltas_tick_launch(void* out, long long threads,
                                  long long iters, void* stream) {
  deltas_tick_kernel<<<1, (unsigned)threads,
                       (size_t)threads * 6 * sizeof(unsigned),
                       (cudaStream_t)stream>>>((long long*)out, (int)iters);
  return (int)cudaGetLastError();
}
