// mesh_combine: the body of the sharded cycle's reduction.
// Replaces kueue_tpu/parallel/mesh.py:320-323: after Phase B over its own
// domain columns, each rank's admitted mask and usage deltas are summed
// over the mesh (domains are disjoint, so each element has at most one
// rank's non-zero delta) and added back to the pre-cycle usage.
//
// pack:   buf[W + NU + NC] int64 = (admitted as 0/1,
//         usage_out - usage, cohort_out - cohort_usage),
//         so a rank makes one all-reduce, not three;
// unpack: after the all-reduce, admitted = buf[:W] > 0,
//         usage' = usage + delta, cohort' = cohort_usage + delta.
//
// Bound on the H100: bytes (each element is read and written once, one
// add or subtract). Design: one thread per element of the buffer in a
// grid-stride loop; the three segments are told apart by the index.
#include "common.cuh"

__global__ void mesh_combine_pack_kernel(
    const unsigned char* __restrict__ admitted,
    const long long* __restrict__ usage, const long long* __restrict__ usage_out,
    const long long* __restrict__ cohort, const long long* __restrict__ cohort_out,
    long long* __restrict__ buf, long long W, long long NU, long long NC) {
  const long long n = W + NU + NC;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    long long v;
    if (i < W) {
      v = admitted[i] ? 1 : 0;
    } else if (i < W + NU) {
      const long long j = i - W;
      v = usage_out[j] - usage[j];
    } else {
      const long long j = i - W - NU;
      v = cohort_out[j] - cohort[j];
    }
    buf[i] = v;
  }
}

__global__ void mesh_combine_unpack_kernel(
    const long long* __restrict__ buf, const long long* __restrict__ usage,
    const long long* __restrict__ cohort, unsigned char* __restrict__ admitted,
    long long* __restrict__ usage_out, long long* __restrict__ cohort_out,
    long long W, long long NU, long long NC) {
  const long long n = W + NU + NC;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long v = buf[i];
    if (i < W) {
      admitted[i] = v > 0 ? 1 : 0;
    } else if (i < W + NU) {
      const long long j = i - W;
      usage_out[j] = usage[j] + v;
    } else {
      const long long j = i - W - NU;
      cohort_out[j] = cohort[j] + v;
    }
  }
}

static unsigned mesh_combine_blocks(long long n, int threads) {
  long long blocks = (n + threads - 1) / threads;
  // a grid-stride loop covers the rest: 132 SMs x 16 blocks of 256
  if (blocks > 132 * 16) blocks = 132 * 16;
  return (unsigned)blocks;
}

extern "C" int mesh_combine_pack_launch(
    const void* admitted, const void* usage, const void* usage_out,
    const void* cohort, const void* cohort_out, void* buf, long long W,
    long long NU, long long NC, void* stream) {
  const long long n = W + NU + NC;
  if (n > 0) {
    const int threads = 256;
    mesh_combine_pack_kernel<<<mesh_combine_blocks(n, threads), threads, 0,
                               (cudaStream_t)stream>>>(
        (const unsigned char*)admitted, (const long long*)usage,
        (const long long*)usage_out, (const long long*)cohort,
        (const long long*)cohort_out, (long long*)buf, W, NU, NC);
  }
  return (int)cudaGetLastError();
}

extern "C" int mesh_combine_unpack_launch(
    const void* buf, const void* usage, const void* cohort, void* admitted,
    void* usage_out, void* cohort_out, long long W, long long NU,
    long long NC, void* stream) {
  const long long n = W + NU + NC;
  if (n > 0) {
    const int threads = 256;
    mesh_combine_unpack_kernel<<<mesh_combine_blocks(n, threads), threads, 0,
                                 (cudaStream_t)stream>>>(
        (const long long*)buf, (const long long*)usage,
        (const long long*)cohort, (unsigned char*)admitted,
        (long long*)usage_out, (long long*)cohort_out, W, NU, NC);
  }
  return (int)cudaGetLastError();
}
