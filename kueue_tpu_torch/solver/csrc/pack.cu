// pack: the compact decision wire format.
// Replaces kueue_tpu/solver/kernel.py:359 _pack_bits and :372
// pack_decisions_impl. dec_pr[W, P*R] = (chosen + 1) | (chosen_borrow << 7);
// dec_bits[3, ceil(W/8)] = little-endian bit planes of fit / admitted /
// borrows. One thread per output byte.
#include "common.cuh"

__global__ void pack_kernel(
    const int* __restrict__ chosen, const unsigned char* __restrict__ chosen_borrow,
    const unsigned char* __restrict__ fit, const unsigned char* __restrict__ admitted,
    const unsigned char* __restrict__ borrows, unsigned char* __restrict__ dec_pr,
    unsigned char* __restrict__ dec_bits, long long W, long long PR, long long NB) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long npr = W * PR;
  if (i < npr) {
    dec_pr[i] = (unsigned char)((chosen[i] + 1) & 0xFF) |
                (unsigned char)(chosen_borrow[i] ? 0x80 : 0);
    return;
  }
  long long j = i - npr;
  if (j >= 3 * NB) return;
  long long plane = j / NB, byte = j % NB;
  const unsigned char* row = plane == 0 ? fit : (plane == 1 ? admitted : borrows);
  unsigned v = 0;
  for (int k = 0; k < 8; ++k) {
    long long idx = byte * 8 + k;
    if (idx < W && row[idx]) v |= 1u << k;
  }
  dec_bits[j] = (unsigned char)v;
}

extern "C" int pack_launch(const void* chosen, const void* chosen_borrow,
                           const void* fit, const void* admitted,
                           const void* borrows, void* dec_pr, void* dec_bits,
                           long long W, long long PR, long long NB,
                           void* stream) {
  long long n = W * PR + 3 * NB;
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    pack_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)chosen, (const unsigned char*)chosen_borrow,
        (const unsigned char*)fit, (const unsigned char*)admitted,
        (const unsigned char*)borrows, (unsigned char*)dec_pr,
        (unsigned char*)dec_bits, W, PR, NB);
  }
  return (int)cudaGetLastError();
}
