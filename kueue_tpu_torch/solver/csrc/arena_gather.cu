// arena_gather: this cycle's heads' rows out of the encode arena's device
// twin. Replaces kueue_tpu/solver/kernel.py:892 gather_arena_impl: batch
// row w takes the twin's row slots[w] of each of the seven fields; a
// padding slot (-1, or any slot outside [0, cap)) gives a row of zeros
// (False for the bool fields), bit-identical to the host-assembled padded
// batch. One block per row; its threads copy or zero the row's bytes of
// every field.
#include "common.cuh"

__global__ void arena_gather_kernel(const int* __restrict__ slots,
                                    KqArenaRows rows, int cap) {
  const int w = blockIdx.x;
  const int slot = slots[w];
  const bool valid = slot >= 0 && slot < cap;
  for (int k = 0; k < KQ_ARENA_FIELDS; ++k) {
    const long long rb = rows.row_bytes[k];
    unsigned char* dst = rows.dst[k] + (size_t)w * rb;
    if (valid) {
      const unsigned char* src = rows.src[k] + (size_t)slot * rb;
      for (long long b = threadIdx.x; b < rb; b += blockDim.x) dst[b] = src[b];
    } else {
      for (long long b = threadIdx.x; b < rb; b += blockDim.x) dst[b] = 0;
    }
  }
}

extern "C" int arena_gather_launch(
    const void* slots, const void* src0, const void* src1, const void* src2,
    const void* src3, const void* src4, const void* src5, const void* src6,
    void* dst0, void* dst1, void* dst2, void* dst3, void* dst4, void* dst5,
    void* dst6, long long W, long long cap, long long rb0, long long rb1,
    long long rb2, long long rb3, long long rb4, long long rb5, long long rb6,
    void* stream) {
  const void* src[KQ_ARENA_FIELDS] = {src0, src1, src2, src3, src4, src5, src6};
  void* dst[KQ_ARENA_FIELDS] = {dst0, dst1, dst2, dst3, dst4, dst5, dst6};
  const long long rb[KQ_ARENA_FIELDS] = {rb0, rb1, rb2, rb3, rb4, rb5, rb6};
  if (W > 0)
    arena_gather_kernel<<<(unsigned)W, 128, 0, (cudaStream_t)stream>>>(
        (const int*)slots, kq_arena_rows(src, dst, rb), (int)cap);
  return (int)cudaGetLastError();
}
