// arena_scatter: the encode arena's changed rows into its device twin,
// in place. Replaces kueue_tpu/solver/kernel.py:863
// scatter_arena_rows_impl (and its donated form, :888): the twin's rows
// upd_slots[d] take the seven fields' rows d. upd_slots is padded with
// the out-of-range slot `cap`; slots outside [0, cap) are dropped. One
// block per row; its threads copy the row's bytes of every field.
#include "common.cuh"

__global__ void arena_scatter_kernel(const int* __restrict__ upd_slots,
                                     KqArenaRows rows, int cap) {
  const int d = blockIdx.x;
  const int slot = upd_slots[d];
  if (slot < 0 || slot >= cap) return;
  for (int k = 0; k < KQ_ARENA_FIELDS; ++k) {
    const long long rb = rows.row_bytes[k];
    const unsigned char* src = rows.src[k] + (size_t)d * rb;
    unsigned char* dst = rows.dst[k] + (size_t)slot * rb;
    for (long long b = threadIdx.x; b < rb; b += blockDim.x) dst[b] = src[b];
  }
}

extern "C" int arena_scatter_launch(
    const void* upd_slots, const void* src0, const void* src1,
    const void* src2, const void* src3, const void* src4, const void* src5,
    const void* src6, void* dst0, void* dst1, void* dst2, void* dst3,
    void* dst4, void* dst5, void* dst6, long long D, long long cap,
    long long rb0, long long rb1, long long rb2, long long rb3, long long rb4,
    long long rb5, long long rb6, void* stream) {
  const void* src[KQ_ARENA_FIELDS] = {src0, src1, src2, src3, src4, src5, src6};
  void* dst[KQ_ARENA_FIELDS] = {dst0, dst1, dst2, dst3, dst4, dst5, dst6};
  const long long rb[KQ_ARENA_FIELDS] = {rb0, rb1, rb2, rb3, rb4, rb5, rb6};
  if (D > 0)
    arena_scatter_kernel<<<(unsigned)D, 128, 0, (cudaStream_t)stream>>>(
        (const int*)upd_slots, kq_arena_rows(src, dst, rb), (int)cap);
  return (int)cudaGetLastError();
}
