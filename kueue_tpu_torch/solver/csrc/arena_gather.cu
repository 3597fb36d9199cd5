// arena_gather: this cycle's heads' rows out of the encode arena's device
// twin. Replaces kueue_tpu/solver/kernel.py:892 gather_arena_impl: batch
// row w takes the twin's row min(slots[w], cap - 1) of each of the seven
// fields, as JAX's gather clamps it; a slot < 0 (the padding, -1) gives a
// row of zeros (False for the bool fields) without reading the twin,
// bit-identical to the host-assembled padded batch. The copy, its latency
// bound (two dependent round trips: the slot, then the fields) and its
// design are arena.cuh's: a warp a row, every field's loads before any
// store, each field in its widest vector.
#include "arena.cuh"

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
  return kq_arena_launch<false>(slots, src, dst, rb, lg, W, cap, stream);
}
