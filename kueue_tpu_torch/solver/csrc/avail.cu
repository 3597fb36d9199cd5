// avail: available[Q,F,R] for every ClusterQueue.
// Replaces kueue_tpu/solver/kernel.py:39 _avail_level, :50 _cohort_avail,
// :70 _available. One thread per (q, f, r), each walking its CQ's cohort
// chain from the root down (no [C,F,R] intermediate, one launch).
#include "common.cuh"

__global__ void avail_kernel(
    const int* __restrict__ cq_cohort, const int* __restrict__ cq_chain,
    const long long* __restrict__ nominal,
    const long long* __restrict__ guaranteed,
    const long long* __restrict__ borrow_limit,
    const long long* __restrict__ usage,
    const long long* __restrict__ cohort_subtree,
    const long long* __restrict__ cohort_guaranteed,
    const long long* __restrict__ cohort_borrow_limit,
    const long long* __restrict__ cohort_usage, long long* __restrict__ out,
    long long Q, int FR, int DC) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q * FR) return;
  int q = (int)(i / FR), e = (int)(i % FR);
  out[i] = kq_cq_avail(q, e, FR, DC, cq_cohort, cq_chain, nominal, guaranteed,
                       borrow_limit, usage, cohort_subtree, cohort_guaranteed,
                       cohort_borrow_limit, cohort_usage);
}

extern "C" int avail_launch(
    const void* cq_cohort, const void* cq_chain, const void* nominal,
    const void* guaranteed, const void* borrow_limit, const void* usage,
    const void* cohort_subtree, const void* cohort_guaranteed,
    const void* cohort_borrow_limit, const void* cohort_usage, void* out,
    long long Q, long long FR, long long DC, void* stream) {
  long long n = Q * FR;
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    avail_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)cq_cohort, (const int*)cq_chain, (const long long*)nominal,
        (const long long*)guaranteed, (const long long*)borrow_limit,
        (const long long*)usage, (const long long*)cohort_subtree,
        (const long long*)cohort_guaranteed,
        (const long long*)cohort_borrow_limit, (const long long*)cohort_usage,
        (long long*)out, Q, (int)FR, (int)DC);
  }
  return (int)cudaGetLastError();
}
