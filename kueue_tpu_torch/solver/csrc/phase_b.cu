// phase_b: the order-dependent admit with intra-cycle quota accounting.
// Replaces kueue_tpu/solver/kernel.py:420 solve_phase_b_domains_impl with
// :82 _chain_avail and :106 _chain_add_usage. One thread block per
// conflict domain (root cohort, or a CQ with no cohort). Domains touch
// disjoint usage state, so blocks never wait on each other. A block walks
// its members in admit order (offsets/members: a CSR of the order); one
// thread per (f, r) element re-checks availability, __syncthreads_and
// decides still_fits, and an admitted workload's usage is added to its
// CQ and bubbled up its cohort chain past each level's guaranteed quota.
// Every thread only touches its own (f, r) column of usage/cohort_usage.
#include "common.cuh"

__global__ void phase_b_kernel(
    const int* __restrict__ cq_cohort, const int* __restrict__ cq_chain,
    const long long* __restrict__ nominal,
    const long long* __restrict__ guaranteed,
    const long long* __restrict__ borrow_limit,
    const long long* __restrict__ cohort_subtree,
    const long long* __restrict__ cohort_guaranteed,
    const long long* __restrict__ cohort_borrow_limit,
    long long* usage, long long* cohort_usage,
    const long long* __restrict__ asg, const unsigned char* __restrict__ fit,
    const int* __restrict__ wl_cq, const int* __restrict__ offsets,
    const int* __restrict__ members, unsigned char* __restrict__ admitted,
    int FR, int DC) {
  const int d = blockIdx.x;
  const int beg = offsets[d], end = offsets[d + 1];
  for (int i = beg; i < end; ++i) {
    const int w = members[i];
    if (!fit[w]) continue;  // uniform: keeps its place, never admits
    const int q = wl_cq[w];
    const long long* au_w = asg + (size_t)w * FR;
    bool ok = true;
    for (int e = threadIdx.x; e < FR; e += blockDim.x) {
      const long long au = au_w[e];
      if (au != 0)
        ok &= au <= kq_cq_avail(q, e, FR, DC, cq_cohort, cq_chain, nominal,
                                guaranteed, borrow_limit, usage, cohort_subtree,
                                cohort_guaranteed, cohort_borrow_limit,
                                cohort_usage);
    }
    const bool admit = __syncthreads_and(ok) != 0;
    if (admit) {
      const bool has_cohort = cq_cohort[q] >= 0;
      for (int e = threadIdx.x; e < FR; e += blockDim.x) {
        const long long au = au_w[e];
        if (au == 0) continue;
        const size_t qe = (size_t)q * FR + e;
        const long long old = usage[qe], nw = old + au;
        usage[qe] = nw;
        if (!has_cohort) continue;
        long long delta = kq_max0(nw - guaranteed[qe]) - kq_max0(old - guaranteed[qe]);
        for (int k = 0; k < DC && delta != 0; ++k) {
          const int c = cq_chain[(size_t)q * DC + k];
          if (c < 0) break;
          const size_t ce = (size_t)c * FR + e;
          const long long oc = cohort_usage[ce], nc = oc + delta;
          cohort_usage[ce] = nc;
          delta = kq_max0(nc - cohort_guaranteed[ce]) - kq_max0(oc - cohort_guaranteed[ce]);
        }
      }
      if (threadIdx.x == 0) admitted[w] = 1;
    }
    __syncthreads();
  }
}

extern "C" int phase_b_launch(
    const void* cq_cohort, const void* cq_chain, const void* nominal,
    const void* guaranteed, const void* borrow_limit,
    const void* cohort_subtree, const void* cohort_guaranteed,
    const void* cohort_borrow_limit, void* usage, void* cohort_usage,
    const void* asg, const void* fit, const void* wl_cq, const void* offsets,
    const void* members, void* admitted, long long D, long long FR,
    long long DC, void* stream) {
  if (D > 0 && FR > 0) {
    long long threads = (FR + 31) / 32 * 32;
    if (threads > 256) threads = 256;
    phase_b_kernel<<<(unsigned)D, (unsigned)threads, 0, (cudaStream_t)stream>>>(
        (const int*)cq_cohort, (const int*)cq_chain, (const long long*)nominal,
        (const long long*)guaranteed, (const long long*)borrow_limit,
        (const long long*)cohort_subtree, (const long long*)cohort_guaranteed,
        (const long long*)cohort_borrow_limit, (long long*)usage,
        (long long*)cohort_usage, (const long long*)asg,
        (const unsigned char*)fit, (const int*)wl_cq, (const int*)offsets,
        (const int*)members, (unsigned char*)admitted, (int)FR, (int)DC);
  }
  return (int)cudaGetLastError();
}
