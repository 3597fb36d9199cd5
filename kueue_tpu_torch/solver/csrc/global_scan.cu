// global_scan: the global W-step admit scan, the test oracle of the cycle.
// Replaces the lax.scan of kueue_tpu/solver/kernel.py:250 solve_cycle_impl
// (admit_step :279-303, with :82 _chain_avail and :106 _chain_add_usage).
//
// One thread block walks the global admit order, one workload a step, as
// the scan does: the step's CQ availability (its cohort chain walked from
// the root down, then the CQ's own level), "still fits" as a block-wide
// AND, then the admitted usage added to the CQ row and the chain's
// over-guaranteed part bubbled up level by level. The steps form one
// dependent chain across every conflict domain, so there is one block.
// One thread per (f, r) lane, looping when F*R exceeds the block; a lane
// only ever reads and writes its own (f, r) column of usage and
// cohort_usage, so the lanes share nothing but the step's decision.
// usage/cohort_usage are the outputs, copies of the inputs, updated in
// global memory. A workload that did not fit never admits (admit = fit &
// still_fits): its step is skipped.
#include "common.cuh"

__global__ void global_scan_kernel(
    const int* __restrict__ cq_cohort, const int* __restrict__ cq_chain,
    const long long* __restrict__ nominal,
    const long long* __restrict__ guaranteed,
    const long long* __restrict__ borrow_limit,
    const long long* __restrict__ cohort_subtree,
    const long long* __restrict__ cohort_guaranteed,
    const long long* __restrict__ cohort_borrow_limit,
    long long* usage, long long* cohort_usage,
    const long long* __restrict__ asg, const unsigned char* __restrict__ fit,
    const int* __restrict__ wl_cq, const int* __restrict__ order,
    unsigned char* __restrict__ admitted, int W, int FR, int DC) {
  for (int step = 0; step < W; ++step) {
    const int w = order[step];
    if (!fit[w]) continue;  // uniform over the block
    const int q = wl_cq[w];
    const int* chain = cq_chain + (size_t)q * DC;
    const bool has_cohort = cq_cohort[q] >= 0;
    const long long* au_w = asg + (size_t)w * FR;

    // still_fits = all((au == 0) | (au <= avail_q))
    bool fits = true;
    for (int e = threadIdx.x; e < FR; e += blockDim.x) {
      const long long au = au_w[e];
      if (au == 0) continue;
      const size_t qe = (size_t)q * FR + e;
      long long avail_q;
      if (has_cohort) {
        // _chain_avail: chain[DC-1..0], -1 past the root; the first valid
        // entry from the end is the root (subtree - usage), each level
        // below adds its guaranteed remainder and the capped parent
        long long parent = 0;
        bool started = false;
        for (int d = DC - 1; d >= 0; --d) {
          const int c = chain[d];
          if (c < 0) continue;
          const size_t ce = (size_t)c * FR + e;
          const long long cu = cohort_usage[ce];
          parent = started
                       ? kq_avail_level(cohort_subtree[ce], cohort_guaranteed[ce],
                                        cohort_borrow_limit[ce], cu, parent)
                       : cohort_subtree[ce] - cu;
          started = true;
        }
        avail_q = kq_avail_level(nominal[qe], guaranteed[qe], borrow_limit[qe],
                                 usage[qe], parent);
      } else {
        avail_q = nominal[qe] - usage[qe];
      }
      fits = fits && au <= avail_q;
    }
    if (!__syncthreads_and(fits)) continue;

    // admit: the CQ row, then _chain_add_usage of the over-guaranteed delta
    for (int e = threadIdx.x; e < FR; e += blockDim.x) {
      const long long au = au_w[e];
      if (au == 0) continue;
      const size_t qe = (size_t)q * FR + e;
      const long long old_q = usage[qe], new_q = old_q + au;
      usage[qe] = new_q;
      if (!has_cohort) continue;
      long long delta = kq_max0(new_q - guaranteed[qe]) - kq_max0(old_q - guaranteed[qe]);
      for (int d = 0; d < DC; ++d) {
        const int c = chain[d];
        if (c < 0) continue;
        const size_t ce = (size_t)c * FR + e;
        const long long old_c = cohort_usage[ce], new_c = old_c + delta;
        cohort_usage[ce] = new_c;
        delta = kq_max0(new_c - cohort_guaranteed[ce]) - kq_max0(old_c - cohort_guaranteed[ce]);
      }
    }
    if (threadIdx.x == 0) admitted[w] = 1;
  }
}

extern "C" int global_scan_launch(
    const void* cq_cohort, const void* cq_chain, const void* nominal,
    const void* guaranteed, const void* borrow_limit,
    const void* cohort_subtree, const void* cohort_guaranteed,
    const void* cohort_borrow_limit, void* usage, void* cohort_usage,
    const void* asg, const void* fit, const void* wl_cq, const void* order,
    void* admitted, long long W, long long FR, long long DC, void* stream) {
  if (W > 0 && FR > 0) {
    long long threads = (FR + 31) / 32 * 32;
    if (threads > 1024) threads = 1024;
    global_scan_kernel<<<1, (unsigned)threads, 0, (cudaStream_t)stream>>>(
        (const int*)cq_cohort, (const int*)cq_chain, (const long long*)nominal,
        (const long long*)guaranteed, (const long long*)borrow_limit,
        (const long long*)cohort_subtree, (const long long*)cohort_guaranteed,
        (const long long*)cohort_borrow_limit, (long long*)usage,
        (long long*)cohort_usage, (const long long*)asg,
        (const unsigned char*)fit, (const int*)wl_cq, (const int*)order,
        (unsigned char*)admitted, (int)W, (int)FR, (int)DC);
  }
  return (int)cudaGetLastError();
}
