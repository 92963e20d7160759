// f64 instances of K4 `cycle` (exact divides).
// Kernel body and design notes: cycle.cuh.
#include "cycle.cuh"

// `fin`: null, or K3's work for the launch's tail (the cycle's last launch).
extern "C" int armon_cycle_f64(const armon::CycleArgs* a, const armon::FinishArgs* fin,
                                void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return armon::dispatch_cycle<double, false>(a, fin, s);
}

// out: resident blocks per SM, threads per block, dynamic shared memory.
extern "C" int armon_cycle_occupancy_f64(int fast, int biz, int* out) {
  if (fast) return -1;
  return biz ? armon::cycle_occupancy<double, false, true>(out)
             : armon::cycle_occupancy<double, false, false>(out);
}
