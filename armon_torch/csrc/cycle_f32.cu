// f32 instances of K4 `cycle` (exact and fast-math divides).
// Kernel body and design notes: cycle.cuh.
#include "cycle.cuh"

// `fin`: null, or K3's work for the launch's tail (the cycle's last launch).
extern "C" int armon_cycle_f32(const armon::CycleArgs* a, const armon::FinishArgs* fin,
                                void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return a->fast ? armon::dispatch_cycle<float, true>(a, fin, s)
                 : armon::dispatch_cycle<float, false>(a, fin, s);
}

// out: resident blocks per SM, threads per block, dynamic shared memory.
extern "C" int armon_cycle_occupancy_f32(int fast, int biz, int* out) {
  using armon::cycle_occupancy;
  if (fast)
    return biz ? cycle_occupancy<float, true, true>(out) : cycle_occupancy<float, true, false>(out);
  return biz ? cycle_occupancy<float, false, true>(out) : cycle_occupancy<float, false, false>(out);
}
