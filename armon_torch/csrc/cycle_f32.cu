// f32 instances of K4 `cycle` (exact and fast-math divides).
// Kernel body and design notes: cycle.cuh.
#include "cycle.cuh"

extern "C" int armon_cycle_f32(const armon::CycleArgs* a, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return a->fast ? armon::dispatch_cycle<float, true>(a, s)
                 : armon::dispatch_cycle<float, false>(a, s);
}
