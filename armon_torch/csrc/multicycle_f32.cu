// f32 instances of K5 `multicycle` (exact and fast-math divides).
// Kernel body and design notes: cycle.cuh.
#include "cycle.cuh"

extern "C" int armon_multicycle_f32(const armon::MultiArgs* m, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return m->c.fast ? armon::dispatch_multicycle<float, true>(m, s)
                   : armon::dispatch_multicycle<float, false>(m, s);
}
