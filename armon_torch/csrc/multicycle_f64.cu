// f64 instances of K5 `multicycle` (exact divides).
// Kernel body and design notes: cycle.cuh.
#include "cycle.cuh"

extern "C" int armon_multicycle_f64(const armon::MultiArgs* m, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return armon::dispatch_multicycle<double, false>(m, s);
}
