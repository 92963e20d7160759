// f64 instances of K5 `multicycle` (exact divides, both window
// geometries). Kernel body and design notes: cycle.cuh.
#include "cycle.cuh"

extern "C" int armon_multicycle_f64(const armon::MultiArgs* m, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return armon::dispatch_multicycle<double, false>(m, s);
}

// As armon_multicycle_occupancy_f32 (`fast` is ignored: f64 divides exactly).
extern "C" int armon_multicycle_occupancy_f64(long long rows, long long cols, int fast, int biz,
                                              int* out) {
  (void)fast;
  return armon::multicycle_occupancy<double, false>(rows, cols, biz, out);
}
