// f32 instances of K5 `multicycle` (exact and fast-math divides, both
// window geometries). Kernel body and design notes: cycle.cuh.
#include "cycle.cuh"

extern "C" int armon_multicycle_f32(const armon::MultiArgs* m, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return m->c.fast ? armon::dispatch_multicycle<float, true>(m, s)
                   : armon::dispatch_multicycle<float, false>(m, s);
}

// out: window edge, tiles, resident blocks per SM, threads per block,
// dynamic shared memory, registers, local bytes of the instance K5 takes
// on a (rows, cols) grid.
extern "C" int armon_multicycle_occupancy_f32(long long rows, long long cols, int fast, int biz,
                                              int* out) {
  return fast ? armon::multicycle_occupancy<float, true>(rows, cols, biz, out)
              : armon::multicycle_occupancy<float, false>(rows, cols, biz, out);
}
