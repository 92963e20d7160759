// f32 instances of the X/Y sweep kernels (exact and fast-math divides).
// Kernel body and design notes: sweep.cuh.
#include "sweep.cuh"

extern "C" int armon_sweep_f32(int axis, const armon::SweepArgs* a, void* stream) {
  const int err = armon::check_geometry(axis, a);
  if (err) return err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return a->fast ? armon::dispatch<float, true>(axis, a, s)
                 : armon::dispatch<float, false>(axis, a, s);
}
