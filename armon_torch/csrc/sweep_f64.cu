// f64 instances of the X/Y sweep kernels (always exact IEEE divides).
// Kernel body and design notes: sweep.cuh.
#include "sweep.cuh"

extern "C" int armon_sweep_f64(int axis, const armon::SweepArgs* a, void* stream) {
  const int err = armon::check_geometry(axis, a);
  if (err) return err;
  if (a->fast) return -4;  // no approximate-reciprocal mode in f64
  return armon::dispatch<double, false>(axis, a, reinterpret_cast<cudaStream_t>(stream));
}
