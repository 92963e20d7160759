// f32 instances of the X/Y sweep kernels (exact and fast-math divides).
// Kernel body and design notes: sweep.cuh.
#include "sweep.cuh"

// `fin`: null, or K3's work for the launch's tail (the cycle's last launch).
extern "C" int armon_sweep_f32(int axis, const armon::SweepArgs* a,
                               const armon::FinishArgs* fin, void* stream) {
  const int err = armon::check_geometry(axis, a);
  if (err) return err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return a->fast ? armon::dispatch<float, true>(axis, a, fin, s)
                 : armon::dispatch<float, false>(axis, a, fin, s);
}
