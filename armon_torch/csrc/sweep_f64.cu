// f64 instances of the X/Y sweep kernels (always exact IEEE divides).
// Kernel body and design notes: sweep.cuh.
#include "sweep.cuh"

// `fin`: null, or K3's work for the launch's tail (the cycle's last launch).
extern "C" int armon_sweep_f64(int axis, const armon::SweepArgs* a,
                               const armon::FinishArgs* fin, void* stream) {
  const int err = armon::check_geometry(axis, a);
  if (err) return err;
  if (a->fast) return -4;  // no approximate-reciprocal mode in f64
  return armon::dispatch<double, false>(axis, a, fin, reinterpret_cast<cudaStream_t>(stream));
}
