// K3 `cfl_finish`: the cross-block half of the CFL reduction plus one step
// of the dt recurrence, on the device.
//
// Replaces `_dt_from_tiles` (armon_tpu/ops/pallas/sweep.py:968), whose
// cross-tile maximum the TPU accumulated in a revisited VMEM block, and the
// dt update the TPU's `_multicycle_kernel` runs in-kernel
// (sweep.py:1950-1967, bitwise `core/timestep.dt_update`; the recurrence
// itself is `dt_step` in common.cuh, shared with K5).
//
// Bound on this card: launch latency. It reads 2 x n_partials values and
// writes a few scalars: at 8200^2 padded K1 writes 8841 partials a launch,
// K2 4225 and K4 13818 (`n_partials` in ops/sweep.py and ops/cycle.py),
// 71, 34 and 111 KB in f32, well under a microsecond of HBM time. One block of CFL_NT = 1024
// threads folds the partials (`fold_partials`: a strided pass, then a tree
// in shared memory) and one thread runs the scalar step (`cfl_scalars`),
// so the loop never reads a scalar back to the host.
//
// The solver's loop launches it once per run, for the first cycle's step;
// every later fold and step runs in the tail of the cycle's last launch
// (`cfl_tail` in common.cuh, the same fold order and scalar step), except
// on a mesh across cards, which copies remote partials in after the cycle
// and then launches K3 (core/step.py).

#include "common.cuh"

namespace armon {

struct CflArgs {
  const void* partials;   // (2, n_partials): max |u|+c, then max |v|+c
  void* scal;             // T[4]: t, dt_prev, lm, dt_use
  void* iscal;            // int32[4]: cycle, ok, run, next
  long long n_partials;   // row stride of `partials`
  long long nblocks;      // partials the last kernel wrote
  int fold;               // fold the partials into lm (if the cycle ran)
  int step;               // run the dt recurrence for the next cycle
  DtParams dt;
  double dx, dy;          // rounded to T
};

constexpr int NT = CFL_NT;

template <typename T>
__global__ void __launch_bounds__(NT) cfl_finish_kernel(const CflArgs a) {
  __shared__ T red[2 * NT];
  int* iscal = reinterpret_cast<int*>(a.iscal);
  // The cycle that wrote them ran; every thread reads iscal[run] before
  // thread 0 rewrites it.
  const bool fold = a.fold && __syncthreads_and(iscal[2] != 0);
  T mx = T(0), my = T(0);
  if (fold)
    fold_partials<T, NT>(reinterpret_cast<const T*>(a.partials), a.n_partials, a.nblocks,
                         red, mx, my);
  if (threadIdx.x != 0) return;
  cfl_scalars<T>(a.dt, a.dx, a.dy, reinterpret_cast<T*>(a.scal), iscal, fold, a.step != 0,
                 mx, my);
}

}  // namespace armon

extern "C" int armon_cfl_finish(int bits, const armon::CflArgs* a, void* stream) {
  using armon::cfl_finish_kernel;
  using armon::NT;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (a->nblocks > a->n_partials) return -3;
  if (bits == 32)
    cfl_finish_kernel<float><<<1, NT, 0, s>>>(*a);
  else if (bits == 64)
    cfl_finish_kernel<double><<<1, NT, 0, s>>>(*a);
  else
    return -1;
  return (int)cudaGetLastError();
}

extern "C" const char* armon_error_string(int code) {
  switch (code) {
    case -4: return "the grid does not fit co-resident on the card (cooperative launch)";
    case -5: return "the card does not support cooperative launches";
    case -6: return "the card cannot place one cluster of this size and shared memory";
    case -7: return "the cluster plan does not cover the grid (probes/cluster.py plan)";
    case -8: return "the plan's shared memory is not what the kernel needs, or exceeds 227 KB";
    case -9: return "the driver offers no cuTensorMapEncodeTiled (TMA descriptors)";
    case -10: return "cuTensorMapEncodeTiled refused the block (K6's TMA descriptors)";
    default: break;
  }
  if (code < 0) return "argument rejected by the launcher";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
