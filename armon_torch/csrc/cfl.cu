// K3 `cfl_finish`: the cross-block half of the CFL reduction plus one step
// of the dt recurrence, on the device.
//
// Replaces `_dt_from_tiles` (armon_tpu/ops/pallas/sweep.py:968), whose
// cross-tile maximum the TPU accumulated in a revisited VMEM block, and the
// dt update the TPU's `_multicycle_kernel` runs in-kernel
// (sweep.py:1950-1967, bitwise `core/timestep.dt_update`; the recurrence
// itself is `dt_step` in common.cuh, shared with K5).
//
// Bound on this card: launch latency. It reads 2 x n_partials values
// (~70 K at 8192^2) and writes a few scalars: ~0.5 MB, well under a
// microsecond of HBM time. One block of 1024 threads strides over the
// partials, reduces in shared memory, and one thread runs the scalar
// recurrence, so the loop never reads a scalar back to the host.

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

constexpr int NT = 1024;

template <typename T>
__global__ void __launch_bounds__(NT) cfl_finish_kernel(const CflArgs a) {
  __shared__ T smx[NT], smy[NT];
  T* scal = reinterpret_cast<T*>(a.scal);
  int* iscal = reinterpret_cast<int*>(a.iscal);
  const T* part = reinterpret_cast<const T*>(a.partials);
  const int tid = threadIdx.x;
  const bool fold = a.fold && iscal[2] != 0;  // the cycle that wrote them ran
  if (fold) {
    T mx = T(0), my = T(0);  // the TPU's zero-initialised max block
    for (long long i = tid; i < a.nblocks; i += NT) {
      mx = jmax(mx, part[i]);
      my = jmax(my, part[a.n_partials + i]);
    }
    smx[tid] = mx;
    smy[tid] = my;
    __syncthreads();
    for (int w = NT / 2; w > 0; w >>= 1) {
      if (tid < w) {
        smx[tid] = jmax(smx[tid], smx[tid + w]);
        smy[tid] = jmax(smy[tid], smy[tid + w]);
      }
      __syncthreads();
    }
  }
  if (tid != 0) return;
  if (fold) scal[2] = jmin(T(a.dx) / smx[0], T(a.dy) / smy[0]);
  if (!a.step) return;
  const T t = scal[0];
  const int cyc = iscal[0];
  const bool run = runs(a.dt, t, cyc, iscal[1] != 0);
  if (run) {
    const DtStep<T> r = dt_step(a.dt, scal[2], scal[1], cyc);
    scal[3] = r.dt_use;
    scal[0] = t + r.dt_use;
    scal[1] = r.dt_next;
    iscal[0] = cyc + 1;
    iscal[1] = r.ok ? 1 : 0;
  }
  iscal[2] = run ? 1 : 0;
  iscal[3] = runs(a.dt, scal[0], iscal[0], iscal[1] != 0) ? 1 : 0;
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
    default: break;
  }
  if (code < 0) return "argument rejected by the launcher";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
