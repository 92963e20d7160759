// Device helpers shared by every kernel of the port: NaN-propagating
// min/max/sign and the dt recurrence.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace armon {

// NaN-propagating max/min, as jnp.maximum / jnp.minimum (fmax/fmin drop
// NaN, which would let a diverged cell yield a finite dt).
template <typename T> __device__ __forceinline__ T jmax(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename T> __device__ __forceinline__ T jmin(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}
// jnp.sign: +-1, and x itself for +-0 and NaN.
template <typename T> __device__ __forceinline__ T jsign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}

// Scalars of the dt recurrence, every value already rounded to T on the
// host.
struct DtParams {
  int cst_dt, dt_on_even_cycles, maxcycle;
  double cfl, maxtime, Dt, cap;
};

template <typename T> struct DtStep {
  T dt_use, dt_next;
  bool ok;
};

// One step of the dt recurrence (`core/timestep.dt_update`, the TPU's
// in-kernel form `_multicycle_kernel`, sweep.py:1952-1967): the +5% cap in
// pure T, `dt_on_even_cycles`, `cst_dt` and the ok gate.
template <typename T>
__device__ __forceinline__ DtStep<T> dt_step(const DtParams& d, T lm, T dtp, int cyc) {
  DtStep<T> r;
  if (d.cst_dt) {
    r.dt_use = r.dt_next = T(d.Dt);
    r.ok = true;
    return r;
  }
  const bool first = dtp == T(0);
  const T cand = first ? T(d.cfl) * lm : jmin(T(d.cfl) * lm, T(d.cap) * dtp);
  r.dt_next = (d.dt_on_even_cycles && !(cyc % 2 == 0 || first)) ? dtp : cand;
  r.dt_use = first ? r.dt_next : dtp;
  r.ok = isfinite(r.dt_next) && r.dt_next > T(0);
  return r;
}

// The run predicate of a cycle: (t < maxtime) & (cycle < maxcycle) & ok.
template <typename T>
__device__ __forceinline__ bool runs(const DtParams& d, T t, int cyc, bool ok) {
  return t < T(d.maxtime) && cyc < d.maxcycle && ok;
}

}  // namespace armon
