// Device helpers shared by every kernel of the port: NaN-propagating
// min/max/sign, the dt recurrence, K3's fold and scalar step, which K3
// (cfl.cu) and the tail of K1, K2 and K4's emitting launches (`cfl_tail`)
// share, and the whole-run graph's WHILE condition (`set_while`), which
// that tail and K5 set.

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
// One rounding of a * b + c: the contraction the JAX package's XLA program
// makes (`armon_torch/ops/fma.py`), where the kernels make it and nowhere
// else (the libraries are built with -fmad=false).
__device__ __forceinline__ float fmadd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fmadd(double a, double b, double c) { return __fma_rn(a, b, c); }

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

// K3's scalar half, run by one thread: lm from the folded maxima (when
// `fold`), then, with `step`, the run predicate and one step of the
// recurrence. scal = [t, dt_prev, lm, dt_use], iscal = [cycle, ok, run,
// next].
template <typename T>
__device__ __forceinline__ void cfl_scalars(const DtParams& d, double dx, double dy, T* scal,
                                            int* iscal, bool fold, bool step, T mx, T my) {
  if (fold) scal[2] = jmin(T(dx) / mx, T(dy) / my);
  if (!step) return;
  const T t = scal[0];
  const int cyc = iscal[0];
  const bool run = runs(d, t, cyc, iscal[1] != 0);
  if (run) {
    const DtStep<T> r = dt_step(d, scal[2], scal[1], cyc);
    scal[3] = r.dt_use;
    scal[0] = t + r.dt_use;
    scal[1] = r.dt_next;
    iscal[0] = cyc + 1;
    iscal[1] = r.ok ? 1 : 0;
  }
  iscal[2] = run ? 1 : 0;
  iscal[3] = runs(d, scal[0], iscal[0], iscal[1] != 0) ? 1 : 0;
}

// K3's block of threads (cfl.cu): its fold's order.
constexpr int CFL_NT = 1024;

// The fold of n CFL partial pairs (rows `stride` apart) in K3's order:
// each of CFL_NT threads v takes jmax from 0 over partials v, v + CFL_NT,
// ..., then a halving tree (v takes v + w, w = CFL_NT/2 ... 1). K3 runs it
// with NT = CFL_NT; a finishing launch's block of NT threads (NT divides
// CFL_NT) runs the same operations in the same order,
// thread t in K3's threads t + j NT: the first levels of the tree in its
// registers, the last log2(NT) in `red` (2 NT words of shared memory), so
// the pair in thread 0 has K3's bits for any partials, NaN payloads and
// signed zeros included. Partials other blocks wrote in this launch are
// read from L2 (__ldcg). Every thread of the block must call it.
template <typename T, int NT>
__device__ __forceinline__ void fold_partials(const T* part, long long stride, long long n,
                                              T* red, T& mx, T& my) {
  static_assert(CFL_NT % NT == 0, "the block must divide K3's threads");
  constexpr int V = CFL_NT / NT;
  const int tid = threadIdx.x;
  T ax[V], ay[V];
#pragma unroll
  for (int j = 0; j < V; ++j) ax[j] = ay[j] = T(0);  // the TPU's zero-initialised max block
#pragma unroll 2
  for (long long base = tid; base < n; base += CFL_NT) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long i = base + (long long)j * NT;
      if (i < n) {
        ax[j] = jmax(ax[j], __ldcg(part + i));
        ay[j] = jmax(ay[j], __ldcg(part + stride + i));
      }
    }
  }
#pragma unroll
  for (int w = V / 2; w > 0; w /= 2) {
#pragma unroll
    for (int j = 0; j < w; ++j) ax[j] = jmax(ax[j], ax[j + w]), ay[j] = jmax(ay[j], ay[j + w]);
  }
  red[tid] = ax[0];
  red[NT + tid] = ay[0];
  __syncthreads();
  for (int w = NT / 2; w > 0; w >>= 1) {
    if (tid < w) {
      red[tid] = jmax(red[tid], red[tid + w]);
      red[NT + tid] = jmax(red[NT + tid], red[NT + tid + w]);
    }
    __syncthreads();
  }
  mx = red[0];
  my = red[NT];
}

// The WHILE condition of a whole-run graph (graph.cu), set by the last
// launch of its body, in the thread that has just written the predicate
// `go`: add 1 to the iteration count, then set the condition from `go`.
// `cond` 0 (every other launch: eager, window graphs, a body's earlier
// steps) sets nothing.
__device__ __forceinline__ void set_while(cudaGraphConditionalHandle cond, int* count,
                                          bool go) {
  if (cond == 0) return;
  *count += 1;
  cudaGraphSetConditional(cond, go ? 1u : 0u);
}

// What the tail of an emitting launch needs to do K3's work (`cfl_tail`).
struct FinishArgs {
  const void* partials;   // (2, stride) CFL maxima: every block's, every shard's
  void* scal;             // T[4]: t, dt_prev, lm, dt_use
  void* iscal;            // int32[4]: cycle, ok, run, next
  unsigned* ticket;       // blocks done in this launch; 0 between launches
  long long stride, n;    // row stride of `partials`; columns [0, n) fold
  DtParams dt;
  double dx, dy;          // rounded to T
  cudaGraphConditionalHandle cond;  // the body's last launch: its WHILE condition; else 0
  int* count;             // with `cond`: the WHILE's iteration count
};

// One ticket of a finishing launch: an atomic add with release semantics
// (this thread's earlier writes, its block's CFL pair among them, are
// visible before the ticket) and acquire semantics (the last block sees
// every block's pair), cheaper than a sequentially consistent fence.
__device__ __forceinline__ unsigned take_ticket(unsigned* ticket) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(old) : "l"(ticket) : "memory");
  return old;
}

// K3 `cfl_finish` (fold, step) in the tail of an emitting launch. No block
// may read the loop scalars after the last one steps them, so every
// thread of a block must be done with them before its thread 0 takes the
// block's ticket: SYNCED says a block barrier already follows the last
// read (the emitting paths), else the tail adds one (the copy paths).
// Thread 0, its CFL pair stored, takes the ticket; the block that draws
// the last one folds all n partials in K3's order (`fold_partials`; this
// launch's, and on a one-card mesh the earlier shards', which stream
// order wrote before), when the cycle that wrote them ran (iscal[run]),
// and its thread 0 runs K3's scalar step and resets the ticket. The
// result does not depend on the order in which blocks finish. A block
// that copies (iscal[run] is 0) takes its ticket too. In the last launch
// of a whole-run graph's body, that thread 0 then sets the WHILE condition
// from iscal[run], the next cycle's predicate (`set_while`). `red`: 2 NT
// words of shared memory the block no longer uses. Every thread of the
// block must call it.
template <typename T, int NT, bool SYNCED>
__device__ __forceinline__ void cfl_tail(const FinishArgs& f, T* red) {
  int* iscal = reinterpret_cast<int*>(f.iscal);
  const bool fold = iscal[2] != 0;  // read before the barrier below
  if constexpr (!SYNCED) __syncthreads();
  bool last = false;
  if (threadIdx.x == 0) last = take_ticket(f.ticket) == gridDim.x * gridDim.y - 1;
  if (!__syncthreads_or(last)) return;
  T mx = T(0), my = T(0);
  if (fold) fold_partials<T, NT>(reinterpret_cast<const T*>(f.partials), f.stride, f.n, red, mx, my);
  if (threadIdx.x != 0) return;
  cfl_scalars<T>(f.dt, f.dx, f.dy, reinterpret_cast<T*>(f.scal), iscal, fold, true, mx, my);
  *f.ticket = 0u;
  set_while(f.cond, f.count, iscal[2] != 0);
}

}  // namespace armon
