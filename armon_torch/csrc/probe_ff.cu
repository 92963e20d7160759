// The ff probe's kernels (armon_torch/probes/ff.py): the sweep chain of
// chain.cuh, out of place, in float, double and float-float.
//
// Replaces `make_pallas_f32` (scripts/ff_probe.py:389, `pl.pallas_call`
// :404) and `make_pallas_ff` (:357, `pl.pallas_call` :380). On the TPU f64
// was emulated by XLA and had no Pallas form; here it is native, at half
// the f32 rate, so the double instance is the yardstick float-float has
// to beat.
//
// Bound on this card: operations. A launch reads 4 fields and writes 4
// (f32: 32 B/cell, f64 and ff: 64 B/cell) for ~190 operations per cell in
// f32 (chain.cuh), and some 10-20x that in float-float; at 1024^2 the
// fields fit in the 50 MB L2.
//
// Design: K1's. A block of 256 threads owns a segment of one row; its 4
// outer positions on each side are read, never written (the chain's
// dependency depth is 4). A row wraps around (the script's jnp.roll over
// the full row), so every output is live. Out of place: blocks run
// concurrently, and a segment's halo is another block's output.

#include <stdint.h>

#include "chain.cuh"

namespace armon {
namespace probe {

struct ChainArgs {
  const void* src[8];  // f32/f64: rho, u, v, E; ff: rho hi, lo, u hi, lo, v hi, lo, E hi, lo
  void* dst[8];        // the same, distinct buffers
  long long rows, cols;
};

constexpr int CP = 256, CH = 4;

template <typename N> struct FieldIo {
  static __device__ __forceinline__ N load(const void* const* p, int f, long long i) {
    return reinterpret_cast<const N*>(p[f])[i];
  }
  static __device__ __forceinline__ void store(void* const* p, int f, long long i, N x) {
    reinterpret_cast<N*>(p[f])[i] = x;
  }
};
template <> struct FieldIo<FF> {
  static __device__ __forceinline__ FF load(const void* const* p, int f, long long i) {
    return {reinterpret_cast<const float*>(p[2 * f])[i],
            reinterpret_cast<const float*>(p[2 * f + 1])[i]};
  }
  static __device__ __forceinline__ void store(void* const* p, int f, long long i, FF x) {
    reinterpret_cast<float*>(p[2 * f])[i] = x.hi;
    reinterpret_cast<float*>(p[2 * f + 1])[i] = x.lo;
  }
};

template <typename N>
__global__ void __launch_bounds__(CP) chain_kernel(const ChainArgs a) {
  __shared__ N buf[2 * CHAIN_SLOTS * CP];
  const int pos = threadIdx.x;
  const long long cols = a.cols, row = blockIdx.y;
  const long long k = (long long)blockIdx.x * (CP - 2 * CH) - CH + pos;
  long long ks = k % cols;
  if (ks < 0) ks += cols;
  N in[4], out[4];
  for (int f = 0; f < 4; ++f) in[f] = FieldIo<N>::load(a.src, f, row * cols + ks);
  Shifter<N, CP, CHAIN_SLOTS> S(buf, pos);
  chain<N>(S, in[0], in[1], in[2], in[3], out);
  if (pos >= CH && pos < CP - CH && k < cols) {
    for (int f = 0; f < 4; ++f) FieldIo<N>::store(a.dst, f, row * cols + k, out[f]);
  }
}

}  // namespace probe
}  // namespace armon

// kind: 0 float, 1 double, 2 float-float. Returns 0 or an error code.
extern "C" int armon_chain(int kind, const armon::probe::ChainArgs* a, void* stream) {
  using namespace armon::probe;
  if (a->rows < 1 || a->rows > 65535 || a->cols < 2 * CH) return -2;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)((a->cols + CP - 2 * CH - 1) / (CP - 2 * CH)), (unsigned)a->rows);
  if (kind == 0)
    chain_kernel<float><<<grid, CP, 0, s>>>(*a);
  else if (kind == 1)
    chain_kernel<double><<<grid, CP, 0, s>>>(*a);
  else if (kind == 2)
    chain_kernel<FF><<<grid, CP, 0, s>>>(*a);
  else
    return -1;
  return (int)cudaGetLastError();
}
