// Per-operation-class rate kernels of the roofline probe
// (armon_torch/probes/roofline.py).
//
// Replaces `_rate_kernel` (scripts/roofline.py:127, run by `measure_class`
// :139, `pl.pallas_call` :151): every element of an f32 array runs 16
// independent chains (ILP 16) of one operation class, W0 = 128 chain
// steps per repetition, and writes the chains' sum. The script's classes
// (:184-221) with the card's own forms: exact divide and square root are
// the IEEE-rounded `__fdiv_rn` / `__fsqrt_rn`, the approximate reciprocal
// is the port's `rcp_approx` (sweep.cuh), `fma` is named apart from
// `mul+add` (the libraries are built with -fmad=false, so mul+add stays
// two instructions), and the TPU's lane and sublane rolls become the two
// neighbour reads a kernel here has: through shared memory behind a
// barrier (the form of `sweep_body`, one barrier per step of the 16
// chains) and `__shfl_sync` within a warp.
//
// Against folding: every step's operand is its own accumulator (the
// script's roll chains read a loop-invariant input, which its note warns
// a compiler may collapse; here a shift class reads the shifted
// accumulator: a + roll(a, s), s = 1 + i mod 3), each step's constant is
// a literal of its unrolled position, and float arithmetic is not
// reassociated. The repetition count is a runtime argument, so the
// probe times two counts and takes the difference: that cancels the
// array's read and write and the launch, and leaves the chains.
//
// Bound on this card: operations, by construction (128 steps per element
// and repetition against 8 B of I/O per element).

#include <stdint.h>

#include "sweep.cuh"

namespace armon {
namespace probe {

enum RateClass {
  RC_NONE = 0, RC_ADD, RC_MUL, RC_FMA, RC_MUL_ADD, RC_MIN, RC_SELECT, RC_ABS_ADD,
  RC_SQRT, RC_DIV, RC_RCP, RC_SMEM, RC_SHFL, RC_COUNT
};
constexpr int RT = 256, ILP = 16, W0 = 128;

// One step of class C at chain position i (the script's `body_fn(a, x, i)`);
// `nbr` is the shifted accumulator of the shift classes.
template <int C>
__device__ __forceinline__ float step(float a, float x, int i, float nbr) {
  if constexpr (C == RC_ADD) return a + x;
  if constexpr (C == RC_MUL) return a * 1.0000001f;
  if constexpr (C == RC_FMA) return __fmaf_rn(a, 1.0000001f, x);
  if constexpr (C == RC_MUL_ADD) return a * 1.0000001f + x;
  if constexpr (C == RC_MIN) return jmin(a, x * float(1.0 + i));
  if constexpr (C == RC_SELECT) return a > x * float(0.5 + 0.01 * i) ? a * 0.9999f : a;
  if constexpr (C == RC_ABS_ADD) return fabsf(a) + x;
  if constexpr (C == RC_SQRT) return __fsqrt_rn(a) + x;
  if constexpr (C == RC_DIV) return __fdiv_rn(x, a);
  if constexpr (C == RC_RCP) return rcp_approx(a) + x;
  if constexpr (C == RC_SMEM || C == RC_SHFL) return a + nbr;
  return a;  // RC_NONE: the I/O and launch alone
}

template <int C>
__global__ void __launch_bounds__(RT) rate_kernel(const float* x, float* out, int reps) {
  __shared__ float sm[C == RC_SMEM ? 2 * ILP * RT : 1];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long e = (long long)blockIdx.x * RT + tid;
  const float xv = x[e];
  float acc[ILP];
#pragma unroll
  for (int j = 0; j < ILP; ++j) acc[j] = xv * (1.0f + 0.25f * j);
  int bank = 0;
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int i = 0; i < W0 / ILP; ++i) {
      if constexpr (C == RC_SMEM) {
#pragma unroll
        for (int j = 0; j < ILP; ++j) sm[(bank * ILP + j) * RT + tid] = acc[j];
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < ILP; ++j) {
        const int s = 1 + (i * ILP + j) % 3;  // roll(a, s): the value of position - s
        float nbr = 0.0f;
        if constexpr (C == RC_SMEM) nbr = sm[(bank * ILP + j) * RT + ((tid - s) & (RT - 1))];
        if constexpr (C == RC_SHFL) nbr = __shfl_sync(0xffffffffu, acc[j], (lane - s) & 31);
        acc[j] = step<C>(acc[j], xv, i * ILP + j, nbr);
      }
      bank ^= 1;
    }
  }
  float sum = acc[0];
#pragma unroll
  for (int j = 1; j < ILP; ++j) sum = sum + acc[j];
  out[e] = sum;
}

template <int C>
int launch_rate(const float* x, float* out, long long n, int reps, cudaStream_t s) {
  rate_kernel<C><<<(unsigned)(n / RT), RT, 0, s>>>(x, out, reps);
  return (int)cudaGetLastError();
}

}  // namespace probe
}  // namespace armon

// n: elements, a multiple of 256. Returns 0 or an error code.
extern "C" int armon_rate(int cls, const void* x, void* out, long long n, int reps, void* stream) {
  using namespace armon::probe;
  if (n < RT || n % RT || n / RT > 2147483647LL || reps < 0) return -2;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* xi = reinterpret_cast<const float*>(x);
  float* o = reinterpret_cast<float*>(out);
  switch (cls) {
    case RC_NONE: return launch_rate<RC_NONE>(xi, o, n, reps, s);
    case RC_ADD: return launch_rate<RC_ADD>(xi, o, n, reps, s);
    case RC_MUL: return launch_rate<RC_MUL>(xi, o, n, reps, s);
    case RC_FMA: return launch_rate<RC_FMA>(xi, o, n, reps, s);
    case RC_MUL_ADD: return launch_rate<RC_MUL_ADD>(xi, o, n, reps, s);
    case RC_MIN: return launch_rate<RC_MIN>(xi, o, n, reps, s);
    case RC_SELECT: return launch_rate<RC_SELECT>(xi, o, n, reps, s);
    case RC_ABS_ADD: return launch_rate<RC_ABS_ADD>(xi, o, n, reps, s);
    case RC_SQRT: return launch_rate<RC_SQRT>(xi, o, n, reps, s);
    case RC_DIV: return launch_rate<RC_DIV>(xi, o, n, reps, s);
    case RC_RCP: return launch_rate<RC_RCP>(xi, o, n, reps, s);
    case RC_SMEM: return launch_rate<RC_SMEM>(xi, o, n, reps, s);
    case RC_SHFL: return launch_rate<RC_SHFL>(xi, o, n, reps, s);
    default: return -1;
  }
}
