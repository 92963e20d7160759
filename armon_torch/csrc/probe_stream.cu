// Streaming probe kernels: the X mirror fill and its copy baseline
// (armon_torch/probes/flip.py) and the I/O-shape roofline ladder
// (armon_torch/probes/roofline_io.py).
//
// `flip_kernel` replaces `kernel_mirror` (scripts/probe_flip.py:39,
// `pl.pallas_call` :54) and `kernel_copy` (:47, :71): an identity copy of
// a (rows, cols) f32 array, the first and last g columns of each row
// mirror-filled (column i <- 2g-1-i, column cols-1-i <- cols-2g+i) when
// `mirror`. Bound: bytes, 8 B per element. Design for HBM: one
// grid-stride pass over the flat array in 16-byte vectors, FLIP_UNROLL
// independent vectors per thread with every load issued before the first
// store, a block's vectors of one step contiguous, streaming (evict-first)
// loads and stores, on a grid of FLIP_BLOCKS_PER_SM blocks per SM; a
// scalar head and tail take the elements before the first 16-byte
// boundary and after the last whole vector. Each vector tracks the column
// of its first element (one division per thread, then an add and a
// compare per step), and a vector that touches the first or last g
// columns of a row (a row may begin mid-vector when cols % 4 != 0)
// gathers those elements from their source columns.
//
// `io_kernel` replaces `make_kernel` (scripts/roofline_io.py:45,
// `pl.pallas_call` :92): read rho/u/v/E, write them back IN PLACE and a
// fifth field p, with graded math per LEVEL: 0 io (x + 1, p = rho - 1),
// 1 light (~25 elementwise operations, a sqrt), 2 half (EOS, one Godunov
// solve and the Lagrangian update, 5 neighbour reads), 3 sweep (the whole
// f32 chain of chain.cuh, p from its output). Bound: bytes, 9 fields x
// 4 B per cell; LEVEL 3 is near the operation bound too.
//
// In place, as the script's aliases are (:96), so that the ladder moves
// exactly the script's bytes and footprint. With neighbour reads that
// needs an order the card's blocks do not have: a read of position k+-1
// can meet another block's write. So one block owns whole rows and walks
// each row's segments (256 positions, 4 of halo per side at LEVEL >= 2)
// left to right; a segment loads before it writes (the chain's barriers
// sit between), keeps the original values of its last 4 outputs in
// shared memory for the next segment's left halo, and the first
// segment's first 4 for the last segment's right halo (a row wraps
// around, the script's jnp.roll over full rows).

#include <stdint.h>

#include "chain.cuh"

namespace armon {
namespace probe {

constexpr int FT = 256;                // flip: threads per block
constexpr int FLIP_UNROLL = 8;         // vectors in flight per thread
constexpr int FLIP_BLOCKS_PER_SM = 8;  // blocks per SM in the grid

// The source column of column `col` (the mirror map, or col itself).
__device__ __forceinline__ long long flip_src_col(long long col, long long cols, int g) {
  if (col < g) return 2LL * g - 1 - col;
  if (col >= cols - g) return cols - 2LL * g + (cols - 1 - col);
  return col;
}

// One element at flat index e, its column `col` (the scalar head and tail).
__device__ __forceinline__ void flip_one(const float* x, float* o, long long e, long long col,
                                         long long cols, int g, int mirror) {
  o[e] = x[mirror ? e - col + flip_src_col(col, cols, g) : e];
}

// `n` elements; vectors start at flat index `head` (16-byte aligned in
// both x and o) and number `nv`. A block's FLIP_UNROLL x FT vectors of one
// step are contiguous, a thread's FT vectors apart.
__global__ void __launch_bounds__(FT) flip_kernel(const float* __restrict__ x,
                                                  float* __restrict__ o, long long n,
                                                  long long cols, int g, int mirror,
                                                  long long head, long long nv) {
  constexpr int U = FLIP_UNROLL;
  const long long tid = (long long)blockIdx.x * FT + threadIdx.x;
  const long long stride = (long long)gridDim.x * FT;
  const long long v0 = (long long)blockIdx.x * U * FT + threadIdx.x;
  const long long is = U * stride;  // vectors per step of the grid
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  float4* ov = reinterpret_cast<float4*>(o + head);
  // Column of each in-flight vector's first element, and its step per
  // iteration, both reduced mod cols.
  long long col[U];
#pragma unroll
  for (int k = 0; k < U; ++k) col[k] = (head + 4 * (v0 + k * FT)) % cols;
  const long long step = (4 * is) % cols;
  for (long long v = v0; v < nv; v += is) {
    float4 a[U];
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (v + k * FT < nv) a[k] = __ldcs(xv + v + k * FT);
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long vk = v + k * FT;
      if (mirror && vk < nv && (col[k] < g || col[k] + 3 >= cols - g)) {
        float* el = reinterpret_cast<float*>(&a[k]);
        const long long e0 = head + 4 * vk;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          long long c = col[k] + i, rs = e0 - col[k];  // column, row start
          if (c >= cols) c -= cols, rs += cols;       // the next row
          if (c < g || c >= cols - g) el[i] = x[rs + flip_src_col(c, cols, g)];
        }
      }
      col[k] += step;
      if (col[k] >= cols) col[k] -= cols;
    }
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (v + k * FT < nv) __stcs(ov + v + k * FT, a[k]);
  }
  // The scalar head [0, head) and tail [head + 4 nv, n): fewer than 4
  // elements each, or every element where the launcher found no vectors.
  const long long ns = n - 4 * nv;
  for (long long s = tid; s < ns; s += stride) {
    const long long e = s < head ? s : s + 4 * nv;
    flip_one(x, o, e, e % cols, cols, g, mirror);
  }
}

struct IoArgs {
  void* f[4];  // rho, u, v, E: read, and written in place
  void* p;     // the fifth output
  long long rows, cols;
};

constexpr int IOP = 256;  // positions per segment (threads per block)
constexpr int IO_IO = 0, IO_LIGHT = 1, IO_HALF = 2, IO_SWEEP = 3;

template <int LEVEL, class SH>
__device__ __forceinline__ void io_math(SH& S, const float in[4], float out[5]) {
  const float rr = in[0], uu = in[1], vv = in[2], EE = in[3];
  if constexpr (LEVEL == IO_IO) {
    out[0] = rr + 1.0f, out[1] = uu + 1.0f, out[2] = vv + 1.0f, out[3] = EE + 1.0f;
    out[4] = rr - 1.0f;
  } else if constexpr (LEVEL == IO_LIGHT) {
    const float e = EE - 0.5f * (uu * uu + vv * vv);
    const float p = 0.4f * rr * e;
    const float c = __fsqrt_rn(1.4f * p * rr);
    const float q = p * c + e;
    out[0] = rr + 1e-7f * q, out[1] = uu + 1e-7f * (p - c), out[2] = vv + 1e-7f * (p + c);
    out[3] = EE + 1e-7f * (q - p), out[4] = p;
  } else if constexpr (LEVEL == IO_HALF) {
    const float e = EE - 0.5f * (uu * uu + vv * vv);
    const float p = 0.4f * rr * e;
    const float c = __fsqrt_rn(1.4f * p * rr);
    const float rc = rr * c;
    S.put(0, rc), S.put(1, uu), S.put(2, p);
    S.sync();
    const float rc_l = S.get(0, -1), u_m = S.get(1, -1), p_m = S.get(2, -1);
    const float rc_sum = rc_l + rc;
    const float us = __fdiv_rn(rc_l * u_m + rc * uu + (p_m - p), rc_sum);
    const float ps = __fdiv_rn(rc * p_m + rc_l * p + rc_l * rc * (u_m - uu), rc_sum);
    S.put(0, us), S.put(1, ps);
    S.sync();
    const float us_p = S.get(0, 1), ps_p = S.get(1, 1);
    const float dx = float(1.0 / 8192.0), dt = float(1e-4);
    const float dm = rr * dx;
    const float dX = dx + dt * (us_p - us);
    const float dt_dm = __fdiv_rn(dt, dm);
    out[0] = __fdiv_rn(dm, dX), out[1] = uu + dt_dm * (ps - ps_p), out[2] = vv;
    out[3] = EE + dt_dm * (ps * us - ps_p * us_p), out[4] = p;
  } else {
    chain<float>(S, rr, uu, vv, EE, out);
    out[4] = 0.4f * out[0] * (out[3] - 0.5f * (out[1] * out[1] + out[2] * out[2]));
  }
}

template <int LEVEL>
__global__ void __launch_bounds__(IOP) io_kernel(const IoArgs a) {
  constexpr int H = LEVEL >= IO_HALF ? 4 : 0;
  constexpr int R = IOP - 2 * H;
  constexpr int HS = H ? H : 1;
  __shared__ float buf[LEVEL >= IO_HALF ? 2 * CHAIN_SLOTS * IOP : 1];
  __shared__ float carry[4][HS], head[4][HS];
  const int pos = threadIdx.x;
  const long long cols = a.cols;
  float* F[4];
  for (int f = 0; f < 4; ++f) F[f] = reinterpret_cast<float*>(a.f[f]);
  float* P = reinterpret_cast<float*>(a.p);
  const long long nseg = (cols + R - 1) / R;
  for (long long row = blockIdx.x; row < a.rows; row += gridDim.x) {
    const long long base = row * cols;
    for (long long s = 0; s < nseg; ++s) {
      const long long k = s * R - H + pos;
      float in[4];
      if (H && s > 0 && pos < H) {  // left halo: the previous segment's originals
        for (int f = 0; f < 4; ++f) in[f] = carry[f][pos];
      } else if (H && s > 0 && k >= cols) {  // wrapped right halo: the row's first originals
        const long long w = k - cols < H ? k - cols : H - 1;
        for (int f = 0; f < 4; ++f) in[f] = head[f][w];
      } else {
        long long ks = k < 0 ? k + cols : (k >= cols ? k - cols : k);
        ks = ks < 0 ? 0 : (ks >= cols ? cols - 1 : ks);
        for (int f = 0; f < 4; ++f) in[f] = F[f][base + ks];
      }
      Shifter<float, IOP, CHAIN_SLOTS> S(buf, pos);
      float out[5];
      io_math<LEVEL>(S, in, out);  // at LEVEL >= 2 every load precedes its barriers
      if constexpr (H > 0) {
        if (s == 0 && pos >= H && pos < 2 * H) {
          for (int f = 0; f < 4; ++f) head[f][pos - H] = in[f];
        }
        if (pos >= R && pos < R + H) {
          for (int f = 0; f < 4; ++f) carry[f][pos - R] = in[f];
        }
      }
      if (pos >= H && pos < IOP - H && k < cols) {
        const long long o = base + k;
        for (int f = 0; f < 4; ++f) F[f][o] = out[f];
        P[o] = out[4];
      }
      if constexpr (H > 0) __syncthreads();  // carry / head before the next loads
    }
  }
}

}  // namespace probe
}  // namespace armon

extern "C" int armon_flip(int mirror, const void* x, void* o, long long rows, long long cols,
                          int g, void* stream) {
  using namespace armon::probe;
  if (rows < 1 || cols < 2LL * g || g < 0) return -2;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n = rows * cols;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), oa = reinterpret_cast<uintptr_t>(o);
  long long head = n, nv = 0;  // all scalar unless x and o align alike
  if ((xa - oa) % 16 == 0 && xa % 4 == 0 && cols >= 4) {
    head = (long long)((16 - xa % 16) % 16) / 4;
    if (head > n) head = n;
    nv = (n - head) / 4;
  }
  // Up to FLIP_BLOCKS_PER_SM blocks per SM, no more than one step of the
  // pass needs: a small array launches few threads (each begins with
  // divides).
  const long long per_block = nv ? (long long)FLIP_UNROLL * FT : FT;
  const long long need = ((nv ? nv : n) + per_block - 1) / per_block;
  const long long most = (long long)sms * FLIP_BLOCKS_PER_SM;
  const long long blocks = need < 1 ? 1 : (need < most ? need : most);
  flip_kernel<<<(unsigned)blocks, FT, 0, s>>>(
      reinterpret_cast<const float*>(x), reinterpret_cast<float*>(o), n, cols, g, mirror, head,
      nv);
  return (int)cudaGetLastError();
}

extern "C" int armon_io_ladder(int level, const armon::probe::IoArgs* a, void* stream) {
  using namespace armon::probe;
  if (a->rows < 1 || a->cols < 8) return -2;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)(a->rows < 2147483647LL ? a->rows : 2147483647LL);
  switch (level) {
    case IO_IO: io_kernel<IO_IO><<<grid, IOP, 0, s>>>(*a); break;
    case IO_LIGHT: io_kernel<IO_LIGHT><<<grid, IOP, 0, s>>>(*a); break;
    case IO_HALF: io_kernel<IO_HALF><<<grid, IOP, 0, s>>>(*a); break;
    case IO_SWEEP: io_kernel<IO_SWEEP><<<grid, IOP, 0, s>>>(*a); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
