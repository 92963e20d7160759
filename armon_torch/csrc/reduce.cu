// K6 `ff_sum`: the f32 conservation sums of one shard, mass and energy,
// as compensated (Knuth 2Sum) pairs, in one launch.
//
// No TPU kernel: this is the port of the `lax.scan` of the JAX package's
// `_ff_sum` (armon_tpu/ops/reductions.py:108-130), which its
// `conservation_vars` runs in f32 inside one jitted program a call
// (armon_tpu/core/solver.py:282-323). It computes the same function in
// the same order, so its four values are bit for bit those of the plain
// version (`ops/reductions._ff_sum`):
//   stage 1, per real row r: (hi_r, lo_r) from (0, 0) by 2Sum over the
//     columns c = 0 .. nx-1 in order, of rho[g+r, g+c] for mass and of the
//     rounded product rho * E for energy;
//   stage 2: (h, l) from (0, 0) by 2Sum over hi_r in row order, and
//     L = sum(lo_r), sequential in row order from 0 in f32; the result is
//     (h, l + L).
// Every add, subtract and multiply is an explicitly rounded intrinsic
// (and the build passes -fmad=false), so nothing is fused or reordered.
//
// Bound on this card: bytes, 2 x nx x ny x 4 read once (0.160 ms at
// 8192^2 at 3.35 TB/s). The order leaves only the rows as parallelism:
// a lane owns a row and walks its columns. A warp reading one column of
// its 32 rows would touch 32 rows a load, so each one-warp block stages
// tiles of 32 rows x FF_TC columns of rho and E through shared memory
// with 4-byte cp.async copies (a lane a column: coalesced), a ring of
// FF_STAGES tiles so that three are in flight while one is summed, rows
// padded to FF_TC + 1 words so that the lanes' row reads hit 32 banks.
// Stage 2 runs in the same launch, in the block that takes the last
// ticket (as `cfl_tail` in common.cuh does): lanes 0-3 each scan one of
// the four per-row arrays (hi_m, lo_m, hi_e, lo_e), staged through the
// same shared memory; for the lo arrays the 2Sum's rounded sum is the
// sequential f32 sum. That block resets the ticket, so the next launch
// starts from 0. Stage 2 is a dependent chain a row on one warp, after
// every block is done: `chip_smoke.py` phase 17 (b) times it nearly
// alone, on a block of one column.
//
// Every entry point returns the CUDA error code (0 on success), or a
// negative code for arguments the launcher rejects.

#include <cuda_pipeline.h>

#include "common.cuh"

namespace armon {

struct FfSumArgs {
  const float* rho;   // padded (rows, cols) block, row-major
  const float* E;     // the same shape
  float* rows;        // (4, ny) scratch: hi_m, lo_m, hi_e, lo_e per real row
  float* out;         // [4]: h_m, l_m + L_m, h_e, l_e + L_e
  unsigned* ticket;   // blocks done in this launch; 0 between launches
  long long cols;     // row stride of rho and E
  int g, nx, ny;      // ghost width and real extent
};

constexpr int FF_ROWS = 32;              // rows a block: one warp, a lane a row
constexpr int FF_TC = 32;                // columns a tile
constexpr int FF_PITCH = FF_TC + 1;      // shared words a tile row
constexpr int FF_STAGES = 4;             // tiles in the ring
constexpr int FF_TILE = FF_ROWS * FF_PITCH;
constexpr int FF_SMEM = FF_STAGES * 2 * FF_TILE;  // floats: 33,792 bytes
constexpr int FF_CHUNK = FF_SMEM / 4 - 2;         // stage 2's rows a pass
constexpr int FF_CPITCH = FF_CHUNK + 1;           // odd: lanes 0-3 on 4 banks
constexpr unsigned FULL = 0xffffffffu;

// Knuth 2Sum of (hi, lo) and b, in the order of the JAX package's scan.
__device__ __forceinline__ void two_sum(float& hi, float& lo, float b) {
  const float t = __fadd_rn(hi, b);
  const float bp = __fsub_rn(t, hi);
  const float err = __fadd_rn(__fsub_rn(hi, __fsub_rn(t, bp)), __fsub_rn(b, bp));
  hi = t;
  lo = __fadd_rn(lo, err);
}

__global__ void __launch_bounds__(FF_ROWS) ff_sum_kernel(const FfSumArgs a) {
  __shared__ float smem[FF_SMEM];
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * FF_ROWS;
  const int nrows = min(FF_ROWS, a.ny - r0);
  const int ntiles = (a.nx + FF_TC - 1) / FF_TC;
  const long long origin = (long long)(a.g + r0) * a.cols + a.g;
  const float* rho = a.rho + origin;
  const float* E = a.E + origin;

  // Tile t's copies into its stage, one commit group a tile (empty past
  // the last tile, so that the group count stays one a tile).
  auto load = [&](int t) {
    const int c = t * FF_TC + lane;
    if (t < ntiles && c < a.nx) {
      float* sr = smem + (t % FF_STAGES) * 2 * FF_TILE + lane;
      float* se = sr + FF_TILE;
      for (int i = 0; i < nrows; ++i) {
        __pipeline_memcpy_async(sr + i * FF_PITCH, rho + i * a.cols + c, 4);
        __pipeline_memcpy_async(se + i * FF_PITCH, E + i * a.cols + c, 4);
      }
    }
    __pipeline_commit();
  };

  for (int t = 0; t < FF_STAGES - 1; ++t) load(t);
  float mh = 0.f, ml = 0.f, eh = 0.f, el = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    load(t + FF_STAGES - 1);  // into the stage the last pass emptied
    __pipeline_wait_prior(FF_STAGES - 1);
    __syncwarp();
    if (lane < nrows) {
      const float* sr = smem + (t % FF_STAGES) * 2 * FF_TILE + lane * FF_PITCH;
      const float* se = sr + FF_TILE;
      const int n = min(FF_TC, a.nx - t * FF_TC);
      if (n == FF_TC) {
#pragma unroll
        for (int j = 0; j < FF_TC; ++j) {
          const float b = sr[j];
          two_sum(mh, ml, b);
          two_sum(eh, el, __fmul_rn(b, se[j]));
        }
      } else {
        for (int j = 0; j < n; ++j) {
          const float b = sr[j];
          two_sum(mh, ml, b);
          two_sum(eh, el, __fmul_rn(b, se[j]));
        }
      }
    }
    __syncwarp();  // every lane is done with the stage before its refill
  }
  __pipeline_wait_prior(0);

  if (lane < nrows) {
    const int r = r0 + lane;
    a.rows[r] = mh;
    a.rows[a.ny + r] = ml;
    a.rows[2 * a.ny + r] = eh;
    a.rows[3 * a.ny + r] = el;
  }
  __threadfence();
  __syncwarp();
  unsigned last = 0;
  if (lane == 0) last = take_ticket(a.ticket) == gridDim.x - 1;
  if (!__shfl_sync(FULL, last, 0)) return;

  // Stage 2, in the block that finished last: lane k scans array k.
  float h = 0.f, l = 0.f;
  for (int base = 0; base < a.ny; base += FF_CHUNK) {
    const int n = min(FF_CHUNK, a.ny - base);
    __syncwarp();
    for (int k = 0; k < 4; ++k)
      for (int i = lane; i < n; i += FF_ROWS)
        smem[k * FF_CPITCH + i] = __ldcg(a.rows + (long long)k * a.ny + base + i);
    __syncwarp();
    if (lane < 4) {
      const float* v = smem + lane * FF_CPITCH;
#pragma unroll 8
      for (int i = 0; i < n; ++i) two_sum(h, l, v[i]);
    }
  }
  const float lm = __shfl_sync(FULL, h, 1);  // L_m: lane 1's sequential sum
  const float le = __shfl_sync(FULL, h, 3);  // L_e
  const float he = __shfl_sync(FULL, h, 2);
  const float lo_e = __shfl_sync(FULL, l, 2);
  if (lane == 0) {
    a.out[0] = h;
    a.out[1] = __fadd_rn(l, lm);
    a.out[2] = he;
    a.out[3] = __fadd_rn(lo_e, le);
    *a.ticket = 0u;
  }
}

}  // namespace armon

extern "C" int armon_ff_sum(const armon::FfSumArgs* a, void* stream) {
  if (a->nx < 1 || a->ny < 1 || a->g < 0 || a->cols < a->g + a->nx) return -3;
  const int blocks = (a->ny + armon::FF_ROWS - 1) / armon::FF_ROWS;
  armon::ff_sum_kernel<<<blocks, armon::FF_ROWS, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}
