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
// 8192^2 at 3.35 TB/s), or on small blocks the chain of nx + ny dependent
// adds the order keeps. The order leaves only the rows, and the two
// fields of a row, as parallelism, so:
// - a lane owns one (row, field): lanes 0-15 of a warp sum mass and lanes
//   16-31 energy over the same 16 rows. A mass lane multiplies its value
//   by an exact 1.0f (the identity on every float without -ftz: NaN stays
//   NaN, infinities and subnormals pass), read from a row of ones in
//   shared memory, so both halves run one instruction stream. A block is
//   one warp: 8192 rows are 512 blocks, at most 4 an SM on 132 SMs in one
//   wave (shared memory admits 8), and no block waits on another warp.
// - the tiles of 16 rows x FF_TC columns of rho and E reach shared memory
//   by TMA (`cp.async.bulk.tensor.2d`, issued by lane 0, completing on an
//   mbarrier a stage), 128-byte swizzled boxes of 32 columns, a ring of
//   FF_STAGES tiles of 8 KB: 16 KB in flight a block while one tile is
//   summed, 64 KB an SM at 8192 rows.
//   A lane reads four columns of its row at once (16 bytes); the swizzle
//   puts the eight rows of each quarter-warp on eight distinct 16-byte
//   chunks, so the reads are free of bank conflicts. TMA needs a 16-byte
//   aligned base and row stride, and a box's first column on a 16-byte
//   boundary (the card refused a box at column 5): the tiles start at
//   the boundary at or before the first real column, and the first tile
//   skips g % 4 columns. A block whose stride or base is not aligned
//   (cols % 4 != 0: 37x129 in the tests) takes the kernel's second load
//   path, 4-byte `cp.async` by every lane into the same swizzled layout
//   (`ops/reductions.ff_load_path` picks it on the host).
// - stage 2 runs in the same launch, in the block that takes the last
//   ticket (as `cfl_tail` in common.cuh does), which resets it: the one
//   warp scans the four per-row arrays (hi_m, lo_m, hi_e, lo_e) at once
//   (`scan_rows`). The 2Sum is split so that a row's only waits are the
//   add on h and the add on l: the chain h += b walks the rows, the error
//   terms, which need only the h before each row, are computed 8 rows at
//   once on 8 lanes, and the chain l += err runs beside the next chunk's
//   h chain. On this card the scan still takes about 18 cycles a row
//   (one column of 8192 rows, `tools/kernel_cmp.py --only k6`), against
//   about 22 for a lane doing each row's whole 2Sum (the design before
//   this one) and the 4 of one add's latency.
// `chip_smoke.py` phase 17 (b) times it at three sizes, and stage 2 nearly
// alone on a block of one column.
//
// Every entry point returns the CUDA error code (0 on success), or a
// negative code for arguments the launcher rejects.

#include <cuda.h>
#include <cuda_pipeline.h>
#include <stdint.h>
#include <string.h>

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

// The TMA descriptors of rho and E (encoded on the host by
// `armon_ff_sum_maps`, kept there by the shard's scratch).
struct FfMaps {
  CUtensorMap rho, E;
};

constexpr int FF_ROWS = 16;                  // rows a block: a lane a (row, field)
constexpr int FF_BOX = 32;                   // columns a box: 128 bytes, the swizzle span
constexpr int FF_BOXES = 2;                  // boxes a field a tile
constexpr int FF_TC = FF_BOX * FF_BOXES;     // columns a tile
constexpr int FF_STAGES = 3;                 // tiles in the ring
constexpr int FF_BOX_F = FF_ROWS * FF_BOX;   // floats a box (2 KB)
constexpr int FF_STAGE_F = 2 * FF_BOXES * FF_BOX_F;  // rho boxes, then E's
constexpr int FF_STAGE_BYTES = FF_STAGE_F * 4;       // 8 KB
constexpr int FF_ONES = FF_STAGES * FF_STAGE_F;      // float offset of the ones row
constexpr int FF_BARS_BYTES = (FF_ONES + FF_BOX) * 4;  // byte offset of the mbarriers
constexpr int FF_SMEM = FF_BARS_BYTES + 8 * FF_STAGES + 1024;  // + alignment slack
constexpr int FF_CHUNK = 32;                 // stage 2's rows a step: 4 slices of 8
constexpr unsigned FULL = 0xffffffffu;

static_assert(FF_SMEM <= 48 * 1024, "K6 runs without the dynamic shared memory attribute");

// Knuth 2Sum of (hi, lo) and b, in the order of the JAX package's scan.
__device__ __forceinline__ void two_sum(float& hi, float& lo, float b) {
  const float t = __fadd_rn(hi, b);
  const float bp = __fsub_rn(t, hi);
  const float err = __fadd_rn(__fsub_rn(hi, __fsub_rn(t, bp)), __fsub_rn(b, bp));
  hi = t;
  lo = __fadd_rn(lo, err);
}

// The error term of 2Sum(h, b), (h + b) - fl(h + b), by 2Sum's operations.
__device__ __forceinline__ float two_sum_err(float h, float b) {
  const float t = __fadd_rn(h, b);
  const float bp = __fsub_rn(t, h);
  return __fadd_rn(__fsub_rn(h, __fsub_rn(t, bp)), __fsub_rn(b, bp));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity` of the mbarrier at `bar`. A copy
// that never lands (a descriptor the card refuses) traps after about 8 s
// instead of hanging the launch.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// Offset (floats) of column c (0 .. FF_BOX-1) within a box row whose row
// index is r7 modulo 8, in TMA's 128-byte swizzle: 16-byte chunk k of a
// row sits at k ^ r7.
__device__ __forceinline__ int swz(int r7, int c) {
  return (((c >> 2) ^ r7) << 2) | (c & 3);
}

// One lane's sums over columns [c0, c1) of a tile (all of it where
// FULL_TILE): x its row of rho's boxes, v its row of E's boxes (or the
// ones row, vbox 0), r7 = row & 7.
template <bool FULL_TILE>
__device__ __forceinline__ void sum_tile(const float* x, const float* v, int vbox,
                                         int r7, int c0, int c1, float& hi, float& lo) {
  if constexpr (FULL_TILE) {
#pragma unroll
    for (int b = 0; b < FF_BOXES; ++b) {
#pragma unroll
      for (int k = 0; k < FF_BOX / 4; ++k) {
        const int s = swz(r7, 4 * k);
        const float4 xs = *reinterpret_cast<const float4*>(x + b * FF_BOX_F + s);
        const float4 vs = *reinterpret_cast<const float4*>(v + b * vbox + s);
        two_sum(hi, lo, __fmul_rn(xs.x, vs.x));
        two_sum(hi, lo, __fmul_rn(xs.y, vs.y));
        two_sum(hi, lo, __fmul_rn(xs.z, vs.z));
        two_sum(hi, lo, __fmul_rn(xs.w, vs.w));
      }
    }
  } else {
    for (int c = c0; c < c1; ++c) {
      const int s = swz(r7, c % FF_BOX), b = c / FF_BOX;
      two_sum(hi, lo, __fmul_rn(x[b * FF_BOX_F + s], v[b * vbox + s]));
    }
  }
}

// Stage 1 for one warp: the (hi, lo) of its rows r0 .. r0 + nrows - 1
// into a.rows, tiles streamed through `ring` (mbarriers at `bars`).
template <bool TMA>
__device__ __forceinline__ void sum_rows(const FfSumArgs& a, const FfMaps& m, float* ring,
                                         const float* ones, uint32_t bars, int lane,
                                         int r0, int nrows) {
  const int row = lane % FF_ROWS, energy = lane / FF_ROWS, r7 = row & 7;
  // Tiles start at column x0 of the block: by TMA the 16-byte boundary at
  // or before the first real column (a box's first column must sit on
  // one: a ghost width of 5 was refused), so the real columns are q .. q
  // + nx - 1 of the tiles; by 4-byte copies at the first real column.
  const int q = TMA ? a.g % 4 : 0, x0 = a.g - q;
  const int ntiles = (q + a.nx + FF_TC - 1) / FF_TC;
  const long long origin = (long long)(a.g + r0) * a.cols + a.g;
  // Tile t into its stage: by TMA, lane 0 alone (4 boxes, 8 KB, on the
  // stage's mbarrier); else every lane copies 4 bytes a row and column,
  // a commit group a tile (empty past the last, so the count stays one a
  // tile).
  auto load = [&](int t) {
    float* st = ring + (t % FF_STAGES) * FF_STAGE_F;
    if constexpr (TMA) {
      if (lane == 0 && t < ntiles) {
        const uint32_t bar = bars + 8 * (t % FF_STAGES);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(bar), "r"(FF_STAGE_BYTES) : "memory");
        for (int b = 0; b < FF_BOXES; ++b) {
          const int x = x0 + t * FF_TC + b * FF_BOX;
          tma_box(smem_addr(st + b * FF_BOX_F), &m.rho, x, a.g + r0, bar);
          tma_box(smem_addr(st + (FF_BOXES + b) * FF_BOX_F), &m.E, x, a.g + r0, bar);
        }
      }
    } else {
      if (t < ntiles) {
        for (int b = 0; b < FF_BOXES; ++b) {
          const int c = t * FF_TC + b * FF_BOX + lane;
          if (c >= a.nx) break;
          const float* sr = a.rho + origin + c;
          const float* se = a.E + origin + c;
          for (int i = 0; i < nrows; ++i) {
            const int o = b * FF_BOX_F + i * FF_BOX + swz(i & 7, lane);
            __pipeline_memcpy_async(st + o, sr + i * a.cols, 4);
            __pipeline_memcpy_async(st + FF_BOXES * FF_BOX_F + o, se + i * a.cols, 4);
          }
        }
      }
      __pipeline_commit();
    }
  };

  if constexpr (TMA) {
    for (int t = 0; t < FF_STAGES; ++t) load(t);
  } else {
    for (int t = 0; t < FF_STAGES - 1; ++t) load(t);
  }
  float hi = 0.f, lo = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % FF_STAGES;
    if constexpr (TMA) {
      mbar_wait(bars + 8 * s, (t / FF_STAGES) & 1);
    } else {
      load(t + FF_STAGES - 1);  // into the stage the last pass emptied
      __pipeline_wait_prior(FF_STAGES - 1);
      __syncwarp();
    }
    const float* st = ring + s * FF_STAGE_F;
    const float* x = st + row * FF_BOX;
    const float* v = energy ? st + FF_BOXES * FF_BOX_F + row * FF_BOX : ones;
    const int vbox = energy ? FF_BOX_F : 0;
    const int c0 = max(0, q - t * FF_TC), c1 = min(FF_TC, q + a.nx - t * FF_TC);
    if (c0 == 0 && c1 == FF_TC) sum_tile<true>(x, v, vbox, r7, 0, FF_TC, hi, lo);
    else sum_tile<false>(x, v, vbox, r7, c0, c1, hi, lo);
    __syncwarp();  // every lane is done with the stage before its refill
    if constexpr (TMA) load(t + FF_STAGES);
  }
  if constexpr (!TMA) __pipeline_wait_prior(0);

  if (row < nrows) {
    const int r = r0 + row;
    a.rows[(2 * energy) * a.ny + r] = hi;
    a.rows[(2 * energy + 1) * a.ny + r] = lo;
  }
}

// Stage 2 by the one warp of the last block. Lane k of each group of 4 (k
// = lane % 4) follows array k of a.rows (hi_m, lo_m, hi_e, lo_e), and the
// lanes of group r (= lane / 4) hold row 8i + r of each 8-row slice i. A
// slice's rows go down the chain h += b one at a time, a shuffle bringing
// row j's value to every lane of its array, and the lanes of group j keep
// the h that row j was added to. A row's 2Sum error needs nothing of the
// chain but that h, so the 8 rows' errors are computed at once, and the
// chain l += err takes them in row order, beside the next chunk's h chain
// (the first chunk's l chain adds +0s: l starts at +0 and a sum from +0
// never reaches -0, so adding +0 changes no bit). Every lane ends with its
// array's (h, l); for lo_m and lo_e, h is their sequential sum. Loads run
// two chunks ahead.
__device__ __forceinline__ void scan_rows(const float* rows, int ny, int lane,
                                          float& h, float& l) {
  const int k = lane % 4, r = lane / 4;
  const float* v = rows + (long long)k * ny + r;  // row 8i + r of array k: v[8i]
  const int chunks = ny / FF_CHUNK;
  float x[4], x1[4], x2[4], e[4] = {0.f, 0.f, 0.f, 0.f};
  auto fetch = [&](float (&d)[4], int c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = c < chunks ? __ldcg(v + c * FF_CHUNK + 8 * i) : 0.f;
  };
  fetch(x, 0);
  fetch(x1, 1);
  for (int c = 0; c < chunks; ++c) {
    fetch(x2, c + 2);
    float hp[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float bj = __shfl_sync(FULL, x[i], 4 * j + k);
        const float ej = __shfl_sync(FULL, e[i], 4 * j + k);  // the previous chunk's
        if (r == j) hp[i] = h;
        h = __fadd_rn(h, bj);
        l = __fadd_rn(l, ej);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[i] = two_sum_err(hp[i], x[i]);
      x[i] = x1[i];
      x1[i] = x2[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) l = __fadd_rn(l, __shfl_sync(FULL, e[i], 4 * j + k));
  // The last ny % 32 rows, a slice of up to 8 at a time.
  for (int base = chunks * FF_CHUNK; base < ny; base += 8) {
    const int m = min(8, ny - base);
    const float b = r < m ? __ldcg(v + base) : 0.f;
    float hp = 0.f;
    for (int j = 0; j < m; ++j) {
      const float bj = __shfl_sync(FULL, b, 4 * j + k);
      if (r == j) hp = h;
      h = __fadd_rn(h, bj);
    }
    const float err = two_sum_err(hp, b);
    for (int j = 0; j < m; ++j) l = __fadd_rn(l, __shfl_sync(FULL, err, 4 * j + k));
  }
}

template <bool TMA>
__global__ void __launch_bounds__(32) ff_sum_kernel(const FfSumArgs a,
                                                    const __grid_constant__ FfMaps m) {
  extern __shared__ unsigned char raw[];
  // TMA's 128-byte swizzle wants each box on a 1024-byte boundary.
  float* smem = reinterpret_cast<float*>(raw + ((1024 - (smem_addr(raw) & 1023)) & 1023));
  const uint32_t bars = smem_addr(smem) + FF_BARS_BYTES;
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * FF_ROWS;

  smem[FF_ONES + lane] = 1.f;
  if constexpr (TMA) {
    if (lane == 0) {
      for (int s = 0; s < FF_STAGES; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bars + 8 * s) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
  }
  __syncwarp();
  sum_rows<TMA>(a, m, smem, smem + FF_ONES, bars, lane, r0, min(FF_ROWS, a.ny - r0));

  // The ticket (as `cfl_tail`): the warp barrier orders the lanes' row
  // sums before lane 0's release, and its acquire makes every block's
  // visible to the last.
  __syncwarp();
  unsigned last = 0;
  if (lane == 0) last = take_ticket(a.ticket) == gridDim.x - 1;
  if (!__shfl_sync(FULL, last, 0)) return;

  // Stage 2, in the block that finished last.
  float h = 0.f, l = 0.f;
  scan_rows(a.rows, a.ny, lane, h, l);
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

// cuTensorMapEncodeTiled, reached through the runtime so that this
// library links no more than the others do.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                   cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

static bool tma_ok(const FfSumArgs* a) {
  return a->cols % 4 == 0 && reinterpret_cast<uintptr_t>(a->rho) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(a->E) % 16 == 0;
}

}  // namespace armon

// Encode the TMA descriptors of a (rows, cols) block's rho and E into
// `maps` (sizeof(FfMaps), 256 bytes): boxes of 16 rows x 32 columns,
// 128-byte swizzle, zeros past the block's edge.
extern "C" int armon_ff_sum_maps(const armon::FfSumArgs* a, long long rows, void* maps) {
  using namespace armon;
  if (!tma_ok(a) || rows < a->g + a->ny) return -3;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return -9;
  FfMaps m;
  const cuuint64_t dims[2] = {(cuuint64_t)a->cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)a->cols * 4};
  const cuuint32_t box[2] = {FF_BOX, FF_ROWS};
  const cuuint32_t unit[2] = {1, 1};
  const float* src[2] = {a->rho, a->E};
  CUtensorMap* dst[2] = {&m.rho, &m.E};
  for (int i = 0; i < 2; ++i) {
    if (encode(dst[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(src[i]),
               dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return -10;
  }
  memcpy(maps, &m, sizeof m);
  return 0;
}

// Launch K6: by TMA with `maps` (from `armon_ff_sum_maps` for these
// tensors), else (maps NULL) by the 4-byte copy path.
extern "C" int armon_ff_sum(const armon::FfSumArgs* a, const void* maps, void* stream) {
  using namespace armon;
  if (a->nx < 1 || a->ny < 1 || a->g < 0 || a->cols < a->g + a->nx) return -3;
  if (maps != nullptr && !tma_ok(a)) return -3;
  const int blocks = (a->ny + FF_ROWS - 1) / FF_ROWS;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  FfMaps m;
  if (maps != nullptr) {
    memcpy(&m, maps, sizeof m);
    ff_sum_kernel<true><<<blocks, 32, FF_SMEM, s>>>(*a, m);
  } else {
    memset(&m, 0, sizeof m);
    ff_sum_kernel<false><<<blocks, 32, FF_SMEM, s>>>(*a, m);
  }
  return (int)cudaGetLastError();
}
