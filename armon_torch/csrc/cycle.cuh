// Whole-cycle hydro kernels for Hopper (sm_90a): K4 `cycle` runs both
// sweeps of one cycle in one launch, K5 `multicycle` runs up to K cycles in
// one launch.
//
// K4 replaces `_cycle_kernel` (armon_tpu/ops/pallas/sweep.py:1571, called
// by `fused_cycle` at :1830), its `slab_y` row splice (:1592-1620) for a
// mesh sharded along Y included. K5 replaces `_multicycle_kernel` (:1905, with
// `_mc_ext` :1883, called by `fused_multicycle` at :2046).
//
// Bound on this card. K4: its bytes and its instructions come close. It
// reads rho/u/v/E once and writes them and the stale p once, 36 B/cell in
// f32 against the 68 B/cell of the two per-sweep kernels of a Sequential
// cycle, for 2 x 192 operations per cell (times ~1.2 for the recomputed
// halo): at 8200^2, 0.72 ms of bytes and 0.77 ms of lane operations. On
// the card it runs well above both, held back by instruction latency
// (PERF.md). K5:
// latency. The grids it admits (<= 256 KiB per field) stay in the 50 MB
// L2 for all K cycles, so the sweeps' dependent chains and one grid-wide
// barrier per cycle set its time, not HBM: a cycle that only copies and
// waits at the barrier takes 4.0 us at 108^2 (PERF.md).
//
// K4's design (`cycle_kernel`, the tile body redesigned for Hopper). A
// block owns an RX x RY output tile and sweeps the WX x WY window around
// it. A line (a window row along X, a window column along Y) belongs to
// one warp, and each lane owns a run of PX (along X) or PY (along Y)
// consecutive positions of it: `run_body` (sweep.cuh, shared with K1) is
// `sweep_body` stage by stage
// with the same operations in the same order at every position, but its
// k-1 / k+1 reads come from the lane's own registers inside the run and
// from `__shfl_up_sync` / `__shfl_down_sync` at its ends, so no block
// barrier sits inside a sweep. Block barriers remain between the load (Y
// first only), the first sweep, the second sweep and the store.
//
// Overlap of loads with math comes from resident blocks: f32 runs two
// blocks of 16 warps per SM (K4Geom: 96 x 64 windows, 88 x 56 tiles, 113
// KB of shared memory and at most 64 registers a thread), so one block's
// loads and stores run under the other's math; a cp.async ring would need
// a second window's shared memory. The window is small for that: the two
// sweeps cover 1.195x the tile's cells X first, 1.169x Y first (the old
// 56 x 56 tiles 1.22x). Larger windows at one block per SM (96 x 128,
// 1.115x) measured slower: the kernel is latency-bound at 16 warps per
// SM (PERF.md). f64 takes 64 x 64 windows, one block of 8 warps.
//
// X first, each warp loads its rows straight from device memory into
// registers (a row is contiguous; the lanes' runs share cache lines),
// the next row's loads issued before the current row's sweep. The
// first sweep keeps its rows' RX inner positions in shared memory (4
// planes), the second sweep runs down F's columns and writes its outputs
// back in place (and p to a fifth plane), and the block then stores the
// tile row by row, coalesced. Y first, a column loaded straight into a
// lane's run would touch one cache line per position, so the block stages
// the whole window in shared memory with coalesced row loads, then sweeps
// its columns and its rows in place; p goes to device memory from the
// rows' registers. The shared memory's layout skews row i by i / PY
// words, so a warp reading a column (lane t at rows PY t ... PY t + PY -
// 1) and a warp reading a row (lane t at columns PX t ... PX t + PX - 1,
// PX odd) both hit 32 distinct banks.
//
// The cross-sweep EOS fold (`SweepFold`, sweep.cuh): in the instances
// that fold (`FOLDS`: exact, perfect gas), K4's and K5's first sweep
// leaves its new density unscaled (X) in shared memory and the second
// rebuilds rho = X * 1/d of the first sweep's axis and takes p = (X * K)
// * e (`CycleArgs.kf_x`, `kf_y`); a K4 or K5 cycle always starts its
// cycle, so it always folds. K4 stores the second sweep's density scaled
// unless `x_out` asks for X (Strang's pair, a K1 follows), K5 always
// scaled. The per-position tile body below (the probe's `base_l32`) does
// not fold.
//
// The per-position tile body (`cycle_tile`, run by the cycle probe's
// `base_l32`; it was K5's before K5's redesign): a block owns an R x R
// output tile (R = L - 2 HALO) and works on the L x L window around it.
// The load fills both ghost bands from the pre-cycle state, Y mirror and
// X mirror (the X sweep is row-local and exactly odd in v, so this equals
// filling before each sweep bit for bit: `_cycle_kernel`'s docstring). On a shard of a mesh sharded along Y, a
// side that faces a neighbour reads its ghost rows from the neighbour's
// packed (4, g, cols) slab instead, and the X mirror maps the column
// first, so a corner cell takes f_x times the neighbour's value, as the
// TPU kernel's splice-then-mirror order gives. K4's first sweep runs on
// those ghost rows too, so the corners reach real cells here and nowhere
// else. The first sweep runs on all L lines of the
// window, L/NL passes of NL lines with one thread per position; its
// outputs on the R inner positions of each line stay in shared memory (F,
// 4 fields x L lines x R), never in device memory. The second sweep runs
// on the R lines of F. Both are `sweep_body` (sweep.cuh), one position
// per thread, with the line's stride in S as the shifted-read stride. The
// TPU's full-width row chunks are not carried over: the TPU runs its grid
// in order out of a large VMEM, the card runs many small tiles at once.
//
// K5's design (`multicycle_kernel`, redesigned for the H100). The old
// body ran a cycle as seven dependent passes of 8 lines (4 for the first
// sweep of a 32 x 32 window, 3 for the second), each a `sweep_body` chain
// with 6 block barriers, on 256-thread blocks: at 108^2 25 blocks on 25 of
// 132 SMs, 11.7 us a cycle, flat from 108^2 to 248^2 (latency). Now every
// line of a W x W window (W = 16 P) belongs to a 16-lane segment of a
// warp, each lane a run of P consecutive positions, neighbours through
// registers and shuffles (`run_body`, as K1 and K4): each sweep of a cycle
// is ONE pass over all its lines, with no barrier inside. Two geometries
// (`MultiGeom`): 16 x 16 windows (8 x 8 tiles, P = 1, 256 threads) while
// their tiles fit co-resident on the card (132 SMs x the blocks per SM of
// their launch bounds), so a small grid spreads over every SM; else 32 x
// 32 windows (24 x 24 tiles, P = 2, 512 threads), which hold every grid
// the routing admits (`multi_window`, `ops/cycle.multi_tile`). X first,
// a segment loads its window row straight from L2 into its run, sweeps it,
// and keeps the inner columns in shared memory (one barrier); the inner
// columns' segments then sweep down them. Y first, the rows go to shared
// memory (one barrier), every column is swept in place (a second), and
// the inner rows' segments sweep them. Either way the second sweep's
// lanes store the tile and p straight from their registers, and each warp
// adds its CFL maxima to the block's pair by atomic maxima, so no block
// barrier follows the second sweep. The halo's redundant work (the two sweeps cover (W^2 + R W) /
// (2 R^2) of the tile's cells: 6x at W = 16, 3.1x at 32) costs little at
// 1% of the operation bound, against the SMs it brings in.
//
// K5 is a cooperative launch of every tile of the grid at once. Each cycle:
// the dt recurrence (`dt_step`, the one K3 runs) and the run predicate,
// computed identically by every block; the tile's cycle, or a copy when
// the cycle does not run; one grid-wide barrier (K5's own, on a count in
// the partials buffer: `grid_barrier`); every block folds the cycle's
// partials into lm (warp shuffles, one block barrier), while the next
// cycle's window loads are in flight. The fields
// ping-pong between the two buffer sets and a cycle that does not run
// copies, so after K cycles the carry sits in the set K's parity names,
// whatever number of cycles ran. The partials are double-buffered by cycle
// parity, so one grid barrier per cycle suffices. Each cycle takes its
// sweep order and dt factors from the parity of the device cycle counter
// (the TPU kernel indexes a static schedule that starts on an even cycle;
// both agree there). Field and partial loads bypass L1 (__ldcg): other
// blocks wrote them before the barrier. After the last cycle, block 0's
// thread 0 writes the loop scalars back and, in the last launch of a
// whole-run graph's body, sets the WHILE condition from iscal[next]
// (`set_while`, common.cuh).

#pragma once

#include "sweep.cuh"

namespace armon {

template <int L> struct Tile {
  static constexpr int NL = 8;            // lines per pass
  static constexpr int NT = L * NL;       // threads per block
  static constexpr int R = L - 2 * HALO;  // output tile edge
  static constexpr int FP = R + 1;        // F's line pitch (odd: no bank conflicts)
  static_assert(L % NL == 0 && R % NL == 0, "passes must tile the lines");
  template <typename T> static constexpr size_t smem() {
    return (size_t)(9 * NT + 4 * L * FP) * sizeof(T);
  }
};

constexpr int BASE_L = 32;  // the cycle probe's `base_l32`: the per-position body, 24 x 24 tiles

// Measurement variants of K4 for the cycle probe
// (armon_torch/probes/cycle_variants.py, after scripts/perf_probe.py), a
// compile-time parameter of `cycle_kernel` (and of the per-position `cycle_tile`)
// whose default, CV_BASE, is the production kernel; the variants are
// instantiated only in probe_cycle.cu. NO_P: the stale p is not written.
// NO_DT: no CFL partials (and no sound speed formed for them). NO_ROLL:
// every shifted read replaced by the own value times (1 + 1e-7 k): no
// shuffle and no shared-memory exchange. STREAM: the same loads, windows,
// passes and stores with trivial math (fields copied, p = rho + u + v +
// E).
enum CycleVariant { CV_BASE = 0, CV_NO_P, CV_NO_DT, CV_NO_P_DT, CV_NO_ROLL, CV_STREAM };
__host__ __device__ constexpr bool cv_writes_p(int v) { return v != CV_NO_P && v != CV_NO_P_DT; }
__host__ __device__ constexpr bool cv_dt(int v) {
  return v == CV_BASE || v == CV_NO_P || v == CV_NO_ROLL;
}

struct CycleArgs {
  const void* src[4];     // rho, u, v, E (input)
  void* dst[4];           // rho, u, v, E (output, distinct buffers)
  void* p;                // stale p (written when emit)
  void* partials;         // CFL maxima, rows n_partials apart: K4 2 rows, K5 2 parities x 2
  void* scal;             // T[4]: t, dt_prev, lm, dt_use (K5 reads and writes)
  void* iscal;            // int32[4]: cycle, ok, run, next
  const void* slab_lo;    // (4, g, cols) Y ghost rows, when ymode_lo is SLAB (K4)
  const void* slab_hi;    // the same for the high side
  long long rows, cols, n_partials;
  int grid_x, grid_y;
  int g, nx, ny;          // nx, ny: this shard's real cells
  int ymode_lo, ymode_hi;  // GhostMode of the Y sides (X: always mirror)
  int riemann, limiter, projection;
  int emit;               // K4: the cycle's last launch, stale p + CFL partials
  int fast, biz;
  int x_first;            // K4: X sweep first
  double fx, fy;          // K4: dt factors of the X and Y sweeps
  double dx, dy, inv_dx, inv_dy;  // rounded to T
  double fx_lo[4], fx_hi[4];  // X-side mirror factors of (rho, u, v, E)
  double fy_lo[4], fy_hi[4];  // Y-side mirror factors
  double k[K_COUNT];
  int x_out;              // K4 (FOLDS): the second sweep stores its new density unscaled
  double kf_x, kf_y;      // the EOS fold's K after an X sweep, after a Y sweep (`SweepFold`)
};

struct MultiArgs {
  CycleArgs c;            // src = first buffer set, dst = second
  int ncycles;
  int x_first[2];         // by cycle parity
  double fx[2], fy[2];
  DtParams dt;
  void* bar;              // u64: the grid barrier's arrival count (zeroed once, then only grows)
  cudaGraphConditionalHandle cond;  // the body's last launch: its WHILE condition; else 0
  int* count;             // with `cond`: the WHILE's iteration count
};

template <typename T> struct Fields { T* f[4]; };

// One cycle of one R x R tile (see the file note). Accumulates the CFL
// maxima of the tile's real cells into mx / my when emitting. Every thread
// of the block must call it.
template <typename T, bool FAST, bool BIZ, int L, int V = CV_BASE>
__device__ __forceinline__ void cycle_tile(const CycleArgs& a, Fields<const T> src,
                                           Fields<T> dst, T* p_out, T dtx, T dty,
                                           bool x_first, bool emit, T* S, T* F,
                                           T& mx, T& my) {
  typedef Tile<L> G;
  constexpr int NL = G::NL, NT = G::NT, R = G::R, FP = G::FP, FS = L * FP;
  const int tid = threadIdx.x;
  const long long rows = a.rows, cols = a.cols;
  const long long r0 = (long long)blockIdx.y * R, c0 = (long long)blockIdx.x * R;
  const int g = a.g;

  // First sweep on the L x L window. Along X a line is a window row and a
  // thread's neighbours are adjacent slots; along Y a line is a window
  // column and the neighbours are NL slots apart.
  {
    const bool ax = x_first;
    const int pos = ax ? tid % L : tid / NL;
    const int li = ax ? tid / L : tid % NL;
    const int st = ax ? 1 : NL;
    const int tm = pos > 0 ? tid - st : tid;
    const int tp = pos < L - 1 ? tid + st : tid;
    const T dt = ax ? dtx : dty;
    const T dx = T(ax ? a.dx : a.dy), inv = T(ax ? a.inv_dx : a.inv_dy);
#pragma unroll 1
    for (int q = 0; q < L / NL; ++q) {
      const int line = q * NL + li;
      long long gr = r0 - HALO + (ax ? line : pos);
      long long gc = c0 - HALO + (ax ? pos : line);
      T fac[4] = {T(1), T(1), T(1), T(1)};
      int side;
      gc = ghost_src(gc, g, a.nx, GHOST_MIRROR, GHOST_MIRROR, a.fx_lo, a.fx_hi, fac, side);
      gc = gc < 0 ? 0 : (gc >= cols ? cols - 1 : gc);  // array edge: dead outputs only
      gr = ghost_src(gr, g, a.ny, a.ymode_lo, a.ymode_hi, a.fy_lo, a.fy_hi, fac, side);
      const T* base[4];
      long long idx;
      if (side < 0) {
        gr = gr < 0 ? 0 : (gr >= rows ? rows - 1 : gr);
        idx = gr * cols + gc;
        for (int f = 0; f < 4; ++f) base[f] = src.f[f];
      } else {  // a neighbour's slab row, at the X-mirrored column
        const T* sl = reinterpret_cast<const T*>(side ? a.slab_hi : a.slab_lo);
        idx = gr * cols + gc;
        for (int f = 0; f < 4; ++f) base[f] = sl + (long long)f * g * cols;
      }
      const T rho = __ldcg(base[0] + idx) * fac[0];
      const T u = __ldcg(base[1] + idx) * fac[1];
      const T v = __ldcg(base[2] + idx) * fac[2];
      const T E = __ldcg(base[3] + idx) * fac[3];
      T r2, a2, o2, e2, p, c;
      if (V == CV_STREAM) {
        r2 = rho, a2 = ax ? u : v, o2 = ax ? v : u, e2 = E;
      } else {
        sweep_body<T, FAST, BIZ, NT, V != CV_NO_ROLL>(
            S, tid, tm, tp, a.k, a.riemann, a.limiter, a.projection, dt, dx, inv,
            false, !ax, rho, ax ? u : v, ax ? v : u, E, r2, a2, o2, e2, p, c);
      }
      if (pos >= HALO && pos < HALO + R) {
        const int o = line * FP + pos - HALO;
        F[o] = r2;
        F[FS + o] = ax ? a2 : o2;
        F[2 * FS + o] = ax ? o2 : a2;
        F[3 * FS + o] = e2;
      }
    }
  }
  __syncthreads();  // F is complete

  // Second sweep along the other axis, on the R inner lines of F: its
  // positions are the first sweep's lines.
  {
    const bool ax = !x_first;
    const int pos = ax ? tid % L : tid / NL;
    const int li = ax ? tid / L : tid % NL;
    const int st = ax ? 1 : NL;
    const int tm = pos > 0 ? tid - st : tid;
    const int tp = pos < L - 1 ? tid + st : tid;
    const T dt = ax ? dtx : dty;
    const T dx = T(ax ? a.dx : a.dy), inv = T(ax ? a.inv_dx : a.inv_dy);
#pragma unroll 1
    for (int q = 0; q < R / NL; ++q) {
      const int line = q * NL + li;
      const int o = pos * FP + line;
      const T rho = F[o], u = F[FS + o], v = F[2 * FS + o], E = F[3 * FS + o];
      T r2, a2, o2, e2, p, c;
      if (V == CV_STREAM) {
        r2 = rho, a2 = ax ? u : v, o2 = ax ? v : u, e2 = E;
        p = ((rho + u) + v) + E;
      } else {
        sweep_body<T, FAST, BIZ, NT, V != CV_NO_ROLL>(
            S, tid, tm, tp, a.k, a.riemann, a.limiter, a.projection, dt, dx, inv,
            emit && cv_dt(V), !ax, rho, ax ? u : v, ax ? v : u, E, r2, a2, o2, e2, p, c);
      }
      if (pos >= HALO && pos < HALO + R) {
        const long long gr = ax ? r0 + line : r0 + pos - HALO;
        const long long gc = ax ? c0 + pos - HALO : c0 + line;
        if (gr < rows && gc < cols) {
          const long long w = gr * cols + gc;
          const T u2 = ax ? a2 : o2, v2 = ax ? o2 : a2;
          dst.f[0][w] = r2;
          dst.f[1][w] = u2;
          dst.f[2][w] = v2;
          dst.f[3][w] = e2;
          if (emit) {
            if (cv_writes_p(V)) p_out[w] = p;
            // `_dt_tile_min`: post-sweep velocities, pre-sweep c.
            if (cv_dt(V) && gr >= g && gr < g + a.ny && gc >= g && gc < g + a.nx) {
              mx = jmax(mx, fabs(u2) + c);
              my = jmax(my, fabs(v2) + c);
            }
          }
        }
      }
    }
  }
}

// A cycle past the run's end: pass the R x R tile's fields through, NT
// threads.
template <typename T, int R, int NT>
__device__ __forceinline__ void copy_tile(const CycleArgs& a, Fields<const T> src,
                                          Fields<T> dst) {
  const long long r0 = (long long)blockIdx.y * R, c0 = (long long)blockIdx.x * R;
  for (int i = threadIdx.x; i < R * R; i += NT) {
    const long long gr = r0 + i / R, gc = c0 + i % R;
    if (gr < a.rows && gc < a.cols) {
      const long long o = gr * a.cols + gc;
      for (int f = 0; f < 4; ++f) dst.f[f][o] = __ldcg(src.f[f] + o);
    }
  }
}

template <typename T>
__device__ __forceinline__ Fields<const T> const_fields(const void* const* p) {
  return {{reinterpret_cast<const T*>(p[0]), reinterpret_cast<const T*>(p[1]),
           reinterpret_cast<const T*>(p[2]), reinterpret_cast<const T*>(p[3])}};
}
template <typename T>
__device__ __forceinline__ Fields<T> fields(void* const* p) {
  return {{reinterpret_cast<T*>(p[0]), reinterpret_cast<T*>(p[1]),
           reinterpret_cast<T*>(p[2]), reinterpret_cast<T*>(p[3])}};
}

// One cycle with the per-position tile body on L x L windows: the cycle probe's
// `base_l32` (K4's function on 24 x 24 tiles).
template <typename T, bool FAST, bool BIZ, int L, int V = CV_BASE>
__global__ void __launch_bounds__(Tile<L>::NT) tile_kernel(const CycleArgs a) {
  constexpr int NT = Tile<L>::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* S = reinterpret_cast<T*>(smem);
  T* F = S + 9 * NT;
  const Fields<const T> src = const_fields<T>(a.src);
  const Fields<T> dst = fields<T>(a.dst);
  if (!reinterpret_cast<const int*>(a.iscal)[2]) {
    copy_tile<T, Tile<L>::R, NT>(a, src, dst);
    return;
  }
  const T dt_use = reinterpret_cast<const T*>(a.scal)[3];
  T mx = T(0), my = T(0);  // the TPU's zero-initialised max block
  cycle_tile<T, FAST, BIZ, L, V>(a, src, dst, reinterpret_cast<T*>(a.p),
                                 dt_use * T(a.fx), dt_use * T(a.fy), a.x_first != 0,
                                 a.emit != 0, S, F, mx, my);
  if (!a.emit || !cv_dt(V)) return;
  block_max2<T, NT>(S, threadIdx.x, mx, my);
  if (threadIdx.x == 0) {
    const long long b = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    T* part = reinterpret_cast<T*>(a.partials);
    part[b] = S[0];
    part[a.n_partials + b] = S[NT];
  }
}

// ------------------------------------------------------------------ K4

// A K4 geometry (see the file note): a lane owns PX consecutive positions
// of an X line and PY of a Y line, so a window is WX = 32 PX columns by
// WY = 32 PY rows; NW warps per block, MINB blocks per SM (launch
// bounds).
template <typename T, int PX_, int PY_, int NW_, int MINB_>
struct K4Shape {
  static constexpr int PX = PX_, PY = PY_, NW = NW_, MINB = MINB_;
  static constexpr int NT = 32 * NW;
  static constexpr int WX = 32 * PX, WY = 32 * PY;
  static constexpr int RX = WX - 2 * HALO, RY = WY - 2 * HALO;
  // One plane of shared memory: X first, the first sweep's WY rows x RX
  // inner columns (5 planes: rho, u, v, E, p); Y first, the whole window
  // (4 planes). Row i starts i / PY words late (the bank skew).
  static constexpr int PLANE_XF = WY * RX + WY / PY, PLANE_YF = WY * WX + WY / PY;
  static constexpr int PLANES = 5 * PLANE_XF > 4 * PLANE_YF ? 5 * PLANE_XF : 4 * PLANE_YF;
  static constexpr size_t smem() { return (size_t)(PLANES + 2 * NW) * sizeof(T); }
  static __device__ __forceinline__ int at(int i, int c, int width) {
    return i * width + i / PY + c;
  }
};

// The production geometries.
template <typename T> struct K4Geom;
template <> struct K4Geom<float> { typedef K4Shape<float, 3, 2, 16, 2> G; };
template <> struct K4Geom<double> { typedef K4Shape<double, 2, 2, 8, 1> G; };
template <typename T> using K4 = typename K4Geom<T>::G;

// Where window cell (gr, gc) of the pre-cycle state with both ghost fills
// lies, and the factors it takes, as `cycle_tile` loads it: the X
// mirror maps the column first, then the Y side (mirror or a neighbour's
// slab row), the factors folded; `window_cell` loads it.
template <typename T>
__device__ __forceinline__ void window_src(const CycleArgs& a, const Fields<const T>& src,
                                           long long gr, long long gc, const T* ptr[4],
                                           T fac[4]) {
#pragma unroll
  for (int f = 0; f < 4; ++f) fac[f] = T(1);
  int side;
  gc = ghost_src(gc, a.g, a.nx, GHOST_MIRROR, GHOST_MIRROR, a.fx_lo, a.fx_hi, fac, side);
  gc = gc < 0 ? 0 : (gc >= a.cols ? a.cols - 1 : gc);  // array edge: dead outputs only
  gr = ghost_src(gr, a.g, a.ny, a.ymode_lo, a.ymode_hi, a.fy_lo, a.fy_hi, fac, side);
  if (side < 0) {
    gr = gr < 0 ? 0 : (gr >= a.rows ? a.rows - 1 : gr);
    const long long idx = gr * a.cols + gc;
#pragma unroll
    for (int f = 0; f < 4; ++f) ptr[f] = src.f[f] + idx;
  } else {  // a neighbour's slab row, at the X-mirrored column
    const T* sl = reinterpret_cast<const T*>(side ? a.slab_hi : a.slab_lo);
    const long long idx = gr * a.cols + gc;
#pragma unroll
    for (int f = 0; f < 4; ++f) ptr[f] = sl + (long long)f * a.g * a.cols + idx;
  }
}

template <typename T>
__device__ __forceinline__ void window_cell(const CycleArgs& a, const Fields<const T>& src,
                                            long long gr, long long gc, T out[4]) {
  const T* ptr[4];
  T fac[4];
  window_src(a, src, gr, gc, ptr, fac);
#pragma unroll
  for (int f = 0; f < 4; ++f) out[f] = __ldg(ptr[f]) * fac[f];
}

// The EOS fold (`SweepFold`) of a cycle's first sweep (`second` false:
// it stores its new density unscaled) or second (it rebuilds rho from the
// first's X, along the other axis, and stores it unscaled only where
// `x_out` asks); none in the instances that do not fold (`FOLDS`).
template <typename T, bool FAST, bool BIZ>
__device__ __forceinline__ SweepFold<T> cycle_fold(const CycleArgs& a, bool along_x,
                                                   bool second) {
  SweepFold<T> f;
  if (!FOLDS<FAST, BIZ>) return f;
  f.in = second;
  f.out = !second || a.x_out != 0;
  f.rdx = T(along_x ? a.inv_dy : a.inv_dx);  // the first sweep's axis
  f.k = T(along_x ? a.kf_y : a.kf_x);
  return f;
}

// One line of P positions through `run_body` (or the STREAM variant's
// copy), the velocities swapped for a Y line; `second`: the cycle's
// second sweep (`cycle_fold`).
template <typename T, bool FAST, bool BIZ, int P, int V>
__device__ __forceinline__ void line(const CycleArgs& a, bool along_x, T dt, bool need_c,
                                     T (&rho)[P], T (&u)[P], T (&v)[P], T (&E)[P], T (&p)[P],
                                     T (&c)[P], bool second) {
  if (V == CV_STREAM) return;
  const T dx = T(along_x ? a.dx : a.dy), inv = T(along_x ? a.inv_dx : a.inv_dy);
  const SweepFold<T> fold = cycle_fold<T, FAST, BIZ>(a, along_x, second);
  if (along_x)
    run_body<T, FAST, BIZ, P, V != CV_NO_ROLL>(a.k, a.riemann, a.limiter, a.projection, dt, dx,
                                               inv, need_c, false, rho, u, v, E, p, c, fold);
  else
    run_body<T, FAST, BIZ, P, V != CV_NO_ROLL>(a.k, a.riemann, a.limiter, a.projection, dt, dx,
                                               inv, need_c, true, rho, v, u, E, p, c, fold);
}

// A CFL sample of an output cell (`_dt_tile_min`: post-sweep velocities,
// pre-sweep c), real cells only.
template <typename T>
__device__ __forceinline__ void cfl_sample(const CycleArgs& a, long long gr, long long gc, T u,
                                           T v, T c, T& mx, T& my) {
  if (gr >= a.g && gr < a.g + a.ny && gc >= a.g && gc < a.g + a.nx) {
    mx = jmax(mx, fabs(u) + c);
    my = jmax(my, fabs(v) + c);
  }
}

// X then Y: rows from device memory, F = the rows' inner columns.
template <typename T, bool FAST, bool BIZ, int V, typename G>
__device__ __forceinline__ void k4_x_first(const CycleArgs& a, Fields<const T> src, T* F,
                                           T dtx, T dty, bool emit, T& mx, T& my) {
  constexpr int PX = G::PX, PY = G::PY, RX = G::RX;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = (long long)blockIdx.y * G::RY, c0 = (long long)blockIdx.x * RX;
  T* pl[5];
#pragma unroll
  for (int f = 0; f < 5; ++f) pl[f] = F + f * G::PLANE_XF;

  T raw[4][PX];  // the next row's values, in flight during this row's sweep
  auto issue = [&](int i) {
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const T* ptr[4];
      T fac[4];
      window_src<T>(a, src, r0 - HALO + i, c0 - HALO + PX * lane + j, ptr, fac);
#pragma unroll
      for (int f = 0; f < 4; ++f) raw[f][j] = __ldg(ptr[f]);
    }
  };
  // Always true (NW <= WY); with the guard ptxas allocates the f32 body
  // with 16 B of spills instead of 80, 5% faster at 8200^2 (PERF.md).
  if (warp < G::WY) issue(warp);
#pragma unroll 1
  for (int i = warp; i < G::WY; i += G::NW) {
    T rho[PX], u[PX], v[PX], E[PX], p[PX], c[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) {  // the factors again: ALU work, no loads
      const T* ptr[4];
      T fac[4];
      window_src<T>(a, src, r0 - HALO + i, c0 - HALO + PX * lane + j, ptr, fac);
      rho[j] = raw[0][j] * fac[0], u[j] = raw[1][j] * fac[1];
      v[j] = raw[2][j] * fac[2], E[j] = raw[3][j] * fac[3];
    }
    if (i + G::NW < G::WY) issue(i + G::NW);
    line<T, FAST, BIZ, PX, V>(a, true, dtx, false, rho, u, v, E, p, c, false);
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int cc = PX * lane + j - HALO;
      if (cc >= 0 && cc < RX) {
        const int o = G::at(i, cc, RX);
        pl[0][o] = rho[j], pl[1][o] = u[j], pl[2][o] = v[j], pl[3][o] = E[j];
      }
    }
  }
  __syncthreads();  // F is complete

#pragma unroll 1
  for (int cc = warp; cc < RX; cc += G::NW) {
    T rho[PY], u[PY], v[PY], E[PY], p[PY], c[PY];
#pragma unroll
    for (int j = 0; j < PY; ++j) {
      const int o = G::at(PY * lane + j, cc, RX);
      rho[j] = pl[0][o], u[j] = pl[1][o], v[j] = pl[2][o], E[j] = pl[3][o];
      if (V == CV_STREAM) p[j] = ((rho[j] + u[j]) + v[j]) + E[j];
    }
    line<T, FAST, BIZ, PY, V>(a, false, dty, emit && cv_dt(V), rho, u, v, E, p, c, true);
#pragma unroll
    for (int j = 0; j < PY; ++j) {
      const int i = PY * lane + j;
      if (i >= HALO && i < G::WY - HALO) {
        const int o = G::at(i, cc, RX);
        pl[0][o] = rho[j], pl[1][o] = u[j], pl[2][o] = v[j], pl[3][o] = E[j];
        if (emit && cv_writes_p(V)) pl[4][o] = p[j];
        if (emit && cv_dt(V)) {
          const long long gr = r0 + i - HALO, gc = c0 + cc;
          if (gr < a.rows && gc < a.cols) cfl_sample(a, gr, gc, u[j], v[j], c[j], mx, my);
        }
      }
    }
  }
}

// Y then X: the window staged in shared memory, both sweeps in place.
template <typename T, bool FAST, bool BIZ, int V, typename G>
__device__ __forceinline__ void k4_y_first(const CycleArgs& a, Fields<const T> src, T* F,
                                           T* p_out, T dtx, T dty, bool emit, T& mx, T& my) {
  constexpr int PX = G::PX, PY = G::PY, WX = G::WX, WY = G::WY;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r0 = (long long)blockIdx.y * G::RY, c0 = (long long)blockIdx.x * G::RX;
  T* pl[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) pl[f] = F + f * G::PLANE_YF;

#pragma unroll 1
  for (int t = threadIdx.x; t < WY * WX; t += G::NT) {
    const int i = t / WX, cw = t % WX;
    T in[4];
    window_cell<T>(a, src, r0 - HALO + i, c0 - HALO + cw, in);
    const int o = G::at(i, cw, WX);
#pragma unroll
    for (int f = 0; f < 4; ++f) pl[f][o] = in[f];
  }
  __syncthreads();  // the window is loaded

#pragma unroll 1
  for (int cw = warp; cw < WX; cw += G::NW) {
    T rho[PY], u[PY], v[PY], E[PY], p[PY], c[PY];
#pragma unroll
    for (int j = 0; j < PY; ++j) {
      const int o = G::at(PY * lane + j, cw, WX);
      rho[j] = pl[0][o], u[j] = pl[1][o], v[j] = pl[2][o], E[j] = pl[3][o];
    }
    line<T, FAST, BIZ, PY, V>(a, false, dty, false, rho, u, v, E, p, c, false);
#pragma unroll
    for (int j = 0; j < PY; ++j) {
      const int i = PY * lane + j;
      if (i >= HALO && i < WY - HALO) {
        const int o = G::at(i, cw, WX);
        pl[0][o] = rho[j], pl[1][o] = u[j], pl[2][o] = v[j], pl[3][o] = E[j];
      }
    }
  }
  __syncthreads();  // the first sweep is complete

#pragma unroll 1
  for (int i = HALO + warp; i < WY - HALO; i += G::NW) {
    T rho[PX], u[PX], v[PX], E[PX], p[PX], c[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int o = G::at(i, PX * lane + j, WX);
      rho[j] = pl[0][o], u[j] = pl[1][o], v[j] = pl[2][o], E[j] = pl[3][o];
      if (V == CV_STREAM) p[j] = ((rho[j] + u[j]) + v[j]) + E[j];
    }
    line<T, FAST, BIZ, PX, V>(a, true, dtx, emit && cv_dt(V), rho, u, v, E, p, c, true);
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int cw = PX * lane + j;
      if (cw >= HALO && cw < WX - HALO) {
        const int o = G::at(i, cw, WX);
        pl[0][o] = rho[j], pl[1][o] = u[j], pl[2][o] = v[j], pl[3][o] = E[j];
        const long long gr = r0 + i - HALO, gc = c0 + cw - HALO;
        if (emit && gr < a.rows && gc < a.cols) {
          if (cv_writes_p(V)) p_out[gr * a.cols + gc] = p[j];
          if (cv_dt(V)) cfl_sample(a, gr, gc, u[j], v[j], c[j], mx, my);
        }
      }
    }
  }
}

// K4: one cycle of one tile (see the file note), or its pass-through copy
// when iscal[run] is 0. Emitting, it writes the stale p and one pair of
// CFL partial maxima per block. FIN: then K3's fold and dt step in the
// tail (`cfl_tail`, common.cuh), in the window's shared memory.
template <typename T, bool FAST, bool BIZ, int V, typename G, bool FIN>
__device__ __forceinline__ void cycle_body(const CycleArgs& a, const FinishArgs* fin) {
  static_assert(G::PLANES >= 2 * G::NT, "the tail's scratch fits the window");
  extern __shared__ __align__(16) unsigned char smem[];
  T* F = reinterpret_cast<T*>(smem);
  T* red = F + G::PLANES;  // 2 NW: the warps' CFL maxima
  const Fields<const T> src = const_fields<T>(a.src);
  const Fields<T> dst = fields<T>(a.dst);
  const long long rows = a.rows, cols = a.cols;
  const long long r0 = (long long)blockIdx.y * G::RY, c0 = (long long)blockIdx.x * G::RX;
  if (!reinterpret_cast<const int*>(a.iscal)[2]) {
    for (int t = threadIdx.x; t < G::RY * G::RX; t += G::NT) {
      const long long gr = r0 + t / G::RX, gc = c0 + t % G::RX;
      if (gr < rows && gc < cols) {
        const long long o = gr * cols + gc;
#pragma unroll
        for (int f = 0; f < 4; ++f) dst.f[f][o] = __ldg(src.f[f] + o);
      }
    }
    if constexpr (FIN) cfl_tail<T, G::NT, false>(*fin, F);
    return;
  }
  const T dt_use = reinterpret_cast<const T*>(a.scal)[3];
  const T dtx = dt_use * T(a.fx), dty = dt_use * T(a.fy);
  const bool emit = a.emit != 0, xf = a.x_first != 0;
  T* p_out = reinterpret_cast<T*>(a.p);
  T mx = T(0), my = T(0);  // the TPU's zero-initialised max block
  if (xf)
    k4_x_first<T, FAST, BIZ, V, G>(a, src, F, dtx, dty, emit, mx, my);
  else
    k4_y_first<T, FAST, BIZ, V, G>(a, src, F, p_out, dtx, dty, emit, mx, my);
  const bool partials = emit && cv_dt(V);
  if (partials) {  // the warp's maxima, before the barrier
    for (int s = 16; s > 0; s >>= 1) {
      mx = jmax(mx, __shfl_xor_sync(0xffffffffu, mx, s));
      my = jmax(my, __shfl_xor_sync(0xffffffffu, my, s));
    }
    if ((threadIdx.x & 31) == 0) {
      red[threadIdx.x >> 5] = mx;
      red[G::NW + (threadIdx.x >> 5)] = my;
    }
  }
  __syncthreads();  // the tile's outputs sit in shared memory

  // Store the tile row by row: consecutive lanes, consecutive columns.
  const int width = xf ? G::RX : G::WX, cofs = xf ? 0 : HALO;
  const int plane = xf ? G::PLANE_XF : G::PLANE_YF;
  const bool p_here = emit && cv_writes_p(V) && xf;  // Y first stored p already
#pragma unroll 1
  for (int t = threadIdx.x; t < G::RY * G::RX; t += G::NT) {
    const int i = HALO + t / G::RX, cc = t % G::RX;
    const long long gr = r0 + i - HALO, gc = c0 + cc;
    if (gr < rows && gc < cols) {
      const long long w = gr * cols + gc;
      const int o = G::at(i, cc + cofs, width);
#pragma unroll
      for (int f = 0; f < 4; ++f) dst.f[f][w] = F[f * plane + o];
      if (p_here) p_out[w] = F[4 * plane + o];
    }
  }
  if (partials && threadIdx.x == 0) {
    T bx = red[0], by = red[G::NW];
    for (int w = 1; w < G::NW; ++w) bx = jmax(bx, red[w]), by = jmax(by, red[G::NW + w]);
    const long long b = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    T* part = reinterpret_cast<T*>(a.partials);
    part[b] = bx;
    part[a.n_partials + b] = by;
  }
  // Synced: the barrier before the store follows the scalars' last read.
  // F is free once every thread is past the tail's barrier.
  if constexpr (FIN) cfl_tail<T, G::NT, true>(*fin, F);
}

template <typename T, bool FAST, bool BIZ, int V = CV_BASE, typename G = K4<T>>
__global__ void __launch_bounds__(G::NT, G::MINB) cycle_kernel(const CycleArgs a) {
  cycle_body<T, FAST, BIZ, V, G, false>(a, nullptr);
}

// K4 as the cycle's last launch: the same cycle, then K3's fold and step.
template <typename T, bool FAST, bool BIZ>
__global__ void __launch_bounds__(K4<T>::NT, K4<T>::MINB)
cycle_finish_kernel(const CycleArgs a, __grid_constant__ const FinishArgs f) {
  cycle_body<T, FAST, BIZ, CV_BASE, K4<T>, true>(a, &f);
}

// ------------------------------------------------------------------ K5

// A K5 geometry (see the file note): a W x W window, W = S P; a line of
// it (a row along X, a column along Y) belongs to one S-lane segment of a
// warp, each lane a run of P consecutive positions, so the block's W
// segments sweep every line of the window at once. R x R output tile;
// MINB blocks per SM (launch bounds), which the choice of geometry counts
// on. A segment's shuffles reach the next segment's lanes at its two ends:
// those positions are halo, read but never valid (`run_body`). Shared
// memory: 4 planes of W rows (rho, u, v, E), each row PITCH words (odd,
// so the lanes reading a column or a row spread over the banks), then the
// fold's warp maxima.
template <typename T, int S_, int P_, int MINB_>
struct MultiShape {
  static constexpr int S = S_, P = P_, MINB = MINB_;
  static constexpr int W = S * P, R = W - 2 * HALO, NT = S * W, NW = NT / 32;
  static constexpr int PITCH = W + 1, PLANE = W * PITCH;
  // The segments of a second sweep (lines HALO .. HALO + R - 1) make
  // whole warps, so every lane of a warp that shuffles is in it.
  static_assert(32 % S == 0 && HALO % (32 / S) == 0 && R % (32 / S) == 0,
                "a sweep's segments fill whole warps");
  static constexpr size_t smem() { return (size_t)(4 * PLANE + 2 * NW) * sizeof(T); }
  static __device__ __forceinline__ int at(int i, int c) { return i * PITCH + c; }
};

// The two geometries: 16 x 16 windows, a 16-lane segment a line and one
// position a lane (256 threads); 32 x 32 windows, an 8-lane segment a line
// and four positions a lane (256 threads), as K1's runs, so a lane's
// positions give the latency the ILP the fewer warps do not. Blocks per
// SM by type, each at the most registers that spill nothing: f32 3 small
// (80 registers) and 2 large (128); f64 2 small (128) and 1 large.
template <typename T> struct MultiGeom;
template <> struct MultiGeom<float> {
  typedef MultiShape<float, 16, 1, 3> Small;
  typedef MultiShape<float, 8, 4, 2> Large;
};
template <> struct MultiGeom<double> {
  typedef MultiShape<double, 16, 1, 2> Small;
  typedef MultiShape<double, 8, 4, 1> Large;
};

// The card the choice sizes tiles for: an H100 SXM's SMs.
constexpr int MULTI_SMS = 132;

__host__ __device__ inline long long tile_count(long long rows, long long cols, int R) {
  return ((rows + R - 1) / R) * ((cols + R - 1) / R);
}

// K5's window edge on a padded (rows, cols) grid of T: the small windows
// while their tiles fit MULTI_SMS x their MINB co-resident, else the large
// ones, which hold every other grid `multicycle_geom_ok` admits (at most
// 160 tiles in f32 and 80 in f64, against 264 and 132; the wide strip 12 x
// 3200 takes 134). `ops/cycle.multi_tile` makes the same choice.
template <typename T> inline int multi_window(long long rows, long long cols) {
  typedef typename MultiGeom<T>::Small S;
  return tile_count(rows, cols, S::R) <= (long long)MULTI_SMS * S::MINB
             ? S::W
             : MultiGeom<T>::Large::W;
}

// The warp's NaN-propagating maxima of (mx, my), in every lane.
template <typename T>
__device__ __forceinline__ void warp_max2(T& mx, T& my) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    mx = jmax(mx, __shfl_xor_sync(0xffffffffu, mx, s));
    my = jmax(my, __shfl_xor_sync(0xffffffffu, my, s));
  }
}

// Field f of the buffer set the cycle of parity `odd` reads (`to`: the
// set it writes): the fields ping-pong between K5's two sets. Taken from
// the launch's arguments where it is used, so no pointer stays live in a
// register across a sweep.
template <typename T>
__device__ __forceinline__ T* multi_field(const MultiArgs& m, bool odd, bool to, int f) {
  return reinterpret_cast<T*>(odd != to ? m.c.dst[f] : const_cast<void*>(m.c.src[f]));
}

// Window row `seg` of the block's tile for the cycle of parity `odd`,
// positions P lane ... P lane + P - 1, with both ghost fills, from L2
// (other blocks wrote it before the grid barrier).
template <typename T, typename G>
__device__ __forceinline__ void multi_load(const MultiArgs& m, bool odd, T (&rho)[G::P],
                                           T (&u)[G::P], T (&v)[G::P], T (&E)[G::P]) {
  const Fields<const T> src = {{multi_field<T>(m, odd, false, 0), multi_field<T>(m, odd, false, 1),
                                multi_field<T>(m, odd, false, 2), multi_field<T>(m, odd, false, 3)}};
  const int seg = threadIdx.x / G::S, lane = threadIdx.x % G::S;
  const long long r0 = (long long)blockIdx.y * G::R, c0 = (long long)blockIdx.x * G::R;
#pragma unroll
  for (int j = 0; j < G::P; ++j) {
    const T* ptr[4];
    T fac[4];
    window_src<T>(m.c, src, r0 - HALO + seg, c0 - HALO + G::P * lane + j, ptr, fac);
    rho[j] = __ldcg(ptr[0]) * fac[0], u[j] = __ldcg(ptr[1]) * fac[1];
    v[j] = __ldcg(ptr[2]) * fac[2], E[j] = __ldcg(ptr[3]) * fac[3];
  }
}

// Cell (gr, gc) of the tile's output, from the registers of a second
// sweep's lane: rho/u/v/E into the other buffer set, the stale p, and
// the CFL sample.
template <typename T>
__device__ __forceinline__ void multi_store(const MultiArgs& m, bool odd, long long gr,
                                            long long gc, T rho, T u, T v, T E, T p, T c,
                                            T& mx, T& my) {
  const CycleArgs& a = m.c;
  if (gr >= a.rows || gc >= a.cols) return;
  const long long w = gr * a.cols + gc;
  multi_field<T>(m, odd, true, 0)[w] = rho;
  multi_field<T>(m, odd, true, 1)[w] = u;
  multi_field<T>(m, odd, true, 2)[w] = v;
  multi_field<T>(m, odd, true, 3)[w] = E;
  reinterpret_cast<T*>(a.p)[w] = p;
  cfl_sample(a, gr, gc, u, v, c, mx, my);
}

// A CFL maximum (+0 or more, or NaN) as an unsigned key in the value's
// order, NaN above every number: its bits, or all ones for NaN (a NaN
// when read back as T). So an atomic maximum of keys is `jmax` of the
// values, and the slot reads back as T.
__device__ __forceinline__ unsigned max_key(float x) {
  return x != x ? 0xffffffffu : __float_as_uint(x);
}
__device__ __forceinline__ unsigned long long max_key(double x) {
  return x != x ? ~0ull : (unsigned long long)__double_as_longlong(x);
}
__device__ __forceinline__ unsigned* max_key(float* p) { return reinterpret_cast<unsigned*>(p); }
__device__ __forceinline__ unsigned long long* max_key(double* p) {
  return reinterpret_cast<unsigned long long*>(p);
}

// One running cycle of the block's tile (see the file note), of parity
// `odd`, from its window row as `multi_load` gave it: both sweeps, the
// tile's rho/u/v/E and stale p into the other buffer set and p, and the
// block's pair of CFL maxima into the parity's partials, each warp's by
// an atomic maximum. Every thread of the block must call it.
template <typename T, bool FAST, bool BIZ, typename G>
__device__ __forceinline__ void multi_tile_cycle(const MultiArgs& m, bool odd, T (&rho)[G::P],
                                                 T (&u)[G::P], T (&v)[G::P], T (&E)[G::P],
                                                 T dtx, T dty, bool x_first, T* sm) {
  constexpr int P = G::P, R = G::R;
  const CycleArgs& a = m.c;
  const int seg = threadIdx.x / G::S, lane = threadIdx.x % G::S;
  const long long r0 = (long long)blockIdx.y * R, c0 = (long long)blockIdx.x * R;
  const bool inner = seg >= HALO && seg < HALO + R;  // a line of the second sweep
  T* pl[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) pl[f] = sm + f * G::PLANE;
  T mx = T(0), my = T(0);  // the TPU's zero-initialised max block
  T p[P], c[P];
  // The block's pair of CFL maxima: zeroed before the block barrier that
  // precedes the warps' atomic maxima (every block folded its last values
  // before the grid barrier this cycle follows).
  T* part = reinterpret_cast<T*>(a.partials) + (odd ? 2 * a.n_partials : 0) +
            ((long long)blockIdx.y * gridDim.x + blockIdx.x);
  if (threadIdx.x == 0) part[0] = part[a.n_partials] = T(0);

  if (x_first) {
    line<T, FAST, BIZ, P, CV_BASE>(a, true, dtx, false, rho, u, v, E, p, c, false);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int cw = P * lane + j;
      if (cw >= HALO && cw < HALO + R) {
        const int o = G::at(seg, cw);
        pl[0][o] = rho[j], pl[1][o] = u[j], pl[2][o] = v[j], pl[3][o] = E[j];
      }
    }
    __syncthreads();  // every row's inner columns
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int o = G::at(seg, P * lane + j);
      pl[0][o] = rho[j], pl[1][o] = u[j], pl[2][o] = v[j], pl[3][o] = E[j];
    }
    __syncthreads();  // the window is staged
    // Column `seg`, down all W rows, its inner rows written back in place.
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int o = G::at(P * lane + j, seg);
      rho[j] = pl[0][o], u[j] = pl[1][o], v[j] = pl[2][o], E[j] = pl[3][o];
    }
    line<T, FAST, BIZ, P, CV_BASE>(a, false, dty, false, rho, u, v, E, p, c, false);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int i = P * lane + j;
      if (i >= HALO && i < HALO + R) {
        const int o = G::at(i, seg);
        pl[0][o] = rho[j], pl[1][o] = u[j], pl[2][o] = v[j], pl[3][o] = E[j];
      }
    }
    __syncthreads();  // the first sweep is complete
  }
  // The second sweep: X first, window column `seg` down all W rows; Y
  // first, window row `seg`; each output stored from the lane's registers.
  if (inner) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int o = x_first ? G::at(P * lane + j, seg) : G::at(seg, P * lane + j);
      rho[j] = pl[0][o], u[j] = pl[1][o], v[j] = pl[2][o], E[j] = pl[3][o];
    }
    line<T, FAST, BIZ, P, CV_BASE>(a, !x_first, x_first ? dty : dtx, true, rho, u, v, E, p, c,
                                   true);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int k = P * lane + j;  // the position along the line
      if (k >= HALO && k < HALO + R) {
        const long long gr = r0 + (x_first ? k : seg) - HALO;
        const long long gc = c0 + (x_first ? seg : k) - HALO;
        multi_store<T>(m, odd, gr, gc, rho[j], u[j], v[j], E[j], p[j], c[j], mx, my);
      }
    }
  }
  warp_max2(mx, my);  // lane 0's into the block's pair (reset above)
  if ((threadIdx.x & 31) == 0) {
    atomicMax(max_key(part), max_key(mx));
    atomicMax(max_key(part + a.n_partials), max_key(my));
  }
}

// K5's grid barrier. `bar` counts every block's arrivals and only grows
// (64 bits: it never wraps); barrier j of a launch waits for the count
// `target`, base + j nb, base being the count at the launch's start
// rounded down to a multiple of nb: every launch on one count (one
// partials buffer, one grid) adds a multiple of nb, and no block passes
// barrier 1 before every block has read the count. A block arrives with
// a release add (its writes, ordered by the block barrier before it, go
// first) and waits on acquire loads, where the cooperative groups barrier
// waits on a returned atomic between two full fences. A barrier that
// cannot complete traps after ~2^35 cycles (the launch fails) rather
// than spin for ever.
__device__ __forceinline__ unsigned long long bar_count(const unsigned long long* bar) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(bar) : "memory");
  return v;
}
__device__ __forceinline__ void grid_barrier(unsigned long long* bar, unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;" : : "l"(bar) : "memory");
    const long long t0 = clock64();
    while (bar_count(bar) < target)
      if (clock64() - t0 > (1LL << 35)) __trap();
  }
  __syncthreads();
}

// K3's fold of the cycle of parity `odd`'s partials (one a block), in
// every block (the same maxima, so the same lm): the CFL minimum. `red`:
// 2 NW words of shared memory. Every thread of the block must call it.
template <typename T, typename G>
__device__ __forceinline__ T multi_fold(const MultiArgs& m, bool odd, T* red) {
  const CycleArgs& a = m.c;
  const T* part = reinterpret_cast<const T*>(a.partials) + (odd ? 2 * a.n_partials : 0);
  const long long nb = (long long)gridDim.x * gridDim.y;
  T mx = T(0), my = T(0);
  for (long long i = threadIdx.x; i < nb; i += G::NT) {
    mx = jmax(mx, __ldcg(part + i));
    my = jmax(my, __ldcg(part + a.n_partials + i));
  }
  warp_max2(mx, my);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[w] = mx, red[G::NW + w] = my;
  __syncthreads();
  mx = red[0], my = red[G::NW];
#pragma unroll
  for (int i = 1; i < G::NW; ++i) mx = jmax(mx, red[i]), my = jmax(my, red[G::NW + i]);
  return jmin(T(a.dx) / mx, T(a.dy) / my);
}

// K5 (see the file note). A cycle's window loads go out before the fold
// of the cycle before, so their L2 round trips overlap; the run predicate
// and the dt recurrence's other scalars never wait for the fold.
template <typename T, bool FAST, bool BIZ, typename G>
__global__ void __launch_bounds__(G::NT, G::MINB) multicycle_kernel(const MultiArgs m) {
  constexpr int P = G::P;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sm = reinterpret_cast<T*>(smem);
  T* red = sm + 4 * G::PLANE;  // the fold's warp maxima
  const CycleArgs& a = m.c;
  const int tid = threadIdx.x;
  const T* scal = reinterpret_cast<const T*>(a.scal);
  const int* iscal = reinterpret_cast<const int*>(a.iscal);
  T t = scal[0], dtp = scal[1], lm = scal[2], dt_last = scal[3];
  int cyc = iscal[0];
  bool ok = iscal[1] != 0, ran = iscal[2] != 0;
  const unsigned long long nb = (unsigned long long)gridDim.x * gridDim.y;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(m.bar);
  unsigned long long target = tid == 0 ? bar_count(bar) / nb * nb : 0;
  bool fold = false;  // the cycle before ran: lm waits for its partials

  for (int k = 0; k < m.ncycles; ++k) {
    const bool run = runs(m.dt, t, cyc, ok);
    const bool odd = k & 1;
    if (run) {
      T rho[P], u[P], v[P], E[P];
      multi_load<T, G>(m, odd, rho, u, v, E);
      if (fold) lm = multi_fold<T, G>(m, !odd, red);
      const DtStep<T> r = dt_step(m.dt, lm, dtp, cyc);
      const int par = cyc & 1;
      multi_tile_cycle<T, FAST, BIZ, G>(m, odd, rho, u, v, E, r.dt_use * T(m.fx[par]),
                                        r.dt_use * T(m.fy[par]), m.x_first[par] != 0, sm);
      t = t + r.dt_use;
      cyc += 1;
      dtp = r.dt_next;
      ok = r.ok;
      dt_last = r.dt_use;
    } else {
      if (fold) lm = multi_fold<T, G>(m, !odd, red);
      Fields<const T> from;
      Fields<T> to;
      for (int f = 0; f < 4; ++f) {
        from.f[f] = multi_field<T>(m, odd, false, f);
        to.f[f] = multi_field<T>(m, odd, true, f);
      }
      copy_tile<T, G::R, G::NT>(a, from, to);
    }
    fold = run;
    ran = run;
    target += nb;
    grid_barrier(bar, target);
  }
  if (fold) lm = multi_fold<T, G>(m, (m.ncycles - 1) & 1, red);
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {
    T* out = reinterpret_cast<T*>(a.scal);
    int* iout = reinterpret_cast<int*>(a.iscal);
    out[0] = t;
    out[1] = dtp;
    out[2] = lm;
    out[3] = dt_last;
    iout[0] = cyc;
    iout[1] = ok ? 1 : 0;
    iout[2] = ran ? 1 : 0;
    const bool go = runs(m.dt, t, cyc, ok);
    iout[3] = go ? 1 : 0;
    set_while(m.cond, m.count, go);
  }
}

// Host side. Checks the launch geometry the Python wrapper computed (it
// sized the partials from it): RX x RY output tiles. Returns 0 or a
// negative code.
inline int check_tile_geometry(const CycleArgs* a, long long RX, long long RY, bool partials) {
  const long long gx = (a->cols + RX - 1) / RX, gy = (a->rows + RY - 1) / RY;
  if (gx != a->grid_x || gy != a->grid_y || gy > 65535 || gx > 2147483647LL) return -2;
  if (partials && a->n_partials < gx * gy) return -3;
  return 0;
}

template <typename T, bool FAST, bool BIZ, int V = CV_BASE, typename G = K4<T>>
int launch_cycle(const CycleArgs& a, cudaStream_t s) {
  const size_t smem = G::smem();
  cudaError_t e = cudaFuncSetAttribute(cycle_kernel<T, FAST, BIZ, V, G>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  cycle_kernel<T, FAST, BIZ, V, G><<<dim3(a.grid_x, a.grid_y), G::NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool FAST, bool BIZ>
int launch_cycle_finish(const CycleArgs& a, const FinishArgs& fin, cudaStream_t s) {
  const size_t smem = K4<T>::smem();
  cudaError_t e = cudaFuncSetAttribute(cycle_finish_kernel<T, FAST, BIZ>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  cycle_finish_kernel<T, FAST, BIZ><<<dim3(a.grid_x, a.grid_y), K4<T>::NT, smem, s>>>(a, fin);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of a K4 instance (cudaOccupancy...), with its
// threads per block and dynamic shared memory.
template <typename T, bool FAST, bool BIZ>
int cycle_occupancy(int* out) {
  const size_t smem = K4<T>::smem();
  auto kern = cycle_kernel<T, FAST, BIZ>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern, K4<T>::NT, smem);
  out[1] = K4<T>::NT;
  out[2] = (int)smem;
  return (int)e;
}

// The per-position tile body as a one-cycle kernel (the probe's base_l32).
template <typename T, bool FAST, bool BIZ, int L, int V = CV_BASE>
int launch_tile(const CycleArgs& a, cudaStream_t s) {
  const size_t smem = Tile<L>::template smem<T>();
  cudaError_t e = cudaFuncSetAttribute(tile_kernel<T, FAST, BIZ, L, V>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  tile_kernel<T, FAST, BIZ, L, V><<<dim3(a.grid_x, a.grid_y), Tile<L>::NT, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// `fin`: null, or K3's work for the launch's tail (the cycle's last launch).
template <typename T, bool FAST>
int dispatch_cycle(const CycleArgs* a, const FinishArgs* fin, cudaStream_t s) {
  int err = check_tile_geometry(a, K4<T>::RX, K4<T>::RY, a->emit != 0);
  if (!err) err = check_finish(fin, a->emit != 0, (long long)a->grid_x * a->grid_y);
  if (err) return err;
  if (fin)
    return a->biz ? launch_cycle_finish<T, FAST, true>(*a, *fin, s)
                  : launch_cycle_finish<T, FAST, false>(*a, *fin, s);
  return a->biz ? launch_cycle<T, FAST, true>(*a, s) : launch_cycle<T, FAST, false>(*a, s);
}

// K5 on geometry G: a cooperative launch of every tile at once, or -4
// when the card cannot hold them all (-5 without cooperative launches).
template <typename T, bool FAST, bool BIZ, typename G>
int launch_multicycle(const MultiArgs& m, cudaStream_t s) {
  const size_t smem = G::smem();
  auto kern = multicycle_kernel<T, FAST, BIZ, G>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return -5;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, G::NT, smem);
  if (e != cudaSuccess) return (int)e;
  if ((long long)per_sm * sms < (long long)m.c.grid_x * m.c.grid_y) return -4;
  void* args[] = {const_cast<MultiArgs*>(&m)};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(m.c.grid_x, m.c.grid_y),
                                  dim3(G::NT), args, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, bool FAST, bool BIZ>
int launch_multicycle(const MultiArgs& m, int window, cudaStream_t s) {
  typedef MultiGeom<T> MG;
  return window == MG::Small::W ? launch_multicycle<T, FAST, BIZ, typename MG::Small>(m, s)
                                : launch_multicycle<T, FAST, BIZ, typename MG::Large>(m, s);
}

template <typename T, bool FAST>
int dispatch_multicycle(const MultiArgs* m, cudaStream_t s) {
  const int w = multi_window<T>(m->c.rows, m->c.cols);
  const int err = check_tile_geometry(&m->c, w - 2 * HALO, w - 2 * HALO, true);
  if (err) return err;
  if (m->ncycles < 1) return -1;
  return m->c.biz ? launch_multicycle<T, FAST, true>(*m, w, s)
                  : launch_multicycle<T, FAST, false>(*m, w, s);
}

// What the card makes of a K5 instance on a (rows, cols) grid: its window
// edge, tiles, resident blocks per SM, threads per block, dynamic shared
// memory, registers a thread and local (spill) bytes a thread.
template <typename T, bool FAST, bool BIZ, typename G>
int multicycle_occupancy(long long rows, long long cols, int* out) {
  const size_t smem = G::smem();
  auto kern = multicycle_kernel<T, FAST, BIZ, G>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kern, G::NT, smem);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  out[0] = G::W;
  out[1] = (int)tile_count(rows, cols, G::R);
  out[3] = G::NT;
  out[4] = (int)smem;
  out[5] = fa.numRegs;
  out[6] = (int)fa.localSizeBytes;
  return 0;
}

template <typename T, bool FAST>
int multicycle_occupancy(long long rows, long long cols, int biz, int* out) {
  typedef MultiGeom<T> MG;
  const bool small = multi_window<T>(rows, cols) == MG::Small::W;
  if (small)
    return biz ? multicycle_occupancy<T, FAST, true, typename MG::Small>(rows, cols, out)
               : multicycle_occupancy<T, FAST, false, typename MG::Small>(rows, cols, out);
  return biz ? multicycle_occupancy<T, FAST, true, typename MG::Large>(rows, cols, out)
             : multicycle_occupancy<T, FAST, false, typename MG::Large>(rows, cols, out);
}

}  // namespace armon
