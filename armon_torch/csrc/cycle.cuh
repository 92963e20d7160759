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
// operations and latency. The grids it admits (<= 256 KiB per field) stay
// in the 50 MB L2 for all K cycles, so the sweeps' flops and one grid-wide
// barrier per cycle set its floor, not HBM.
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
// K5's design (`cycle_tile`, also run by the probe's `base_l32`): a block
// owns an R x R output tile (R = L - 2 HALO) and works on
// the L x L window around it. The load fills both ghost bands from the
// pre-cycle state, Y mirror and X mirror (the X sweep is row-local and
// exactly odd in v, so this equals filling before each sweep bit for bit:
// `_cycle_kernel`'s docstring). On a shard of a mesh sharded along Y, a
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
// per thread, with the line's stride in S as the shifted-read stride. The block
// writes its tile's rho/u/v/E (+ p) to the second buffer set and, when it
// emits, one pair of CFL partial maxima. The TPU's full-width row chunks
// are not carried over: the TPU runs its grid in order out of a large
// VMEM, the card runs many small tiles at once.
//
// K5 is a cooperative launch of every tile of the grid at once. Each cycle:
// the dt recurrence (`dt_step`, the one K3 runs) and the run predicate,
// computed identically by every block; K4's tile body, or a copy when the
// cycle does not run; one grid-wide barrier; every block folds the cycle's
// partials into lm. The fields ping-pong between the two buffer sets and a
// cycle that does not run copies, so after K cycles the carry sits in the
// set K's parity names, whatever number of cycles ran. The partials are
// double-buffered by cycle parity, so one barrier per cycle suffices. Each
// cycle takes its sweep order and dt factors from the parity of the device
// cycle counter (the TPU kernel indexes a static schedule that starts on
// an even cycle; both agree there). Field and partial loads bypass L1
// (__ldcg): other blocks wrote them before the barrier. After the last
// cycle, block 0's thread 0 writes the loop scalars back and, in the last
// launch of a whole-run graph's body, sets the WHILE condition from
// iscal[next] (`set_while`, common.cuh).

#pragma once

#include <cooperative_groups.h>

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

constexpr int MULTI_L = 32;  // K5: 24 x 24 tiles, more blocks on small grids

// Measurement variants of K4 for the cycle probe
// (armon_torch/probes/cycle_variants.py, after scripts/perf_probe.py), a
// compile-time parameter of `cycle_kernel` (and of K5's `cycle_tile`)
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
};

struct MultiArgs {
  CycleArgs c;            // src = first buffer set, dst = second
  int ncycles;
  int x_first[2];         // by cycle parity
  double fx[2], fy[2];
  DtParams dt;
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
            false, rho, ax ? u : v, ax ? v : u, E, r2, a2, o2, e2, p, c);
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
            emit && cv_dt(V), rho, ax ? u : v, ax ? v : u, E, r2, a2, o2, e2, p, c);
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

// A cycle past the run's end: pass the tile's fields through.
template <typename T, int L>
__device__ __forceinline__ void copy_tile(const CycleArgs& a, Fields<const T> src,
                                          Fields<T> dst) {
  constexpr int R = Tile<L>::R;
  const long long r0 = (long long)blockIdx.y * R, c0 = (long long)blockIdx.x * R;
  for (int i = threadIdx.x; i < R * R; i += Tile<L>::NT) {
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

// One cycle with K5's tile body on L x L windows: the cycle probe's
// `base_l32` (K4's function on K5's 24 x 24 tiles).
template <typename T, bool FAST, bool BIZ, int L, int V = CV_BASE>
__global__ void __launch_bounds__(Tile<L>::NT) tile_kernel(const CycleArgs a) {
  constexpr int NT = Tile<L>::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* S = reinterpret_cast<T*>(smem);
  T* F = S + 9 * NT;
  const Fields<const T> src = const_fields<T>(a.src);
  const Fields<T> dst = fields<T>(a.dst);
  if (!reinterpret_cast<const int*>(a.iscal)[2]) {
    copy_tile<T, L>(a, src, dst);
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

template <typename T, bool FAST, bool BIZ, int L>
__global__ void __launch_bounds__(Tile<L>::NT) multicycle_kernel(const MultiArgs m) {
  constexpr int NT = Tile<L>::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* S = reinterpret_cast<T*>(smem);
  T* F = S + 9 * NT;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const CycleArgs& a = m.c;
  const int tid = threadIdx.x;
  T* scal = reinterpret_cast<T*>(a.scal);
  int* iscal = reinterpret_cast<int*>(a.iscal);
  T t = scal[0], dtp = scal[1], lm = scal[2], dt_last = scal[3];
  int cyc = iscal[0];
  bool ok = iscal[1] != 0, ran = iscal[2] != 0;
  const Fields<T> A = fields<T>(const_cast<void* const*>(a.src));
  const Fields<T> B = fields<T>(a.dst);
  T* p = reinterpret_cast<T*>(a.p);
  const long long nb = (long long)gridDim.x * gridDim.y;
  const long long b = (long long)blockIdx.y * gridDim.x + blockIdx.x;

  for (int k = 0; k < m.ncycles; ++k) {
    const bool run = runs(m.dt, t, cyc, ok);
    const bool odd = k & 1;
    Fields<const T> from;
    Fields<T> to;
    for (int f = 0; f < 4; ++f) {
      from.f[f] = odd ? B.f[f] : A.f[f];
      to.f[f] = odd ? A.f[f] : B.f[f];
    }
    T* part = reinterpret_cast<T*>(a.partials) + (odd ? 2 * a.n_partials : 0);
    DtStep<T> r = {T(0), T(0), false};
    if (run) {
      r = dt_step(m.dt, lm, dtp, cyc);
      const int par = cyc & 1;
      T mx = T(0), my = T(0);
      cycle_tile<T, FAST, BIZ, L>(a, from, to, p, r.dt_use * T(m.fx[par]),
                                  r.dt_use * T(m.fy[par]), m.x_first[par] != 0,
                                  true, S, F, mx, my);
      block_max2<T, NT>(S, tid, mx, my);
      if (tid == 0) {
        part[b] = S[0];
        part[a.n_partials + b] = S[NT];
      }
    } else {
      copy_tile<T, L>(a, from, to);
    }
    grid.sync();
    if (run) {
      // K3's fold, in every block: the same maxima, so the same lm.
      T mx = T(0), my = T(0);
      for (long long i = tid; i < nb; i += NT) {
        mx = jmax(mx, __ldcg(part + i));
        my = jmax(my, __ldcg(part + a.n_partials + i));
      }
      block_max2<T, NT>(S, tid, mx, my);
      const T lm_new = jmin(T(a.dx) / S[0], T(a.dy) / S[NT]);
      __syncthreads();  // S is the next cycle's scratch
      t = t + r.dt_use;
      cyc += 1;
      dtp = r.dt_next;
      lm = lm_new;
      ok = r.ok;
      dt_last = r.dt_use;
    }
    ran = run;
  }
  if (b == 0 && tid == 0) {
    scal[0] = t;
    scal[1] = dtp;
    scal[2] = lm;
    scal[3] = dt_last;
    iscal[0] = cyc;
    iscal[1] = ok ? 1 : 0;
    iscal[2] = ran ? 1 : 0;
    const bool go = runs(m.dt, t, cyc, ok);
    iscal[3] = go ? 1 : 0;
    set_while(m.cond, m.count, go);
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
// lies, and the factors it takes, as K5's `cycle_tile` loads it: the X
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

// One line of P positions through `run_body` (or the STREAM variant's
// copy), the velocities swapped for a Y line.
template <typename T, bool FAST, bool BIZ, int P, int V>
__device__ __forceinline__ void line(const CycleArgs& a, bool along_x, T dt, bool need_c,
                                     T (&rho)[P], T (&u)[P], T (&v)[P], T (&E)[P], T (&p)[P],
                                     T (&c)[P]) {
  if (V == CV_STREAM) return;
  const T dx = T(along_x ? a.dx : a.dy), inv = T(along_x ? a.inv_dx : a.inv_dy);
  if (along_x)
    run_body<T, FAST, BIZ, P, V != CV_NO_ROLL>(a.k, a.riemann, a.limiter, a.projection, dt, dx,
                                               inv, need_c, rho, u, v, E, p, c);
  else
    run_body<T, FAST, BIZ, P, V != CV_NO_ROLL>(a.k, a.riemann, a.limiter, a.projection, dt, dx,
                                               inv, need_c, rho, v, u, E, p, c);
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
    line<T, FAST, BIZ, PX, V>(a, true, dtx, false, rho, u, v, E, p, c);
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
    line<T, FAST, BIZ, PY, V>(a, false, dty, emit && cv_dt(V), rho, u, v, E, p, c);
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
    line<T, FAST, BIZ, PY, V>(a, false, dty, false, rho, u, v, E, p, c);
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
    line<T, FAST, BIZ, PX, V>(a, true, dtx, emit && cv_dt(V), rho, u, v, E, p, c);
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

// K5's tile body as a one-cycle kernel (the probe's base_l32).
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

template <typename T, bool FAST, bool BIZ>
int launch_multicycle(const MultiArgs& m, cudaStream_t s) {
  constexpr int L = MULTI_L;
  const size_t smem = Tile<L>::template smem<T>();
  auto kern = multicycle_kernel<T, FAST, BIZ, L>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return -5;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, Tile<L>::NT, smem);
  if (e != cudaSuccess) return (int)e;
  if ((long long)per_sm * sms < (long long)m.c.grid_x * m.c.grid_y) return -4;
  void* args[] = {const_cast<MultiArgs*>(&m)};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(m.c.grid_x, m.c.grid_y),
                                  dim3(Tile<L>::NT), args, smem, s);
  if (e != cudaSuccess) return (int)e;
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

template <typename T, bool FAST>
int dispatch_multicycle(const MultiArgs* m, cudaStream_t s) {
  constexpr int R = MULTI_L - 2 * HALO;
  const int err = check_tile_geometry(&m->c, R, R, true);
  if (err) return err;
  if (m->ncycles < 1) return -1;
  return m->c.biz ? launch_multicycle<T, FAST, true>(*m, s)
                  : launch_multicycle<T, FAST, false>(*m, s);
}

}  // namespace armon
