// K5 `multicycle` as one thread-block cluster (sm_90a): a redesign of the
// solver's K5 (cycle.cuh `multicycle_kernel`, the tiled cooperative
// kernel) that holds the grid in the cluster's distributed shared memory
// from the first cycle to the last. Kept as a probe (probes/cluster.py,
// probe_cluster.cu), not on the solver's path: on the H100 it is slower
// than the tiled K5 at every grid the routing admits (PERF.md, Findings).
//
// Computes what `_multicycle_kernel` (armon_tpu/ops/pallas/sweep.py:1905,
// with `_mc_ext` :1883, called by `fused_multicycle` at :2046) computes.
// Each of the K cycles runs the dt recurrence (`dt_step`) and the run
// predicate (`runs`, common.cuh), both sweeps in the order and with the
// dt factors of the cycle's parity, each after the mirror fill of its
// axis, the stale p, and the CFL fold into lm. A cycle past the stop
// changes nothing. The carry ends in the buffer set that K's parity
// names.
//
// Bound on this card: operations and latency. The grids it admits (the
// routing's 256 KiB cap per padded field) hold at most ~60 K real cells;
// device memory is read once (rho/u/v/E) at the start and written once
// (the carry and p) at the end, so HBM never bounds it: at Sod 100^2, 8
// cycles of 2 x 192 operations per cell take ~1 us of the card's f32
// lane rate, ~0.2 us of bytes. What bounds it is how many SMs work, how
// long their dependent chains are, and the barriers.
//
// Design, against what held the tiled kernel back (25 blocks of 8 warps
// on 132 SMs at 108^2, ~45 block barriers and a grid-wide barrier a
// cycle, every field through L2 every cycle):
// - One cluster of C = 16 CTAs (the non-portable limit), one per SM
//   (`plan` in probes/cluster.py picks the bands; `check_plan` here
//   checks them). The grid's real cells live in the CTAs' shared memory
//   in one of two layouts: by rows (CTA r holds the real rows [r Br, r Br + Br), each row whole) or
//   by columns (the real columns [r Bc, r Bc + Bc), each column whole).
//   Two field sets A and B and a plane of p, each plane large enough for
//   either layout (see `McView`). Only real cells are stored: ghost cells
//   are index maps.
// - Every sweep runs on lines its CTA holds whole: an X sweep reads a set
//   laid out by rows, a Y sweep one laid out by columns. It writes its
//   outputs into the other set in the layout the next sweep reads: by
//   columns after an X sweep followed by a Y sweep, a transposition
//   through the cluster's distributed shared memory (DSMEM stores into
//   the CTA that owns the cell), or in its own layout, locally, when the
//   next sweep runs along the same axis (Godunov's splitting across a
//   cycle's end). So a sweep reads only its own CTA's shared memory and
//   no line is cut, and no halo is swept twice.
// - A line is cut into pieces of at most W positions, W - 2 HALO written,
//   each piece a group of lanes, each lane a run of P consecutive
//   positions through `run_body` (sweep.cuh, shared with K1 and K4:
//   neighbours through registers and shuffles, no barrier in the sweep).
//   Short pieces pack 32 / Lg groups of Lg lanes into a warp; a group reads
//   its neighbour group's end only at halo positions, which it never
//   writes. The positions beyond the real cells read their mirror, the
//   ghost fill of the swept axis, in the load. The first sweep reads A and
//   writes B, the second reads B and writes A, and p in its own layout.
// - The cross-sweep EOS fold (`SweepFold`, sweep.cuh), as K5's: in the
//   instances that fold (`FOLDS`), the first sweep writes its new density
//   unscaled into B, and the second rebuilds rho from it and folds its
//   pressure.
// - Filling before each sweep equals the plain version's fill of both
//   bands from the pre-cycle state bit for bit: the first sweep is
//   line-local and exactly odd in the other velocity, so it commutes with
//   the other axis's mirror (`_cycle_kernel`'s docstring).
// - Barriers, a cycle: one cluster barrier between the sweeps and one
//   after the second, no block barrier. Before the second, every warp
//   stores its pair of CFL maxima into every CTA's shared memory; after
//   it, every warp folds all C x NW pairs from its own CTA and computes
//   the same lm (max and min are exact in any order).
// - The store writes every padded cell: real cells from A, ghost cells as
//   their mirror fill, and p (when a cycle ran) likewise; each CTA the
//   padded lines whose source lines it holds.

#pragma once

#include <cooperative_groups.h>

#include "sweep.cuh"

namespace armon {

struct McArgs {
  const void* src[4];     // rho, u, v, E (input)
  void* dst[4];           // the second buffer set
  void* p;                // stale p (written when a cycle ran)
  void* scal;             // T[4]: t, dt_prev, lm, dt_use (read and written)
  void* iscal;            // int32[4]: cycle, ok, run, next
  long long rows, cols;   // the padded shape
  int g, nx, ny;
  int riemann, limiter, projection, fast, biz;
  int ncycles;
  int x_first[2];         // by cycle parity
  // The plan (probes/cluster.py `plan`): rows and columns a CTA holds in
  // each layout, the stride of a line in each (`McView`), the elements of
  // one plane.
  int band_r, band_c, pitch_r, pitch_c, plane;
  long long smem;         // dynamic shared memory a CTA uses
  double fx[2], fy[2];    // dt factors by cycle parity
  double dx, dy, inv_dx, inv_dy;  // rounded to T
  double fx_lo[4], fx_hi[4];  // X-side mirror factors of (rho, u, v, E)
  double fy_lo[4], fy_hi[4];  // Y-side mirror factors
  double k[K_COUNT];
  double kf_x, kf_y;      // the EOS fold's K after an X sweep, after a Y sweep (`SweepFold`)
  DtParams dt;
};

// The geometry: runs of P positions, pieces of at most W positions (RW
// written), NW warps a CTA, CLUSTER CTAs (the non-portable cluster
// size), HEAD bytes of shared memory before the planes (every
// warp's pair of CFL maxima).
template <typename T> struct McGeom {
  static constexpr int P = sizeof(T) == 4 ? 2 : 4, NW = sizeof(T) == 4 ? 16 : 8;
  static constexpr int NT = 32 * NW, W = 32 * P, RW = W - 2 * HALO;
  static constexpr int CLUSTER = 16, PLANES = 9;
  static constexpr int HEAD = CLUSTER * NW * 2 * sizeof(T);
};

// Position k of a line of n real cells (real coordinates): the real cell
// it reads, with the mirror factors folded into fac; high side first, as
// `ghost_src` resolves a band thinner than the halo. Positions past the
// padded array are clamped: dead outputs only.
template <typename T>
__device__ __forceinline__ int mc_mirror(int k, int n, const double* f_lo, const double* f_hi,
                                         T fac[4]) {
  if (k >= n) {
    k = 2 * n - 1 - k;
#pragma unroll
    for (int f = 0; f < 4; ++f) fac[f] = fac[f] * T(f_hi[f]);
  }
  if (k < 0) {
    k = -1 - k;
#pragma unroll
    for (int f = 0; f < 4; ++f) fac[f] = fac[f] * T(f_lo[f]);
  }
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}

// The cluster's shared memory: plane q (A: 0-3, B: 4-7, p: 8) of every
// CTA, real cell (r, c) in layout `by_cols` (false: by rows). Each layout
// keeps the other axis contiguous: by rows, a CTA's rows of one column
// are consecutive (`pr` apart from the next column's); by columns, its
// columns of one row. A sweep then reads its lines with a stride (odd, so
// a warp's runs of 2 fall in 16 banks), and the transposing store of a
// warp's piece writes consecutive elements of the owner's plane.
template <typename T> struct McView {
  T* base;  // this CTA's plane 0
  int plane, br, bc, pr, pc;
  __device__ __forceinline__ int owner(bool by_cols, int r, int c) const {
    return by_cols ? c / bc : r / br;
  }
  __device__ __forceinline__ int index(bool by_cols, int r, int c, int own) const {
    return by_cols ? r * pc + (c - own * bc) : c * pr + (r - own * br);
  }
  __device__ __forceinline__ T* local(int q, bool by_cols, int r, int c, int rank) const {
    return base + q * plane + index(by_cols, r, c, rank);
  }
  __device__ __forceinline__ T* at(cooperative_groups::cluster_group& cl, int q, bool by_cols,
                                   int r, int c) const {
    const int own = owner(by_cols, r, c);
    return cl.map_shared_rank(base + q * plane + index(by_cols, r, c, own), own);
  }
};

// One sweep of this CTA's lines (see the file note): the rows it holds
// (along X, set `from` laid out by rows) or its columns (along Y, by
// columns). Writes set `to` laid out by columns when `to_cols`. LAST: the
// cycle's second sweep, which also writes p (in its own layout) and takes
// the CFL samples of its outputs.
template <typename T, bool FAST, bool BIZ, bool LAST>
__device__ __forceinline__ void mc_sweep(const McArgs& a, cooperative_groups::cluster_group& cl,
                                         const McView<T>& V, bool along_x, int from, int to,
                                         bool to_cols, T dt, T& mx, T& my) {
  typedef McGeom<T> G;
  constexpr int P = G::P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, rank = (int)cl.block_rank();
  const int n = along_x ? a.nx : a.ny, band = along_x ? a.band_r : a.band_c;
  const int l0 = rank * band, lines = max(0, min(band, (along_x ? a.ny : a.nx) - l0));
  if (lines == 0) return;  // a CTA past the last band
  const bool own_cols = !along_x;
  const int lg = min(32, (min(n, G::RW) + 2 * HALO + P - 1) / P);  // lanes a piece
  const int pw = P * lg - 2 * HALO, pieces = (n + pw - 1) / pw;
  const int gpw = 32 / lg, group = lane / lg, pos0 = P * (lane - group * lg);
  const int items = lines * pieces;
  const double* f_lo = along_x ? a.fx_lo : a.fy_lo;
  const double* f_hi = along_x ? a.fx_hi : a.fy_hi;
  const T dx = T(along_x ? a.dx : a.dy), inv = T(along_x ? a.inv_dx : a.inv_dy);
  // The cross-sweep EOS fold, as K5's (`cycle_fold`): the first sweep
  // stores X, the second (LAST) rebuilds rho from it.
  SweepFold<T> fold;
  if (FOLDS<FAST, BIZ>) {
    fold.in = LAST;
    fold.out = !LAST;
    fold.rdx = T(along_x ? a.inv_dy : a.inv_dx);
    fold.k = T(along_x ? a.kf_y : a.kf_x);
  }
#pragma unroll 1
  for (int first = warp * gpw; first < items; first += G::NW * gpw) {
    const int item = first + group;
    const bool live = group < gpw && item < items;
    const int line = l0 + (live ? item / pieces : 0);
    const int k0 = (live ? item % pieces * pw : 0) - HALO + pos0;
    T rho[P], ua[P], uo[P], E[P], p[P], c[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      T fac[4] = {T(1), T(1), T(1), T(1)};
      const int k = mc_mirror<T>(k0 + j, n, f_lo, f_hi, fac);
      const T* q = V.local(from, own_cols, along_x ? line : k, along_x ? k : line, rank);
      const T in1 = q[V.plane], in2 = q[2 * V.plane];
      rho[j] = q[0] * fac[0];
      ua[j] = (along_x ? in1 : in2) * fac[along_x ? 1 : 2];
      uo[j] = (along_x ? in2 : in1) * fac[along_x ? 2 : 1];
      E[j] = q[3 * V.plane] * fac[3];
    }
    run_body<T, FAST, BIZ, P>(a.k, a.riemann, a.limiter, a.projection, dt, dx, inv, LAST,
                              !along_x, rho, ua, uo, E, p, c, fold);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int lp = pos0 + j, k = k0 + j;
      if (!live || lp < HALO || lp >= HALO + pw || k >= n) continue;
      const int r = along_x ? line : k, cc = along_x ? k : line;
      const T u = along_x ? ua[j] : uo[j], v = along_x ? uo[j] : ua[j];
      T* q = V.at(cl, to, to_cols, r, cc);
      q[0] = rho[j];
      q[V.plane] = u;
      q[2 * V.plane] = v;
      q[3 * V.plane] = E[j];
      if (LAST) {
        *V.local(8, own_cols, r, cc, rank) = p[j];
        // `_dt_tile_min`: post-sweep velocities, pre-sweep c.
        mx = jmax(mx, fabs(u) + c[j]);
        my = jmax(my, fabs(v) + c[j]);
      }
    }
  }
}

template <typename T, bool FAST, bool BIZ>
__global__ void __launch_bounds__(McGeom<T>::NT, 1) cluster_kernel(const McArgs a) {
  typedef McGeom<T> G;
  constexpr int NW = G::NW, NT = G::NT;
  cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  T* maxima = reinterpret_cast<T*>(smem);  // (C, NW, 2): every warp's CFL maxima
  const McView<T> V = {reinterpret_cast<T*>(smem + G::HEAD), a.plane, a.band_r, a.band_c,
                       a.pitch_r, a.pitch_c};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cl.block_rank(), C = G::CLUSTER;
  const int g = a.g, nx = a.nx, ny = a.ny;
  const long long cols = a.cols;
  T* scal = reinterpret_cast<T*>(a.scal);
  int* iscal = reinterpret_cast<int*>(a.iscal);
  T t = scal[0], dtp = scal[1], lm = scal[2], dt_last = scal[3];
  int cyc = iscal[0];
  bool ok = iscal[1] != 0, ran = iscal[2] != 0, any = false;

  // This CTA's lines into set A, in the layout the first cycle's first
  // sweep reads.
  bool by_cols = a.x_first[cyc & 1] == 0;
  {
    const int band = by_cols ? a.band_c : a.band_r, n = by_cols ? ny : nx;
    const int l0 = rank * band, nl = max(0, min(band, (by_cols ? nx : ny) - l0));
    for (int w = tid; w < nl * n; w += NT) {
      const int r = by_cols ? w % n : l0 + w / n, c = by_cols ? l0 + w / n : w % n;
      const long long o = (long long)(g + r) * cols + g + c;
      T* q = V.local(0, by_cols, r, c, rank);
#pragma unroll
      for (int f = 0; f < 4; ++f)
        q[f * V.plane] = __ldg(reinterpret_cast<const T*>(a.src[f]) + o);
    }
  }
  bool p_cols = false;
  cl.sync();  // every CTA's lines are loaded

  for (int k = 0; k < a.ncycles; ++k) {
    const bool run = runs(a.dt, t, cyc, ok);
    if (run) {
      const DtStep<T> r = dt_step(a.dt, lm, dtp, cyc);
      const int par = cyc & 1;
      const bool xf = a.x_first[par] != 0;
      const T dtx = r.dt_use * T(a.fx[par]), dty = r.dt_use * T(a.fy[par]);
      // The next cycle's first sweep reads by columns when it runs along Y.
      const bool next_cols = a.x_first[par ^ 1] == 0;
      T mx = T(0), my = T(0);  // the TPU's zero-initialised max block
      mc_sweep<T, FAST, BIZ, false>(a, cl, V, xf, 0, 4, xf, xf ? dtx : dty, mx, my);
      cl.sync();  // set B is complete
      mc_sweep<T, FAST, BIZ, true>(a, cl, V, !xf, 4, 0, next_cols, xf ? dty : dtx, mx, my);
      by_cols = next_cols;
      p_cols = xf;
      for (int s = 16; s > 0; s >>= 1) {
        mx = jmax(mx, __shfl_xor_sync(0xffffffffu, mx, s));
        my = jmax(my, __shfl_xor_sync(0xffffffffu, my, s));
      }
      if (lane < C) {  // the warp's pair into every CTA's maxima
        T* q = cl.map_shared_rank(maxima + 2 * (rank * NW + warp), lane);
        q[0] = mx;
        q[1] = my;
      }
      cl.sync();  // set A, p and every warp's maxima are complete
      // K3's fold, in every warp: the same maxima, so the same lm.
      T cx = T(0), cy = T(0);
      for (int i = lane; i < C * NW; i += 32) {
        cx = jmax(cx, maxima[2 * i]);
        cy = jmax(cy, maxima[2 * i + 1]);
      }
      for (int s = 16; s > 0; s >>= 1) {
        cx = jmax(cx, __shfl_xor_sync(0xffffffffu, cx, s));
        cy = jmax(cy, __shfl_xor_sync(0xffffffffu, cy, s));
      }
      t = t + r.dt_use;
      cyc += 1;
      dtp = r.dt_next;
      lm = jmin(T(a.dx) / cx, T(a.dy) / cy);
      ok = r.ok;
      dt_last = r.dt_use;
      any = true;
    }
    ran = run;
  }

  // The carry into the set K's parity names: every padded cell, ghost
  // cells as their mirror fill. A CTA writes the padded lines (rows when
  // set A is laid out by rows) whose mirror source it holds, so it reads
  // only its own shared memory.
  T* out[4];
#pragma unroll
  for (int f = 0; f < 4; ++f)
    out[f] = (a.ncycles & 1) ? reinterpret_cast<T*>(a.dst[f])
                             : const_cast<T*>(reinterpret_cast<const T*>(a.src[f]));
  T* p_out = reinterpret_cast<T*>(a.p);
  const int rows = (int)a.rows, ncols = (int)cols;
  const int plines = by_cols ? ncols : rows, plen = by_cols ? rows : ncols;
  const int n_line = by_cols ? nx : ny, n_len = by_cols ? ny : nx;
  const int band = by_cols ? a.band_c : a.band_r;
  const double* fl_lo = by_cols ? a.fx_lo : a.fy_lo;
  const double* fl_hi = by_cols ? a.fx_hi : a.fy_hi;
  const double* fe_lo = by_cols ? a.fy_lo : a.fx_lo;
  const double* fe_hi = by_cols ? a.fy_hi : a.fx_hi;
  for (int gl = warp; gl < plines; gl += NW) {
    T fl[4] = {T(1), T(1), T(1), T(1)};
    const int l = mc_mirror<T>(gl - g, n_line, fl_lo, fl_hi, fl);
    if (l / band != rank) continue;
    for (int ge = lane; ge < plen; ge += 32) {
      T fac[4] = {fl[0], fl[1], fl[2], fl[3]};
      const int e = mc_mirror<T>(ge - g, n_len, fe_lo, fe_hi, fac);
      const int r = by_cols ? e : l, c = by_cols ? l : e;
      const long long w = (long long)(by_cols ? ge : gl) * cols + (by_cols ? gl : ge);
      const T* q = V.local(0, by_cols, r, c, rank);
#pragma unroll
      for (int f = 0; f < 4; ++f) out[f][w] = q[f * V.plane] * fac[f];
      // p, in the layout the last second sweep left it.
      if (any) p_out[w] = p_cols == by_cols ? *V.local(8, by_cols, r, c, rank)
                                           : *V.at(cl, 8, p_cols, r, c);
    }
  }
  if (rank == 0 && tid == 0) {
    scal[0] = t;
    scal[1] = dtp;
    scal[2] = lm;
    scal[3] = dt_last;
    iscal[0] = cyc;
    iscal[1] = ok ? 1 : 0;
    iscal[2] = ran ? 1 : 0;
    iscal[3] = runs(a.dt, t, cyc, ok) ? 1 : 0;
  }
  cl.sync();  // no CTA leaves while another reads its shared memory
}

// Host side. Checks the plan the Python wrapper computed (`plan`): every
// real row in one CTA's rows and every real column in one CTA's columns,
// a CTA's lines within the stride, both layouts within a plane, the
// shared memory it states. Returns 0 or a negative code.
template <typename T>
inline int check_plan(const McArgs* m) {
  typedef McGeom<T> G;
  const long long C = G::CLUSTER, br = m->band_r, bc = m->band_c;
  if (m->ncycles < 1) return -1;
  if (br < 1 || bc < 1 || C * br < m->ny || C * bc < m->nx) return -7;
  if (m->pitch_r < br || m->pitch_c < bc || m->nx < 1 || m->ny < 1) return -7;
  if ((long long)m->plane < (long long)m->nx * m->pitch_r ||
      (long long)m->plane < (long long)m->ny * m->pitch_c)
    return -7;
  if (m->rows != m->ny + 2LL * m->g || m->cols != m->nx + 2LL * m->g) return -7;
  const long long need = G::HEAD + (long long)G::PLANES * m->plane * sizeof(T);
  if (need != m->smem || need > 232448) return -8;
  return 0;
}

// The launch configuration of one cluster of CLUSTER CTAs.
template <typename T>
void cluster_config(const McArgs& m, cudaStream_t s, cudaLaunchConfig_t* cfg,
                    cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(McGeom<T>::CLUSTER);
  cfg->blockDim = dim3(McGeom<T>::NT);
  cfg->dynamicSmemBytes = (size_t)m.smem;
  cfg->stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = McGeom<T>::CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Sets the kernel's attributes for this plan's shared memory and the
// non-portable cluster size on the current card and asks how many such
// clusters the card holds at once (`clusters`); remembered per card for
// the last plan, so that a run's launches after the first skip both
// calls.
template <typename T, bool FAST, bool BIZ>
int cluster_prepare(const McArgs& m, int* clusters) {
  struct Prepared { long long smem; int clusters; };
  static Prepared done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  Prepared& d = done[dev & 63];
  if (d.smem == m.smem) {
    *clusters = d.clusters;
    return 0;
  }
  auto kern = cluster_kernel<T, FAST, BIZ>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)m.smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config<T>(m, nullptr, &cfg, attr);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
  if (e != cudaSuccess) return (int)e;
  d = {m.smem, *clusters};
  return 0;
}

// out: clusters of this plan the card can hold at once, threads a CTA,
// registers a thread, local memory (spills) a thread.
template <typename T, bool FAST, bool BIZ>
int cluster_occupancy(const McArgs& m, int* out) {
  int e = cluster_prepare<T, FAST, BIZ>(m, &out[0]);
  if (e) return e;
  cudaFuncAttributes fa;
  cudaError_t ce = cudaFuncGetAttributes(&fa, cluster_kernel<T, FAST, BIZ>);
  out[1] = McGeom<T>::NT;
  out[2] = fa.numRegs;
  out[3] = (int)fa.localSizeBytes;
  return (int)ce;
}

template <typename T, bool FAST, bool BIZ>
int launch_cluster(const McArgs& m, cudaStream_t s) {
  int clusters = 0;
  int e = cluster_prepare<T, FAST, BIZ>(m, &clusters);
  if (e) return e;
  if (clusters < 1) return -6;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config<T>(m, s, &cfg, attr);
  cudaError_t ce = cudaLaunchKernelEx(&cfg, cluster_kernel<T, FAST, BIZ>, m);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

template <typename T, bool FAST>
int dispatch_cluster(const McArgs* m, cudaStream_t s, int* occupancy) {
  const int err = check_plan<T>(m);
  if (err) return err;
  if (occupancy)
    return m->biz ? cluster_occupancy<T, FAST, true>(*m, occupancy)
                  : cluster_occupancy<T, FAST, false>(*m, occupancy);
  return m->biz ? launch_cluster<T, FAST, true>(*m, s)
                : launch_cluster<T, FAST, false>(*m, s);
}

}  // namespace armon
