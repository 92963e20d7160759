// Per-sweep hydro kernels for Hopper (sm_90a): K1 `x_sweep_kernel` and K2
// `y_sweep_kernel`, and the device bodies of the sweep: `sweep_body` (one
// position per thread, neighbours through shared memory; run by K5's tile
// body and the probes) and `run_body` (a run of positions per lane,
// neighbours through registers and shuffles; run by K1 and K4).
//
// Replaces the TPU kernels `_x_sweep_kernel` and `_y_sweep_kernel` of
// armon_tpu/ops/pallas/sweep.py (with their body `_sweep_math`, the
// in-kernel mirror fills `_bc_x_apply` / `_halo_cat_bc`, the slab splices
// of a domain-decomposed run `_bc_x_apply_slab` / `_halo_cat_slab`, and
// the CFL tile reduction `_dt_tile_min`).
//
// Bound on this card: bytes and instructions come close. A sweep reads
// rho/u/v/E once and writes them once (plus the stale p on the cycle's
// last sweep), 32-36 bytes per cell in f32, against 192 operations per
// cell (-fmad=false: one lane instruction each): at 8200^2, 0.64-0.72 ms
// of bytes and 0.77 ms of operations; the card's issue of the compiled
// body takes more (PERF.md).
//
// Design. No block barrier and no shared memory inside a sweep: every
// k-1 / k+1 operand is a register. The outer HALO = 4 positions on each
// side of a segment are read but not written, which covers the sweep's
// dependency depth (<= 4 = nghost floor). The intermediates (EOS, fluxes,
// slopes) never leave the SM. Output goes to a second buffer set (out of
// place): GPU blocks run concurrently, so the TPU's in-place update would
// race on the halo. Every block is on grid_x, so any padded shape with
// int32 rows and columns launches (the TPU's X kernel tiles rows too).
// - K1 (`XGeom`): a warp sweeps windows of 128 consecutive columns of a
//   row (120 written, 1.067x the cells), each lane a run of 4 through
//   `run_body` with shuffles at the runs' ends, as K4's X-first sweep
//   does; rows load and store as 16-byte vectors, the next window's loads
//   in flight during this one's sweep. Up to 8 windows a warp, fewer on a
//   small grid so that it still has 2048 blocks.
// - K2 (`YGeom`): a thread marches down one column of 128 output rows
//   (136 read, 1.0625x; 64 or 32 on a grid that would otherwise have
//   fewer than 512 blocks), a warp on 32 consecutive columns so every row
//   access is one 128-byte line. The seven stages run as a register
//   pipeline over rows: at step i stages 1-2 at row i, 3 at i-1, 4 at i-2,
//   5-6 at i-3, 7 at i-4, so a stage's neighbours are the registers of the
//   steps before, and stages on different rows give the scheduler
//   independent work.
// - CFL partials: a running max per thread, folded by warp shuffles and
//   once per block through shared memory; one pair per block. The cycle's
//   last launch (`x_sweep_finish_kernel`, `y_sweep_finish_kernel`) then
//   runs K3's fold and dt step in its tail (`cfl_tail`, common.cuh): the
//   last block to finish folds every block's pair.

// Ghost bands are filled in the load, per side of the swept axis: mirror
// (a global border), slab (a mesh neighbour's g real lines, packed by the
// host into a (4, rows, g) X or (4, g, cols) Y buffer: the TPU kernels'
// `slab_x` / `slab_y` variants, whose 128-lane padding and 8-row strips
// are Mosaic layouts and do not carry over) or none (filled beforehand).
// The mirror reflects about the shard's own n_real, so the hi-edge shard
// of an uneven split needs no write-back of its band.
//
// Arithmetic follows `_sweep_math` operation by operation. Exact mode
// (FAST=false: f64, and f32 without fast math) uses IEEE divides and sqrt,
// and the library is built with -fmad=false so no multiply-add is fused.
// Fast mode (f32 only) puts the approximate reciprocal exactly where the
// TPU kernel does: one Newton step for primary divides, the raw reciprocal
// for second-order correction factors.

#pragma once

#include <stdint.h>

#include "common.cuh"

namespace armon {

constexpr int HALO = 4;


// EOS constants, precomputed on the host in dtype T with the exact numpy
// expressions of the TPU kernel (see ops/_build.py).
enum EosConst {
  K_GM = 0, K_GM1, K_RHO0, K_S, K_SK, K_Q, K_R, K_2Q, K_3R, K_6R, K_2S,
  K_G0, K_EPS0, K_CV0T0, K_C05K0R, K_PK0C, K_C05K0, K_CM05K0, K_G0RHO0,
  K_INVRHO0, K_E1C, K_E2C, K_E3C, K_PPC, K_COUNT
};

// Ghost source of one side of an axis (`ghost_mode`, ops/sweep.py).
enum GhostMode { GHOST_NONE = 0, GHOST_MIRROR = 1, GHOST_SLAB = 2 };

struct SweepArgs {
  const void* src[4];     // rho, u, v, E (input)
  void* dst[4];           // rho, u, v, E (output, distinct buffers)
  void* p;                // stale p (written when emit)
  void* partials;         // CFL maxima, rows n_partials apart (written when emit)
  const void* scal;       // T[4]: t, dt_prev, lm, dt_use
  const void* iscal;      // int32[4]: cycle, ok, run, next
  const void* slab_lo;    // (4, rows, g) X / (4, g, cols) Y, when mode_lo is SLAB
  const void* slab_hi;    // the same for the high side
  long long rows, cols, n_partials;
  int grid_x, grid_y;
  int g, nx, ny;          // nx, ny: this shard's real cells
  int riemann;            // 0 Godunov, 1 GAD
  int limiter;            // 0 no_limiter, 1 minmod, 2 superbee
  int projection;         // 0 euler, 1 euler_2nd
  int mode_lo, mode_hi;   // GhostMode of the low / high side of the axis
  int emit;               // last sweep of the cycle: stale p + CFL partials
  int fast;               // approximate-reciprocal divides (f32 only)
  int biz;                // Bizarrium EOS (else perfect gas)
  double dt_factor;       // dt = dt_use * T(dt_factor)
  double dx;              // T(cell size along the axis)
  double inv_dx;          // T(1) / T(dx)
  double f_lo[4], f_hi[4];  // mirror factors of (rho, u, v, E)
  double k[K_COUNT];
  int fold_in;            // rho holds the previous sweep's unscaled density (`SweepFold`)
  int x_out;              // store the unscaled new density
  double fold_rdx, fold_k;  // with fold_in: T(1/d), K of the previous sweep's axis
};

// The cross-sweep EOS fold of one sweep (ROADMAP C2: XLA folds the
// previous sweep's (X * (1/d)) * (gamma-1) into X * K across the sweeps
// of one cycle of the JAX package's jnp tier; `ops/eos.folds`). `in`: the
// rho operand holds the previous sweep of the cycle's unscaled new
// density X; the sweep takes rho = X * rdx, the value that sweep would
// have stored, and the perfect gas's p = (X * k) * e. `out`: the sweep
// stores its new density unscaled (no multiply by inv_dx). Exact
// perfect-gas instances only: the fast-math and Bizarrium instances
// compile it away (`FOLDS`).
template <typename T> struct SweepFold {
  bool in = false, out = false;
  T rdx = T(0), k = T(0);
};
template <bool FAST, bool BIZ> constexpr bool FOLDS = !FAST && !BIZ;

// Division primitives (`_make_div`, `_make_div_correction`, `_div_shared`).
template <typename T, bool FAST> struct Div {
  static __device__ __forceinline__ T div(T a, T b) { return a / b; }
  static __device__ __forceinline__ T divc(T a, T b) { return a / b; }
  // Shared denominator: `over(a)` == div(a, b) bitwise.
  struct Over {
    T b;
    __device__ __forceinline__ explicit Over(T b_) : b(b_) {}
    __device__ __forceinline__ T operator()(T a) const { return a / b; }
  };
};

__device__ __forceinline__ float rcp_approx(float b) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(b));
  return r;
}
__device__ __forceinline__ float rcp_newton(float b) {
  float r = rcp_approx(b);
  return r * (2.0f - b * r);
}

template <> struct Div<float, true> {
  static __device__ __forceinline__ float div(float a, float b) { return a * rcp_newton(b); }
  static __device__ __forceinline__ float divc(float a, float b) { return a * rcp_approx(b); }
  struct Over {
    float r;
    __device__ __forceinline__ explicit Over(float b) : r(rcp_newton(b)) {}
    __device__ __forceinline__ float operator()(float a) const { return a * r; }
  };
};

template <typename T> __device__ __forceinline__ T limiter(int name, T r) {
  if (name == 0) return T(1);
  if (name == 1) return jmax(T(0), jmin(T(1), r));
  return jmax(jmax(T(0), jmin(T(2) * r, T(1))), jmin(r, T(2)));
}

// `_eos_prc`: pressure, impedance rho*c, sound speed c (only formed when
// needed: always in exact mode), and the refined 1/rho of the fast
// Bizarrium chain (rr, reused by the Lagrangian update). The internal
// energy contracts u*u + v*v as fma(u, u, v*v) whatever the axis
// (`along_y`: ua is v). `folded` (`SweepFold`): the perfect gas's p is
// xk * e, xk = X * K.
template <typename T, bool FAST, bool BIZ>
__device__ __forceinline__ void eos_prc(const double* kk, T rho, T ua, T uo, T E,
                                        bool need_c, bool along_y, T& p, T& rc, T& c,
                                        T& rr, bool folded = false, T xk = T(0)) {
  typedef Div<T, FAST> D;
  const T half = T(0.5);
  const T uu = along_y ? uo : ua, vv = along_y ? ua : uo;
  const T e = fmadd(fmadd(uu, uu, vv * vv), -half, E);
  if (BIZ) {
    if (FAST) {
      const T s = T(kk[K_S]), q = T(kk[K_Q]), r = T(kk[K_R]), k = T(kk[K_SK]);
      T r_rho = D::div(T(1), rho);  // Newton-refined reciprocal
      const T x = rho * T(kk[K_INVRHO0]) - T(1);
      const T x2 = x * x;
      typename D::Over over_sx(T(1) - s * x);
      const T f0 = over_sx(((r * x + q) * x + k) * x + T(1));
      const T f1 = over_sx((T(kk[K_3R]) * x + T(kk[K_2Q])) * x + k + s * f0);
      const T f2t = over_sx(T(kk[K_6R]) * x + T(kk[K_2Q]) + T(kk[K_2S]) * f1);
      const T epsk0 = (T(kk[K_E1C]) + T(kk[K_E2C]) * r_rho) + T(kk[K_E3C]) * (x2 * f0);
      const T xp1 = T(1) + x;
      const T xp12 = xp1 * xp1;
      const T pk0 = T(kk[K_PK0C]) + (T(kk[K_C05K0]) * (x * xp12)) * (T(2) * f0 + x * f1);
      const T pk0prime = (T(kk[K_PPC]) * (xp12 * xp1)) *
          (((T(6) * x + T(2)) * f0 + (x * (T(6) * x + T(4))) * f1) + (x2 * xp1) * f2t);
      const T tt = T(kk[K_G0RHO0]) * (e - epsk0);
      p = pk0 + tt;
      const T sq = sqrt(T(kk[K_G0RHO0]) * tt - pk0prime);
      rc = sq;
      if (need_c) c = sq * r_rho;
      rr = r_rho;
      return;
    }
    const T rho0 = T(kk[K_RHO0]), s = T(kk[K_S]);
    const T x = rho / rho0 - T(1);
    const T G = T(kk[K_G0]) * (T(1) - D::div(rho0, rho));
    typename D::Over over_sx(T(1) - s * x);
    const T x2 = x * x;
    const T f0 = over_sx(T(1) + T(kk[K_SK]) * x + T(kk[K_Q]) * x2 + T(kk[K_R]) * (x * x2));
    const T f1 = over_sx(T(kk[K_SK]) + T(kk[K_2Q]) * x + T(kk[K_3R]) * x2 + s * f0);
    const T epsk0 = T(kk[K_EPS0]) - T(kk[K_CV0T0]) * (T(1) + G) + T(kk[K_C05K0R]) * x2 * f0;
    const T xp1 = T(1) + x;
    const T pk0 = T(kk[K_PK0C]) + T(kk[K_C05K0]) * x * (xp1 * xp1) * (T(2) * f0 + x * f1);
    const T pk0prime = T(kk[K_CM05K0]) * (xp1 * (xp1 * xp1)) * rho0 *
        (T(2) * (T(1) + T(3) * x) * f0 + T(2) * x * (T(2) + T(3) * x) * f1 +
         x2 * xp1 * over_sx(T(kk[K_2Q]) + T(kk[K_6R]) * x + T(kk[K_2S]) * f1));
    p = fmadd(T(kk[K_G0RHO0]), e - epsk0, pk0);
    const T sq = sqrt(fmadd(T(kk[K_G0RHO0]), p - pk0, -pk0prime));
    if (FAST && !need_c) {  // rho * (sq/rho) == sq up to 2 ulp
      rc = sq;
      return;
    }
    c = D::div(sq, rho);
    rc = rho * c;
    return;
  }
  const T gm = T(kk[K_GM]);
  p = (FOLDS<FAST, BIZ> && folded) ? xk * e : T(kk[K_GM1]) * rho * e;
  if (FAST && !need_c) {
    rc = sqrt(gm * p * rho);
    return;
  }
  c = sqrt(D::div(gm * p, rho));
  rc = rho * c;
}

// The ghost fill along one axis as an index map. Position k of an axis
// with g ghosts and n_real real cells reads the array at the returned
// position times the factors folded into fac (`slab` = -1), or line
// `returned` of the low (`slab` = 0) or high (1) side's slab. A mirror
// band reflects about the real cells; the high side is resolved first, so
// that a reflection landing in the low band (a grid thinner than the
// band) resolves there again: the sequential low-then-high fill. The
// factors are +-1, so folding those of two axes in either order is exact.
template <typename T>
__device__ __forceinline__ long long ghost_src(long long k, int g, int n_real,
                                               int mode_lo, int mode_hi,
                                               const double* f_lo, const double* f_hi,
                                               T fac[4], int& slab) {
  slab = -1;
  if (k >= g + n_real) {
    if (mode_hi == GHOST_SLAB) {  // past the band: dead outputs only
      slab = 1;
      k -= g + n_real;
      return k < g ? k : g - 1;
    }
    if (mode_hi == GHOST_MIRROR) {
      k = 2LL * g + 2LL * n_real - 1 - k;
      for (int f = 0; f < 4; ++f) fac[f] = fac[f] * T(f_hi[f]);
    }
  }
  if (k < g) {
    if (mode_lo == GHOST_SLAB) {
      slab = 0;
      return k < 0 ? 0 : k;
    }
    if (mode_lo == GHOST_MIRROR) {
      k = 2LL * g - 1 - k;
      for (int f = 0; f < 4; ++f) fac[f] = fac[f] * T(f_lo[f]);
    }
  }
  return k;
}

// `_sweep_math` at one position of a line, one position per thread (K5's
// tile body and the probes run it; K1, K2 and K4 run the same operations
// in the same order through `run_body` or K2's pipeline), with an explicit
// fused multiply-add at each site the plain version contracts
// (`ops/sweep.py` `sweep_math_plain`). The calling
// thread owns position k and reads the stage
// values of k-1 and k+1 through shared memory S (9 rows of NS values):
// `tm` / `tp` are those neighbours' slots, i.e. the thread's own slot minus
// / plus the line's stride in S, clamped at the line's ends (the outer
// HALO positions of a line are read but never valid). Every thread of the
// block must call it: it holds barriers. In: the axis velocity `ua`, the
// other one `uo` (`along_y`: ua is v). Out: the swept (rho, ua, uo, E) and
// the pre-sweep p and c (c only when need_c, or always in exact mode).
//
// SHIFT = false is the `no_roll` measurement variant of the cycle probe
// (armon_torch/probes/cycle_variants.py, scripts/perf_probe.py:80-87):
// every read at k-1 / k+1 takes the thread's own value times (1 + 1e-7 k)
// instead, with no shared-memory traffic and no barrier. Wrong numerics by
// design; production code always has SHIFT = true.
template <typename T, bool FAST, bool BIZ, int NS, bool SHIFT = true>
__device__ __forceinline__ void sweep_body(
    T* S, int tid, int tm, int tp, const double* kk, int riemann, int lim,
    int projection, T dt, T dx, T inv_dx, bool need_c, bool along_y,
    T rho, T ua, T uo, T E,
    T& rho_o, T& ua_o, T& uo_o, T& E_o, T& p, T& c) {
  typedef Div<T, FAST> D;
  auto sv = [S](int j, int i) -> T& { return S[j * NS + i]; };
  // Stage value j at slot t (tm: k-1, tp: k+1); `own` is this thread's.
  auto nb = [&](int j, int t, T own, int k) -> T {
    return SHIFT ? sv(j, t) : own * T(1 + 1e-7 * k);
  };
  auto sync = [] {
    if (SHIFT) __syncthreads();
  };

  // ---- stage 1: EOS of the input state. The neighbour's rho and c (its
  // rc in fast mode, where c is not formed): the blend contracts rho*c
  // and rho*dx of the neighbour into its sums.
  T rc, rr = T(0);
  c = T(0);
  eos_prc<T, FAST, BIZ>(kk, rho, ua, uo, E, need_c, along_y, p, rc, c, rr);
  const T dm = rho * dx;
  if (SHIFT) {
    sv(0, tid) = rho;
    sv(1, tid) = ua;
    sv(2, tid) = p;
    sv(3, tid) = FAST ? rc : c;
  }
  sync();

  // ---- stage 2: Godunov solve at the k-1/2 interface (`_godunov`)
  const T rho_m = nb(0, tm, rho, -1), u_m = nb(1, tm, ua, -1), p_m = nb(2, tm, p, -1);
  const T c_m = nb(3, tm, FAST ? rc : c, -1);
  const T rc_l = FAST ? c_m : rho_m * c_m;
  const T rc_sum = rc_l + rc;
  T us_i, ps_i;
  {
    typename D::Over over(rc_sum);
    us_i = over(fmadd(rc_l, u_m, rc * ua) + (p_m - p));
    ps_i = over(fmadd(rc_l * rc, u_m - ua, fmadd(rc, p_m, rc_l * p)));
  }
  const T e_u = us_i - u_m, e_p = ps_i - p_m;
  const T d_u = ua - us_i, d_p = p - ps_i;
  T theta = T(0);
  if (riemann == 1) {
    if (FAST) {
      theta = T(0.5) * fmadd(-rc_sum, D::divc(dt, fmadd(rho_m, dx, dm)), T(1));
    } else {
      const T Dm = fmadd(rho_m, dx, dm) / T(2);
      theta = T(0.5) * fmadd(-(fmadd(rho_m, c_m, rc) / T(2)), D::divc(dt, Dm), T(1));
    }
  }
  if (SHIFT) {
    sv(4, tid) = e_u;
    sv(5, tid) = e_p;
    sv(6, tid) = d_u;
    sv(7, tid) = d_p;
  }
  sync();

  // ---- stage 3: GAD limiter blend (src/riemann_schemes.jl:55-104)
  T ustar = us_i, pstar = ps_i;
  if (riemann == 1) {
    const T eps = T(1e-6);
    const T r_um = limiter(lim, D::divc(nb(4, tp, e_u, 1), e_u + eps));
    const T r_pm = limiter(lim, D::divc(nb(5, tp, e_p, 1), e_p + eps));
    const T r_up = limiter(lim, D::divc(nb(6, tm, d_u, -1), d_u + eps));
    const T r_pp = limiter(lim, D::divc(nb(7, tm, d_p, -1), d_p + eps));
    ustar = fmadd(theta, fmadd(r_up, d_u, -(r_um * e_u)), us_i);
    pstar = fmadd(theta, fmadd(r_pp, d_p, -(r_pm * e_p)), ps_i);
  }
  if (SHIFT) {
    sv(0, tid) = ustar;
    sv(1, tid) = pstar;
  }
  sync();

  // ---- stage 4: Lagrangian cell update (src/kernels.jl:58-68)
  const T us_p = nb(0, tp, ustar, 1), ps_p = nb(1, tp, pstar, 1);
  const T dX = fmadd(dt, us_p - ustar, dx);
  const T rho1 = D::div(dm, dX);
  const T dt_dm = (FAST && BIZ) ? (dt * inv_dx) * rr : D::div(dt, dm);
  const T ua1 = fmadd(dt_dm, pstar - ps_p, ua);
  const T E1 = fmadd(dt_dm, fmadd(pstar, ustar, -(ps_p * us_p)), E);
  const T disp = dt * ustar;
  const bool up = disp > T(0);
  const T dxe = up ? -fmadd(-dt, nb(0, tm, ustar, -1), dx) : fmadd(dt, nb(0, tp, ustar, 1), dx);
  T q[4] = {rho1, rho1 * ua1, rho1 * uo, rho1 * E1};
  if (SHIFT) {
    sv(4, tid) = dX;
    for (int j = 0; j < 4; ++j) sv(5 + j, tid) = q[j];
  }
  sync();

  // ---- stage 5: upwind values and limited slopes (slope_shift form)
  const bool second = projection == 1;
  const T dXm = nb(4, tm, dX, -1), dXp = nb(4, tp, dX, 1);
  const T dxl = up ? dXm : dX;
  T qi[4];
  {
    const T r_m = D::divc(T(2) * dX, dX + dXm);
    const T r_p = D::divc(T(2) * dX, dX + dXp);
    for (int j = 0; j < 4; ++j) {
      const T qm = nb(5 + j, tm, q[j], -1), qp = nb(5 + j, tp, q[j], 1);
      qi[j] = up ? qm : q[j];
      const T du_p = r_p * (qp - q[j]);
      const T du_m = r_m * (q[j] - qm);
      const T sgn = jsign(du_p);
      q[j] = sgn * jmax(T(0), jmin(fabs(du_p), sgn * du_m));  // slope at k
    }
  }
  // S[0..3] were last read in stage 4, before its barrier.
  if (SHIFT && second) {
    for (int j = 0; j < 4; ++j) sv(j, tid) = q[j];
  }
  sync();

  // ---- stage 6: advection fluxes disp * Q (src/projection_schemes.jl:
  // 62-124). Shared: the rho flux, the other fluxes' Q, and disp.
  T Q[4];
  if (second) {
    const T lf = D::divc(dxe, T(2) * dxl);
    for (int j = 0; j < 4; ++j) {
      const T sl = up ? nb(j, tm, q[j], -1) : (SHIFT ? sv(j, tid) : q[j]);
      Q[j] = fmadd(-sl, lf, qi[j]);
    }
  } else {
    for (int j = 0; j < 4; ++j) Q[j] = qi[j];
  }
  const T adv0 = disp * Q[0];
  // S[4..8] were last read in stage 5, before its barrier.
  if (SHIFT) {
    sv(4, tid) = adv0;
    for (int j = 1; j < 4; ++j) sv(4 + j, tid) = Q[j];
    sv(8, tid) = disp;
  }
  sync();

  // ---- stage 7: projection (src/projection_schemes.jl:23-41), `/ dx` a
  // multiply by inv_dx. The flux differences: rho's contracts the cell's
  // flux, the others the next cell's. S[0..3] were last read in stage 6,
  // so a caller may reuse them right after.
  T tmp[4];
  {
    const T disp_p = nb(8, tp, disp, 1);
    T d[4];
    d[0] = fmadd(-disp, Q[0], nb(4, tp, adv0, 1));
    for (int j = 1; j < 4; ++j) d[j] = fmadd(disp_p, nb(4 + j, tp, Q[j], 1), -(disp * Q[j]));
    const T dXr = dX * rho1;
    const T x[4] = {T(0), ua1, uo, E1};
    rho_o = fmadd(dX, rho1, -d[0]) * inv_dx;
    tmp[0] = (dXr - d[0]) * inv_dx;
    for (int j = 1; j < 4; ++j) tmp[j] = fmadd(dXr, x[j], -d[j]) * inv_dx;
  }
  {
    typename D::Over over_rho(tmp[0]);
    ua_o = over_rho(tmp[1]);
    uo_o = over_rho(tmp[2]);
    E_o = over_rho(tmp[3]);
  }
}

// Block-wide NaN-propagating maxima of (mx, my) through S rows 0 and 1
// (NS a power of two, S[0..1] free): the results land in S[0] and S[NS].
// Every thread of the block must call it.
template <typename T, int NS>
__device__ __forceinline__ void block_max2(T* S, int tid, T mx, T my) {
  S[tid] = mx;
  S[NS + tid] = my;
  __syncthreads();
  for (int w = NS / 2; w > 0; w >>= 1) {
    if (tid < w) {
      S[tid] = jmax(S[tid], S[tid + w]);
      S[NS + tid] = jmax(S[NS + tid], S[NS + tid + w]);
    }
    __syncthreads();
  }
}

// jmax / jmin (common.cuh) in the forms `run_body` meets them, with the
// same results bit for bit, NaN operands and signed zeros included, in
// fewer instructions: jmax(0, m) is m < 0 ? 0 : m, jmin(a, b) is
// a < b || a != a ? a : b. PTX's min.NaN / max.NaN would order -0 below
// +0, where jmax(+0, -0) gives -0.
template <typename T> __device__ __forceinline__ T clamp0(T m) { return m < T(0) ? T(0) : m; }
template <typename T> __device__ __forceinline__ T xmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T xmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T limiter_x(int name, T r) {
  if (name == 0) return T(1);
  if (name == 1) return clamp0(xmin(T(1), r));
  return xmax(clamp0(xmin(T(2) * r, T(1))), xmin(r, T(2)));
}

// `sweep_body` on a run of P consecutive positions of a line held by one
// lane, the line's 32 P positions spread over the warp's 32 lanes in
// order. The same operations in the same order at every position; a k-1
// read at the run's first position comes from the lane below through
// `__shfl_up_sync`, a k+1 read at its last from the lane above through
// `__shfl_down_sync`, every other one from the lane's own registers (at
// the line's ends a lane reads itself: those positions are halo, read
// but never valid). Every lane of the warp must call it. In: the state
// with the axis velocity `ua`, the other one `uo`; out: the swept state in
// place, the pre-sweep p and c. SHIFT = false is the no_roll variant, as
// in `sweep_body`. Its min/max are `limiter_x`, `clamp0` and `xmin`.
// `fold`: the sweep's place in its cycle's EOS fold (`SweepFold`).
template <typename T, bool FAST, bool BIZ, int P, bool SHIFT = true>
__device__ __forceinline__ void run_body(const double* kk, int riemann, int lim, int projection,
                                         T dt, T dx, T inv_dx, bool need_c, bool along_y,
                                         T (&rho)[P], T (&ua)[P], T (&uo)[P], T (&E)[P],
                                         T (&p)[P], T (&c)[P],
                                         const SweepFold<T> fold = SweepFold<T>()) {
  typedef Div<T, FAST> D;
  constexpr unsigned FULL = 0xffffffffu;
  // The neighbouring lanes' values at the run's ends.
  auto lo = [](T v) -> T { return SHIFT ? __shfl_up_sync(FULL, v, 1) : v; };
  auto hi = [](T v) -> T { return SHIFT ? __shfl_down_sync(FULL, v, 1) : v; };
  // Position k-1 / k+1 of run slot j; `edge` is `lo` / `hi` of the run.
  auto km = [](const T (&a)[P], T edge, int j) -> T {
    return SHIFT ? (j > 0 ? a[j - 1] : edge) : a[j] * T(1 + 1e-7 * -1);
  };
  auto kp = [](const T (&a)[P], T edge, int j) -> T {
    return SHIFT ? (j < P - 1 ? a[j + 1] : edge) : a[j] * T(1 + 1e-7 * 1);
  };

  // ---- stage 1: EOS of the input state (rho rebuilt from X when folded)
  constexpr bool FOLD = FOLDS<FAST, BIZ>;
  T rc[P], rr[P], dm[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    rr[j] = T(0);
    c[j] = T(0);
    T xk = T(0);
    if (FOLD && fold.in) {
      xk = rho[j] * fold.k;
      rho[j] = rho[j] * fold.rdx;
    }
    eos_prc<T, FAST, BIZ>(kk, rho[j], ua[j], uo[j], E[j], need_c, along_y, p[j], rc[j], c[j],
                          rr[j], FOLD && fold.in, xk);
    dm[j] = rho[j] * dx;
  }

  // ---- stage 2: Godunov solve at the k-1/2 interface. The neighbour's
  // rho and c (its rc in fast mode): the blend contracts them into its sums.
  T us_i[P], ps_i[P], e_u[P], e_p[P], d_u[P], d_p[P], theta[P];
  {
    T cs[P];
#pragma unroll
    for (int j = 0; j < P; ++j) cs[j] = FAST ? rc[j] : c[j];
    const T rho_e = lo(rho[P - 1]), ua_e = lo(ua[P - 1]), p_e = lo(p[P - 1]),
            cs_e = lo(cs[P - 1]);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const T rho_m = km(rho, rho_e, j), u_m = km(ua, ua_e, j), p_m = km(p, p_e, j),
              c_m = km(cs, cs_e, j);
      const T rc_l = FAST ? c_m : rho_m * c_m;
      const T rc_sum = rc_l + rc[j];
      {
        typename D::Over over(rc_sum);
        us_i[j] = over(fmadd(rc_l, u_m, rc[j] * ua[j]) + (p_m - p[j]));
        ps_i[j] = over(fmadd(rc_l * rc[j], u_m - ua[j], fmadd(rc[j], p_m, rc_l * p[j])));
      }
      e_u[j] = us_i[j] - u_m, e_p[j] = ps_i[j] - p_m;
      d_u[j] = ua[j] - us_i[j], d_p[j] = p[j] - ps_i[j];
      theta[j] = T(0);
      if (riemann == 1) {
        if (FAST) {
          theta[j] = T(0.5) * fmadd(-rc_sum, D::divc(dt, fmadd(rho_m, dx, dm[j])), T(1));
        } else {
          const T Dm = fmadd(rho_m, dx, dm[j]) / T(2);
          theta[j] = T(0.5) * fmadd(-(fmadd(rho_m, c_m, rc[j]) / T(2)), D::divc(dt, Dm), T(1));
        }
      }
    }
  }

  // ---- stage 3: GAD limiter blend
  T ustar[P], pstar[P];
#pragma unroll
  for (int j = 0; j < P; ++j) ustar[j] = us_i[j], pstar[j] = ps_i[j];
  if (riemann == 1) {
    const T eu_e = hi(e_u[0]), ep_e = hi(e_p[0]), du_e = lo(d_u[P - 1]), dp_e = lo(d_p[P - 1]);
    const T eps = T(1e-6);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const T r_um = limiter_x(lim, D::divc(kp(e_u, eu_e, j), e_u[j] + eps));
      const T r_pm = limiter_x(lim, D::divc(kp(e_p, ep_e, j), e_p[j] + eps));
      const T r_up = limiter_x(lim, D::divc(km(d_u, du_e, j), d_u[j] + eps));
      const T r_pp = limiter_x(lim, D::divc(km(d_p, dp_e, j), d_p[j] + eps));
      ustar[j] = fmadd(theta[j], fmadd(r_up, d_u[j], -(r_um * e_u[j])), us_i[j]);
      pstar[j] = fmadd(theta[j], fmadd(r_pp, d_p[j], -(r_pm * e_p[j])), ps_i[j]);
    }
  }

  // ---- stage 4: Lagrangian cell update
  T dX[P], rho1[P], ua1[P], E1[P], disp[P], dxe[P];
  bool up[P];
  {
    const T us_e = hi(ustar[0]), ps_e = hi(pstar[0]), usm_e = lo(ustar[P - 1]);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const T us_p = kp(ustar, us_e, j), ps_p = kp(pstar, ps_e, j);
      dX[j] = fmadd(dt, us_p - ustar[j], dx);
      rho1[j] = D::div(dm[j], dX[j]);
      const T dt_dm = (FAST && BIZ) ? (dt * inv_dx) * rr[j] : D::div(dt, dm[j]);
      ua1[j] = fmadd(dt_dm, pstar[j] - ps_p, ua[j]);
      E1[j] = fmadd(dt_dm, fmadd(pstar[j], ustar[j], -(ps_p * us_p)), E[j]);
      disp[j] = dt * ustar[j];
      up[j] = disp[j] > T(0);
      dxe[j] = up[j] ? -fmadd(-dt, km(ustar, usm_e, j), dx) : fmadd(dt, us_p, dx);
    }
  }

  // ---- stages 5-7, one conserved variable q at a time (each position's
  // operations as in `sweep_body`, their order across variables free):
  // upwind values and limited slopes (slope_shift form), advection fluxes
  // disp * Q, projection. Per variable only its result stays live.
  const bool second = projection == 1;
  T dxl[P], r_m[P], r_p[P], lf[P], dXr[P];
  const T disp_e = hi(disp[0]);
  {
    const T dXm_e = lo(dX[P - 1]), dXp_e = hi(dX[0]);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const T dXm = km(dX, dXm_e, j), dXp = kp(dX, dXp_e, j);
      dxl[j] = up[j] ? dXm : dX[j];
      r_m[j] = D::divc(T(2) * dX[j], dX[j] + dXm);
      r_p[j] = D::divc(T(2) * dX[j], dX[j] + dXp);
      lf[j] = second ? D::divc(dxe[j], T(2) * dxl[j]) : T(0);
      dXr[j] = dX[j] * rho1[j];
    }
  }
  T tmp[4][P];
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    T q[P];
#pragma unroll
    for (int j = 0; j < P; ++j)
      q[j] = f == 0 ? rho1[j] : rho1[j] * (f == 1 ? ua1[j] : (f == 2 ? uo[j] : E1[j]));
    const T qm_e = lo(q[P - 1]), qp_e = hi(q[0]);
    T qi[P], s5[P], Q[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const T qm = km(q, qm_e, j), qp = kp(q, qp_e, j);
      qi[j] = up[j] ? qm : q[j];
      const T du_p = r_p[j] * (qp - q[j]);
      const T du_m = r_m[j] * (q[j] - qm);
      const T sgn = jsign(du_p);
      s5[j] = sgn * clamp0(xmin(fabs(du_p), sgn * du_m));
    }
    if (second) {
      const T s5_e = lo(s5[P - 1]);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const T sl = up[j] ? km(s5, s5_e, j) : s5[j];
        Q[j] = fmadd(-sl, lf[j], qi[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) Q[j] = qi[j];
    }
    // The flux differences: rho's contracts the cell's flux, the others
    // the next cell's (`ops/sweep.py` `sweep_math_plain`).
    T d[P];
    if (f == 0) {
      T adv[P];
#pragma unroll
      for (int j = 0; j < P; ++j) adv[j] = disp[j] * Q[j];
      const T adv_e = hi(adv[0]);
#pragma unroll
      for (int j = 0; j < P; ++j) d[j] = fmadd(-disp[j], Q[j], kp(adv, adv_e, j));
    } else {
      const T Q_e = hi(Q[0]);
#pragma unroll
      for (int j = 0; j < P; ++j)
        d[j] = fmadd(kp(disp, disp_e, j), kp(Q, Q_e, j), -(disp[j] * Q[j]));
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (f == 0) {
        const T X = fmadd(dX[j], rho1[j], -d[j]);
        rho[j] = (FOLD && fold.out) ? X : X * inv_dx;
        tmp[0][j] = (dXr[j] - d[j]) * inv_dx;
      } else {
        const T x = f == 1 ? ua1[j] : (f == 2 ? uo[j] : E1[j]);
        tmp[f][j] = fmadd(dXr[j], x, -d[j]) * inv_dx;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    typename D::Over over_rho(tmp[0][j]);
    ua[j] = over_rho(tmp[1][j]);
    uo[j] = over_rho(tmp[2][j]);
    E[j] = over_rho(tmp[3][j]);
  }
}

// ------------------------------------------------------------ K1 / K2

// K1's geometry (`x_sweep_kernel`): a warp sweeps windows of W = 32 PX
// consecutive columns of a row, each lane a run of PX positions through
// `run_body`; the window's outer HALO columns on each side are only read,
// so it writes RX = W - 2 HALO. NW warps a block, up to WPW windows a
// warp: fewer where that leaves fewer than MIN_BLOCKS blocks, so a small
// grid still fills the card (`x_windows_per_warp`; at 2008^2 two windows
// a warp ran 14% faster than eight and 7% faster than one: PERF.md).
struct XGeom {
  static constexpr int PX = 4, NW = 8, WPW = 8, MIN_BLOCKS = 2048;
  static constexpr int W = 32 * PX, RX = W - 2 * HALO, NT = 32 * NW;
};
// K2's geometry (`y_sweep_kernel`): a thread marches down one column of a
// segment of H output rows (H + 2 HALO rows read); NT columns a block. H
// is the longest of 128, 64, 32 that gives at least MIN_BLOCKS blocks
// (`y_segment_rows`): shorter segments recompute more (8 / H) but fill
// the card on a small grid (at 2008^2, 64 rows ran 19% faster than 128,
// and a minimum of 1024 blocks, 32 rows, 4% slower than 64: PERF.md).
struct YGeom {
  static constexpr int H = 128, H_MIN = 32, NT = 128, MIN_BLOCKS = 512;
};
// Resident blocks per SM the launch bounds ask for. f32: K1 two blocks of
// 256 threads (128 registers a thread), K2 five of 128 (at most 102; it
// takes 96 without spills, 6.4% faster at 8200^2 than four blocks with
// 114, while six blocks (80) spill and lose 12%: PERF.md). f64 takes half
// the blocks.
template <typename T> struct SweepMinBlocks {
  static constexpr int X = sizeof(T) == 4 ? 2 : 1, Y = sizeof(T) == 4 ? 5 : 2;
};

__host__ __device__ inline long long x_windows(long long rows, long long cols) {
  return rows * ((cols + XGeom::RX - 1) / XGeom::RX);
}
__host__ __device__ inline int x_windows_per_warp(long long rows, long long cols) {
  const long long w = x_windows(rows, cols) / ((long long)XGeom::NW * XGeom::MIN_BLOCKS);
  return w < 1 ? 1 : (w > XGeom::WPW ? XGeom::WPW : (int)w);
}
__host__ __device__ inline int y_segment_rows(long long rows, long long cols) {
  const long long cgroups = (cols + YGeom::NT - 1) / YGeom::NT;
  int h = YGeom::H;
  while (h > YGeom::H_MIN && cgroups * ((rows + h - 1) / h) < YGeom::MIN_BLOCKS) h /= 2;
  return h;
}

// Blocks of a K1 (axis 0) or K2 (axis 1) launch over a padded (rows, cols)
// array, all on grid_x: K1 one per NW x `x_windows_per_warp` windows in
// row-major order (rows x ceil(cols / RX) windows), K2 one per NT columns
// x `y_segment_rows` rows.
inline long long sweep_blocks(int axis, long long rows, long long cols) {
  if (axis == 0) {
    const long long per = (long long)XGeom::NW * x_windows_per_warp(rows, cols);
    return (x_windows(rows, cols) + per - 1) / per;
  }
  const long long h = y_segment_rows(rows, cols);
  return ((cols + YGeom::NT - 1) / YGeom::NT) * ((rows + h - 1) / h);
}

// The block's pair of CFL partial maxima (NaN-propagating; exact in any
// order): the warps' maxima through `red` (2 NWARP words), stored by
// thread 0 after a block barrier. Every thread of the block must call it.
template <typename T, int NWARP>
__device__ __forceinline__ void block_partials(const SweepArgs& a, T* red, T mx, T my) {
  for (int s = 16; s > 0; s >>= 1) {
    mx = jmax(mx, __shfl_xor_sync(0xffffffffu, mx, s));
    my = jmax(my, __shfl_xor_sync(0xffffffffu, my, s));
  }
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = mx;
    red[NWARP + (threadIdx.x >> 5)] = my;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T bx = red[0], by = red[NWARP];
    for (int w = 1; w < NWARP; ++w) bx = jmax(bx, red[w]), by = jmax(by, red[NWARP + w]);
    T* part = reinterpret_cast<T*>(a.partials);
    part[blockIdx.x] = bx;
    part[a.n_partials + blockIdx.x] = by;
  }
}

// K3's function in the tail of a finishing K1 / K2 launch (`cfl_tail`),
// with 2 NT words of shared memory of its own. Every thread of the block
// must call it.
template <typename T, int NT, bool SYNCED>
__device__ __forceinline__ void sweep_tail(const FinishArgs& f) {
  __shared__ T scratch[2 * NT];
  cfl_tail<T, NT, SYNCED>(f, scratch);
}

// Where the four fields at position k of the swept axis of line `across`
// lie, and the factors they take: the ghost fill along the axis
// (`ghost_src`), a neighbour's slab line, or the array (clamped).
template <typename T, int AXIS>
__device__ __forceinline__ void axis_src(const SweepArgs& a, long long k, long long across,
                                         const T* ptr[4], T fac[4]) {
  const long long cols = a.cols;
  const long long n_along = AXIS == 0 ? cols : a.rows;
  const long long n_across = AXIS == 0 ? a.rows : cols;
#pragma unroll
  for (int f = 0; f < 4; ++f) fac[f] = T(1);
  int side;
  long long ks = ghost_src(k, a.g, AXIS == 0 ? a.nx : a.ny, a.mode_lo, a.mode_hi, a.f_lo,
                           a.f_hi, fac, side);
  const T* const* src = reinterpret_cast<const T* const*>(a.src);
  if (side < 0) {
    ks = ks < 0 ? 0 : (ks >= n_along ? n_along - 1 : ks);  // array edge: dead outputs only
    const long long idx = AXIS == 0 ? across * cols + ks : ks * cols + across;
#pragma unroll
    for (int f = 0; f < 4; ++f) ptr[f] = src[f] + idx;
  } else {
    const T* sl = reinterpret_cast<const T*>(side ? a.slab_hi : a.slab_lo);
    const long long o = AXIS == 0 ? across * a.g + ks : ks * cols + across;
#pragma unroll
    for (int f = 0; f < 4; ++f) ptr[f] = sl + f * a.g * n_across + o;
  }
}

// PX consecutive values at 16-byte aligned p, in 16-byte loads / stores.
template <typename T, int PX>
__device__ __forceinline__ void load_run(const T* p, T (&o)[PX]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int v = 0; v < PX / 4; ++v) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(p) + v);
      o[4 * v] = x.x, o[4 * v + 1] = x.y, o[4 * v + 2] = x.z, o[4 * v + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < PX / 2; ++v) {
      const double2 x = __ldg(reinterpret_cast<const double2*>(p) + v);
      o[2 * v] = x.x, o[2 * v + 1] = x.y;
    }
  }
}
template <typename T, int PX>
__device__ __forceinline__ void store_run(T* p, const T (&o)[PX]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int v = 0; v < PX / 4; ++v)
      reinterpret_cast<float4*>(p)[v] =
          make_float4(o[4 * v], o[4 * v + 1], o[4 * v + 2], o[4 * v + 3]);
  } else {
#pragma unroll
    for (int v = 0; v < PX / 2; ++v)
      reinterpret_cast<double2*>(p)[v] = make_double2(o[2 * v], o[2 * v + 1]);
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// A K1 / K2 launch's `SweepFold`.
template <typename T>
__device__ __forceinline__ SweepFold<T> sweep_fold(const SweepArgs& a) {
  SweepFold<T> f;
  f.in = a.fold_in != 0;
  f.out = a.x_out != 0;
  f.rdx = T(a.fold_rdx);
  f.k = T(a.fold_k);
  return f;
}

// K1: one X sweep (see the file note). Warp w of block b takes windows
// (b P + i) NW + w, i < P = `x_windows_per_warp`, so at each step the
// block's warps sweep NW
// consecutive windows. A window whose columns are all real cells, in rows
// that start on 16-byte boundaries (cols a multiple of 16 / sizeof(T)),
// loads and stores its lanes' runs as 16-byte vectors, its loads issued
// one window ahead; a window at a border loads position by position with
// the ghost fill. FIN: K3's function in the tail (`sweep_tail`).
template <typename T, bool FAST, bool BIZ, bool FIN>
__device__ __forceinline__ void x_sweep_body(const SweepArgs& a, const FinishArgs* fin) {
  constexpr int PX = XGeom::PX, NW = XGeom::NW, RX = XGeom::RX;
  constexpr int VEC = 16 / sizeof(T);
  static_assert(PX % VEC == 0 && RX % VEC == 0, "runs and windows in whole vectors");
  __shared__ T red[2 * NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long rows = a.rows, cols = a.cols;
  const long long segs = (cols + RX - 1) / RX, nwin = rows * segs;
  const int wpw = x_windows_per_warp(rows, cols);
  const T* const* src = reinterpret_cast<const T* const*>(a.src);
  T* const* dst = reinterpret_cast<T* const*>(a.dst);
  T* p_out = reinterpret_cast<T*>(a.p);
  const int g = a.g, nx = a.nx, ny = a.ny;
  const bool emit = a.emit != 0;
  auto window = [&](int i) { return ((long long)blockIdx.x * wpw + i) * NW + warp; };
  const int off = PX * lane - HALO;  // the lane's first position in the window

  if (!reinterpret_cast<const int*>(a.iscal)[2]) {  // past the run's end: copy
    for (int i = 0; i < wpw; ++i) {
      const long long id = window(i);
      if (id >= nwin) break;
      const long long row = id / segs, c0 = (id % segs) * RX;
      for (int j = 0; j < PX; ++j) {
        const long long k = c0 + off + j;
        if (k >= c0 && k < c0 + RX && k < cols)
          for (int f = 0; f < 4; ++f) dst[f][row * cols + k] = src[f][row * cols + k];
      }
    }
    if constexpr (FIN) sweep_tail<T, XGeom::NT, false>(*fin);
    return;
  }
  const T dt = reinterpret_cast<const T*>(a.scal)[3] * T(a.dt_factor);
  const SweepFold<T> fold = sweep_fold<T>(a);
  bool vec = cols % VEC == 0 && (!emit || aligned16(p_out));
  for (int f = 0; f < 4; ++f) vec = vec && aligned16(src[f]) && aligned16(dst[f]);
  // Every column of the window real: no ghost fill, no array edge.
  auto fast_window = [&](long long id) {
    const long long c = (id % segs) * RX - HALO;
    return vec && id < nwin && c >= g && c + XGeom::W <= g + nx;
  };

  T raw[4][PX];  // the next fast window's runs, in flight
  auto issue = [&](long long id) {
    const long long base = (id / segs) * cols + (id % segs) * RX + off;
#pragma unroll
    for (int f = 0; f < 4; ++f) load_run<T, PX>(src[f] + base, raw[f]);
  };
  if (fast_window(window(0))) issue(window(0));
  T mx = T(0), my = T(0);  // the TPU's zero-initialised max block
#pragma unroll 1
  for (int i = 0; i < wpw; ++i) {
    const long long id = window(i);
    if (id >= nwin) break;
    const long long row = id / segs, c0 = (id % segs) * RX;
    const bool fast = fast_window(id);
    T rho[PX], u[PX], v[PX], E[PX], p[PX], c[PX];
    if (fast) {
#pragma unroll
      for (int j = 0; j < PX; ++j)
        rho[j] = raw[0][j], u[j] = raw[1][j], v[j] = raw[2][j], E[j] = raw[3][j];
    } else {
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const T* ptr[4];
        T fac[4];
        axis_src<T, 0>(a, c0 + off + j, row, ptr, fac);
        rho[j] = __ldg(ptr[0]) * fac[0], u[j] = __ldg(ptr[1]) * fac[1];
        v[j] = __ldg(ptr[2]) * fac[2], E[j] = __ldg(ptr[3]) * fac[3];
      }
    }
    if (i + 1 < wpw && fast_window(window(i + 1))) issue(window(i + 1));
    run_body<T, FAST, BIZ, PX>(a.k, a.riemann, a.limiter, a.projection, dt, T(a.dx),
                               T(a.inv_dx), emit, false, rho, u, v, E, p, c, fold);
    const bool row_real = row >= g && row < g + ny;
    const long long base = row * cols + c0 + off;
    if (fast) {  // lanes 1-30 hold whole runs of outputs, every column real
      if (lane >= 1 && lane <= 30) {
        store_run<T, PX>(dst[0] + base, rho);
        store_run<T, PX>(dst[1] + base, u);
        store_run<T, PX>(dst[2] + base, v);
        store_run<T, PX>(dst[3] + base, E);
        if (emit) {
          store_run<T, PX>(p_out + base, p);
          if (row_real) {
#pragma unroll
            for (int j = 0; j < PX; ++j) {
              mx = jmax(mx, fabs(u[j]) + c[j]);
              my = jmax(my, fabs(v[j]) + c[j]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const long long k = c0 + off + j;
        if (k >= c0 && k < c0 + RX && k < cols) {
          dst[0][base + j] = rho[j];
          dst[1][base + j] = u[j];
          dst[2][base + j] = v[j];
          dst[3][base + j] = E[j];
          if (emit) {
            p_out[base + j] = p[j];
            // `_dt_tile_min`: post-sweep velocities, pre-sweep c.
            if (row_real && k >= g && k < g + nx) {
              mx = jmax(mx, fabs(u[j]) + c[j]);
              my = jmax(my, fabs(v[j]) + c[j]);
            }
          }
        }
      }
    }
  }
  if (emit) block_partials<T, NW>(a, red, mx, my);
  if constexpr (FIN) sweep_tail<T, XGeom::NT, true>(*fin);  // FIN emits: synced
}

template <typename T, bool FAST, bool BIZ>
__global__ void __launch_bounds__(XGeom::NT, SweepMinBlocks<T>::X)
x_sweep_kernel(const SweepArgs a) {
  x_sweep_body<T, FAST, BIZ, false>(a, nullptr);
}

// K1 as the cycle's last launch: the same sweep, then K3's fold and step.
template <typename T, bool FAST, bool BIZ>
__global__ void __launch_bounds__(XGeom::NT, SweepMinBlocks<T>::X)
x_sweep_finish_kernel(const SweepArgs a, __grid_constant__ const FinishArgs f) {
  x_sweep_body<T, FAST, BIZ, true>(a, &f);
}

// K2's register pipeline (see the file note): what a row holds after
// stage 1 (S1), stage 2 (S2) and stage 4 (S4).
template <typename T> struct S1 { T rho, ua, uo, E, p, rc, c, rr; };
template <typename T> struct S2 { T us, ps, eu, ep, du, dp, th; };
template <typename T> struct S4 { T dX, rho1, ua1, E1, disp, dxe, q[4]; bool up; };

// K2: one Y sweep (see the file note). Thread t of block b marches down
// column (b mod ceil(cols / NT)) NT + t from row r0 - HALO to r0 + H +
// HALO - 1, r0 = (b div ceil(cols / NT)) H. At step i it loads row i (the
// next row's loads in flight) and runs stages 1-2 at row i, 3 at i - 1, 4
// at i - 2, 5-6 at i - 3 and 7 at i - 4, each stage's k-1 / k+1 operands
// from registers that earlier steps wrote; the rows before r0 - HALO are
// zeros, read only by dead positions. Each position's operations are
// `sweep_body`'s in its order (min and max in `run_body`'s forms). FIN:
// K3's function in the tail (`sweep_tail`).
template <typename T, bool FAST, bool BIZ, bool FIN>
__device__ __forceinline__ void y_sweep_body(const SweepArgs& a, const FinishArgs* fin) {
  typedef Div<T, FAST> D;
  constexpr int NT = YGeom::NT;
  __shared__ T red[2 * (NT / 32)];
  const long long rows = a.rows, cols = a.cols;
  const long long H = y_segment_rows(rows, cols);
  const long long cgroups = (cols + NT - 1) / NT;
  const long long col = (blockIdx.x % cgroups) * NT + threadIdx.x;
  const long long r0 = (blockIdx.x / cgroups) * H;
  const long long r_end = r0 + H < rows ? r0 + H : rows;  // output rows [r0, r_end)
  const bool live = col < cols;
  const long long cc = live ? col : cols - 1;  // dead lanes sweep the last column
  const T* const* src = reinterpret_cast<const T* const*>(a.src);
  T* const* dst = reinterpret_cast<T* const*>(a.dst);
  T* p_out = reinterpret_cast<T*>(a.p);
  const int g = a.g;
  const bool emit = a.emit != 0;

  if (!reinterpret_cast<const int*>(a.iscal)[2]) {  // past the run's end: copy
    if (live)
      for (long long r = r0; r < r_end; ++r)
        for (int f = 0; f < 4; ++f) dst[f][r * cols + col] = src[f][r * cols + col];
    if constexpr (FIN) sweep_tail<T, YGeom::NT, false>(*fin);
    return;
  }
  const T dt = reinterpret_cast<const T*>(a.scal)[3] * T(a.dt_factor);
  const T dx = T(a.dx), inv_dx = T(a.inv_dx);
  const int riemann = a.riemann, lim = a.limiter;
  const bool second = a.projection == 1;
  const bool col_real = live && col >= g && col < g + a.nx;
  constexpr bool FOLD = FOLDS<FAST, BIZ>;
  const SweepFold<T> fold = sweep_fold<T>(a);

  // Each stage's outputs by row, indexed by the distance to row i.
  S1<T> s1[5] = {};
  S2<T> s2[3] = {};
  T us3[4] = {}, ps3[4] = {};  // stage 3: ustar, pstar
  S4<T> s4[5] = {};
  T s5[5][4] = {}, Q[5][4] = {};  // stages 5 and 6: slopes, fluxes' Q
  T mx = T(0), my = T(0);  // the TPU's zero-initialised max block

  T raw[4];  // the next row's fields, in flight
  auto issue = [&](long long r) {
    const T* ptr[4];
    T fac[4];
    axis_src<T, 1>(a, r, cc, ptr, fac);
#pragma unroll
    for (int f = 0; f < 4; ++f) raw[f] = __ldg(ptr[f]);
  };
  issue(r0 - HALO);
#pragma unroll 1
  for (long long i = r0 - HALO; i < r_end + HALO; ++i) {
    T in[4];
    {  // the factors again: ALU work, no loads
      const T* ptr[4];
      T fac[4];
      axis_src<T, 1>(a, i, cc, ptr, fac);
#pragma unroll
      for (int f = 0; f < 4; ++f) in[f] = raw[f] * fac[f];
    }
    if (i + 1 < r_end + HALO) issue(i + 1);

    // ---- stage 1 at row i: EOS of the input state (ua = v, uo = u; rho
    // rebuilt from X when folded)
    {
      S1<T>& n = s1[0];
      n.rr = T(0);
      n.c = T(0);
      n.ua = in[2], n.uo = in[1], n.E = in[3];
      T xk = T(0);
      n.rho = in[0];
      if (FOLD && fold.in) {
        xk = in[0] * fold.k;
        n.rho = in[0] * fold.rdx;
      }
      eos_prc<T, FAST, BIZ>(a.k, n.rho, n.ua, n.uo, n.E, emit, true, n.p, n.rc, n.c, n.rr,
                            FOLD && fold.in, xk);
    }
    // ---- stage 2 at row i: Godunov solve at the i-1/2 interface
    {
      const S1<T>& m = s1[1];
      const S1<T>& k = s1[0];
      S2<T>& n = s2[0];
      // the neighbour's rho * c formed from its rho and c, as run_body
      const T rc_l = FAST ? m.rc : m.rho * m.c;
      const T rc_sum = rc_l + k.rc;
      {
        typename D::Over over(rc_sum);
        n.us = over(fmadd(rc_l, m.ua, k.rc * k.ua) + (m.p - k.p));
        n.ps = over(fmadd(rc_l * k.rc, m.ua - k.ua, fmadd(k.rc, m.p, rc_l * k.p)));
      }
      n.eu = n.us - m.ua, n.ep = n.ps - m.p;
      n.du = k.ua - n.us, n.dp = k.p - n.ps;
      n.th = T(0);
      if (riemann == 1) {
        const T dm = k.rho * dx;
        if (FAST) {
          n.th = T(0.5) * fmadd(-rc_sum, D::divc(dt, fmadd(m.rho, dx, dm)), T(1));
        } else {
          const T Dm = fmadd(m.rho, dx, dm) / T(2);
          n.th = T(0.5) * fmadd(-(fmadd(m.rho, m.c, k.rc) / T(2)), D::divc(dt, Dm), T(1));
        }
      }
    }
    // ---- stage 3 at row i-1: GAD limiter blend
    {
      const S2<T>& k = s2[1];
      us3[1] = k.us, ps3[1] = k.ps;
      if (riemann == 1) {
        const T eps = T(1e-6);
        const T r_um = limiter_x(lim, D::divc(s2[0].eu, k.eu + eps));
        const T r_pm = limiter_x(lim, D::divc(s2[0].ep, k.ep + eps));
        const T r_up = limiter_x(lim, D::divc(s2[2].du, k.du + eps));
        const T r_pp = limiter_x(lim, D::divc(s2[2].dp, k.dp + eps));
        us3[1] = fmadd(k.th, fmadd(r_up, k.du, -(r_um * k.eu)), k.us);
        ps3[1] = fmadd(k.th, fmadd(r_pp, k.dp, -(r_pm * k.ep)), k.ps);
      }
    }
    // ---- stage 4 at row i-2: Lagrangian cell update
    {
      const S1<T>& k = s1[2];
      S4<T>& n = s4[2];
      const T ustar = us3[2], pstar = ps3[2], us_p = us3[1], ps_p = ps3[1];
      const T dm = k.rho * dx;
      n.dX = fmadd(dt, us_p - ustar, dx);
      n.rho1 = D::div(dm, n.dX);
      const T dt_dm = (FAST && BIZ) ? (dt * inv_dx) * k.rr : D::div(dt, dm);
      n.ua1 = fmadd(dt_dm, pstar - ps_p, k.ua);
      n.E1 = fmadd(dt_dm, fmadd(pstar, ustar, -(ps_p * us_p)), k.E);
      n.disp = dt * ustar;
      n.up = n.disp > T(0);
      n.dxe = n.up ? -fmadd(-dt, us3[3], dx) : fmadd(dt, us_p, dx);
      n.q[0] = n.rho1, n.q[1] = n.rho1 * n.ua1;
      n.q[2] = n.rho1 * k.uo, n.q[3] = n.rho1 * n.E1;
    }
    // ---- stages 5-6 at row i-3: upwind values, limited slopes, fluxes
    {
      const S4<T>& k = s4[3];
      const S4<T>& m = s4[4];
      const S4<T>& n = s4[2];
      const T dxl = k.up ? m.dX : k.dX;
      const T r_m = D::divc(T(2) * k.dX, k.dX + m.dX);
      const T r_p = D::divc(T(2) * k.dX, k.dX + n.dX);
      T qi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T qm = m.q[j], qp = n.q[j], q = k.q[j];
        qi[j] = k.up ? qm : q;
        const T du_p = r_p * (qp - q);
        const T du_m = r_m * (q - qm);
        const T sgn = jsign(du_p);
        s5[3][j] = sgn * clamp0(xmin(fabs(du_p), sgn * du_m));
      }
      if (second) {
        const T lf = D::divc(k.dxe, T(2) * dxl);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const T sl = k.up ? s5[4][j] : s5[3][j];
          Q[3][j] = fmadd(-sl, lf, qi[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) Q[3][j] = qi[j];
      }
    }
    // ---- stage 7 at row i-4: projection and output
    const long long r = i - HALO;
    if (r >= r0) {
      const S4<T>& k = s4[4];
      const T dp_ = s4[3].disp;  // the next row's
      const T dXr = k.dX * k.rho1;
      // the flux differences: rho's contracts the row's flux, the others
      // the next row's; `/ dx` a multiply by inv_dx
      const T d0 = fmadd(-k.disp, Q[4][0], dp_ * Q[3][0]);
      const T X = fmadd(k.dX, k.rho1, -d0);
      const T rho_o = (FOLD && fold.out) ? X : X * inv_dx;
      const T x[4] = {T(0), k.ua1, s1[4].uo, k.E1};
      T tmp[4];
      tmp[0] = (dXr - d0) * inv_dx;
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        const T dj = fmadd(dp_, Q[3][j], -(k.disp * Q[4][j]));
        tmp[j] = fmadd(dXr, x[j], -dj) * inv_dx;
      }
      typename D::Over over_rho(tmp[0]);
      const T ua_o = over_rho(tmp[1]), uo_o = over_rho(tmp[2]), E_o = over_rho(tmp[3]);
      if (live) {
        const long long o = r * cols + col;
        dst[0][o] = rho_o;
        dst[1][o] = uo_o;
        dst[2][o] = ua_o;
        dst[3][o] = E_o;
        if (emit) {
          p_out[o] = s1[4].p;
          // `_dt_tile_min`: post-sweep velocities, pre-sweep c.
          if (col_real && r >= g && r < g + a.ny) {
            mx = jmax(mx, fabs(uo_o) + s1[4].c);
            my = jmax(my, fabs(ua_o) + s1[4].c);
          }
        }
      }
    }
    // Shift the pipeline by one row.
#pragma unroll
    for (int d = 4; d > 0; --d) {
      s1[d] = s1[d - 1];
      s4[d] = s4[d - 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) s5[d][j] = s5[d - 1][j], Q[d][j] = Q[d - 1][j];
    }
#pragma unroll
    for (int d = 3; d > 0; --d) us3[d] = us3[d - 1], ps3[d] = ps3[d - 1];
    s2[2] = s2[1];
    s2[1] = s2[0];
  }
  if (emit) block_partials<T, NT / 32>(a, red, mx, my);
  if constexpr (FIN) sweep_tail<T, NT, true>(*fin);  // FIN emits: synced
}

template <typename T, bool FAST, bool BIZ>
__global__ void __launch_bounds__(YGeom::NT, SweepMinBlocks<T>::Y)
y_sweep_kernel(const SweepArgs a) {
  y_sweep_body<T, FAST, BIZ, false>(a, nullptr);
}

// K2 as the cycle's last launch: the same sweep, then K3's fold and step.
template <typename T, bool FAST, bool BIZ>
__global__ void __launch_bounds__(YGeom::NT, SweepMinBlocks<T>::Y)
y_sweep_finish_kernel(const SweepArgs a, __grid_constant__ const FinishArgs f) {
  y_sweep_body<T, FAST, BIZ, true>(a, &f);
}

// Host side. Checks the launch geometry the Python wrapper computed (it
// sized the partials from it): `sweep_blocks` blocks, all on grid_x.
// Returns 0 or a negative code.
inline int check_geometry(int axis, const SweepArgs* a) {
  if (axis != 0 && axis != 1) return -1;
  const long long gx = sweep_blocks(axis, a->rows, a->cols);
  if (gx != a->grid_x || a->grid_y != 1 || gx < 1 || gx > 2147483647LL) return -2;
  if (a->emit && a->n_partials < gx) return -3;
  return 0;
}

// A finishing launch (`fin` not null) emits, and folds at least its own
// blocks' partials.
inline int check_finish(const FinishArgs* fin, bool emit, long long nblocks) {
  if (!fin) return 0;
  if (!emit || !fin->ticket || fin->n < nblocks || fin->stride < fin->n) return -3;
  return 0;
}

template <typename T, bool FAST, bool BIZ>
int launch_one(int axis, const SweepArgs& a, const FinishArgs* fin, cudaStream_t stream) {
  if (axis == 0 && fin)
    x_sweep_finish_kernel<T, FAST, BIZ><<<a.grid_x, XGeom::NT, 0, stream>>>(a, *fin);
  else if (axis == 0)
    x_sweep_kernel<T, FAST, BIZ><<<a.grid_x, XGeom::NT, 0, stream>>>(a);
  else if (fin)
    y_sweep_finish_kernel<T, FAST, BIZ><<<a.grid_x, YGeom::NT, 0, stream>>>(a, *fin);
  else
    y_sweep_kernel<T, FAST, BIZ><<<a.grid_x, YGeom::NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool FAST>
int dispatch(int axis, const SweepArgs* a, const FinishArgs* fin, cudaStream_t stream) {
  const int err = check_finish(fin, a->emit != 0, a->grid_x);
  if (err) return err;
  return a->biz ? launch_one<T, FAST, true>(axis, *a, fin, stream)
                : launch_one<T, FAST, false>(axis, *a, fin, stream);
}

}  // namespace armon
