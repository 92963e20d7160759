// Per-sweep hydro kernels for Hopper (sm_90a): the shared device body
// `sweep_body` (also run by the whole-cycle kernels of cycle.cuh) and the
// X/Y sweep kernel template.
//
// Replaces the TPU kernels `_x_sweep_kernel` and `_y_sweep_kernel` of
// armon_tpu/ops/pallas/sweep.py (with their body `_sweep_math`, the
// in-kernel mirror fills `_bc_x_apply` / `_halo_cat_bc`, the slab splices
// of a domain-decomposed run `_bc_x_apply_slab` / `_halo_cat_slab`, and
// the CFL tile reduction `_dt_tile_min`).
//
// Bound on this card: memory. A sweep reads rho/u/v/E once and writes them
// once (plus the stale p on the cycle's last sweep): 32-36 bytes per cell
// in f32 against ~230 flops, far below the H100's ~20 flop/byte f32 ridge.
//
// Design: one block owns a segment of TILE positions along the sweep axis
// times LINES lines across it (X: 256 x 1 row, Y: 32 rows x 16 columns so
// a warp reads 16 consecutive columns). Each thread owns one position and
// keeps it through seven stages; values a stage reads at a shifted
// position (k-1, k+1) go through shared memory, with a barrier between
// stages. The outer HALO = 4 positions on each side are read but not
// written, which covers the sweep's dependency depth (<= 4 = nghost
// floor). Every field crosses device memory once per sweep (plus 8/TILE
// re-read halo); the intermediates (EOS, fluxes, slopes) never leave the
// SM. Output goes to a second buffer set (out of place): GPU blocks run
// concurrently, so the TPU's in-place update would race on the halo.
//
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

template <int AXIS> struct Geom;
template <> struct Geom<0> { static constexpr int TILE = 256, LINES = 1; };
template <> struct Geom<1> { static constexpr int TILE = 32, LINES = 16; };

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
  double inv_dx;          // T(1) / T(dx), fast mode only
  double f_lo[4], f_hi[4];  // mirror factors of (rho, u, v, E)
  double k[K_COUNT];
};

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
// Bizarrium chain (rr, reused by the Lagrangian update).
template <typename T, bool FAST, bool BIZ>
__device__ __forceinline__ void eos_prc(const double* kk, T rho, T ua, T uo, T E,
                                        bool need_c, T& p, T& rc, T& c, T& rr) {
  typedef Div<T, FAST> D;
  const T half = T(0.5);
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
      const T e = E - half * (ua * ua + uo * uo);
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
    const T e = E - half * (ua * ua + uo * uo);
    p = pk0 + T(kk[K_G0RHO0]) * (e - epsk0);
    const T sq = sqrt(T(kk[K_G0RHO0]) * (p - pk0) - pk0prime);
    if (FAST && !need_c) {  // rho * (sq/rho) == sq up to 2 ulp
      rc = sq;
      return;
    }
    c = D::div(sq, rho);
    rc = rho * c;
    return;
  }
  const T gm = T(kk[K_GM]);
  const T e = E - half * (ua * ua + uo * uo);
  p = T(kk[K_GM1]) * rho * e;
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

// `_sweep_math` at one position of a line, the one port of it that every
// kernel runs. The calling thread owns position k and reads the stage
// values of k-1 and k+1 through shared memory S (9 rows of NS values):
// `tm` / `tp` are those neighbours' slots, i.e. the thread's own slot minus
// / plus the line's stride in S, clamped at the line's ends (the outer
// HALO positions of a line are read but never valid). Every thread of the
// block must call it: it holds barriers. In: the axis velocity `ua`, the
// other one `uo`. Out: the swept (rho, ua, uo, E) and the pre-sweep p and
// c (c only when need_c, or always in exact mode).
template <typename T, bool FAST, bool BIZ, int NS>
__device__ __forceinline__ void sweep_body(
    T* S, int tid, int tm, int tp, const double* kk, int riemann, int lim,
    int projection, T dt, T dx, T inv_dx, bool need_c,
    T rho, T ua, T uo, T E,
    T& rho_o, T& ua_o, T& uo_o, T& E_o, T& p, T& c) {
  typedef Div<T, FAST> D;
  auto sv = [S](int j, int i) -> T& { return S[j * NS + i]; };

  // ---- stage 1: EOS of the input state
  T rc, rr = T(0);
  c = T(0);
  eos_prc<T, FAST, BIZ>(kk, rho, ua, uo, E, need_c, p, rc, c, rr);
  const T dm = rho * dx;
  sv(0, tid) = dm;
  sv(1, tid) = ua;
  sv(2, tid) = p;
  sv(3, tid) = rc;
  __syncthreads();

  // ---- stage 2: Godunov solve at the k-1/2 interface (`_godunov`)
  const T dm_l = sv(0, tm), u_m = sv(1, tm), p_m = sv(2, tm), rc_l = sv(3, tm);
  const T rc_sum = rc_l + rc;
  T us_i, ps_i;
  {
    typename D::Over over(rc_sum);
    us_i = over(rc_l * u_m + rc * ua + (p_m - p));
    ps_i = over(rc * p_m + rc_l * p + rc_l * rc * (u_m - ua));
  }
  const T e_u = us_i - u_m, e_p = ps_i - p_m;
  const T d_u = ua - us_i, d_p = p - ps_i;
  T theta = T(0);
  if (riemann == 1) {
    if (FAST) {
      theta = T(0.5) * (T(1) - rc_sum * D::divc(dt, dm_l + dm));
    } else {
      const T Dm = (dm_l + dm) / T(2);
      theta = T(0.5) * (T(1) - rc_sum / T(2) * D::divc(dt, Dm));
    }
  }
  sv(4, tid) = e_u;
  sv(5, tid) = e_p;
  sv(6, tid) = d_u;
  sv(7, tid) = d_p;
  __syncthreads();

  // ---- stage 3: GAD limiter blend (src/riemann_schemes.jl:55-104)
  T ustar = us_i, pstar = ps_i;
  if (riemann == 1) {
    const T eps = T(1e-6);
    const T r_um = limiter(lim, D::divc(sv(4, tp), e_u + eps));
    const T r_pm = limiter(lim, D::divc(sv(5, tp), e_p + eps));
    const T r_up = limiter(lim, D::divc(sv(6, tm), d_u + eps));
    const T r_pp = limiter(lim, D::divc(sv(7, tm), d_p + eps));
    ustar = us_i + theta * (r_up * d_u - r_um * e_u);
    pstar = ps_i + theta * (r_pp * d_p - r_pm * e_p);
  }
  sv(0, tid) = ustar;
  sv(1, tid) = pstar;
  __syncthreads();

  // ---- stage 4: Lagrangian cell update (src/kernels.jl:58-68)
  const T us_p = sv(0, tp), ps_p = sv(1, tp);
  const T dX = dx + dt * (us_p - ustar);
  const T rho1 = D::div(dm, dX);
  const T dt_dm = (FAST && BIZ) ? (dt * inv_dx) * rr : D::div(dt, dm);
  const T ua1 = ua + dt_dm * (pstar - ps_p);
  const T E1 = E + dt_dm * (pstar * ustar - ps_p * us_p);
  const T disp = dt * ustar;
  const bool up = disp > T(0);
  const T dxe = up ? (dt * sv(0, tm) - dx) : (dx + dt * sv(0, tp));
  T q[4] = {rho1, rho1 * ua1, rho1 * uo, rho1 * E1};
  sv(4, tid) = dX;
  for (int j = 0; j < 4; ++j) sv(5 + j, tid) = q[j];
  __syncthreads();

  // ---- stage 5: upwind values and limited slopes (slope_shift form)
  const bool second = projection == 1;
  const T dXm = sv(4, tm), dXp = sv(4, tp);
  const T dxl = up ? dXm : dX;
  T qi[4];
  {
    const T r_m = D::divc(T(2) * dX, dX + dXm);
    const T r_p = D::divc(T(2) * dX, dX + dXp);
    for (int j = 0; j < 4; ++j) {
      const T qm = sv(5 + j, tm), qp = sv(5 + j, tp);
      qi[j] = up ? qm : q[j];
      const T du_p = r_p * (qp - q[j]);
      const T du_m = r_m * (q[j] - qm);
      const T sgn = jsign(du_p);
      q[j] = sgn * jmax(T(0), jmin(fabs(du_p), sgn * du_m));  // slope at k
    }
  }
  // S[0..3] were last read in stage 4, before its barrier.
  for (int j = 0; j < 4; ++j) sv(j, tid) = second ? q[j] : disp * qi[j];
  __syncthreads();

  // ---- stage 6: advection fluxes (src/projection_schemes.jl:62-124)
  T adv[4];
  if (second) {
    const T lf = D::divc(dxe, T(2) * dxl);
    for (int j = 0; j < 4; ++j) {
      const T sl = up ? sv(j, tm) : sv(j, tid);
      adv[j] = disp * (qi[j] - sl * lf);
    }
  } else {
    for (int j = 0; j < 4; ++j) adv[j] = sv(j, tid);
  }
  // S[4..8] were last read in stage 5, before its barrier.
  for (int j = 0; j < 4; ++j) sv(4 + j, tid) = adv[j];
  __syncthreads();

  // ---- stage 7: projection (src/projection_schemes.jl:23-41). S[0..3]
  // were last read in stage 6, so a caller may reuse them right after.
  T tmp[4];
  {
    const T dXr = dX * rho1;
    const T num[4] = {dXr, dXr * ua1, dXr * uo, dXr * E1};
    for (int j = 0; j < 4; ++j) {
      const T v = num[j] - (sv(4 + j, tp) - adv[j]);
      tmp[j] = FAST ? v * inv_dx : v / dx;
    }
  }
  rho_o = tmp[0];
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

template <typename T, int AXIS, bool FAST, bool BIZ>
__global__ void __launch_bounds__(Geom<AXIS>::TILE * Geom<AXIS>::LINES)
sweep_kernel(const SweepArgs a) {
  constexpr int P = Geom<AXIS>::TILE;
  constexpr int C = Geom<AXIS>::LINES;
  constexpr int NT = P * C;
  __shared__ T S[9][NT];

  const int lane = AXIS == 0 ? 0 : threadIdx.x;
  const int pos = AXIS == 0 ? threadIdx.x : threadIdx.y;
  const int tid = pos * C + lane;
  const int tm = pos > 0 ? tid - C : tid;      // position k-1 (clamped)
  const int tp = pos < P - 1 ? tid + C : tid;  // position k+1 (clamped)

  const long long rows = a.rows, cols = a.cols;
  const long long n_along = AXIS == 0 ? cols : rows;
  const long long n_across = AXIS == 0 ? rows : cols;
  const long long seg = AXIS == 0 ? blockIdx.x : blockIdx.y;
  const long long k = seg * (P - 2 * HALO) - HALO + pos;
  const long long across = AXIS == 0 ? (long long)blockIdx.y
                                     : (long long)blockIdx.x * C + lane;
  const long long across_c = across < n_across ? across : n_across - 1;
  const bool out = pos >= HALO && pos < P - HALO && k < n_along && across < n_across;
  const int g = a.g;
  const int n_real = AXIS == 0 ? a.nx : a.ny;
  const int n_cross = AXIS == 0 ? a.ny : a.nx;

  auto at = [&](long long kk) -> long long {
    return AXIS == 0 ? across_c * cols + kk : kk * cols + across_c;
  };

  const T* const* src = reinterpret_cast<const T* const*>(a.src);
  const int run = reinterpret_cast<const int*>(a.iscal)[2];
  if (!run) {  // this cycle is past the run's end: pass the fields through
    if (out) {
      for (int f = 0; f < 4; ++f)
        reinterpret_cast<T*>(a.dst[f])[at(k)] = src[f][at(k)];
    }
    return;
  }
  const T dt = reinterpret_cast<const T*>(a.scal)[3] * T(a.dt_factor);

  // Load with the ghost fill along the axis.
  T fac[4] = {T(1), T(1), T(1), T(1)};
  int side;
  long long ks = ghost_src(k, g, n_real, a.mode_lo, a.mode_hi, a.f_lo, a.f_hi, fac, side);
  T in[4];
  if (side < 0) {
    ks = ks < 0 ? 0 : (ks >= n_along ? n_along - 1 : ks);  // array edge: dead outputs only
    const long long idx = at(ks);
    for (int f = 0; f < 4; ++f) in[f] = src[f][idx] * fac[f];
  } else {
    const T* sl = reinterpret_cast<const T*>(side ? a.slab_hi : a.slab_lo);
    const long long o = AXIS == 0 ? across_c * g + ks : ks * cols + across_c;
    for (int f = 0; f < 4; ++f) in[f] = sl[f * g * n_across + o] * fac[f];
  }
  const T rho = in[0], u_in = in[1], v_in = in[2], E = in[3];
  const T ua = AXIS == 0 ? u_in : v_in;  // velocity along the axis
  const T uo = AXIS == 0 ? v_in : u_in;  // the other one

  T rho2, ua2, uo2, E2, p, c;
  sweep_body<T, FAST, BIZ, NT>(&S[0][0], tid, tm, tp, a.k, a.riemann, a.limiter,
                               a.projection, dt, T(a.dx), T(a.inv_dx), a.emit != 0,
                               rho, ua, uo, E, rho2, ua2, uo2, E2, p, c);
  const T ux2 = AXIS == 0 ? ua2 : uo2;
  const T uy2 = AXIS == 0 ? uo2 : ua2;
  if (out) {
    const long long o = at(k);
    reinterpret_cast<T*>(a.dst[0])[o] = rho2;
    reinterpret_cast<T*>(a.dst[1])[o] = ux2;
    reinterpret_cast<T*>(a.dst[2])[o] = uy2;
    reinterpret_cast<T*>(a.dst[3])[o] = E2;
    if (a.emit) reinterpret_cast<T*>(a.p)[o] = p;
  }
  if (!a.emit) return;

  // ---- CFL partials (`_dt_tile_min`): max of |u|+c and |v|+c over this
  // block's real output cells, post-sweep velocities with the pre-sweep c.
  const bool real = out && k >= g && k < g + n_real && across >= g && across < g + n_cross;
  block_max2<T, NT>(&S[0][0], tid, real ? fabs(ux2) + c : T(0),
                    real ? fabs(uy2) + c : T(0));
  if (tid == 0) {
    const long long b = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    T* part = reinterpret_cast<T*>(a.partials);
    part[b] = S[0][0];
    part[a.n_partials + b] = S[1][0];
  }
}

// Host side: geometry check and dispatch to the template instance.
template <typename T, int AXIS, bool FAST, bool BIZ>
int launch_one(const SweepArgs& a, cudaStream_t stream) {
  const dim3 block = AXIS == 0 ? dim3(Geom<0>::TILE) : dim3(Geom<1>::LINES, Geom<1>::TILE);
  sweep_kernel<T, AXIS, FAST, BIZ><<<dim3(a.grid_x, a.grid_y), block, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Checks the launch geometry the Python wrapper computed (it sized the
// partials from it). Returns 0 or a negative code.
inline int check_geometry(int axis, const SweepArgs* a) {
  if (axis != 0 && axis != 1) return -1;
  const long long P = axis == 0 ? Geom<0>::TILE : Geom<1>::TILE;
  const long long C = axis == 0 ? Geom<0>::LINES : Geom<1>::LINES;
  const long long gx = axis == 0 ? (a->cols + P - 2 * HALO - 1) / (P - 2 * HALO)
                                 : (a->cols + C - 1) / C;
  const long long gy = axis == 0 ? a->rows : (a->rows + P - 2 * HALO - 1) / (P - 2 * HALO);
  if (gx != a->grid_x || gy != a->grid_y || gy > 65535 || gx > 2147483647LL) return -2;
  if (a->emit && a->n_partials < gx * gy) return -3;
  return 0;
}

template <typename T, bool FAST>
int dispatch(int axis, const SweepArgs* a, cudaStream_t stream) {
  if (axis == 0)
    return a->biz ? launch_one<T, 0, FAST, true>(*a, stream)
                  : launch_one<T, 0, FAST, false>(*a, stream);
  return a->biz ? launch_one<T, 1, FAST, true>(*a, stream)
                : launch_one<T, 1, FAST, false>(*a, stream);
}

}  // namespace armon
