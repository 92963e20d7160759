// The probes' sweep chain: the GAD + minmod + euler_2nd X-sweep chain of
// `scripts/ff_probe.py` (`chain_plain` :264 and `chain_ff` :181), one
// template over the number type: float, double (native on this card) or
// the float-float pair `FF`. `probe_ff.cu` runs it out of place (the ff
// probe), `probe_stream.cu` in place at the top of its I/O ladder.
//
// A thread owns one position of a line of P positions. A value read at
// k-1 / k+1 goes through shared memory (`Shifter`): a group of up to
// NSLOT values is stored, one barrier, then read at the neighbours'
// slots. Two banks alternate, so each group costs one barrier: a bank is
// rewritten only after the next group's barrier, which every thread
// reaches after its reads of the previous group. Six groups per sweep.
// Reads past the line's ends are clamped: those outputs are dead.
//
// Exact arithmetic: the probe libraries are built with -fmad=false, so no
// multiply and add contract; float divides and square roots are the
// IEEE-rounded `__fdiv_rn` / `__fsqrt_rn`, double ones IEEE by default.
// The float-float algorithms are the script's (Dekker / Knuth, the QD
// library's df64 forms), operation by operation, except that `two_prod`
// takes its error term from one `__fmaf_rn`: the term is exact either way,
// so it equals the script's Dekker split bit for bit.

#pragma once

#include "common.cuh"

namespace armon {
namespace probe {

// The script's constants (`ff_probe.py:175-178`), whatever the grid.
constexpr double CHAIN_GAMMA = 1.4, CHAIN_DX = 1.0 / 1024.0, CHAIN_DT = 1e-4,
                 CHAIN_EPS = 1e-6;

struct FF {
  float hi, lo;
};

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = a + b;
  const float bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}
__device__ __forceinline__ FF quick_two_sum(float a, float b) {
  const float s = a + b;
  return {s, b - (s - a)};
}
__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  e = __fmaf_rn(a, b, -p);
}
__device__ __forceinline__ FF operator+(FF a, FF b) {
  float s, e;
  two_sum(a.hi, b.hi, s, e);
  return quick_two_sum(s, (e + a.lo) + b.lo);
}
__device__ __forceinline__ FF operator-(FF a, FF b) {
  float s, e;
  two_sum(a.hi, -b.hi, s, e);
  return quick_two_sum(s, (e + a.lo) - b.lo);
}
__device__ __forceinline__ FF operator-(FF a) { return {-a.hi, -a.lo}; }
__device__ __forceinline__ FF operator*(FF a, FF b) {
  float p, e;
  two_prod(a.hi, b.hi, p, e);
  return quick_two_sum(p, (e + a.hi * b.lo) + a.lo * b.hi);
}
__device__ __forceinline__ FF operator/(FF a, FF b) {
  const float q1 = __fdiv_rn(a.hi, b.hi);
  float p, e;
  two_prod(q1, b.hi, p, e);
  const FF r = a - FF{p, e + q1 * b.lo};
  return quick_two_sum(q1, __fdiv_rn(r.hi + r.lo, b.hi));
}

// Number-type helpers: constants, sqrt, NaN-propagating min/max (FF: the
// script's sign-of-difference selects), the upwind test and the slope's
// sign (float/double: jnp.sign; FF: +-1 from the sign of hi).
template <typename N> __device__ __forceinline__ N nc(double c) { return N(c); }
template <> __device__ __forceinline__ FF nc<FF>(double c) { return {float(c), 0.0f}; }

__device__ __forceinline__ float nsqrt(float x) { return __fsqrt_rn(x); }
__device__ __forceinline__ double nsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ FF nsqrt(FF x) {
  const float s = __fsqrt_rn(x.hi);
  float p, e;
  two_prod(s, s, p, e);
  const FF r = x - FF{p, e};
  return quick_two_sum(s, __fdiv_rn(r.hi + r.lo, 2.0f * s));
}
template <typename N> __device__ __forceinline__ N ndiv(N a, N b) { return a / b; }
template <> __device__ __forceinline__ float ndiv<float>(float a, float b) { return __fdiv_rn(a, b); }

template <typename N> __device__ __forceinline__ N nmin(N a, N b) { return jmin(a, b); }
template <typename N> __device__ __forceinline__ N nmax(N a, N b) { return jmax(a, b); }
template <> __device__ __forceinline__ FF nmin<FF>(FF a, FF b) { return (a - b).hi < 0.0f ? a : b; }
template <> __device__ __forceinline__ FF nmax<FF>(FF a, FF b) { return (b - a).hi < 0.0f ? a : b; }

template <typename N> __device__ __forceinline__ bool npos(N x) { return x > N(0); }
template <> __device__ __forceinline__ bool npos<FF>(FF x) { return x.hi > 0.0f; }

template <typename N> __device__ __forceinline__ N nsgn(N x) { return jsign(x); }
template <> __device__ __forceinline__ FF nsgn<FF>(FF x) {
  return x.hi >= 0.0f ? FF{1.0f, 0.0f} : FF{-1.0f, -0.0f};
}

// Neighbour reads through shared memory (see the file note). `buf` holds
// 2 banks x NSLOT slots x P values.
template <typename N, int P, int NSLOT>
struct Shifter {
  N* buf;
  int pos, bank = 0, rbank = 0;
  __device__ __forceinline__ Shifter(N* b, int p) : buf(b), pos(p) {}
  __device__ __forceinline__ void put(int j, N x) { buf[(bank * NSLOT + j) * P + pos] = x; }
  __device__ __forceinline__ void sync() {
    __syncthreads();
    rbank = bank;
    bank ^= 1;
  }
  __device__ __forceinline__ N get(int j, int k) const {
    int q = pos + k;
    q = q < 0 ? 0 : (q >= P ? P - 1 : q);
    return buf[(rbank * NSLOT + j) * P + q];
  }
};
constexpr int CHAIN_SLOTS = 5;

// `chain_plain` / `chain_ff` at this thread's position. Every thread of
// the block must call it (it holds barriers). Out: rho', u', v', E'.
template <typename N, class SH>
__device__ __forceinline__ void chain(SH& S, N rho, N uax, N uot, N E, N out[4]) {
  const N one = nc<N>(1.0), half = nc<N>(0.5), two = nc<N>(2.0), zero = nc<N>(0.0);
  const N dx = nc<N>(CHAIN_DX), dt = nc<N>(CHAIN_DT), eps = nc<N>(CHAIN_EPS);

  // EOS (perfect gas)
  const N e = E - half * (uax * uax + uot * uot);
  const N p = nc<N>(CHAIN_GAMMA - 1.0) * rho * e;
  const N c = nsqrt(ndiv(nc<N>(CHAIN_GAMMA) * p, rho));
  const N rc = rho * c;
  const N dm = rho * dx;
  S.put(0, rc), S.put(1, uax), S.put(2, p), S.put(3, dm);
  S.sync();
  const N rc_l = S.get(0, -1), u_m = S.get(1, -1), p_m = S.get(2, -1), dm_l = S.get(3, -1);

  // Godunov solve at the k-1/2 interface, GAD blend
  const N rc_sum = rc_l + rc;
  const N us_i = ndiv(rc_l * u_m + rc * uax + (p_m - p), rc_sum);
  const N ps_i = ndiv(rc * p_m + rc_l * p + rc_l * rc * (u_m - uax), rc_sum);
  const N e_u = us_i - u_m, e_p = ps_i - p_m;
  const N d_u = uax - us_i, d_p = p - ps_i;
  S.put(0, e_u), S.put(1, e_p), S.put(2, d_u), S.put(3, d_p);
  S.sync();
  auto lim = [&](N r) { return nmax(zero, nmin(one, r)); };  // minmod
  const N r_um = lim(ndiv(S.get(0, 1), e_u + eps));
  const N r_pm = lim(ndiv(S.get(1, 1), e_p + eps));
  const N r_up = lim(ndiv(S.get(2, -1), d_u + eps));
  const N r_pp = lim(ndiv(S.get(3, -1), d_p + eps));
  const N Dm = (dm_l + dm) * half;
  const N theta = half * (one - rc_sum * half * ndiv(dt, Dm));
  const N ustar = us_i + theta * (r_up * d_u - r_um * e_u);
  const N pstar = ps_i + theta * (r_pp * d_p - r_pm * e_p);
  const N disp = dt * ustar;
  S.put(0, ustar), S.put(1, pstar), S.put(2, disp);
  S.sync();
  const N us_p = S.get(0, 1), ps_p = S.get(1, 1), disp_m = S.get(2, -1), disp_p = S.get(2, 1);

  // Lagrangian update
  const N dX = dx + dt * (us_p - ustar);
  const N rho1 = ndiv(dm, dX);
  const N dt_dm = ndiv(dt, dm);
  const N uax1 = uax + dt_dm * (pstar - ps_p);
  const N E1 = E + dt_dm * (pstar * ustar - ps_p * us_p);

  // Slope-limited advection fluxes
  const bool up = npos(disp);
  const N q[4] = {rho1, rho1 * uax1, rho1 * uot, rho1 * E1};
  const N dxe = up ? disp_m - dx : dx + disp_p;
  S.put(0, dX);
  for (int j = 0; j < 4; ++j) S.put(1 + j, q[j]);
  S.sync();
  const N dXm = S.get(0, -1), dXp = S.get(0, 1);
  const N dxl = up ? dXm : dX;
  const N r_m = ndiv(two * dX, dX + dXm);
  const N r_p = ndiv(two * dX, dX + dXp);
  N qi[4], sl[4];
  for (int j = 0; j < 4; ++j) {
    const N qm = S.get(1 + j, -1), qp = S.get(1 + j, 1);
    qi[j] = up ? qm : q[j];
    const N du_p = r_p * (qp - q[j]);
    const N du_m = r_m * (q[j] - qm);
    const N sg = nsgn(du_p);
    sl[j] = sg * nmax(zero, nmin(sg * du_p, sg * du_m));
  }
  for (int j = 0; j < 4; ++j) S.put(j, sl[j]);
  S.sync();
  const N lf = ndiv(dxe, two * dxl);
  N adv[4];
  for (int j = 0; j < 4; ++j) adv[j] = disp * (qi[j] - (up ? S.get(j, -1) : sl[j]) * lf);
  for (int j = 0; j < 4; ++j) S.put(j, adv[j]);
  S.sync();

  // Projection
  const N dXr = dX * rho1;
  const N num[4] = {dXr, dXr * uax1, dXr * uot, dXr * E1};
  N tmp[4];
  for (int j = 0; j < 4; ++j) tmp[j] = ndiv(num[j] - (S.get(j, 1) - adv[j]), dx);
  out[0] = tmp[0];
  for (int j = 1; j < 4; ++j) out[j] = ndiv(tmp[j], tmp[0]);
}

}  // namespace probe
}  // namespace armon
