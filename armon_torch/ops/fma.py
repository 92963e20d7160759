"""Exactly rounded fused multiply-add, `fma(a, b, c)` = RN(a * b + c), in
ordinary tensor operations.

PyTorch's CPU operations round every product and every sum. XLA:CPU, which
runs the JAX package's jitted jnp tier, contracts a product into the add or
subtract that uses it when that is its only use in the same basic block
(LLVM's fusion of fmul and fadd: the first operand when both are such
products), and multiplies by the rounded reciprocal where it divides by a
constant. The op path, the kernels' plain versions (`ops/sweep.py`) and the
CUDA kernels (`csrc/sweep.cuh`, `fmadd`; built with -fmad=false, so nothing
else fuses) make the same contractions, so the three stay bit for bit alike
and most runs equal the jitted jnp tier bit for bit.

The sites, JAX package (`armon_tpu/ops/`) -> port (`armon_torch/ops/`;
the plain versions in `sweep.py` and the kernels' `eos_prc`, `sweep_body`,
`run_body` and K2's pipeline make the same ones):

- `eos.py:23,63` e = E - 0.5*(u*u + v*v) -> fma(fma(u, u, v*v), -0.5, E),
  u first whatever the axis (`eos.py:40,83`; `sweep.py:268,274`).
- `eos.py:64` p = pk0 + G0rho0*(e - epsk0) -> fma(G0rho0, e - epsk0,
  pk0); `:65` G0rho0*(p - pk0) - pk0prime -> fma(G0rho0, p - pk0,
  -pk0prime) (`eos.py:84-85`; `sweep.py:269-270`).
- `riemann.py:24` rc_l*u_im + rc_r*u_i -> fma(rc_l, u_im, rc_r*u_i);
  `:25` -> fma(rc_l*rc_r, u_im - u_i, fma(rc_r, p_im, rc_l*p_i)); their
  rc_l + rc_r is not contracted (`riemann.py:29-30`; `sweep.py:284-285`).
- `riemann.py:72` (dm_l + dm_r)/2 -> fma(rho_m, dx, rho*dx)/2; `:76`
  1 - (rc_l + rc_r)/2*(dt/Dm) -> fma(-(fma(rho_m, c_m, rho*c)/2), dt/Dm,
  1); `:78-79` us_i + theta*(r_up*d - r_um*e) -> fma(theta, fma(r_up, d,
  -(r_um*e)), us_i) (`riemann.py:72-77`; `sweep.py:323-327`).
- `update.py:21` (and `projection.py:98`) dx + dt*(us_p - us) -> fma(dt,
  us_p - us, dx); `:22` uax + dt/dm*(...) -> fma(dt/dm, ps - ps_p, uax);
  `:23` -> fma(dt/dm, fma(ps, us, -(ps_p*us_p)), E) (`update.py:24-27`,
  `projection.py:143`; `sweep.py:332-336`).
- `projection.py:58` dxe -> where(up, -fma(-dt, us_m, dx), fma(dt, us_p,
  dx)); `:60-62` dx + dt*(...) -> fma(dt, ..., dx); `:84-87` q_i - sl*lf
  -> fma(-sl, lf, q_i) (`projection.py:88-93,114`; `sweep.py:350-363`).
- `projection.py:100-103` the flux differences: rho's stored flux shifted
  minus the cell's product -> fma(-disp, Q, adv_next); u, v and E ->
  fma(disp_next, Q_next, -(disp*Q)); dX*rho - d -> fma(dX, rho, -d) for
  the new rho, not contracted where it divides u, v and E; dX*rho*x - d ->
  fma(dX*rho, x, -d); `/ dx` -> `* (1/dx)` (`projection.py:135-150`;
  `sweep.py:369-376`).
- No site: `reductions.py:60` (|u| + c, dx / max), `reductions.py:108-130`
  (the products are stored before the scan), `core/timestep.py:36`.

Also copied, on every route: across the sweeps of a cycle XLA folds the
previous sweep's (X*(1/dx))*(gamma-1) into X*K, K one constant, X the
unscaled new density fma(dX, rho, -d) (`ops/eos.folds`). Not copied
(ROADMAP C2): XLA reassociates the Bizarrium EOS's constants (`1 + x` of
`x = rho*(1/rho0) - 1` becomes rho*(1/rho0)), contracting its polynomials
differently in each fusion; and it flushes subnormal results to zero.

How: f32, the f64 product of two f32 values is exact; a TwoSum with c
gives the exact sum as two f64 values; rounding the high part to odd with
the low part's sign (round-to-odd, 53 bits) and then to f32 rounds once
(Boldo and Melquiond, "Emulation of FMA and correctly rounded sums: proved
algorithms using rounding to odd", IEEE TC 2008). f64: Dekker's exact
product, a TwoSum, a round-to-odd addition and one rounded addition (the
same paper), where the operands' range makes every step exact; elsewhere
a and b are scaled to mantissas in [0.5, 1) and c by the same power of
two, and the result scaled back; a result in the subnormal range is
rounded once by that scaling, from the round-to-odd value of the exact
sum, with the case where that value sits on a midpoint of the subnormal
grid decided by the sign of the exact remainder. Non-finite inputs and
zero factors take ``a*b + c`` as it is, which is then exact.

CPU tensors take the native library's `std::fma` (`native/armon_fma.cc`),
one pass; `emulated_fma`, the construction, is what other devices take,
CHUNK elements at a time, and equals it bit for bit
(`tests/test_torch_fma.py`). Either is a plain version (tests, the op
path, the cycle-0 EOS) and never stands in for a kernel.
"""

import torch

_SPLIT = 134217729.0  # 2**27 + 1, Veltkamp's splitter for 53 bits
_INF = torch.tensor(float("inf"), dtype=torch.float64)


def _two_sum_err(x, y, s):
    """The exact error of s = RN(x + y) (Knuth's TwoSum)."""
    bp = s - x
    return (x - (s - bp)) + (y - bp)


def _split(x):
    g = _SPLIT * x
    hi = g - (g - x)
    return hi, x - hi


def _round_odd(w, err, direction=True):
    """Round to odd of the exact w + err, w = RN(w + err): w where err is 0
    or w is odd, else w's neighbour toward err. Returns (value, sign of
    exact - value), the sign only with `direction`."""
    bump = (err != 0) & ((w.view(torch.int64) & 1) == 0)
    y = torch.where(bump, torch.nextafter(w, torch.copysign(_INF, err)), w)
    if not direction:
        return y, None
    s = torch.sign(err)
    return y, torch.where(bump, -s, s)


def _pow2(k):
    """2**k as float64 for an integer tensor k in [-1022, 1023]."""
    return ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def _scale(x, k):
    """x * 2**k, exact wherever the result is a normal number (or
    overflows), for k in [-2200, 2100]: three factors of one sign, so each
    partial product lies between x and the result."""
    out = x
    for _ in range(3):
        step = k.clamp(-1022, 1023)
        out = out * _pow2(step)
        k = k - step
    return out


def _fma32(a, b, c):
    p = a.double() * b.double()
    cd = c.double()
    th = p + cd
    y, _ = _round_odd(th, _two_sum_err(p, cd, th), direction=False)
    return torch.where(torch.isfinite(th), y, th).to(torch.float32)


def _core(x, y, z):
    """(th, v): th + v is x*y + z, v rounded to odd (Dekker's product, a
    TwoSum, a round-to-odd addition), exact where no step overflows or
    underflows; RN(th + v) is the fused result. Also returns v's sign of
    the exact remainder."""
    uh = x * y
    xh, xl = _split(x)
    yh, yl = _split(y)
    ul = xl * yl - (((uh - xh * yh) - xl * yh) - xh * yl)
    th = z + uh
    tl = _two_sum_err(z, uh, th)
    w = tl + ul
    v, dir_v = _round_odd(w, _two_sum_err(tl, ul, w))
    return th, v, dir_v


# The unscaled algorithm is exact for factors in [2**-480, 2**480], |c| up
# to 2**960 and a result of at least 2**-960 in magnitude (or 0).
_LO, _HI = 2.0 ** -480, 2.0 ** 480


def _fma64(a, b, c):
    th, v, _ = _core(a, b, c)
    aa, ab = torch.abs(a), torch.abs(b)
    # a zero factor makes a*b + c exact (and gives its signed zeros)
    zero = (aa == 0) | (ab == 0)
    r = torch.where(zero, a * b + c, th + v)
    ar = torch.abs(r)
    safe = zero | ((aa >= _LO) & (aa <= _HI) & (ab >= _LO) & (ab <= _HI)
                   & (torch.abs(c) <= 2.0 ** 960)
                   & ((ar >= 2.0 ** -960) | (r == 0)))
    safe &= torch.isfinite(c)
    # one host read skips the scaled form where no input needs it (the op
    # path, the only caller on the card, is never captured in a graph)
    if bool(safe.all()):
        return r
    return torch.where(safe, r, _fma64_scaled(a, b, c))


def _fma64_scaled(a, b, c):
    """Every finite input: a and b scaled to mantissas in [0.5, 1), c by
    the same power of two."""
    naive = a * b + c
    prod = a * b
    finite = torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(c)
    nonzero = (a != 0) & (b != 0)
    ma, ea = torch.frexp(a)
    mb, eb = torch.frexp(b)
    mc, ec = torch.frexp(c)
    s = (ea + eb).to(torch.int64)
    d = ec.to(torch.int64) - s
    # c's weight against the product's: above 2**60 the product is under
    # half an ulp of c; below 2**-300 c only breaks ties, as any value of
    # its sign that small does.
    tiny = torch.copysign(torch.full_like(c, 2.0 ** -400), c)
    z = torch.where(d < -300, tiny, mc * _pow2(d.clamp(-300, 60)))
    th, v, dir_v = _core(ma, mb, z)
    r = th + v
    normal = _scale(r, s)
    # Subnormal results: Y, the exact sum rounded to odd, scaled once.
    y, dir_y = _round_odd(r, _two_sum_err(th, v, r))
    dir_x = torch.where(dir_y != 0, dir_y, dir_v)  # sign of exact - Y
    is_sub = (torch.abs(r) < _pow2((-1022 - s).clamp(-1022, 1023))) & (s >= -1074)
    sub = (y * _pow2((s + 1022).clamp(-1022, 1023))) * 2.0 ** -1022
    # t: Y in units of half the subnormal step; an odd integer is a
    # midpoint, where the scaling rounded to even, not toward the exact sum
    t = torch.where(is_sub, y * _pow2((s + 1075).clamp(-1022, 1023)), 0.0)
    mid = (t == torch.floor(t)) & (torch.remainder(t, 2.0) == 1) & (dir_x != 0)
    below = _scale(torch.where(is_sub, sub, 0.0), -s) < y
    fix = mid & (below != (dir_x < 0))
    sub = torch.where(fix, sub + dir_x * 2.0 ** -1074, sub)
    core = torch.where(is_sub, sub, normal)
    out = torch.where((d > 60) | (s < -1074), c, core)
    out = torch.where(c == 0, prod, out)
    # a*b may overflow where c is infinite: the exact sum is c
    naive = torch.where(torch.isinf(c) & torch.isfinite(a) & torch.isfinite(b),
                        c, naive)
    return torch.where(finite & nonzero, out, naive)


def _native(a, b, c):
    from ._build import load_fma
    a, b, c = (x.contiguous() for x in (a, b, c))
    out = torch.empty_like(a)
    fn = load_fma().armon_fma_f64 if a.dtype == torch.float64 \
        else load_fma().armon_fma_f32
    fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), a.numel())
    return out


def _operands(a, b, c):
    like = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    if like.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fma of {like.dtype}")
    return torch.broadcast_tensors(*(
        x if isinstance(x, torch.Tensor) else
        torch.tensor(x, dtype=like.dtype, device=like.device)
        for x in (a, b, c)))


# Elements a call of the construction takes at once: its f64 temporaries
# of a whole field would multiply a run's peak memory on the card.
CHUNK = 1 << 22


def emulated_fma(a, b, c):
    """RN(a * b + c) from ordinary tensor operations (the constructions in
    the module doc), on any device, CHUNK elements at a time."""
    a, b, c = _operands(a, b, c)
    fn = _fma32 if a.dtype == torch.float32 else _fma64
    if a.numel() <= CHUNK:
        return fn(a, b, c)
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    flat = [x.reshape(-1) for x in (a, b, c)]
    flat_out = out.view(-1)
    for i in range(0, flat_out.numel(), CHUNK):
        flat_out[i:i + CHUNK] = fn(*(x[i:i + CHUNK] for x in flat))
    return out


def fma(a, b, c):
    """RN(a * b + c) elementwise, float32 or float64, broadcasting; a
    Python number is taken in the dtype of the tensors. CPU tensors go
    through the native library's `std::fma` (one pass; the same bits as
    `emulated_fma`, which the tests hold to exact rational arithmetic),
    others through `emulated_fma`."""
    a, b, c = _operands(a, b, c)
    if a.device.type == "cpu":
        return _native(a, b, c)
    if a.device.type == "meta":  # shapes and operation counts: one fma
        return torch.addcmul(c, a, b)
    return emulated_fma(a, b, c)
