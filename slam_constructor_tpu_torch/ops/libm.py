"""The reference's elementary functions, bit for bit, in torch ops.

The jitted reference computes ``sin``, ``cos``, ``atan`` and ``atan2`` of
float32 by calling glibc's ``sinf``, ``cosf``, ``atanf`` and ``atan2f``
(glibc 2.36 on x86-64; ``sinf`` and ``cosf`` are ifuncs, and on a CPU with
FMA the loader picks their FMA build, whose double-precision polynomials
fuse their multiply-adds), ``exp`` and ``log`` by XLA's own polynomials
(Cephes' ``expf`` and ``logf``, with the multiply-adds that XLA's CPU code
fuses fused), and ``sqrt`` correctly rounded. torch's CPU functions and
CUDA's libdevice give other bits. The functions here follow the
reference's algorithms operation for operation, in float32 and float64
tensor ops that round as IEEE says, so they give its bits on any device and
do not call into the host's libm:

* ``sin``, ``cos``, ``sincos``: glibc's ``sinf.c`` / ``cosf.c`` /
  ``sincosf.h`` (a polynomial in double with a fast reduction below 120
  and the 4/pi table's integer reduction above); a double-precision fused
  multiply-add is emulated exactly (:func:`fma64`);
* ``atan``, ``atan2``: glibc's ``s_atanf.c`` / ``e_atan2f.c`` (fdlibm, in
  float32);
* ``exp``, ``log``: XLA's CPU code for ``exp`` / ``log`` of f32;
* ``sqrt``: through float64 (innocuous double rounding for a square root);
* ``fma32``: a float32 fused multiply-add, for the sites where XLA's CPU
  code fuses one (``a * b + c`` rounded once).

NaN results may differ from the reference's in sign and payload; every
other bit is the reference's. ``kernels.libm_*`` is the same on the card,
one launch a call (``csrc/libm.cu`` over ``csrc/libm.cuh``); the public
functions here send a CUDA tensor there and compute a CPU tensor here.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

Tensor = torch.Tensor

_INF = math.inf


def _f(bits: int) -> float:
    """The float32 with these bits, as a Python float."""
    return float(np.array([bits], np.uint32).view(np.float32)[0])


# --- the reference's flushes ------------------------------------------------
#
# XLA runs its CPU code with denormals flushed (MXCSR's DAZ and FTZ set), and
# glibc's functions run inside it: a subnormal operand of a float operation
# reads as zero, a result that is tiny after rounding to 24 bits is zero.
# Integer tests of a float's word see its bits as they are.

_MIN_NORMAL = _f(0x00800000)
#: a quotient below it in magnitude rounds (to 24 bits, unbounded exponent)
#: below the smallest normal: ``2^-126 - 2^-151``
_TINY_QUOTIENT = 2.0 ** -126 - 2.0 ** -151


def _daz(x: Tensor) -> Tensor:
    """Subnormal float32 values read as zero of their sign."""
    return torch.where(x.abs() < _MIN_NORMAL, x * 0.0, x)


def _div_ftz(a: Tensor, b: Tensor) -> Tensor:
    """float32 ``a / b`` with a tiny quotient flushed to zero of its sign
    (the float64 quotient of two float32 values classifies it exactly)."""
    q = a / b
    return torch.where((a.double() / b.double()).abs() < _TINY_QUOTIENT, q * 0.0, q)


# --- exact double-precision arithmetic --------------------------------------

_SPLITTER = 134217729.0  # 2^27 + 1: Dekker's split of a double into 26 + 27 bits


def _two_sum(a: Tensor, b) -> tuple[Tensor, Tensor]:
    """``s = a + b`` rounded and its exact error ``e`` (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    """Dekker's split of a double (a number or a tensor) into 26 + 27 bits."""
    t = a * _SPLITTER
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a: Tensor, b) -> tuple[Tensor, Tensor]:
    """``p = a * b`` rounded and its exact error (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, (((ah * bh - p) + ah * bl) + al * bh) + al * bl


def _to_odd(s: Tensor, e: Tensor) -> Tensor:
    """``s + e`` (``s`` its rounding to nearest, ``e`` the exact error)
    rounded to odd: ``s`` if exact or odd, else its neighbour towards ``e``."""
    fix = ((s.view(torch.int64) & 1) == 0) & (e != 0) & torch.isfinite(e)
    return torch.where(fix, torch.nextafter(s, torch.where(e > 0, _INF, -_INF).to(s)), s)


def fma64(a: Tensor, b, c) -> Tensor:
    """float64 ``a * b + c`` rounded once: the exact product (Dekker), a
    two-sum with ``c``, the low parts added rounding to odd, then one
    rounding to nearest (Boldo and Melquiond's emulated FMA). Exact for
    the finite operands of the polynomials here (no overflow in a split)."""
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c if torch.is_tensor(c) else torch.full_like(uh, c), uh)
    v = _to_odd(*_two_sum(tl, ul))
    return th + v


def fma32(a: Tensor, b, c) -> Tensor:
    """float32 ``a * b + c`` rounded once, broadcast (``b`` and ``c`` may be
    numbers): on the card one launch, else the product of two float32
    values, exact in float64, plus ``c`` rounded to odd in float64 and then
    to nearest in float32 (no double rounding)."""
    a = _f32(a)
    if _grad_needed(a, b, c):  # the fused value; the derivative of a * b + c
        with torch.no_grad():
            out = fma32(a, b, c)
        v = a * b + c
        return out + (v - v.detach())
    if _on_card(a):
        from . import kernels
        return kernels.libm_fma32(a, b, c)
    return _fma32_ref(a, b, c)


def fma32_plain(a: Tensor, b, c) -> Tensor:
    """:func:`fma32`'s plain version on any device, with no launch of its
    own: for the few values of an index computation (a window's origin)."""
    return _fma32_ref(_f32(a), b, c)


def _fma32_ref(a: Tensor, b, c) -> Tensor:
    b = _f32(b).double() if torch.is_tensor(b) else float(np.float32(b))
    c = _f32(c).double() if torch.is_tensor(c) else float(np.float32(c))
    p = a.double() * b
    s, e = _two_sum(p, c if torch.is_tensor(c) else torch.full_like(p, c))
    return _to_odd(s, e).float()


# --- sin, cos: glibc's sinf / cosf / sincosf (FMA build) ---------------------

# __sincosf_table[0] and [1] (the second with the cosine polynomial negated):
# hpi_inv (2/pi * 2^24), hpi, then c0, c1, s1, c2, s2, c3, s3, c4 (sign[q & 3]: 1, -1, -1, 1)
_SC_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
_SC_HPI = float.fromhex("0x1.921fb54442d18p+0")
_SC_C0 = 1.0
_SC_C1 = float.fromhex("-0x1.ffffffd0c621cp-2")
_SC_S1 = float.fromhex("-0x1.555545995a603p-3")
_SC_C2 = float.fromhex("0x1.55553e1068f19p-5")
_SC_S2 = float.fromhex("0x1.1107605230bc4p-7")
_SC_C3 = float.fromhex("-0x1.6c087e89a359dp-10")
_SC_S3 = float.fromhex("-0x1.994eb3774cf24p-13")
_SC_C4 = float.fromhex("0x1.99343027bf8c3p-16")
_PI63 = float.fromhex("0x1.921fb54442d18p-62")  # 2 pi / 2^64
#: __inv_pio4: 4/pi to 192 bits, 24 words (a word a byte further each)
_INV_PIO4 = (0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
             0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
             0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
             0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041)

_M32 = 0xFFFFFFFF


def _reduce(y: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """glibc's range reduction of float32 ``y``: (r, n, q, top) with r the
    reduced double, n the quadrant (its parity picks the polynomial), q the
    quadrant that picks the sign and the table (n plus the sign bit on the
    large path) and top the top 12 bits of |y|'s word."""
    i = y.view(torch.int32).to(torch.int64) & _M32
    top = (i >> 20) & 0x7FF
    x = y.double()
    small = top < 0x3F4  # |y| < pi/4
    mid = top < 0x42F  # |y| < 120: x - n pi/2, n from a scaled truncation
    r = x * _SC_HPI_INV
    n_mid = (torch.where(mid, r, 0.0).trunc().to(torch.int64) + 0x800000) >> 24
    x_mid = fma64(-n_mid.double(), _SC_HPI, x)
    # |y| >= 120: a 32 x 96 -> 128-bit product with 4/pi, modulo 2^64
    tab = torch.tensor(_INV_PIO4, dtype=torch.int64, device=y.device)
    j = (i >> 26) & 15
    xi = ((i & 0xFFFFFF) | 0x800000) << ((i >> 23) & 7)
    res0 = (xi * tab[j]) & _M32
    res1 = xi * tab[j + 4]
    res2 = xi * tab[j + 8]
    res0 = ((res2 >> 32) | (res0 << 32)) + res1  # int64 wraps: modulo 2^64
    n_big = ((res0 + (1 << 61)) >> 62) & 3
    res0 = res0 - (n_big << 62)
    x_big = res0.double() * _PI63
    q_big = n_big + (i >> 31)
    r = torch.where(small, x, torch.where(mid, x_mid, x_big))
    n = torch.where(small, 0, torch.where(mid, n_mid, n_big))
    q = torch.where(small, 0, torch.where(mid, n_mid, q_big))
    return r, n, q, top


def _polys_exact(r: Tensor, q: Tensor) -> tuple[Tensor, Tensor]:
    """sinf_poly's two polynomials in float64 with glibc's FMA build's fused
    multiply-adds, each exact (:func:`fma64`), before the rounding to
    float32: the sine of ``r * sign[q & 3]`` and the cosine of table ``(q &
    2) >> 1``."""
    x2 = r * r
    sign = torch.where(((q + 1) & 2) != 0, -1.0, 1.0).double()  # sign[q & 3]
    xs = r * sign
    # sine: fma(fma(x2, s3, s2), x5, fma(x3, s1, xs)), x3 = x2 xs, x5 = x3 x2
    x3 = x2 * xs
    sin_p = fma64(fma64(x2, _SC_S3, _SC_S2), x3 * x2, fma64(x3, _SC_S1, xs))
    # cosine: fma(fma(x2, c4, c3), x6, fma(x4, c2, fma(x2, c1, c0))), negated
    # with table 1; x4 = x2 x2, x6 = x2 x4
    x4 = x2 * x2
    cos_p = fma64(fma64(x2, _SC_C4, _SC_C3), x2 * x4, fma64(x4, _SC_C2, fma64(x2, _SC_C1, _SC_C0)))
    return sin_p, torch.where((q & 2) != 0, -cos_p, cos_p)  # table 1: c's negated


def _polys_plain(r: Tensor, q: Tensor) -> tuple[Tensor, Tensor]:
    """The same polynomials with every product and sum rounded on its own:
    within ~10 float64 ulps of the fused results (no step cancels)."""
    x2 = r * r
    xs = r * torch.where(((q + 1) & 2) != 0, -1.0, 1.0).double()
    x3 = x2 * xs
    sin_p = (x2 * _SC_S3 + _SC_S2) * (x3 * x2) + (x3 * _SC_S1 + xs)
    x4 = x2 * x2
    cos_p = (x2 * _SC_C4 + _SC_C3) * (x2 * x4) + (x4 * _SC_C2 + (x2 * _SC_C1 + _SC_C0))
    return sin_p, torch.where((q & 2) != 0, -cos_p, cos_p)


def _near_midpoint(d: Tensor, f: Tensor) -> Tensor:
    """Where float64 ``d`` lies within 2^-40 |d| of a midpoint between
    float32 ``f`` (its rounding) and a neighbour: there a few float64 ulps
    could round it to the other float32."""
    fd = f.double()
    up = torch.nextafter(f, torch.full_like(f, _INF)).double() - fd
    down = fd - torch.nextafter(f, torch.full_like(f, -_INF)).double()
    tol = d.abs() * 2.0 ** -40
    err = d - fd
    return (((err - 0.5 * up).abs() <= tol) | ((err + 0.5 * down).abs() <= tol)) & torch.isfinite(d)


def _polys(r: Tensor, q: Tensor) -> tuple[Tensor, Tensor]:
    """sinf_poly's two polynomials rounded to float32 (sine, cosine).
    Evaluated with plain float64 operations, then, only where such a result
    lies next to a float32 rounding midpoint, with the exact fused
    multiply-adds: the FMA build's float32 everywhere, at a fraction of the
    cost."""
    ds, dc = _polys_plain(r, q)
    fs, fc = ds.float(), dc.float()
    near = _near_midpoint(ds, fs) | _near_midpoint(dc, fc)
    if bool(near.any()):
        i = near.nonzero().squeeze(1)
        es, ec = _polys_exact(r[i], q[i])
        fs, fc = fs.index_put((i,), es.float()), fc.index_put((i,), ec.float())
    return fs, fc


def _sincos_ref(y: Tensor) -> tuple[Tensor, Tensor]:
    r, n, q, top = _reduce(y)
    ps, pc = _polys(r.reshape(-1), q.reshape(-1))
    ps, pc = ps.reshape(y.shape), pc.reshape(y.shape)
    odd = (n & 1) != 0  # an odd quadrant swaps the polynomials
    s, c = torch.where(odd, pc, ps), torch.where(odd, ps, pc)
    tiny, bad = top < 0x398, top >= 0x7F8
    s = torch.where(bad, y - y, torch.where(tiny, y, s))  # |y| < 2^-12: y; inf, NaN: NaN
    c = torch.where(bad, y - y, torch.where(tiny, torch.ones_like(y), c))
    return s, c


def _sin_ref(y: Tensor) -> Tensor:
    return _sincos_ref(y)[0]


def _cos_ref(y: Tensor) -> Tensor:
    return _sincos_ref(y)[1]


# --- atan, atan2: glibc's s_atanf.c / e_atan2f.c (fdlibm, float32) -----------

_ATANHI = tuple(map(_f, (0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA)))
_ATANLO = tuple(map(_f, (0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168)))
# aT[0], aT[2], ..., aT[10] and |aT[1]|, |aT[3]|, ..., |aT[9]| with aT[9]'s sign
_AT_EVEN = tuple(map(_f, (0x3EAAAAAB, 0x3E124925, 0x3DBA2E6E, 0x3D886B35, 0x3D4BDA59,
                          0x3C8569D7)))
_AT_ODD = tuple(map(_f, (0x3E4CCCCD, 0x3DE38E38, 0x3D9D8795, 0x3D6EF16B)))
_AT_9 = _f(0xBD15A221)
_PI = _f(0x40490FDB)
_PI_O_2 = _f(0x3FC90FDB)
_PI_O_4 = _f(0x3F490FDB)
_PI_LO_NEG = _f(0x33BBBD2E)  # -pi_lo
_HALF_PI_LO_NEG = _f(0x333BBD2E)  # -0.5 pi_lo
_TINY = _f(0x0DA24260)  # 1e-30


def _c(v: float, like: Tensor) -> Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _atan_ref(x: Tensor) -> Tensor:
    def c(v):
        return _c(v, x)

    hx = x.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    ax = x.abs()
    one = c(1.0)
    # argument reduction: id -1 (|x| < 7/16), 0, 1, 2 (|x| < 39/16), 3
    ident = torch.where(ix < 0x3F300000, 0, torch.where(ix < 0x3F980000, 1,
                                                        torch.where(ix < 0x401C0000, 2, 3)))
    ident = torch.where(ix < 0x3EE00000, -1, ident)
    num = torch.where(ident == 0, (ax + ax) - one, torch.where(ident == 1, ax - one, ax - c(1.5)))
    den = torch.where(ident == 0, ax + c(2.0), torch.where(ident == 1, ax + one,
                                                          ax * c(1.5) + one))
    r = torch.where(ident == 3, c(-1.0) / ax, num / den)
    r = torch.where(ident < 0, x, r)
    z = r * r
    w = z * z
    s1 = c(_AT_EVEN[5])
    for a in reversed(_AT_EVEN[:5]):
        s1 = s1 * w + c(a)
    s1 = s1 * z
    s2 = c(_AT_9) * w
    for a in reversed(_AT_ODD):
        s2 = (s2 - c(a)) * w
    t = (s1 + s2) * r
    small = x - t
    k = ident.clamp(min=0)
    hi = torch.tensor(_ATANHI, dtype=torch.float32, device=x.device)[k]
    lo = torch.tensor(_ATANLO, dtype=torch.float32, device=x.device)[k]
    big = hi - ((t - lo) - r)
    big = torch.where(hx < 0, -big, big)
    out = torch.where(ident < 0, small, big)
    out = torch.where(ix <= 0x30FFFFFF, x, out)  # |x| < 2^-29: x
    huge = torch.where(hx > 0, c(_ATANHI[3]) + c(_ATANLO[3]), c(-_ATANHI[3]) - c(_ATANLO[3]))
    out = torch.where(ix > 0x4BFFFFFF, huge, out)  # |x| >= 2^25: +-pi/2
    return torch.where(ix > 0x7F800000, x + x, out)


def _atan2_ref(y: Tensor, x: Tensor) -> Tensor:
    y, x = torch.broadcast_tensors(y, x)

    def c(v):
        return _c(v, x)

    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hx >> 30) & 2) | ((hy >> 31) & 1)  # 2 sign(x) + sign(y)
    tiny = c(_TINY)
    pi_p, pi_m = c(_PI) + tiny, c(-_PI) - tiny
    half_p, half_m = c(_PI_O_2) + tiny, c(-_PI_O_2) - tiny
    # finite, nonzero: z = atan(|y / x|), unless |y/x| > 2^60 or < 2^-60 with x < 0
    k = iy - ix
    z = _atan_ref(_div_ftz(_daz(y), _daz(x)).abs())
    z = torch.where((hx < 0) & ((k >> 23) < -60), c(0.0), z)
    z = torch.where(k > 0x1E7FFFFF, c(_PI_O_2) - c(_HALF_PI_LO_NEG), z)
    zl = z + c(_PI_LO_NEG)
    out = torch.where(m == 0, z, torch.where(m == 1, -z, torch.where(m == 2, c(_PI) - zl,
                                                                       zl - c(_PI))))
    # y = +-inf, or x = 0 (y not 0): +-pi/2
    out = torch.where((iy == 0x7F800000) | (ix == 0), torch.where(hy < 0, half_m, half_p), out)
    # x = +-inf
    inf_inf = torch.where(m == 0, tiny + c(_PI_O_4), torch.where(
        m == 1, c(-_PI_O_4) - tiny, torch.where(m == 2, c(3.0) * c(_PI_O_4) + tiny,
                                                c(-3.0) * c(_PI_O_4) - tiny)))
    inf_fin = torch.where(m == 0, c(0.0), torch.where(m == 1, c(-0.0), torch.where(
        m == 2, pi_p, pi_m)))
    out = torch.where(ix == 0x7F800000, torch.where(iy == 0x7F800000, inf_inf, inf_fin), out)
    # y = 0
    out = torch.where(iy == 0, torch.where(m == 2, pi_p, torch.where(m == 3, pi_m, y)), out)
    one = hx == 0x3F800000
    if bool(one.any()):
        out = torch.where(one, _atan_ref(y), out)  # x = 1: atan(y)
    return torch.where((ix > 0x7F800000) | (iy > 0x7F800000), x + y, out)


# --- exp, log: XLA's CPU code for f32 ----------------------------------------

_EXP_LO, _EXP_HI = _f(0xC2AF999A), _f(0x42B1999A)  # -87.8, 88.8
_LOG2E = _f(0x3FB8AA3B)
_LN2_HI, _LN2_LO = _f(0x3F318000), _f(0xB95E8083)
_EXP_P = tuple(map(_f, (0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1, 0x3E2AAAAA)))

_LOG_SQRTHALF = _f(0x3F3504F3)
_LOG_MIN = _f(0x00800000)  # the smallest normal float
_LOG_C = tuple(map(_f, (0x3D9021BB, 0xBDEBD1B8, 0xBDFE5D4F, 0x3E11E9BF, 0x3E4CCEAC,
                        0xBE7FFFFC, 0x3DEF251A, 0xBE2AAE50, 0x3EAAAAAA)))


def _exp_ref(x: Tensor) -> Tensor:
    def c(v):
        return _c(v, x)

    xc = torch.where(c(_EXP_LO) > x, c(_EXP_LO), x)  # max, NaN kept
    xc = torch.where(c(_EXP_HI) < xc, c(_EXP_HI), xc)
    fx = torch.floor(_fma32_ref(xc, _LOG2E, 0.5))
    fx = torch.where(c(-127.0) > fx, c(-127.0), fx)
    fx = torch.where(c(127.0) < fx, c(127.0), fx)
    r = _fma32_ref(-fx, _LN2_HI, xc)
    r = _fma32_ref(-fx, _LN2_LO, r)
    y = _fma32_ref(r, _EXP_P[0], _EXP_P[1])
    for p in (*_EXP_P[2:], 0.5):
        y = _fma32_ref(y, r, p)
    y = _fma32_ref(y, r * r, r) + c(1.0)
    n = torch.where(torch.isnan(fx), 0.0, fx).to(torch.int32)
    scale = ((n << 23) + 0x3F800000).view(torch.float32)
    # the product is exact in float64; below the smallest normal it flushes
    return torch.where(y.double() * scale.double() < _MIN_NORMAL, c(0.0), y * scale)


def _log_ref(x: Tensor) -> Tensor:
    def c(v):
        return _c(v, x)

    x = _daz(x)
    vm = torch.where(x > c(_LOG_MIN), x, c(_LOG_MIN))  # NaN: the smallest normal
    iv = vm.view(torch.int32)
    m = ((iv & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e1 = ((iv >> 23) - 127).float() + c(1.0)
    below = m < c(_LOG_SQRTHALF)
    xp = (m + c(-1.0)) + torch.where(below, m, c(0.0))
    e = torch.where(below, e1 - c(1.0), e1)
    xx = xp * xp
    x3 = xx * xp
    a, b, cc, d, ee, f, g, h, i = _LOG_C
    p1 = _fma32_ref(_fma32_ref(xp, a, b), xp, g)
    p2 = _fma32_ref(_fma32_ref(xp, cc, d), xp, h)
    p3 = _fma32_ref(_fma32_ref(xp, ee, f), xp, i)
    t = _fma32_ref(_fma32_ref(p1, x3, p2), x3, p3)
    y = _fma32_ref(t, x3, e * c(_LN2_LO))
    r = _fma32_ref(e, _LN2_HI, _fma32_ref(c(-0.5), xx, xp) + y)
    r = torch.where(x > 0, r, c(math.nan))  # x <= 0 or NaN: NaN
    r = torch.where(x == 0, c(-math.inf), r)
    return torch.where(x == math.inf, c(math.inf), r)


def _sqrt_ref(x: Tensor) -> Tensor:
    """Correctly rounded: through float64, whose square root rounds to
    float32 without a double-rounding error (53 >= 2 * 24 + 2)."""
    return _daz(x).double().sqrt().float()


def _wrap_angle_ref(t: Tensor) -> Tensor:
    return _atan2_ref(*_sincos_ref(t))


# --- the public functions: the card's kernel on a CUDA tensor ---------------

_PLAIN = [False]


@contextlib.contextmanager
def plain_versions():
    """Inside the block every function here runs its plain version on any
    device, the card's tensors too (the yardstick of the card's kernels)."""
    _PLAIN[0] = True
    try:
        yield
    finally:
        _PLAIN[0] = False


def _on_card(x: Tensor) -> bool:
    return x.is_cuda and not _PLAIN[0]


class _Differentiable(torch.autograd.Function):
    """A function here on a tensor that requires grad: its values as the
    function computes them, its derivative from those values (the score's
    plain twin is differentiated through its pose's sine and cosine)."""

    @staticmethod
    def forward(ctx, op, *xs):
        out = _DISPATCH[op](*xs)
        ctx.op = op
        ctx.save_for_backward(*xs, *(out if isinstance(out, tuple) else (out,)))
        return out

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        op = ctx.op
        if op == "sincos":
            _, s, c = saved
            return None, grads[0] * c - grads[1] * s
        if op == "atan2":
            y, x, _ = saved
            r2 = x * x + y * y
            return None, grads[0] * x / r2, -grads[0] * y / r2
        x, out = saved
        g = grads[0]
        d = {"sin": lambda: _DISPATCH["cos"](x), "cos": lambda: -_DISPATCH["sin"](x),
             "atan": lambda: 1.0 / (1.0 + x * x), "exp": lambda: out, "log": lambda: 1.0 / x,
             "sqrt": lambda: 0.5 / out, "wrap_angle": lambda: torch.ones_like(x)}[op]()
        return None, g * d


def _grad_needed(*xs) -> bool:
    return torch.is_grad_enabled() and any(torch.is_tensor(x) and x.requires_grad for x in xs)


_REFS = {"sin": _sin_ref, "cos": _cos_ref, "atan": _atan_ref, "exp": _exp_ref,
         "log": _log_ref, "sqrt": _sqrt_ref, "wrap_angle": _wrap_angle_ref}


def _f32(x: Tensor) -> Tensor:
    """The reference computes in float32 (JAX without x64): other dtypes are
    cast first."""
    return x if x.dtype == torch.float32 else x.float()


def _unary(op: str, x: Tensor, inplace: bool = False) -> Tensor:
    x = _f32(x)
    if _grad_needed(x):
        return _Differentiable.apply(op, x)
    if _on_card(x):
        from . import kernels
        return kernels.libm_unary(op, x, inplace)
    return _REFS[op](x)


# ``inplace``: on the card, write the result into ``x`` (a temporary of the
# caller's, contiguous) and return it: one launch and no allocation. A CPU
# tensor gets a new one.


def sin(x: Tensor, inplace: bool = False) -> Tensor:
    """glibc's ``sinf``."""
    return _unary("sin", x, inplace)


def cos(x: Tensor, inplace: bool = False) -> Tensor:
    """glibc's ``cosf``."""
    return _unary("cos", x, inplace)


def atan(x: Tensor, inplace: bool = False) -> Tensor:
    """glibc's ``atanf``."""
    return _unary("atan", x, inplace)


def exp(x: Tensor, inplace: bool = False) -> Tensor:
    """XLA's CPU ``exp`` of f32."""
    return _unary("exp", x, inplace)


def log(x: Tensor, inplace: bool = False) -> Tensor:
    """XLA's CPU ``log`` of f32."""
    return _unary("log", x, inplace)


def sqrt(x: Tensor, inplace: bool = False) -> Tensor:
    """The correctly rounded square root (subnormals read as zero)."""
    return _unary("sqrt", x, inplace)


def wrap_angle(t: Tensor, inplace: bool = False) -> Tensor:
    """``atan2(sin t, cos t)`` with glibc's functions: the angle in
    (-pi, pi], one launch on the card."""
    return _unary("wrap_angle", t, inplace)


def cossin(x: Tensor) -> Tensor:
    """``stack([cosf(x), sinf(x)], -1)``: f32[..., 2], one launch and one
    allocation on the card."""
    x = _f32(x)
    if _on_card(x):
        from . import kernels
        return kernels.libm_cossin(x)
    s, c = _sincos_ref(x)
    return torch.stack([c, s], dim=-1)


def sincos(x: Tensor) -> tuple[Tensor, Tensor]:
    """``(sinf(x), cosf(x))``, one launch on the card."""
    x = _f32(x)
    if _grad_needed(x):
        return _Differentiable.apply("sincos", x)
    if _on_card(x):
        from . import kernels
        return kernels.libm_sincos(x)
    return _sincos_ref(x)


def atan2(y: Tensor, x: Tensor) -> Tensor:
    """glibc's ``atan2f(y, x)``, broadcast."""
    y, x = _f32(y), _f32(x)
    if _grad_needed(y, x):
        y, x = torch.broadcast_tensors(y, x)
        return _Differentiable.apply("atan2", y, x)
    if _on_card(y):
        from . import kernels
        y, x = torch.broadcast_tensors(y, x)
        return kernels.libm_atan2(y.contiguous(), x.contiguous())
    return _atan2_ref(y, x)


# --- log-sum-exp over the last dimension --------------------------------------
#
# jax.scipy.special.logsumexp: m = max (0 where it is not finite), then
# log(sum exp(x - m)) + m; the sum here is taken in element order (the
# reference's CPU reduction order is its own: ROADMAP trap k). On the card
# one launch of csrc/libm.cu's row kernel, a row a thread, the same order.

_ROW_MODES = ("lse", "normalize", "softmax", "ess", "sumexp")


def _row_lse_ref(x: Tensor, off: Tensor | None = None, scale: float = 1.0) -> Tensor:
    v = x if off is None else x - off[..., None]
    v = v * scale if scale != 1.0 else v
    m = v.amax(-1)
    m = torch.where(torch.isfinite(m), m, 0.0)
    return _log_ref(_sum_in_order(_exp_ref(v - m[..., None]))) + m


def _sum_in_order(e: Tensor) -> Tensor:
    """The float32 sum of the last dimension in element order: n dependent
    roundings, so one vectorised add over all rows a column (the row
    kernel's order; ``torch.sum`` pairs and ``torch.cumsum`` accumulates
    in float64 on the CPU, other bits). A row is a step's particles (30)."""
    total = torch.zeros(e.shape[:-1], dtype=e.dtype, device=e.device)
    for j in range(e.shape[-1]):
        total = total + e[..., j]
    return total


def _rows_ref(mode: str, x: Tensor, off: Tensor | None = None):
    if mode == "sumexp":
        return _sum_in_order(_exp_ref(x - off[..., None]))
    lse = _row_lse_ref(x)
    if mode == "lse":
        return lse
    if mode == "ess":
        return _exp_ref(-_row_lse_ref(x, lse, 2.0))
    v = x - lse[..., None]
    return v if mode == "normalize" else (_exp_ref(v), lse)


def _rows(mode: str, x: Tensor, off: Tensor | None = None):
    x = _f32(x)
    if _on_card(x):
        from . import kernels
        return kernels.libm_rows(mode, x, off)
    return _rows_ref(mode, x, off)


def logsumexp(x: Tensor) -> Tensor:
    """The log-sum-exp of the last dimension: f32[...]."""
    return _rows("lse", x)


def normalize_log(x: Tensor) -> Tensor:
    """``x - logsumexp(x)`` over the last dimension (one launch on the card)."""
    return _rows("normalize", x)


def softmax_lse(x: Tensor) -> tuple[Tensor, Tensor]:
    """``(exp(x - lse), lse)`` with ``lse = logsumexp(x)`` over the last
    dimension (one launch on the card)."""
    return _rows("softmax", x)


def effective_sample_size(x: Tensor) -> Tensor:
    """``exp(-logsumexp(2 (x - logsumexp(x))))``: 1 / sum(w^2) of the
    normalised weights of log-weights ``x`` (one launch on the card)."""
    return _rows("ess", x)


def _no_grad_dispatch(op):
    def run(*xs):
        with torch.no_grad():
            return {"sincos": sincos, "atan2": atan2}.get(op, lambda x: _unary(op, x))(*xs)
    return run


#: the functions by name, without autograd (``_Differentiable``'s forward)
_DISPATCH = {op: _no_grad_dispatch(op) for op in
             ("sin", "cos", "atan", "exp", "log", "sqrt", "wrap_angle", "sincos", "atan2")}


def sum_exp(x: Tensor, off: Tensor) -> Tensor:
    """``sum exp(x - off)`` over the last dimension, in element order, ``off``
    f32[...] (a rank's share of a sharded log-sum-exp: at one rank the
    sharded normalisation gives :func:`normalize_log`'s bits)."""
    return _rows("sumexp", x, _f32(off))
