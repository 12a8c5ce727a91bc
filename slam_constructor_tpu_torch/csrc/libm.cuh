// libm.cuh: the reference's elementary functions as __device__ code, bit
// for bit with ops/libm.py (and so with the jitted JAX reference on an
// x86-64 CPU with FMA): glibc 2.36's sinf / cosf / sincosf (the FMA build
// the ifunc picks: double-precision polynomials with fused multiply-adds),
// atanf / atan2f (fdlibm, float32), XLA's CPU exp / log of f32 (Cephes'
// polynomials with the multiply-adds XLA's code fuses), the correctly rounded
// square root, and XLA's log1p (ops/prng.py's normal transform).
//
// Every operation is an explicit intrinsic (__fma_rn, __dmul_rn, __dadd_rn,
// __fmaf_rn, __fmul_rn, __fadd_rn, __fdiv_rn, ...), so no contraction by
// nvcc can change a bit (the build passes --fmad=false too). The reference
// runs its CPU code with denormals flushed (DAZ and FTZ): where a subnormal
// can reach an operation here, it is flushed explicitly (libm::daz), as in
// ops/libm.py. Integer tests of a float's word see its bits as they are.
#pragma once

#include <cstdint>

namespace libm {

constexpr float kMinNormal = 1.17549435082228750797e-38f;  // 0x00800000

__device__ __forceinline__ float bits_f(uint32_t b) { return __uint_as_float(b); }

// a subnormal reads as zero of its sign
__device__ __forceinline__ float daz(float x) {
  return fabsf(x) < kMinNormal ? __fmul_rn(x, 0.0f) : x;
}

// float32 a * b + c rounded once
__device__ __forceinline__ float fma32(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// --- sinf, cosf, sincosf (glibc, FMA build) ----------------------------------

// __sincosf_table[0]: c0, c1, s1, c2, s2, c3, s3, c4 (table 1 negates the c's)
constexpr double kC0 = 1.0;
constexpr double kC1 = -0x1.ffffffd0c621cp-2;
constexpr double kS1 = -0x1.555545995a603p-3;
constexpr double kC2 = 0x1.55553e1068f19p-5;
constexpr double kS2 = 0x1.1107605230bc4p-7;
constexpr double kC3 = -0x1.6c087e89a359dp-10;
constexpr double kS3 = -0x1.994eb3774cf24p-13;
constexpr double kC4 = 0x1.99343027bf8c3p-16;
constexpr double kHpiInv = 0x1.45f306dc9c883p+23;  // 2/pi * 2^24
constexpr double kHpi = 0x1.921fb54442d18p+0;
constexpr double kPi63 = 0x1.921fb54442d18p-62;  // 2 pi / 2^64

// __inv_pio4: 4/pi to 192 bits, a word a byte further each (constant
// memory, so that no call builds it on its stack)
namespace {
__constant__ uint32_t kInvPio4[24] = {
    0xa2u,       0xa2f9u,     0xa2f983u,   0xa2f9836eu, 0xf9836e4eu, 0x836e4e44u,
    0x6e4e4415u, 0x4e441529u, 0x441529fcu, 0x1529fc27u, 0x29fc2757u, 0xfc2757d1u,
    0x2757d1f5u, 0x57d1f534u, 0xd1f534ddu, 0xf534ddc0u, 0x34ddc0dbu, 0xddc0db62u,
    0xc0db6295u, 0xdb629599u, 0x6295993cu, 0x95993c43u, 0x993c4390u, 0x3c439041u};
}  // namespace

__device__ __forceinline__ uint32_t inv_pio4(int i) { return kInvPio4[i]; }

// the reduced argument r, the quadrant n (its parity picks the polynomial)
// and q (it picks the sign and the table: n, plus the sign bit on the large
// path); top: the top 12 bits of |y|'s word
struct Reduced {
  double r;
  int n, q;
  uint32_t top;
};

__device__ __forceinline__ Reduced reduce(float y) {
  const uint32_t i = __float_as_uint(y);
  const uint32_t top = (i >> 20) & 0x7ffu;
  const double x = double(y);
  if (top < 0x3f4u) return {x, 0, 0, top};  // |y| < pi/4
  if (top < 0x42fu) {  // |y| < 120
    const double r = __dmul_rn(x, kHpiInv);
    const int n = (__double2int_rz(r) + 0x800000) >> 24;
    return {__fma_rn(-double(n), kHpi, x), n, n, top};
  }
  // a 32 x 96 -> 128-bit product with 4/pi, modulo 2^64
  const int j = (i >> 26) & 15;
  const uint32_t xi = ((i & 0xffffffu) | 0x800000u) << ((i >> 23) & 7);
  uint64_t res0 = uint32_t(xi * inv_pio4(j));
  const uint64_t res1 = uint64_t(xi) * inv_pio4(j + 4);
  const uint64_t res2 = uint64_t(xi) * inv_pio4(j + 8);
  res0 = ((res2 >> 32) | (res0 << 32)) + res1;
  const uint64_t n = (res0 + (1ull << 61)) >> 62;
  res0 -= n << 62;
  const double r = __dmul_rn(__ll2double_rn(int64_t(res0)), kPi63);
  return {r, int(n), int(n) + int(i >> 31), top};
}

// sinf_poly: the sine polynomial of r * sign[q & 3], or (odd) the cosine
// polynomial of table (q & 2) >> 1
__device__ __forceinline__ float poly(double r, int q, bool odd) {
  const double x2 = __dmul_rn(r, r);
  if (!odd) {
    const double xs = __dmul_rn(r, ((q + 1) & 2) ? -1.0 : 1.0);
    const double x3 = __dmul_rn(x2, xs);
    return __double2float_rn(
        __fma_rn(__fma_rn(x2, kS3, kS2), __dmul_rn(x3, x2), __fma_rn(x3, kS1, xs)));
  }
  const double x4 = __dmul_rn(x2, x2);
  const double c =
      __fma_rn(__fma_rn(x2, kC4, kC3), __dmul_rn(x2, x4), __fma_rn(x4, kC2, __fma_rn(x2, kC1, kC0)));
  return __double2float_rn((q & 2) ? -c : c);
}

__device__ __forceinline__ float sin(float y) {
  const Reduced d = reduce(y);
  if (d.top < 0x398u) return y;  // |y| < 2^-12
  if (d.top >= 0x7f8u) return __fsub_rn(y, y);  // inf, NaN
  return poly(d.r, d.q, d.n & 1);
}

__device__ __forceinline__ float cos(float y) {
  const Reduced d = reduce(y);
  if (d.top < 0x398u) return 1.0f;
  if (d.top >= 0x7f8u) return __fsub_rn(y, y);
  return poly(d.r, d.q, !(d.n & 1));
}

__device__ __forceinline__ void sincos(float y, float* s, float* c) {
  const Reduced d = reduce(y);
  if (d.top < 0x398u) {
    *s = y;
    *c = 1.0f;
  } else if (d.top >= 0x7f8u) {
    *s = *c = __fsub_rn(y, y);
  } else {
    *s = poly(d.r, d.q, d.n & 1);
    *c = poly(d.r, d.q, !(d.n & 1));
  }
}

// --- atanf, atan2f (glibc: fdlibm in float32) --------------------------------

__device__ __forceinline__ float atan(float x) {
  const int32_t hx = __float_as_int(x);
  const int32_t ix = hx & 0x7fffffff;
  if (ix > 0x4bffffff) {  // |x| >= 2^25, inf, NaN
    if (ix > 0x7f800000) return __fadd_rn(x, x);
    return hx > 0 ? __fadd_rn(bits_f(0x3fc90fdau), bits_f(0x33a22168u))
                  : __fsub_rn(bits_f(0xbfc90fdau), bits_f(0x33a22168u));
  }
  if (ix <= 0x30ffffff) return x;  // |x| < 2^-29
  const float ax = fabsf(x);
  int id;
  float r;
  if (ix < 0x3ee00000) {
    id = -1;
    r = x;
  } else if (ix < 0x3f300000) {
    id = 0;
    r = __fdiv_rn(__fsub_rn(__fadd_rn(ax, ax), 1.0f), __fadd_rn(ax, 2.0f));
  } else if (ix < 0x3f980000) {
    id = 1;
    r = __fdiv_rn(__fsub_rn(ax, 1.0f), __fadd_rn(ax, 1.0f));
  } else if (ix < 0x401c0000) {
    id = 2;
    r = __fdiv_rn(__fsub_rn(ax, 1.5f), __fadd_rn(__fmul_rn(ax, 1.5f), 1.0f));
  } else {
    id = 3;
    r = __fdiv_rn(-1.0f, ax);
  }
  const float z = __fmul_rn(r, r);
  const float w = __fmul_rn(z, z);
  float s1 = __fmul_rn(bits_f(0x3c8569d7u), w);
  s1 = __fmul_rn(__fadd_rn(s1, bits_f(0x3d4bda59u)), w);
  s1 = __fmul_rn(__fadd_rn(s1, bits_f(0x3d886b35u)), w);
  s1 = __fmul_rn(__fadd_rn(s1, bits_f(0x3dba2e6eu)), w);
  s1 = __fmul_rn(__fadd_rn(s1, bits_f(0x3e124925u)), w);
  s1 = __fmul_rn(__fadd_rn(s1, bits_f(0x3eaaaaabu)), z);
  float s2 = __fmul_rn(bits_f(0xbd15a221u), w);
  s2 = __fmul_rn(__fsub_rn(s2, bits_f(0x3d6ef16bu)), w);
  s2 = __fmul_rn(__fsub_rn(s2, bits_f(0x3d9d8795u)), w);
  s2 = __fmul_rn(__fsub_rn(s2, bits_f(0x3de38e38u)), w);
  s2 = __fmul_rn(__fsub_rn(s2, bits_f(0x3e4ccccdu)), w);
  const float t = __fmul_rn(__fadd_rn(s1, s2), r);
  if (id < 0) return __fsub_rn(x, t);
  // atanhi[id], atanlo[id], selected in registers
  const uint32_t hi = id == 0 ? 0x3eed6338u : id == 1 ? 0x3f490fdau : id == 2 ? 0x3f7b985eu
                                                                             : 0x3fc90fdau;
  const uint32_t lo = id == 0 ? 0x31ac3769u : id == 1 ? 0x33222168u : id == 2 ? 0x33140fb4u
                                                                             : 0x33a22168u;
  const float v = __fsub_rn(bits_f(hi), __fsub_rn(__fsub_rn(t, bits_f(lo)), r));
  return hx < 0 ? -v : v;
}

// float32 a / b, a tiny quotient (below the smallest normal after rounding
// to 24 bits) flushed to zero of its sign
__device__ __forceinline__ float div_ftz(float a, float b) {
  const float q = __fdiv_rn(a, b);
  if (fabsf(q) > kMinNormal) return q;  // above the band: not tiny however it rounds
  // the float64 quotient of two float32 values classifies it exactly
  const double e = __ddiv_rn(double(a), double(b));
  return fabs(e) < 0x1p-126 - 0x1p-151 ? __fmul_rn(q, 0.0f) : q;
}

__device__ __forceinline__ float atan2(float y, float x) {
  const int32_t hx = __float_as_int(x), hy = __float_as_int(y);
  const int32_t ix = hx & 0x7fffffff, iy = hy & 0x7fffffff;
  const float tiny = bits_f(0x0da24260u);  // 1e-30
  const float pi = bits_f(0x40490fdbu), pi_o_2 = bits_f(0x3fc90fdbu);
  const float pi_o_4 = bits_f(0x3f490fdbu);
  if (ix > 0x7f800000 || iy > 0x7f800000) return __fadd_rn(x, y);
  if (hx == 0x3f800000) return atan(y);
  const int m = ((hx >> 30) & 2) | ((hy >> 31) & 1);
  if (iy == 0) {
    if (m == 2) return __fadd_rn(pi, tiny);
    if (m == 3) return __fsub_rn(-pi, tiny);
    return y;
  }
  const float half = hy < 0 ? __fsub_rn(-pi_o_2, tiny) : __fadd_rn(tiny, pi_o_2);
  if (ix == 0) return half;
  if (ix == 0x7f800000) {
    if (iy == 0x7f800000) {
      if (m == 0) return __fadd_rn(tiny, pi_o_4);
      if (m == 1) return __fsub_rn(-pi_o_4, tiny);
      if (m == 2) return __fadd_rn(__fmul_rn(3.0f, pi_o_4), tiny);
      return __fsub_rn(__fmul_rn(-3.0f, pi_o_4), tiny);
    }
    if (m == 0) return 0.0f;
    if (m == 1) return -0.0f;
    if (m == 2) return __fadd_rn(tiny, pi);
    return __fsub_rn(-pi, tiny);
  }
  if (iy == 0x7f800000) return half;
  const int32_t k = iy - ix;
  float z;
  if (k > 0x1e7fffff) {
    z = __fsub_rn(pi_o_2, bits_f(0x333bbd2eu));  // pi/2 + pi_lo / 2
  } else if (hx < 0 && (k >> 23) < -60) {
    z = 0.0f;
  } else {
    z = atan(fabsf(div_ftz(daz(y), daz(x))));
  }
  const float pi_lo_neg = bits_f(0x33bbbd2eu);
  if (m == 0) return z;
  if (m == 1) return -z;
  if (m == 2) return __fsub_rn(pi, __fadd_rn(z, pi_lo_neg));
  return __fsub_rn(__fadd_rn(z, pi_lo_neg), pi);
}

// atan2(sin t, cos t): the angle in (-pi, pi]
__device__ __forceinline__ float wrap_angle(float t) {
  float s, c;
  sincos(t, &s, &c);
  return atan2(s, c);
}

// --- exp, log, log1p: XLA's CPU code for f32 ---------------------------------

__device__ __forceinline__ float exp(float x) {
  float xc = bits_f(0xc2af999au) > x ? bits_f(0xc2af999au) : x;  // max(-87.8, x), NaN kept
  xc = bits_f(0x42b1999au) < xc ? bits_f(0x42b1999au) : xc;      // min(88.8, .)
  float fx = floorf(__fmaf_rn(xc, bits_f(0x3fb8aa3bu), 0.5f));
  fx = -127.0f > fx ? -127.0f : fx;
  fx = 127.0f < fx ? 127.0f : fx;
  float r = __fmaf_rn(-fx, bits_f(0x3f318000u), xc);
  r = __fmaf_rn(-fx, bits_f(0xb95e8083u), r);
  float y = __fmaf_rn(r, bits_f(0x39506967u), bits_f(0x3ab743ceu));
  y = __fmaf_rn(y, r, bits_f(0x3c088908u));
  y = __fmaf_rn(y, r, bits_f(0x3d2aa9c1u));
  y = __fmaf_rn(y, r, bits_f(0x3e2aaaaau));
  y = __fmaf_rn(y, r, 0.5f);
  y = __fadd_rn(__fmaf_rn(y, __fmul_rn(r, r), r), 1.0f);
  const int n = fx != fx ? 0 : int(fx);
  const float scale = __uint_as_float((uint32_t(n) << 23) + 0x3f800000u);
  // the product is exact in double; below the smallest normal it flushes
  return __dmul_rn(double(y), double(scale)) < double(kMinNormal) ? 0.0f : __fmul_rn(y, scale);
}

// Cephes' logf of v > 0 as XLA's code computes it (v <= 0, NaN, inf: the
// caller's)
__device__ __forceinline__ float log_core(float v) {
  const float vm = v > kMinNormal ? v : kMinNormal;  // NaN: the smallest normal
  const uint32_t iv = __float_as_uint(vm);
  const float m = __uint_as_float((iv & 0x7fffffu) | 0x3f000000u);
  const float e1 = __fadd_rn(float(int(iv >> 23) - 127), 1.0f);
  const bool below = m < bits_f(0x3f3504f3u);
  const float xp = __fadd_rn(__fadd_rn(m, -1.0f), below ? m : 0.0f);
  const float e = below ? __fsub_rn(e1, 1.0f) : e1;
  const float xx = __fmul_rn(xp, xp);
  const float x3 = __fmul_rn(xx, xp);
  const float p1 = __fmaf_rn(__fmaf_rn(xp, bits_f(0x3d9021bbu), bits_f(0xbdebd1b8u)), xp,
                             bits_f(0x3def251au));
  const float p2 = __fmaf_rn(__fmaf_rn(xp, bits_f(0xbdfe5d4fu), bits_f(0x3e11e9bfu)), xp,
                             bits_f(0xbe2aae50u));
  const float p3 = __fmaf_rn(__fmaf_rn(xp, bits_f(0x3e4cceacu), bits_f(0xbe7ffffcu)), xp,
                             bits_f(0x3eaaaaaau));
  const float t = __fmaf_rn(__fmaf_rn(p1, x3, p2), x3, p3);
  const float y = __fmaf_rn(t, x3, __fmul_rn(e, bits_f(0xb95e8083u)));
  return __fmaf_rn(e, bits_f(0x3f318000u), __fadd_rn(__fmaf_rn(-0.5f, xx, xp), y));
}

__device__ __forceinline__ float log(float x) {
  x = daz(x);
  float r = log_core(x);
  if (!(x > 0.0f)) r = __uint_as_float(0x7fc00000u);  // x <= 0 or NaN: NaN
  if (x == 0.0f) r = __uint_as_float(0xff800000u);
  if (x == __uint_as_float(0x7f800000u)) r = x;
  return r;
}

// XLA's CPU log1p of x (f32), as ops/prng.py log1p_xla
__device__ __forceinline__ float log1p(float x) {
  // |x| < sqrt(2) - 1: x + (-x^2 / 2 + x^3 N(x) / D(x))
  const float x2 = __fmul_rn(x, x);
  const float z0 = __fmul_rn(x, 0.0f);
  float den = __fadd_rn(z0, 1.0f);
  den = __fmaf_rn(den, x, bits_f(0x417101ADu));
  den = __fmaf_rn(den, x, bits_f(0x42A6185Bu));
  den = __fmaf_rn(den, x, bits_f(0x435DC32Du));
  den = __fmaf_rn(den, x, bits_f(0x439A8CA3u));
  den = __fmaf_rn(den, x, bits_f(0x43586D8Au));
  den = __fmaf_rn(den, x, bits_f(0x42707982u));
  float num = __fadd_rn(z0, bits_f(0x383DE04Bu));
  num = __fmaf_rn(num, x, bits_f(0x3EFF40C5u));
  num = __fmaf_rn(num, x, bits_f(0x40D284FAu));
  num = __fmaf_rn(num, x, bits_f(0x41EF4B9Cu));
  num = __fmaf_rn(num, x, bits_f(0x4273CC76u));
  num = __fmaf_rn(num, x, bits_f(0x426473ADu));
  num = __fmaf_rn(num, x, bits_f(0x41A05101u));
  const float s = __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(num, den));
  const float small = __fadd_rn(x, __fmaf_rn(-0.5f, x2, s));
  // else: Cephes' logf of v = 1 + x
  const float v = __fadd_rn(x, 1.0f);
  float big = log_core(v);
  if (!(v > 0.0f)) big = __uint_as_float(0xFFFFFFFFu);  // v <= 0 or NaN: NaN
  if (v == 0.0f) big = __uint_as_float(0xFF800000u);
  if (v == __uint_as_float(0x7F800000u)) big = __uint_as_float(0x7F800000u);
  return fabsf(x) < bits_f(0x3ED413CDu) ? small : big;
}

// correctly rounded, a subnormal reading as zero
__device__ __forceinline__ float sqrt(float x) { return __fsqrt_rn(daz(x)); }

// --- poses: ops/geometry.py's plain versions, fused as the reference's jitted
// code fuses them --------------------------------------------------------------

// compose(a, b): apply delta b (in a's body frame) to pose a
__device__ __forceinline__ void compose(float ax, float ay, float at, float bx, float by,
                                        float bt, float out[3]) {
  float s, c;
  sincos(at, &s, &c);
  out[0] = fma32(-s, by, fma32(c, bx, ax));
  out[1] = fma32(c, by, fma32(s, bx, ay));
  out[2] = wrap_angle(__fadd_rn(at, bt));
}

}  // namespace libm
