// threefry.cuh: jax.random's threefry2x32 hash, its uniform and its normal
// transform as XLA's CPU code computes them, as __device__ code (ops/prng.py
// has the derivation). threefry.cu draws a step's plan with them;
// mc_match.cu draws a Monte-Carlo match's numbers in its prologue.
#pragma once

#include <cstdint>

#include "libm.cuh"

namespace tf {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32, 20 rounds: (y0, y1) of counter (x0, x1) under key (k0, k1)
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1,
                                         uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + uint32_t(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

// erf_inv(x) as XLA's CPU code computes it (ops/prng.py erf_inv_xla):
// Giles' polynomial, an FMA a Horner step, XLA's log1p
__device__ __forceinline__ float erf_inv(float x) {
  const float lg = libm::log1p(__fmul_rn(-x, x));
  const bool lt = lg > -5.0f;  // w = -log1p(-x^2) < 5
  const float z = lt ? __fsub_rn(-2.5f, lg) : __fadd_rn(__fsqrt_rn(-lg), -3.0f);
  const uint32_t c_lt[9] = {0x32F16588u, 0x34B84B36u, 0xB66C7357u, 0xB6935AC1u, 0x396532DBu,
                            0xBAA45408u, 0xBB88E4EFu, 0x3E7C8F63u, 0x3FC02E2Fu};
  const uint32_t c_ge[9] = {0xB951F09Bu, 0x38D3B56Bu, 0x3AB0DC72u, 0xBB70BDE7u, 0x3BBC127Bu,
                            0xBBF9C5D7u, 0x3C1AA57Eu, 0x3F8036DBu, 0x40354F7Eu};
  float p = __uint_as_float(lt ? c_lt[0] : c_ge[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(z, p, __uint_as_float(lt ? c_lt[i] : c_ge[i]));
  return __fmul_rn(x, fabsf(x) == 1.0f ? __uint_as_float(0x7F800000u) : p);
}

// sqrt(2) erf_inv(x): jax.random.normal's transform of its uniform
__device__ __forceinline__ float normal_transform(float x) {
  return __fmul_rn(erf_inv(x), __uint_as_float(0x3FB504F3u));
}

// the uniform on [lo, lo + span) of 32 random bits
__device__ __forceinline__ float uniform(uint32_t b, float lo, float span) {
  const float f = __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
  const float u = __fmaf_rn(f, span, lo);
  return u > lo ? u : lo;  // max(lo, u); u is never NaN
}

// normal's uniform: on (nextafter(-1, 0), 1), span 2 in float32
constexpr uint32_t kNormalLo = 0xBF7FFFFFu;

// element e of erf_inv(uniform) under key (k0, k1): jax.random.normal's
// draw before its last multiply by sqrt(2)
__device__ __forceinline__ float erf_inv_draw(uint32_t k0, uint32_t k1, uint32_t e) {
  uint32_t y0, y1;
  threefry(k0, k1, 0u, e, y0, y1);
  const float lo = __uint_as_float(kNormalLo);
  return erf_inv(uniform(y0 ^ y1, lo, __fsub_rn(1.0f, lo)));
}

}  // namespace tf
