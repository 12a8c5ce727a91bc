// threefry.cu: a step's random numbers from threefry2x32 keys, bit for bit
// with jax.random, in one launch, for Hopper (sm_90a). Plain C interface,
// bound from Python with ctypes (slam_constructor_tpu_torch/ops/kernels.py
// prng_draws, built by ops/_build.py); its plain version is ops/prng.py.
//
// Replaces no Pallas kernel: the reference draws every random number with
// jax.random (XLA's threefry2x32 and its erf_inv, compiled for the TPU)
// from keys held in its state: the Monte-Carlo match
// (slam_constructor_tpu/ops/matchers.py:75, :92), the engine's step
// (models/engine.py:219), the RBPF (models/gmapping.py:207-211, :239,
// :286, :302, :314, :318), resampling (ops/resample.py:43) and the
// synthetic data (utils/datagen.py:156-166).
//
// A launch evaluates a plan: records, one an output, each a path of
// (take i of a split, or every one of a split: an output dimension) from a
// root key, then a leaf: the key itself (two words), 32 random bits, a
// uniform or a normal. JAX's partitionable counters make every element a
// pure function of its own indices: key i of split(k, n) is
// threefry(k, (0, i)) for any n, and element i of a draw is
// threefry(k, (hi(i), lo(i))), bits y0 ^ y1. So a thread computes one
// element: it walks its path from the root (one hash a step) and hashes
// its leaf counter. No thread waits for another; no order is involved.
//
// The floats follow XLA's CPU code operation by operation (ops/prng.py
// has the derivation): the uniform is (bits >> 9 | 0x3F800000) - 1, one
// fused multiply-add by (max - min) and min, then max(min, .); the normal
// is sqrt(2) erf_inv(u) with u on (nextafter(-1, 0), 1), erf_inv Giles'
// polynomial with an FMA a Horner step, log1p XLA's (a rational function
// near 0, Cephes' logf elsewhere) with the multiply-adds that XLA's code
// fuses fused and the others rounded on their own. Every operation is an
// explicit intrinsic: __fmaf_rn where XLA fuses, __fmul_rn / __fadd_rn /
// __fdiv_rn / __fsqrt_rn where it does not, so no contraction by nvcc can
// change a bit (the build passes --fmad=false too).
//
// What bounds it on an H100: a hash is 20 rounds of an add, a rotate (one
// funnel shift) and a xor, plus the key schedule: ~70 32-bit integer
// operations; a normal adds ~80 float operations and one division. The
// RBPF's step (30 particles, 5 rounds of 20 candidates) is 9,000 elements
// of 3-4 hashes: ~2.5 M integer operations, ~0.04 us against the card's
// integer rate, and 36 KB written, ~0.01 us. So it is the launch (~1-2
// us) that bounds it, by three orders of magnitude; the design keeps it to
// one launch a step and nothing read on the host.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRecordWords = 16;
constexpr int kMaxPath = 8;
constexpr int kMaxRecords = 16;

// each record's output, allocated by the wrapper (a tensor an output, so a
// step's draws cost the host one allocation each and no view)
struct Outputs {
  uint32_t* p[kMaxRecords];
};
// kTransform: the normal of the uniform whose 23 mantissa bits are the
// element's index, not its hash (the transform over every input, checked)
enum Kind : int { kKey = 0, kBits = 1, kUniform = 2, kNormal = 3, kTransform = 4 };

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

__device__ __forceinline__ float bits_f(uint32_t b) { return __uint_as_float(b); }

// XLA's CPU log1p of x (f32), as ops/prng.py log1p_xla
__device__ float log1p_xla(float x) {
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
  const float vm = v > bits_f(0x00800000u) ? v : bits_f(0x00800000u);
  const uint32_t iv = __float_as_uint(vm);
  const float m = __uint_as_float((iv & 0x7FFFFFu) | 0x3F000000u);
  const float e1 = __fadd_rn(float(int(iv >> 23) - 127), 1.0f);
  const bool below = m < bits_f(0x3F3504F3u);
  const float xp = __fadd_rn(__fadd_rn(m, -1.0f), below ? m : 0.0f);
  const float e = below ? __fsub_rn(e1, 1.0f) : e1;
  const float xx = __fmul_rn(xp, xp);
  const float x3 = __fmul_rn(xx, xp);
  const float p1 = __fmaf_rn(__fmaf_rn(xp, bits_f(0x3D9021BBu), bits_f(0xBDEBD1B8u)), xp,
                             bits_f(0x3DEF251Au));
  const float p2 = __fmaf_rn(__fmaf_rn(xp, bits_f(0xBDFE5D4Fu), bits_f(0x3E11E9BFu)), xp,
                             bits_f(0xBE2AAE50u));
  const float p3 = __fmaf_rn(__fmaf_rn(xp, bits_f(0x3E4CCEACu), bits_f(0xBE7FFFFCu)), xp,
                             bits_f(0x3EAAAAAAu));
  const float t = __fmaf_rn(__fmaf_rn(p1, x3, p2), x3, p3);
  const float y = __fmaf_rn(t, x3, __fmul_rn(e, bits_f(0xB95E8083u)));
  float big = __fmaf_rn(e, bits_f(0x3F318000u), __fadd_rn(__fmaf_rn(-0.5f, xx, xp), y));
  if (!(v > 0.0f)) big = __uint_as_float(0xFFFFFFFFu);  // v <= 0 or NaN: NaN
  if (v == 0.0f) big = __uint_as_float(0xFF800000u);
  if (v == __uint_as_float(0x7F800000u)) big = __uint_as_float(0x7F800000u);
  return fabsf(x) < bits_f(0x3ED413CDu) ? small : big;
}

// sqrt(2) erf_inv(x) as jax.random.normal computes it (ops/prng.py
// normal_transform)
__device__ float normal_transform(float x) {
  const float lg = log1p_xla(__fmul_rn(-x, x));
  const bool lt = lg > -5.0f;  // w = -log1p(-x^2) < 5
  const float z = lt ? __fsub_rn(-2.5f, lg) : __fadd_rn(__fsqrt_rn(-lg), -3.0f);
  const uint32_t c_lt[9] = {0x32F16588u, 0x34B84B36u, 0xB66C7357u, 0xB6935AC1u, 0x396532DBu,
                            0xBAA45408u, 0xBB88E4EFu, 0x3E7C8F63u, 0x3FC02E2Fu};
  const uint32_t c_ge[9] = {0xB951F09Bu, 0x38D3B56Bu, 0x3AB0DC72u, 0xBB70BDE7u, 0x3BBC127Bu,
                            0xBBF9C5D7u, 0x3C1AA57Eu, 0x3F8036DBu, 0x40354F7Eu};
  float p = bits_f(lt ? c_lt[0] : c_ge[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(z, p, bits_f(lt ? c_lt[i] : c_ge[i]));
  const float r = __fmul_rn(x, fabsf(x) == 1.0f ? __uint_as_float(0x7F800000u) : p);
  return __fmul_rn(r, bits_f(0x3FB504F3u));
}

__device__ __forceinline__ float uniform(uint32_t b, float lo, float span) {
  const float f = __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
  const float u = __fmaf_rn(f, span, lo);
  return u > lo ? u : lo;  // max(lo, u); u is never NaN
}

// One record a blockIdx.y, an element a thread. A record (kRecordWords
// int32): kind, (unused), elements, leaf count, path length, min and max
// (float bits), the span (float bits), then the path: i >= 0 takes key i,
// -n takes every key of a split of n (an output dimension).
__global__ void prng_draws_kernel(const int32_t* __restrict__ plan, const uint32_t* __restrict__ roots,
                                  const Outputs outs) {
  const int32_t* rec = plan + blockIdx.y * kRecordWords;
  const int kind = rec[0];
  const int64_t elements = rec[2];
  const int64_t e = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= elements) return;
  const int64_t leaves = rec[3];
  const int len = rec[4];
  int64_t rest = e / leaves;
  const int64_t leaf = e - rest * leaves;
  uint32_t idx[kMaxPath];
#pragma unroll
  for (int j = kMaxPath - 1; j >= 0; --j) {
    if (j >= len) continue;
    const int32_t s = rec[8 + j];
    if (s < 0) {
      idx[j] = uint32_t(rest % int64_t(-s));
      rest /= int64_t(-s);
    } else {
      idx[j] = uint32_t(s);
    }
  }
  uint32_t k0 = roots[2 * rest], k1 = roots[2 * rest + 1];
#pragma unroll
  for (int j = 0; j < kMaxPath; ++j) {
    if (j >= len) break;
    threefry(k0, k1, 0u, idx[j], k0, k1);
  }
  uint32_t* dst = outs.p[blockIdx.y];
  if (kind == kKey) {
    dst[2 * e] = k0;
    dst[2 * e + 1] = k1;
    return;
  }
  uint32_t y0, y1;
  threefry(k0, k1, uint32_t(uint64_t(leaf) >> 32), uint32_t(leaf), y0, y1);
  const uint32_t b = kind == kTransform ? (uint32_t(leaf) & 0x7FFFFFu) << 9 : y0 ^ y1;
  if (kind == kBits) {
    dst[e] = b;
    return;
  }
  const float u = uniform(b, __int_as_float(rec[5]), __int_as_float(rec[7]));
  dst[e] = __float_as_uint(kind == kUniform ? u : normal_transform(u));
}

}  // namespace

extern "C" {

// plan: n_records records of kRecordWords int32 on the device; roots:
// uint32[n_roots, 2]; outs: a host array of n_records device pointers, one
// output a record. max_elements: the largest record's element count.
int prng_draws_launch(const void* plan, int n_records, long long max_elements, const void* roots,
                      void* const* outs, void* stream) {
  if (n_records < 1 || max_elements < 1) return 0;
  const int threads = 256;
  const long long blocks = (max_elements + threads - 1) / threads;
  if (blocks > 0x7FFFFFFFLL || n_records > kMaxRecords) return int(cudaErrorInvalidConfiguration);
  Outputs o{};
  for (int r = 0; r < n_records; ++r) o.p[r] = static_cast<uint32_t*>(outs[r]);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_records));
  prng_draws_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(plan), static_cast<const uint32_t*>(roots), o);
  return int(cudaGetLastError());
}

}  // extern "C"
