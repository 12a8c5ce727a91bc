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
// change a bit (the build passes --fmad=false too). The hash, the uniform
// and the transform are csrc/threefry.cuh's (mc_match.cu draws with them
// too), XLA's log1p csrc/libm.cuh's.
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

#include "threefry.cuh"

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
enum Kind : int { kKey = 0, kBits = 1, kUniform = 2, kNormal = 3, kTransform = 4, kErfinv = 5 };

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
    tf::threefry(k0, k1, 0u, idx[j], k0, k1);
  }
  uint32_t* dst = outs.p[blockIdx.y];
  if (kind == kKey) {
    dst[2 * e] = k0;
    dst[2 * e + 1] = k1;
    return;
  }
  uint32_t y0, y1;
  tf::threefry(k0, k1, uint32_t(uint64_t(leaf) >> 32), uint32_t(leaf), y0, y1);
  const uint32_t b = kind == kTransform ? (uint32_t(leaf) & 0x7FFFFFu) << 9 : y0 ^ y1;
  if (kind == kBits) {
    dst[e] = b;
    return;
  }
  const float u = tf::uniform(b, __int_as_float(rec[5]), __int_as_float(rec[7]));
  dst[e] = __float_as_uint(kind == kUniform ? u
                           : kind == kErfinv ? tf::erf_inv(u)
                                             : tf::normal_transform(u));
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
