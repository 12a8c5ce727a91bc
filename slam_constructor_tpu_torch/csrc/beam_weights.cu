// beam_weights.cu: vinySLAM's beam weights of N scans in one launch, for
// Hopper (sm_90a). Plain C interface, bound from Python with ctypes
// (slam_constructor_tpu_torch/ops/kernels.py::beam_weights, built by
// ops/_build.py).
//
// The reference computes them as XLA ops on the TPU (no Pallas kernel):
// slam_constructor_tpu/models/engine.py:_point_weights over
// ops/scan.py:angle_histogram. For a scan of R beams:
//
//   ang[j]  = atan2(dy, dx) of the endpoint step from beam j to beam j + 1
//             (j < R - 1), the later endpoint's product fused
//             (scan.endpoint_angles' operations)
//   bin(a)  = clamp(floor((a + pi) * f32(f32(1 / 2 pi) * n_bins)), 0, n_bins - 1)
//             (scan.angle_bins: the reference's jitted code folds its
//             division by 2 pi and its product by n_bins into one constant)
//   hist[b] = count of j with bin(ang[j]) = b and both beams valid,
//             divided by max(the counts' sum, 1)
//   w[j]    = 1 / fma(hist[bin(ang[min(j, R - 2)])], n_bins, 1)
//
// Its plain version is scan.point_weights_ref (what engine._point_weights
// runs off the card); the launch gives its bits.
//
// What bounds it on an H100: the launch. A scan is 360 beams (4.3 KB read,
// 1.4 KB written) and ~360 sincos and atan2 evaluations: well under a
// microsecond of work. As PyTorch ops it was two endpoint-angle launches,
// an fma launch and ~25 ATen calls a scan, each a launch of its own.
//
// Design: one block a scan. Each thread takes beams j (a stride of the
// block): its sincos (libm.cuh, the reference's sinf and cosf) and its
// endpoint's products r cos b and r sin b into shared memory, once a beam.
// After a barrier each thread takes beam pairs j: the fused step from
// shared memory, glibc's atan2f, the bin into shared memory, and the
// pair's count by an integer atomic into the bins in shared memory
// (integer counts: exact in any order). Then the normalised bins and each
// beam's weight from its pair's bin. Nothing is written to global memory
// but the weights, and nothing is read on the host.
//
// Numerics: built without --use_fast_math and with --fmad=false; every
// multiply-add the plain version fuses is an explicit fma, the divisions
// are IEEE divisions.

#include <cuda_runtime.h>

#include "libm.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBins = 256;

// scan.angle_bins: the bin of angle a, `offset` f32(pi), `factor`
// f32(f32(1 / 2 pi) * n_bins); compared in float before the cast
__device__ __forceinline__ int angle_bin(float a, int n_bins, float offset, float factor) {
  const float b = floorf(__fmul_rn(__fadd_rn(a, offset), factor));
  return static_cast<int>(fminf(fmaxf(b, 0.0f), static_cast<float>(n_bins - 1)));
}

__global__ void __launch_bounds__(kThreads)
beam_weights_kernel(const float* __restrict__ ranges, const float* __restrict__ bearings,
                    const unsigned char* __restrict__ valid, float* __restrict__ out, int r,
                    int n_bins, float offset, float factor) {
  // the beams' cosines, sines and endpoint products f32[r] each, then each
  // pair's bin i32[r - 1]
  extern __shared__ float s_beam[];
  float* s_c = s_beam;
  float* s_s = s_c + r;
  float* s_x = s_s + r;
  float* s_y = s_x + r;
  int* s_bin = reinterpret_cast<int*>(s_y + r);
  __shared__ int s_count[kMaxBins];
  __shared__ float s_hist[kMaxBins];
  __shared__ int s_total;
  const size_t first = static_cast<size_t>(blockIdx.x) * r;
  ranges += first;
  bearings += first;
  valid += first;
  out += first;
  for (int b = threadIdx.x; b < n_bins; b += kThreads) s_count[b] = 0;
  for (int j = threadIdx.x; j < r; j += kThreads) {
    float sn, cs;
    libm::sincos(__ldg(bearings + j), &sn, &cs);
    const float rj = __ldg(ranges + j);
    s_c[j] = cs;
    s_s[j] = sn;
    s_x[j] = __fmul_rn(rj, cs);
    s_y[j] = __fmul_rn(rj, sn);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < r - 1; j += kThreads) {
    const float r1 = __ldg(ranges + j + 1);
    const float dx = libm::fma32(r1, s_c[j + 1], -s_x[j]);
    const float dy = libm::fma32(r1, s_s[j + 1], -s_y[j]);
    const int bin = angle_bin(libm::atan2(dy, dx), n_bins, offset, factor);
    s_bin[j] = bin;
    if (__ldg(valid + j) && __ldg(valid + j + 1)) atomicAdd(&s_count[bin], 1);
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // the counts' sum: integers, exact in any order
    int total = 0;
    for (int b = threadIdx.x; b < n_bins; b += 32) total += s_count[b];
#pragma unroll
    for (int lanes = 16; lanes > 0; lanes >>= 1) {
      total += __shfl_xor_sync(0xffffffffu, total, lanes);
    }
    if (threadIdx.x == 0) s_total = total;
  }
  __syncthreads();
  const float den = fmaxf(static_cast<float>(s_total), 1.0f);
  for (int b = threadIdx.x; b < n_bins; b += kThreads) {
    s_hist[b] = __fdiv_rn(static_cast<float>(s_count[b]), den);
  }
  __syncthreads();
  const float fb = static_cast<float>(n_bins);
  for (int j = threadIdx.x; j < r; j += kThreads) {
    const int bin = s_bin[j < r - 1 ? j : r - 2];  // the last beam takes the pair before
    out[j] = __fdiv_rn(1.0f, libm::fma32(s_hist[bin], fb, 1.0f));
  }
}

}  // namespace

// The weights out[n, r] of n scans of r >= 2 beams (ranges, bearings f32,
// valid bool, each [n, r] contiguous) into n_bins <= 256 bins, `offset`
// and `factor` as angle_bin() takes them, on `stream` (PyTorch's current
// stream); one block a scan. Returns the cudaError_t of the launch (0 = ok).
extern "C" int beam_weights_launch(const float* ranges, const float* bearings,
                                   const unsigned char* valid, float* out, int n, int r,
                                   int n_bins, float offset, float factor, void* stream) {
  if (n <= 0 || r < 2 || n_bins < 1 || n_bins > kMaxBins) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared = static_cast<size_t>(4 * r) * sizeof(float) +
                        static_cast<size_t>(r - 1) * sizeof(int);
  if (shared > 32 * 1024) {  // past the default 48 KB a block with the static part
    const cudaError_t err = cudaFuncSetAttribute(
        beam_weights_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  beam_weights_kernel<<<n, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      ranges, bearings, valid, out, r, n_bins, offset, factor);
  return static_cast<int>(cudaGetLastError());
}
