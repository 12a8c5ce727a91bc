// polar_free.cu: the dense polar free-space fill of one laser scan, for
// Hopper (sm_90a). Plain C interface, bound from Python with ctypes
// (slam_constructor_tpu_torch/ops/kernels.py, built by ops/_build.py).
//
// Replaces the TPU kernel slam_constructor_tpu/ops/pallas_kernels.py:
// polar_free_lookup (body _polar_lookup_kernel) together with everything
// ops/raycast.py:_polar_free_plane_pallas computes around it, i.e. the
// whole of ops/raycast.py:_polar_free_plane in one launch. The TPU kernel
// took the bearing-bin, distance and weight planes ready-made (its compiler
// has no atan2) and looked the range up with a one-hot product (a gather
// serialises there). Here the trigonometry runs in the kernel and the
// lookup is a read from shared memory.
//
//   out[row, col] = 2 atan(scale / (2 max(d, scale / 2))) / |db|
//                   if the cell centre lies inside the field of view,
//                      d < rng_eff[bin] - hole_half and d < max_range,
//                   else 0
//
// with d and the bearing of the cell centre taken from the pose, bin the
// nearest beam (round half to even), db the bearing spacing, and rng_eff[i]
// the range of beam i minimised with its two neighbours' (invalid beams
// count +inf for their neighbours and 0 for themselves; neighbours go round
// the circle for a full-circle scan and are clamped at the ends otherwise).
//
// What bounds it on an H100: at the main-path shape (256 x 256 cells, 360
// beams) it writes 262,144 B and reads 3,260 B, about 0.08 us at 3.35 TB/s.
// Per cell it calls atan2f twice, sinf, cosf and atanf once each, plus a
// square root and three divisions: about 190 f32 operations with the math
// library's routines expanded, 12.5 MFLOP a plane, about 0.19 us at
// 67 TFLOP/s. So operations bind before bytes do, and the launch itself
// (a few us) before either. The design therefore spends nothing on memory
// tricks: one thread a cell, consecutive threads on consecutive columns so
// the one store is coalesced, no atomics, no reduction; the result is the
// same bits on every run. Each block first builds rng_eff in dynamic shared
// memory (R floats; 3 R small reads that stay in L1/L2), so no second
// launch and no scratch in device memory are needed. Nothing of the scan is
// read on the host: the spacing, the full-circle test, the pose and the
// origin are all read through device pointers.
//
// Numerics: built without --use_fast_math and with --fmad=false, so every
// product and sum rounds on its own, as the plain PyTorch twin's separate
// ops do, in the reference's order: centre = origin + (i + 0.5) * scale;
// d = sqrt(dx dx + dy dy); ang = atan2(dy, dx) - theta; wrap_angle is
// atan2(sin, cos); the bin is rintf (half to even) of wrap / db, an IEEE
// division; C's % may be negative, so the modulo is folded back into [0, R).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
polar_free_kernel(const float* __restrict__ ranges,
                  const unsigned char* __restrict__ valid,  // bool[R]
                  const float* __restrict__ bearings, int r,
                  const float* __restrict__ pose,
                  const float* __restrict__ origin, int h, int w, float scale,
                  float hole_half, float max_range, float* __restrict__ out) {
  extern __shared__ float s_rng[];  // rng_eff, f32[R]

  const float b0 = __ldg(bearings);
  float db = (__ldg(bearings + (r - 1)) - b0) / static_cast<float>(r > 1 ? r - 1 : 1);
  if (fabsf(db) < 1e-6f) db = 1.0f;
  const float adb = fabsf(db);
  // 2 pi in f32
  const bool full_circle = adb * static_cast<float>(r) >= 6.283185307179586f - 1.5f * adb;

  for (int i = threadIdx.x; i < r; i += kThreads) {
    float eff = 0.0f;
    if (__ldg(valid + i)) {
      const int ip = full_circle ? (i == 0 ? r - 1 : i - 1) : (i == 0 ? 0 : i - 1);
      const int in = full_circle ? (i == r - 1 ? 0 : i + 1) : (i == r - 1 ? r - 1 : i + 1);
      const float prev = __ldg(valid + ip) ? __ldg(ranges + ip) : CUDART_INF_F;
      const float next = __ldg(valid + in) ? __ldg(ranges + in) : CUDART_INF_F;
      eff = fminf(__ldg(ranges + i), fminf(prev, next));
    }
    s_rng[i] = eff;
  }
  __syncthreads();

  const int cell = blockIdx.x * kThreads + threadIdx.x;
  if (cell >= h * w) return;
  const int row = cell / w;
  const int col = cell - row * w;

  const float y = __ldg(origin + 1) + (static_cast<float>(row) + 0.5f) * scale;
  const float x = __ldg(origin + 0) + (static_cast<float>(col) + 0.5f) * scale;
  const float dy = y - __ldg(pose + 1);
  const float dx = x - __ldg(pose + 0);
  const float d = sqrtf(dx * dx + dy * dy);
  const float ang = atan2f(dy, dx) - __ldg(pose + 2);
  const float t = ang - b0;
  const float binf = atan2f(sinf(t), cosf(t)) / db;
  int bini = static_cast<int>(rintf(binf));
  const bool ok = full_circle || (bini >= 0 && bini <= r - 1);
  if (full_circle) {
    bini %= r;
    if (bini < 0) bini += r;
  } else {
    bini = min(max(bini, 0), r - 1);
  }
  const float cell_range = s_rng[bini];
  const bool is_free = ok && d < cell_range - hole_half && d < max_range;
  const float wgt = 2.0f * atanf(scale / (2.0f * fmaxf(d, scale * 0.5f))) / adb;
  out[cell] = is_free ? wgt : 0.0f;
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), does not synchronise
// and allocates nothing. Returns the cudaError_t of the launch (0 = ok).
// The caller keeps r * 4 bytes within the 48 KB a block gets by default.
extern "C" int polar_free_launch(const float* ranges, const unsigned char* valid,
                                 const float* bearings, int r,
                                 const float* pose, const float* origin, int h,
                                 int w, float scale, float hole_half,
                                 float max_range, float* out, void* stream) {
  if (r <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (h * w + kThreads - 1) / kThreads;
  const size_t shared = static_cast<size_t>(r) * sizeof(float);
  polar_free_kernel<<<blocks, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      ranges, valid, bearings, r, pose, origin, h, w, scale, hole_half, max_range, out);
  return static_cast<int>(cudaGetLastError());
}
