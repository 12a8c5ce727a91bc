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
// A cell that a beam could reach calls atan2f twice, sinf, cosf and atanf
// once each, plus a square root and three divisions: about 190 f32
// operations with the math library's routines expanded, 12.5 MFLOP if every
// cell of the plane did, about 0.19 us at 67 TFLOP/s. So operations bind
// before bytes do, and the launch itself (a few us) before either.
//
// Design, and what it does about that.
// - Less work: while the neighbour-min table rng_eff is built in shared
//   memory, its maximum is reduced too. A cell with d >= max_range or
//   d >= max(rng_eff) - hole_half cannot be free whatever its bin is
//   (rng_eff[bin] <= the maximum, and an f32 subtraction is monotone), so
//   it stores 0 before any trigonometry or division. The map is 25.6 m
//   wide and a scan reaches 15 m at most, in a corridor far less: most of
//   the plane takes this path, whole warps at a time.
// - A 2-D launch: blockIdx.y is the row, so no thread divides for its row
//   and dy is uniform in the block; consecutive threads are consecutive
//   columns and the one store is coalesced. No atomics, the same bits on
//   every run.
// - The table: every block builds rng_eff itself (R floats; 3 R small reads
//   that stay in L1/L2), so no second launch and no scratch in device
//   memory are needed. Building it once a cluster of 8 blocks (rows) and
//   copying it through distributed shared memory between two cluster
//   barriers was measured slower on an H100 and is not kept: PERF.md has
//   both times.
// - Nothing of the scan is read on the host: the spacing, the full-circle
//   test, the pose and the origin are all read through device pointers.
//
// Numerics: built without --use_fast_math and with --fmad=false, so every
// product and sum rounds on its own, as the plain PyTorch twin's separate
// ops do, in the reference's order: centre = origin + (i + 0.5) * scale;
// d = sqrt(dx dx + dy dy); ang = atan2(dy, dx) - theta; wrap_angle is
// atan2(sin, cos); the bin is rintf (half to even) of wrap / db, an IEEE
// division; C's % may be negative, so the modulo is folded back into [0, R).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "libm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// rng_eff into s_rng[0 .. r) and its maximum into s_rng[r], by the whole
// block; ends in a __syncthreads().
__device__ __forceinline__ void build_table(const float* __restrict__ ranges,
                                            const unsigned char* __restrict__ valid,
                                            int r, bool full_circle, float* s_rng,
                                            float* s_warp_max) {
  // fmaxf skips NaN: a NaN range frees no cell whichever way the test goes
  float top = -CUDART_INF_F;
  for (int i = threadIdx.x; i < r; i += kThreads) {
    const int ip = full_circle ? (i == 0 ? r - 1 : i - 1) : (i == 0 ? 0 : i - 1);
    const int in = full_circle ? (i == r - 1 ? 0 : i + 1) : (i == r - 1 ? r - 1 : i + 1);
    // all six loads at once, whether or not a beam is valid: one trip to L2
    const bool vi = __ldg(valid + i), vp = __ldg(valid + ip), vn = __ldg(valid + in);
    const float ri = __ldg(ranges + i), rp = __ldg(ranges + ip), rn = __ldg(ranges + in);
    const float prev = vp ? rp : CUDART_INF_F;
    const float next = vn ? rn : CUDART_INF_F;
    const float eff = vi ? fminf(ri, fminf(prev, next)) : 0.0f;
    s_rng[i] = eff;
    top = fmaxf(top, eff);
  }
#pragma unroll
  for (int lanes = 16; lanes > 0; lanes >>= 1) {
    top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, lanes));
  }
  if (threadIdx.x % 32 == 0) s_warp_max[threadIdx.x / 32] = top;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kWarps; ++i) top = fmaxf(top, s_warp_max[i]);
    s_rng[r] = top;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
polar_free_kernel(const float* __restrict__ ranges,
                  const unsigned char* __restrict__ valid,  // bool[R]
                  const float* __restrict__ bearings, int r,
                  const float* __restrict__ pose,
                  const float* __restrict__ origin, int h, int w, float scale,
                  float hole_half, float max_range, float* __restrict__ out) {
  extern __shared__ float s_rng[];  // rng_eff f32[R], then its maximum
  __shared__ float s_warp_max[kWarps];

  // every scalar the cells need, loaded before the table is built
  const float ox = __ldg(origin + 0), oy = __ldg(origin + 1);
  const float px = __ldg(pose + 0), py = __ldg(pose + 1), ptheta = __ldg(pose + 2);
  const float b0 = __ldg(bearings);
  // the reference's jitted code divides by the constant r - 1 as a product
  // with its float32 reciprocal
  float db = __fmul_rn(__ldg(bearings + (r - 1)) - b0,
                       __fdiv_rn(1.0f, static_cast<float>(r > 1 ? r - 1 : 1)));
  if (fabsf(db) < 1e-6f) db = 1.0f;
  const float adb = fabsf(db);
  // 2 pi in f32
  const bool full_circle = adb * static_cast<float>(r) >= 6.283185307179586f - 1.5f * adb;

  build_table(ranges, valid, r, full_circle, s_rng, s_warp_max);

  const int row = blockIdx.y;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (row < h && col < w) {
    // the centre and d^2 fused as the reference's jitted code fuses them
    const float y = libm::fma32(static_cast<float>(row) + 0.5f, scale, oy);
    const float x = libm::fma32(static_cast<float>(col) + 0.5f, scale, ox);
    const float dy = y - py;
    const float dx = x - px;
    const float d = libm::sqrt(libm::fma32(dx, dx, dy * dy));
    // no beam reaches further than this, whatever the cell's bin
    const float reach = s_rng[r] - hole_half;
    float wgt = 0.0f;
    if (!(d >= max_range || d >= reach)) {
      const float ang = libm::atan2(dy, dx) - ptheta;
      const float t = ang - b0;
      const float binf = libm::wrap_angle(t) / db;
      int bini = static_cast<int>(rintf(binf));
      const bool ok = full_circle || (bini >= 0 && bini <= r - 1);
      if (full_circle) {
        bini %= r;
        if (bini < 0) bini += r;
      } else {
        bini = min(max(bini, 0), r - 1);
      }
      const float cell_range = s_rng[bini];
      if (ok && d < cell_range - hole_half && d < max_range) {
        wgt = 2.0f * libm::atan(scale / (2.0f * fmaxf(d, scale * 0.5f))) / adb;
      }
    }
    out[row * w + col] = wgt;
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), does not synchronise
// and allocates nothing. Returns the cudaError_t of the launch (0 = ok).
// The caller keeps (r + 1) * 4 bytes within the 48 KB a block gets by
// default. Every block builds its own table.
extern "C" int polar_free_launch(const float* ranges, const unsigned char* valid,
                                 const float* bearings, int r,
                                 const float* pose, const float* origin, int h,
                                 int w, float scale, float hole_half,
                                 float max_range, float* out, void* stream) {
  if (r <= 0 || h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((w + kThreads - 1) / kThreads, h);
  const size_t shared = (static_cast<size_t>(r) + 1) * sizeof(float);
  polar_free_kernel<<<grid, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      ranges, valid, bearings, r, pose, origin, h, w, scale, hole_half, max_range, out);
  return static_cast<int>(cudaGetLastError());
}
