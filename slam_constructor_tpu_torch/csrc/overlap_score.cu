// overlap_score.cu: scan-overlap scoring of K candidate poses, for Hopper
// (sm_90a). Plain C interface, bound from Python with ctypes
// (slam_constructor_tpu_torch/ops/kernels.py, built by ops/_build.py).
//
// Replaces the TPU kernel slam_constructor_tpu/ops/pallas_kernels.py:
// sample_plane_bilinear (body _bilinear_kernel), fused with what
// ops/scoring.py:score_poses computes around it at overlap extent 1: the
// pose transform of the sensor-frame endpoints and _weighted_mean.
//
//   score[k] = sum_r beam_w[r] * sample(v, (apply_pose(poses[k], pts[r])
//              - origin) / scale) / max(sum_r beam_w[r], 1e-9)
//
// sample() is _bilinear_kernel's math: per axis i0 = floor(pos - 0.5) and
// w0 = i0 + 1.5 - pos; taps i0 and i0 + 1 count only inside [0, n);
// coverage = (sum of row taps) * (sum of col taps); the result is
// ssum + (1 - coverage) * unknown, so mass off the map reads `unknown`.
//
// What bounds it on an H100: launch cost and latency, not bytes. At the
// main-path shape (K = 64 candidates, R = 360 beams) one call reads
// 23,040 points x 4 taps x 4 B, about 370 KB of plane taps: about 0.1 us
// at 3.35 TB/s. The 256 KB f32 plane stays in the 50 MB L2 between calls.
// A later change folds the 12-round Monte-Carlo loop into one launch and
// captures the whole step in a CUDA graph.
//
// Design: one block per candidate; kThreads (a warp multiple) stride over
// the beams; cos/sin of the pose once per block; the plane read through
// __ldg (it is larger than a block's 227 KB of shared memory, so it is
// not staged there); beams of weight 0 (invalid) skipped; per-thread sums
// in a fixed order, then a fixed-order shared-memory tree reduction, so a
// result is the same bit for bit from run to run.
//
// Numerics: built without --use_fast_math and with --fmad=false, so no
// multiply-add is contracted and each product and sum rounds on its own,
// as the plain PyTorch twin's separate ops do. The arithmetic order is the
// reference's: world = p + R(theta) pt (x = px + c qx - s qy), minus the
// origin, then DIVIDED by scale (IEEE division, no reciprocal).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct AxisTaps {
  float a0, a1;  // weights of taps i0 and i0 + 1, zero where off the map
  int i0, i1;    // tap indices, clamped into the map
};

__device__ __forceinline__ AxisTaps axis_taps(float pos, int n) {
  const float f = floorf(pos - 0.5f);
  const float w0 = (f + 1.5f) - pos;
  const float fn = static_cast<float>(n);
  AxisTaps t;
  const bool ok0 = f >= 0.0f && f < fn;
  const bool ok1 = f + 1.0f >= 0.0f && f + 1.0f < fn;
  t.a0 = ok0 ? w0 : 0.0f;
  t.a1 = ok1 ? 1.0f - w0 : 0.0f;
  // clamp in float before converting: the comparison also sends NaN to 0
  const float c0 = f >= 0.0f ? fminf(f, fn - 1.0f) : 0.0f;
  const float c1 = f + 1.0f >= 0.0f ? fminf(f + 1.0f, fn - 1.0f) : 0.0f;
  t.i0 = static_cast<int>(c0);
  t.i1 = static_cast<int>(c1);
  return t;
}

__global__ void __launch_bounds__(kThreads)
overlap_score_kernel(const float* __restrict__ v, int h, int w,
                     const float* __restrict__ poses,
                     const float* __restrict__ pts,
                     const float* __restrict__ beam_w, int r,
                     const float* __restrict__ origin, float scale,
                     float unknown, float* __restrict__ out) {
  __shared__ float trig[2];
  __shared__ float s_num[kThreads];
  __shared__ float s_den[kThreads];

  const int k = blockIdx.x;
  const float px = poses[3 * k + 0];
  const float py = poses[3 * k + 1];
  if (threadIdx.x == 0) {
    const float th = poses[3 * k + 2];
    trig[0] = cosf(th);
    trig[1] = sinf(th);
  }
  __syncthreads();
  const float c = trig[0];
  const float s = trig[1];
  const float ox = __ldg(origin + 0);
  const float oy = __ldg(origin + 1);

  float num = 0.0f;
  float den = 0.0f;
  for (int i = threadIdx.x; i < r; i += kThreads) {
    const float bw = __ldg(beam_w + i);
    if (bw == 0.0f) continue;
    const float qx = __ldg(pts + 2 * i + 0);
    const float qy = __ldg(pts + 2 * i + 1);
    const float wx = (px + c * qx) - s * qy;
    const float wy = (py + s * qx) + c * qy;
    const float x = (wx - ox) / scale;
    const float y = (wy - oy) / scale;
    const AxisTaps ry = axis_taps(y, h);
    const AxisTaps cx = axis_taps(x, w);
    // a tap off the map has weight 0 and reads 0, as the one-hot of the
    // reference never matches it
    const float v00 = (ry.a0 != 0.0f && cx.a0 != 0.0f) ? __ldg(v + ry.i0 * w + cx.i0) : 0.0f;
    const float v10 = (ry.a1 != 0.0f && cx.a0 != 0.0f) ? __ldg(v + ry.i1 * w + cx.i0) : 0.0f;
    const float v01 = (ry.a0 != 0.0f && cx.a1 != 0.0f) ? __ldg(v + ry.i0 * w + cx.i1) : 0.0f;
    const float v11 = (ry.a1 != 0.0f && cx.a1 != 0.0f) ? __ldg(v + ry.i1 * w + cx.i1) : 0.0f;
    // rows first, then columns: the order of the reference's a @ plane . b
    const float ssum = (ry.a0 * v00 + ry.a1 * v10) * cx.a0 +
                       (ry.a0 * v01 + ry.a1 * v11) * cx.a1;
    const float coverage = (ry.a0 + ry.a1) * (cx.a0 + cx.a1);
    const float p = ssum + (1.0f - coverage) * unknown;
    num += bw * p;
    den += bw;
  }

  s_num[threadIdx.x] = num;
  s_den[threadIdx.x] = den;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      s_num[threadIdx.x] += s_num[threadIdx.x + stride];
      s_den[threadIdx.x] += s_den[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = s_num[0] / fmaxf(s_den[0], 1e-9f);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream), does not synchronise
// and allocates nothing. Returns the cudaError_t of the launch (0 = ok).
extern "C" int overlap_score_launch(const float* v, int h, int w,
                                    const float* poses, int k,
                                    const float* pts, const float* beam_w,
                                    int r, const float* origin, float scale,
                                    float unknown, float* out, void* stream) {
  if (k <= 0) return 0;
  overlap_score_kernel<<<k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, h, w, poses, pts, beam_w, r, origin, scale, unknown, out);
  return static_cast<int>(cudaGetLastError());
}
