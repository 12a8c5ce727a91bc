// overlap_score_grad.cu: the scan score of K candidate poses on each of M
// planes and its gradient with respect to each pose, in one pass, for
// Hopper (sm_90a). Plain C interface, bound from Python with ctypes
// (slam_constructor_tpu_torch/ops/kernels.py::overlap_score_grad, built by
// ops/_build.py).
//
// The gradient matcher's ascent direction. The reference differentiates
// its score with jax.grad (slam_constructor_tpu/ops/matchers.py:
// gradient_match over scoring.score_single); on the TPU that score is the
// kernel of slam_constructor_tpu/ops/pallas_kernels.py: sample_plane_bilinear
// (body _bilinear_kernel) for the overlap reducer at extent 1, and the
// gather path of scoring.py:score_poses for the others, whose counterpart
// here is overlap_score.cu. This kernel is that score's pose gradient:
//
//   score[m, k]  = sum_r beam_w[m, r] * sample(v[m], (apply_pose(poses[m, k],
//                  pts[m, r]) - origin[m]) / scale) / max(sum_r beam_w[m, r], 1e-9)
//   dscore[m, k] = sum_r beam_w[m, r] * d sample / d poses[m, k]
//                  / max(sum_r beam_w[m, r], 1e-9)
//
// sample() and its gradient are overlap_sample.cuh's grad_at(): for the
// bilinear taps sample_grad_at() (each axis weight's derivative -1 for the
// lower tap, +1 for the upper, 0 off the map, where the `unknown` fill
// takes the mass; on a cell's centre the mean of both sides'); for the
// general overlap reducer reduce_grad_at() (each overlap length
// piecewise linear in the endpoint's position, through the normalisation
// by the weights' sum); 0 for the obstacle, max and mean
// reducers, which are piecewise constant. Then the chain through the
// rotation over `scale`. The score is computed as overlap_score.cu computes
// it (the same beams in the same order, the same reduction tree), so its
// bits are that kernel's.
//
// What bounds it on an H100: launch cost and latency. The gradient refine's
// yardstick calls it with K = 1 (the pose being refined), R = 360 beams:
// 360 points x 4 taps (the bilinear reducer; (2 radius + 1)^2 cells for the
// others) of a 256 KB plane that stays in L2; about 0.1 MFLOP.
//
// Design: overlap_score.cu's, one block of 128 threads a (pose, map)
// striding over the beams, with three more per-thread sums (the gradient)
// reduced by the same fixed-order tree, so a result is the same bits from
// run to run. Numerics: see overlap_sample.cuh (no fast math, --fmad=false).

#include <cuda_runtime.h>

#include "overlap_sample.cuh"

namespace {

constexpr int kThreads = overlap::kGroupThreads;

__global__ void __launch_bounds__(kThreads)
overlap_score_grad_kernel(const float* __restrict__ v, int h, int w,
                          const float* __restrict__ poses, int k_poses,
                          const float* __restrict__ pts,
                          const float* __restrict__ beam_w, int r,
                          const float* __restrict__ origin, float scale, float unknown,
                          overlap::Reducer red, float* __restrict__ out,
                          float* __restrict__ dout) {
  __shared__ float trig[2];
  __shared__ float s_a[kThreads];
  __shared__ float s_b[kThreads];

  const int k = blockIdx.x;
  const int m = blockIdx.y;
  const int t = threadIdx.x;
  v += static_cast<long long>(m) * h * w;
  poses += (static_cast<long long>(m) * k_poses + k) * 3;
  pts += static_cast<long long>(m) * r * 2;
  beam_w += static_cast<long long>(m) * r;
  origin += 2 * m;
  const long long o = static_cast<long long>(m) * k_poses + k;
  if (t == 0) {
    const float th = poses[2];
    trig[0] = libm::cos(th);
    trig[1] = libm::sin(th);
  }
  __syncthreads();
  const overlap::Pose p{poses[0], poses[1], trig[0], trig[1]};
  const overlap::LdgPlane at{v, w};
  const float ox = __ldg(origin + 0);
  const float oy = __ldg(origin + 1);

  // beams t, t + kThreads, ... in that order, as overlap::beam_sums_at
  float num = 0.0f, den = 0.0f, gx = 0.0f, gy = 0.0f, gth = 0.0f;
  for (int i = t; i < r; i += kThreads) {
    const float bw = beam_w[i];
    if (bw == 0.0f) continue;
    float dx, dy, dth;
    const float pr = overlap::grad_at(red, at, h, w, p, pts[2 * i + 0], pts[2 * i + 1], ox, oy,
                                      scale, unknown, dx, dy, dth);
    num += bw * pr;
    den += bw;
    gx += bw * dx;
    gy += bw * dy;
    gth += bw * dth;
  }
  overlap::group_reduce(num, den, s_a, s_b, t, 0);
  overlap::group_reduce(gx, gy, s_a, s_b, t, 0);
  float unused = 0.0f;
  overlap::group_reduce(gth, unused, s_a, s_b, t, 0);
  if (t == 0) {
    const float d = fmaxf(den, 1e-9f);
    out[o] = overlap::weighted_mean(num, den);
    dout[3 * o + 0] = gx / d;
    dout[3 * o + 1] = gy / d;
    dout[3 * o + 2] = gth / d;
  }
}

}  // namespace

// v f32[m, h, w], poses f32[m, k, 3], pts f32[m, r, 2], beam_w f32[m, r],
// origin f32[m, 2] -> out f32[m, k], dout f32[m, k, 3], all contiguous; map
// i scores and differentiates its own poses with its own scan. A beam reads
// the plane by the reducer (reducer, radius, extent: see
// overlap_sample.cuh). Launches on `stream` (PyTorch's current stream),
// does not synchronise and allocates nothing. Returns the cudaError_t of
// the launch (0 = ok; cudaErrorInvalidValue for a bad reducer or more than
// 65535 maps).
extern "C" int overlap_score_grad_launch(const float* v, int m, int h, int w, const float* poses,
                                         int k, const float* pts, const float* beam_w, int r,
                                         const float* origin, float scale, float unknown,
                                         int reducer, int radius, float extent, float* out,
                                         float* dout, void* stream) {
  overlap::Reducer red;
  if (!overlap::make_reducer(reducer, radius, extent, &red) || m > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k <= 0 || m <= 0) return 0;
  overlap_score_grad_kernel<<<dim3(k, m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, h, w, poses, k, pts, beam_w, r, origin, scale, unknown, red, out, dout);
  return static_cast<int>(cudaGetLastError());
}
