// overlap_score.cu: scan-overlap scoring of K candidate poses against each
// of M map planes, for Hopper (sm_90a). Plain C interface, bound from Python with ctypes
// (slam_constructor_tpu_torch/ops/kernels.py, built by ops/_build.py).
//
// Replaces the TPU kernel slam_constructor_tpu/ops/pallas_kernels.py:
// sample_plane_bilinear (body _bilinear_kernel), fused with what
// ops/scoring.py:score_poses computes around it at overlap extent 1: the
// pose transform of the sensor-frame endpoints and _weighted_mean; and, with
// another reducer (obstacle, max, mean, the overlap at any extent), the
// gather path of score_poses that the reference runs off the TPU for them.
//
//   score[m, k] = sum_r beam_w[m, r] * sample(v[m], (apply_pose(poses[m, k],
//                 pts[m, r]) - origin[m]) / scale)
//                 / max(sum_r beam_w[m, r], 1e-9)
//
// Every map has its own plane, candidates, scan (endpoints and weights) and
// origin: loop closing matches a different keyframe scan against every
// submap. M = 1 is the single-plane score and gives the same bits as any
// other slot of a batch holding the same inputs.
//
// sample() is _bilinear_kernel's math (overlap_sample.cuh, shared with
// mc_match.cu): mass off the map reads `unknown`.
//
// What bounds it on an H100: launch cost and latency, not bytes. At the
// main-path shape (K = 64 candidates, R = 360 beams) one call reads
// 23,040 points x 4 taps x 4 B, about 370 KB of plane taps: about 0.1 us
// at 3.35 TB/s. The 256 KB f32 plane stays in the 50 MB L2 between calls.
// The Monte-Carlo matcher does not call this kernel once a round: its
// whole loop is one launch of mc_match.cu. This one serves score_poses.
//
// Loop closing calls it with M <= 32 submaps of 120^2 cells and the K = 343
// poses of a 7^3 grid: 10,976 blocks in one launch, planes of 57.6 KB each
// that stay in L2.
//
// Design: one block per (candidate, map), the map on the grid's y axis; its
// 128 threads stride over the beams;
// cos/sin of the pose once per block; the plane read through __ldg (it is
// larger than a block's 227 KB of shared memory, so it is not staged
// there); beams of weight 0 (invalid) skipped; per-thread sums in a fixed
// order, then a fixed-order tree reduction, so a result is the same bit
// for bit from run to run. Numerics: see overlap_sample.cuh.

#include <cuda_runtime.h>

#include "overlap_sample.cuh"

namespace {

constexpr int kThreads = overlap::kGroupThreads;

__global__ void __launch_bounds__(kThreads)
overlap_score_kernel(const float* __restrict__ v, int h, int w,
                     const float* __restrict__ poses,
                     const float* __restrict__ pts,
                     const float* __restrict__ beam_w, int r,
                     const float* __restrict__ origin, float scale,
                     float unknown, const overlap::Reducer red, float* __restrict__ out) {
  __shared__ float trig[2];
  __shared__ float s_num[kThreads];
  __shared__ float s_den[kThreads];

  const int k = blockIdx.x;
  const int n_k = gridDim.x;
  const size_t m = blockIdx.y;
  v += m * h * w;
  poses += m * n_k * 3;
  pts += m * r * 2;
  beam_w += m * r;
  origin += m * 2;
  out += m * n_k;
  if (threadIdx.x == 0) {
    const float th = poses[3 * k + 2];
    trig[0] = cosf(th);
    trig[1] = sinf(th);
  }
  __syncthreads();
  const overlap::Pose p{poses[3 * k + 0], poses[3 * k + 1], trig[0], trig[1]};

  float num, den;
  overlap::beam_sums(v, h, w, p, pts, beam_w, r, threadIdx.x, __ldg(origin + 0),
                     __ldg(origin + 1), scale, unknown, red, num, den);
  overlap::group_reduce(num, den, s_num, s_den, threadIdx.x, 0);
  if (threadIdx.x == 0) out[k] = overlap::weighted_mean(num, den);
}

}  // namespace

// v f32[m, h, w], poses f32[m, k, 3], pts f32[m, r, 2], beam_w f32[m, r],
// origin f32[m, 2] -> out f32[m, k], all contiguous; a beam's endpoint read
// by the reducer (reducer, radius, extent): overlap_sample.cuh. Launches on
// `stream` (PyTorch's current stream), does not synchronise and allocates
// nothing. Returns the cudaError_t of the launch (0 = ok).
extern "C" int overlap_score_launch(const float* v, int m, int h, int w,
                                    const float* poses, int k,
                                    const float* pts, const float* beam_w,
                                    int r, const float* origin, float scale,
                                    float unknown, int reducer, int radius, float extent,
                                    float* out, void* stream) {
  overlap::Reducer red;
  if (!overlap::make_reducer(reducer, radius, extent, &red)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k <= 0 || m <= 0) return 0;
  if (m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(k, m);
  overlap_score_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      v, h, w, poses, pts, beam_w, r, origin, scale, unknown, red, out);
  return static_cast<int>(cudaGetLastError());
}
