// gradient_refine.cu: the gradient matcher's whole refine in one launch, one
// block, for Hopper (sm_90a). Plain C interface, bound from Python with
// ctypes (slam_constructor_tpu_torch/ops/kernels.py::gradient_refine, built
// by ops/_build.py).
//
// Replaces the loop of slam_constructor_tpu/ops/matchers.py:gradient_match (a
// lax.scan whose iterations take jax.grad of scoring.score_single, the score
// whose TPU kernel is pallas_kernels.py:sample_plane_bilinear) with what
// kernels.gradient_refine_loop computes over overlap_score_grad.cu, bit for
// bit:
//
//   prob, g = score and gradient at the start pose
//   each iteration: gn = g / (sqrt((gx^2 + gy^2) + gth^2) + 1e-12);
//     cand = pose + steps * gn, the heading wrapped with atan2f(sinf, cosf);
//     p, g' = score and gradient at cand; if p > prob (strictly): pose,
//     prob, g = cand, p, g' else steps *= shrink; trace[it] = prob
//
// The score and gradient are overlap_score_grad.cu's: overlap_sample.cuh's
// sample_grad_at() summed over the beams in its assignment (thread t of a
// group of 128 takes beams t, t + 128, ... in that order, skipping weight 0)
// and the five sums meeting in the group tree of overlap::group_reduce, one
// tree a sum in the same order, so the score has overlap_score.cu's bits.
//
// What bounds it on an H100: the chain of 1 + iterations passes, each a
// round of taps, a tree and two barriers, and thread 0's step between them
// (a square root, three divisions, sinf, cosf, atan2f, then sinf and cosf of
// the candidate). At tiny_refined's shape (360 beams, 256^2, 12 iterations)
// the taps touch a few hundred cells and the work is about 0.5 MFLOP: the
// bound is well under a microsecond. Run as 13 launches with ~10 PyTorch
// ops between them, the host's dispatch set the pace of the refine.
//
// Design: one block a refine; the scan's points and weights staged in shared
// memory once; the plane read through __ldg (a refine moves less than a few
// cells, so after the first pass the taps hit L1); the state (pose, prob, g,
// steps, the candidate) in shared memory, updated by thread 0 and handed on
// by a block barrier. The block is 3 x 128 threads: each thread computes
// one beam's terms a pass into shared memory and the first 128 threads fold
// them in the group's order (the same bits), so a pass takes one beam's
// latency, not three (a block of 128 threads, each computing its beams in
// turn, measured 34.2 against 27.8 us on an H100 at tiny_refined's shape).
// Nothing is
// read on the host, nothing allocated, no atomics. Numerics: see
// overlap_sample.cuh (no fast math, --fmad=false).

#include <cuda_runtime.h>

#include "overlap_sample.cuh"

namespace {

constexpr int kGroup = overlap::kGroupThreads;
constexpr int kGroups = 3;  // the block's groups of 128 threads
constexpr int kThreads = kGroups * kGroup;
constexpr int kSums = 5;  // the score's numerator and weight, the gradient's three

// The group tree of overlap::group_reduce over the five sums at once (each
// sum the same pairs in the same order); valid in thread t == 0.
__device__ __forceinline__ void reduce_sums(float (&v)[kSums], float (*tree)[kGroup], int t) {
#pragma unroll
  for (int k = 0; k < kSums; ++k) tree[k][t] = v[k];
  overlap::group_sync(1);
  if (t < 64) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      v[k] = tree[k][t] + tree[k][t + 64];
      tree[k][t] = v[k];
    }
  }
  overlap::group_sync(1);
  if (t < 32) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) v[k] = tree[k][t] + tree[k][t + 32];
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
#pragma unroll
      for (int k = 0; k < kSums; ++k) v[k] += __shfl_down_sync(0xffffffffu, v[k], stride);
    }
  }
  overlap::group_sync(1);
}

// Beam i's terms: bw * p, and bw times each derivative.
__device__ __forceinline__ void beam_terms(const overlap::LdgPlane& at, int h, int w,
                                           const overlap::Pose& p, const float* pts, float bw,
                                           int i, float ox, float oy, float scale,
                                           float unknown, float (&term)[kSums]) {
  float dx, dy, dth;
  const float pr = overlap::sample_grad_at(at, h, w, p, pts[2 * i + 0], pts[2 * i + 1], ox, oy,
                                           scale, unknown, dx, dy, dth);
  term[0] = bw * pr;
  term[1] = bw;
  term[2] = bw * dx;
  term[3] = bw * dy;
  term[4] = bw * dth;
}

__global__ void __launch_bounds__(kThreads)
gradient_refine_kernel(const float* __restrict__ v, int h, int w, const float* __restrict__ pts,
                       const float* __restrict__ beam_w, int r, const float* __restrict__ origin,
                       const float* __restrict__ init_pose, float scale, float unknown,
                       float step_xy, float step_theta, float shrink, int iterations,
                       float* __restrict__ pose_out, float* __restrict__ prob_out,
                       float* __restrict__ trace_out) {
  extern __shared__ float smem[];
  __shared__ float s_tree[kSums][kGroup];
  __shared__ float s_terms[kSums][kThreads];
  __shared__ float st_pose[3], st_cand[3], st_g[3], st_steps[3], st_prob, st_trig[2];
  float* s_pts = smem;         // f32[r][2]
  float* s_bw = smem + 2 * r;  // f32[r]

  const int t = threadIdx.x;
  for (int i = t; i < 2 * r; i += kThreads) s_pts[i] = __ldg(pts + i);
  for (int i = t; i < r; i += kThreads) s_bw[i] = __ldg(beam_w + i);
  if (t == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) st_pose[d] = st_cand[d] = init_pose[d];
    st_steps[0] = step_xy;
    st_steps[1] = step_xy;
    st_steps[2] = step_theta;
    st_trig[0] = cosf(st_cand[2]);
    st_trig[1] = sinf(st_cand[2]);
  }
  __syncthreads();
  const overlap::LdgPlane at{v, w};
  const float ox = __ldg(origin + 0), oy = __ldg(origin + 1);

  // pass -1 scores the start pose; pass it >= 0 the iteration's candidate
  for (int it = -1; it < iterations; ++it) {
    const overlap::Pose p{st_cand[0], st_cand[1], st_trig[0], st_trig[1]};
    float sums[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int base = 0; base < r; base += kThreads) {
      const int i = base + t;
      if (i < r && s_bw[i] != 0.0f) {  // weight 0 (invalid) skipped, as overlap_score does
        float term[kSums];
        beam_terms(at, h, w, p, s_pts, s_bw[i], i, ox, oy, scale, unknown, term);
#pragma unroll
        for (int k = 0; k < kSums; ++k) s_terms[k][t] = term[k];
      }
      __syncthreads();
      if (t < kGroup) {  // beams t, t + 128, ... of this pass, in that order
#pragma unroll
        for (int j = 0; j < kGroups; ++j) {
          const int u = t + j * kGroup;
          if (base + u < r && s_bw[base + u] != 0.0f) {
#pragma unroll
            for (int k = 0; k < kSums; ++k) sums[k] += s_terms[k][u];
          }
        }
      }
      __syncthreads();
    }
    if (t < kGroup) reduce_sums(sums, s_tree, t);
    if (t == 0) {
      const float d = fmaxf(sums[1], 1e-9f);
      const float prob = overlap::weighted_mean(sums[0], sums[1]);
      const float g[3] = {sums[2] / d, sums[3] / d, sums[4] / d};
      if (it < 0 || prob > st_prob) {  // strict, and never true for a NaN score
        if (it >= 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) st_pose[k] = st_cand[k];
        }
        st_prob = prob;
#pragma unroll
        for (int k = 0; k < 3; ++k) st_g[k] = g[k];
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) st_steps[k] *= shrink;
      }
      if (it >= 0) trace_out[it] = st_prob;
      if (it + 1 < iterations) {  // the next candidate
        const float norm = sqrtf((st_g[0] * st_g[0] + st_g[1] * st_g[1]) + st_g[2] * st_g[2]);
        const float den = norm + static_cast<float>(1e-12);
#pragma unroll
        for (int k = 0; k < 3; ++k) st_cand[k] = st_pose[k] + st_steps[k] * (st_g[k] / den);
        st_cand[2] = atan2f(sinf(st_cand[2]), cosf(st_cand[2]));
        st_trig[0] = cosf(st_cand[2]);
        st_trig[1] = sinf(st_cand[2]);
      }
    }
    __syncthreads();
  }
  if (t == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) pose_out[k] = st_pose[k];
    *prob_out = st_prob;
  }
}

}  // namespace

// v f32[h, w], pts f32[r, 2], beam_w f32[r], origin f32[2], init_pose f32[3]
// -> pose_out f32[3], prob_out f32[], trace_out f32[iterations], all
// contiguous. Launches on `stream` (PyTorch's current stream), does not
// synchronise and allocates nothing. Returns the cudaError_t of the launch
// (0 = ok).
extern "C" int gradient_refine_launch(const float* v, int h, int w, const float* pts,
                                      const float* beam_w, int r, const float* origin,
                                      const float* init_pose, float scale, float unknown,
                                      float step_xy, float step_theta, float shrink,
                                      int iterations, float* pose_out, float* prob_out,
                                      float* trace_out, void* stream) {
  const size_t shared = 12 * static_cast<size_t>(r);  // the points and weights
  if (shared > 32 * 1024) {  // with the static arrays, above the default cap: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        gradient_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gradient_refine_kernel<<<1, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      v, h, w, pts, beam_w, r, origin, init_pose, scale, unknown, step_xy, step_theta, shrink,
      iterations, pose_out, prob_out, trace_out);
  return static_cast<int>(cudaGetLastError());
}
