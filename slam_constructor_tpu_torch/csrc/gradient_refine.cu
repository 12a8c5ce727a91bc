// gradient_refine.cu: the gradient matcher's whole refine of M poses, each
// on its own map, in one launch, a block a map, for Hopper (sm_90a). Plain C
// interface, bound from Python with ctypes
// (slam_constructor_tpu_torch/ops/kernels.py::gradient_refine, built by
// ops/_build.py).
//
// Replaces the loop of slam_constructor_tpu/ops/matchers.py:gradient_match (a
// lax.scan whose iterations take jax.grad of scoring.score_single, the score
// whose TPU kernel is pallas_kernels.py:sample_plane_bilinear at extent 1,
// the gather path of scoring.py:score_poses for the other reducers; the
// reference vmaps it over particles and submaps) with what
// kernels.gradient_refine_loop computes over overlap_score_grad.cu, bit for
// bit, for every map:
//
//   prob, g = score and gradient at the start pose
//   each iteration: gn = g / (sqrt((gx^2 + gy^2) + gth^2) + 1e-12);
//     cand = pose + steps * gn, the heading wrapped with atan2f(sinf, cosf);
//     p, g' = score and gradient at cand; if p > prob (strictly): pose,
//     prob, g = cand, p, g' else steps *= shrink; trace[it] = prob
//
// The score and gradient are overlap_score_grad.cu's: overlap_sample.cuh's
// grad_at() by the launch's reducer summed over the beams in its assignment
// (lane t of a group of 128 takes beams t, t + 128, ... in that order,
// skipping weight 0) and the five sums meeting in the tree of
// overlap::group_reduce (s[t] + s[t + 64], then + s[t + 32], then shuffles
// from 16 down to 1), so the score has overlap_score.cu's bits.
//
// What bounds it on an H100: the chain of 1 + iterations passes, each the
// taps, the sums' fold and tree, and the step (seven divisions, a square
// root, sinf, cosf, atan2f, then sinf and cosf of the candidate), each a
// chain of dependent instructions on one SM. The work is small: at the
// RBPF's shape (30 maps, 180 beams, 25 cells a beam, 9 passes) its bound
// is under a microsecond (PERF.md); the passes' latency sets the pace.
//
// Design: one block a map (a refine) of 13 warps: warp 0 keeps the state and
// steps, warps 1-12 (3 groups of 128 threads) compute a beam a thread:
//  - a beam's cells are read before its arithmetic (overlap_grad_fixed for
//    the general overlap at radius 1 or 2: its (2 radius + 1)^2 reads from
//    one row pointer a row; sample_grad_at's four taps for the bilinear
//    reducer; grad_at's loop for any other), so they are in flight
//    together; the plane is read through __ldg (a refine moves a few cells:
//    after the first pass the taps hit L1);
//  - each beam thread writes its beam's five terms to shared memory (zeros
//    for a beam of weight 0 or past the scan: adding +0.0 to a sum that
//    starts at +0.0 leaves it as skipping the beam does); after one block
//    barrier warp 0 alone folds them (overlap::fold_terms, fold_tree, which
//    overlap_score.cu shares): lane l sums group lanes l, l + 32, l + 64
//    and l + 96 over their beams in order, forms
//    (s[l] + s[l + 64]) + (s[l + 32] + s[l + 96]) and adds across lanes by
//    xor shuffles from 16 down to 1, which give lane 0 the pairs of the
//    tree's shfl_down and every lane the same bits;
//  - warp 0 keeps the state (pose, prob, g, g / (|g| + 1e-12), steps) in
//    every lane and steps with the loop's expressions, its divisions spread
//    over lanes (lanes 0-2 a component of the gradient, lane 3 the score;
//    then lanes 0-2 a component of g / (|g| + 1e-12)) and read back by
//    shuffles; sincosf for each sinf, cosf pair (their bits: every one of
//    the 2^32 inputs, scripts/torch_port/kernel_probe.py --sincos). While
//    the beam warps tap, warp 0 computes the candidate that follows a
//    rejection (the same pose and direction, the steps shrunk), so a
//    rejected candidate costs no step; lane 0 hands the next candidate to
//    the block through shared memory and one block barrier.
// Two block barriers a pass (with more beams than beam threads, one more
// a 384 beams), nothing read on the host, nothing allocated, no atomics.
// Measured and dropped (PERF.md): staging the cells a refine can reach in
// shared memory (cp.async during the first pass: no faster taps, 2-8 us
// more set-up), warp 0 computing a beam too. Numerics: see
// overlap_sample.cuh (no fast math, --fmad=false).

#include <cuda_runtime.h>

#include "overlap_sample.cuh"

namespace {

constexpr int kGroup = overlap::kGroupThreads;
constexpr int kGroups = 3;  // the beam threads' groups of 128
constexpr int kBeamThreads = kGroups * kGroup;
constexpr int kThreads = 32 + kBeamThreads;  // warp 0 keeps the state
constexpr int kSums = 5;  // the score's numerator and weight, the gradient's three
constexpr unsigned kFull = 0xffffffffu;

// The beam code a kernel is compiled for: any reducer through grad_at(), the
// bilinear taps, or the general overlap at radius 1 or 2 unrolled.
enum BeamCode : int { kAny = 0, kBilinearTaps = 1, kOverlapR1 = 2, kOverlapR2 = 3 };

// overlap::reduce_grad_at() for the general overlap at a radius N >= 1 known
// when compiled: the same operations in the same order, so the same bits,
// with the (2N + 1)^2 cells read before the arithmetic and each column's
// length and derivative, and each row's and column's bounds, computed once
// (the loop computes the same values again for every cell).
template <int N>
__device__ __forceinline__ float overlap_grad_fixed(float extent, const overlap::LdgPlane& at,
                                                    int h, int w, const overlap::Pose& p,
                                                    float qx, float qy, float ox, float oy,
                                                    float scale, float unknown, float& gx,
                                                    float& gy, float& gth) {
  using overlap::max_nan;
  using overlap::min_nan;
  using overlap::overlap_len_grad;
  constexpr int S = 2 * N + 1;
  const float wx = (p.x + p.c * qx) - p.s * qy;
  const float wy = (p.y + p.s * qx) + p.c * qy;
  const float x = (wx - ox) / scale;
  const float y = (wy - oy) / scale;
  const float fx = floorf(x);
  const float fy = floorf(y);
  const float half = 0.5f * extent;
  const float ex = x - fx;
  const float ey = y - fy;
  float len_x[S], dlen_x[S], len_y[S], dlen_y[S];
  bool row_ok[S], col_ok[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const float d = static_cast<float>(k - N);
    len_y[k] = max_nan(min_nan(d + 1.0f, ey + half) - max_nan(d, ey - half), 0.0f);
    dlen_y[k] = overlap_len_grad(d, ey, half, len_y[k]);
    len_x[k] = max_nan(min_nan(d + 1.0f, ex + half) - max_nan(d, ex - half), 0.0f);
    dlen_x[k] = overlap_len_grad(d, ex, half, len_x[k]);
    // cell_or_unknown's test, split by axis: compared before the cast
    const float cy = fy + d, cx = fx + d;
    row_ok[k] = cy >= 0.0f && cy < static_cast<float>(h);
    col_ok[k] = cx >= 0.0f && cx < static_cast<float>(w);
  }
  // the window's first cell (clamped where no cell of the window lies on
  // the plane: a NaN or far position)
  const int row0 = static_cast<int>(fminf(fmaxf(fy, -(N + 1.0f)), h + static_cast<float>(N))) - N;
  const int col0 = static_cast<int>(fminf(fmaxf(fx, -(N + 1.0f)), w + static_cast<float>(N))) - N;
  float v[S][S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const float* row = at.v + ((row0 + i) * w + col0);
#pragma unroll
    for (int j = 0; j < S; ++j) v[i][j] = row_ok[i] && col_ok[j] ? __ldg(row + j) : unknown;
  }
  float num = 0.0f, wsum = 0.0f;
  float dnum_x = 0.0f, dnum_y = 0.0f, dw_x = 0.0f, dw_y = 0.0f;
#pragma unroll
  for (int i = 0; i < S; ++i) {  // rows outer, columns inner
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const float wgt = len_x[j] * len_y[i];
      wsum += wgt;
      num += v[i][j] * wgt;
      const float wdx = dlen_x[j] * len_y[i];
      const float wdy = len_x[j] * dlen_y[i];
      dw_x += wdx;
      dw_y += wdy;
      dnum_x += v[i][j] * wdx;
      dnum_y += v[i][j] * wdy;
    }
  }
  const float den = max_nan(wsum, 1e-9f);
  const float val = num / den;
  float dx, dy;
  if (!(wsum >= 1e-9f)) {  // the floor holds: p = num / 1e-9
    dx = dnum_x / den;
    dy = dnum_y / den;
  } else {
    dx = (dnum_x - val * dw_x) / den;
    dy = (dnum_y - val * dw_y) / den;
  }
  gx = dx / scale;
  gy = dy / scale;
  gth = (dx * (-p.s * qx - p.c * qy) + dy * (p.c * qx - p.s * qy)) / scale;
  return val;
}

template <int kCode>
__device__ __forceinline__ float beam_grad(const overlap::Reducer& red,
                                           const overlap::LdgPlane& at, int h, int w,
                                           const overlap::Pose& p, float qx, float qy, float ox,
                                           float oy, float scale, float unknown, float& dx,
                                           float& dy, float& dth) {
  if constexpr (kCode == kBilinearTaps) {
    return overlap::sample_grad_at(at, h, w, p, qx, qy, ox, oy, scale, unknown, dx, dy, dth);
  } else if constexpr (kCode == kOverlapR1) {
    return overlap_grad_fixed<1>(red.extent, at, h, w, p, qx, qy, ox, oy, scale, unknown, dx, dy,
                                 dth);
  } else if constexpr (kCode == kOverlapR2) {
    return overlap_grad_fixed<2>(red.extent, at, h, w, p, qx, qy, ox, oy, scale, unknown, dx, dy,
                                 dth);
  } else {
    return overlap::grad_at(red, at, h, w, p, qx, qy, ox, oy, scale, unknown, dx, dy, dth);
  }
}

// Stamps for scripts/torch_port/kernel_probe.py --stamps (a -DSLAM_KERNEL_PROBE
// build): thread 0 of a block times each pass's kParts parts and writes,
// besides the start, set-up and end stamps, the first pass's parts (slots 3
// on, cycles), the parts summed over every pass (the next kParts slots), the
// passes (the slot after them) and kParts (slot 61); thread 32, the first
// beam thread, times its own beam the same way from slot 40 (write_at).
template <int kParts>
struct PassClock {
#ifdef SLAM_KERNEL_PROBE
  unsigned long long t = 0, first[kParts] = {}, total[kParts] = {};
  int passes = 0;
  __device__ void start() { t = clock64(); }
  __device__ void part(int k) {
    const unsigned long long now = clock64();
    total[k] += now - t;
    if (passes == 0) first[k] = now - t;
    t = now;
  }
  __device__ void end_pass() { ++passes; }
  __device__ void write_at(int block, int slot) const {
    for (int k = 0; k < kParts; ++k) {
      probe::stamp(block, slot + k, first[k]);
      probe::stamp(block, slot + kParts + k, total[k]);
    }
    probe::stamp(block, slot + 2 * kParts, passes);
  }
  __device__ void write(int block) const {
    write_at(block, 3);
    probe::stamp(block, 61, kParts);
  }
#else
  __device__ void start() {}
  __device__ void part(int) {}
  __device__ void end_pass() {}
  __device__ void write_at(int, int) const {}
  __device__ void write(int) const {}
#endif
};

// a pass's parts in thread 0's stamps: the candidate after a rejection,
// the barrier on the beams' terms (the clock may be read before the warp
// leaves it: the wait then falls in the fold), the fold, the tree across
// lanes, the step, the barrier that hands the candidate on
enum Part : int { kSpeculate, kTermsBarrier, kFold, kTree, kStep, kHandOff, kPartCount };

// The candidate pose + steps * gn with its heading wrapped, and the cos and
// sin of that heading: the loop's expressions (sincosf gives sinf's and
// cosf's bits).
__device__ __forceinline__ void next_candidate(const float (&pose)[3], const float (&steps)[3],
                                               const float (&gn)[3], float (&cand)[3],
                                               float (&trig)[2]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) cand[k] = pose[k] + steps[k] * gn[k];
  float sn, cs;
  sincosf(cand[2], &sn, &cs);
  cand[2] = atan2f(sn, cs);
  sincosf(cand[2], &sn, &cs);
  trig[0] = cs;
  trig[1] = sn;
}

// The value of lane k of warp 0 in every lane.
__device__ __forceinline__ float from_lane(float x, int k) { return __shfl_sync(kFull, x, k); }

template <int kCode>
__global__ void __launch_bounds__(kThreads)
gradient_refine_kernel(const float* __restrict__ v, int h, int w, const float* __restrict__ pts,
                       const float* __restrict__ beam_w, int r, const float* __restrict__ origin,
                       const float* __restrict__ init_pose, float scale, float unknown,
                       float step_xy, float step_theta, float shrink, int iterations,
                       overlap::Reducer red, float* __restrict__ pose_out,
                       float* __restrict__ prob_out, float* __restrict__ trace_out) {
  extern __shared__ float smem[];
  __shared__ float s_terms[kSums][kBeamThreads];
  __shared__ float s_cand[4];  // the candidate's x, y, and the cos and sin of its heading
  float* s_pts = smem;         // f32[r][2]
  float* s_bw = smem + 2 * r;  // f32[r]

  const int t = threadIdx.x;
  const int lane = t & 31;
  const bool state = t < 32;  // warp 0
  const int bt = t - 32;      // the beam thread, negative in warp 0
  const int m = blockIdx.x;   // the map: every pointer moves to its slice
  PassClock<kPartCount> clk;
  PassClock<1> beam_clk;
  if (t == 0) {
    PROBE_STAMP(m, probe::kStart);
    PROBE_STAMP_NS(m, probe::kStartNs);
  }
  v += static_cast<long long>(m) * h * w;
  pts += static_cast<long long>(m) * r * 2;
  beam_w += static_cast<long long>(m) * r;
  origin += 2 * m;
  init_pose += 3 * m;
  pose_out += 3 * m;
  prob_out += m;
  trace_out += static_cast<long long>(m) * iterations;
  const overlap::LdgPlane at{v, w};
  const float ox = __ldg(origin + 0), oy = __ldg(origin + 1);
  for (int i = t; i < 2 * r; i += kThreads) s_pts[i] = __ldg(pts + i);
  for (int i = t; i < r; i += kThreads) s_bw[i] = __ldg(beam_w + i);
  // warp 0's state, the same in every lane: the pose, its score and
  // gradient, g / (|g| + 1e-12), the steps, the candidate being scored
  float pose[3], prob = 0.0f, g[3], gn[3], steps[3] = {step_xy, step_xy, step_theta};
  float cand[3], trig[2];
  if (state) {
#pragma unroll
    for (int d = 0; d < 3; ++d) pose[d] = cand[d] = __ldg(init_pose + d);
    if (lane == 0) {
      s_cand[0] = cand[0];
      s_cand[1] = cand[1];
      s_cand[2] = cosf(cand[2]);
      s_cand[3] = sinf(cand[2]);
    }
  }
  __syncthreads();
  if (t == 0) PROBE_STAMP(m, probe::kSetup);

  // pass -1 scores the start pose; pass it >= 0 the iteration's candidate
  for (int it = -1; it < iterations; ++it) {
    if (t == 0) clk.start();
    if (t == 32) beam_clk.start();
    const bool more = it + 1 < iterations;
    const overlap::Pose p{s_cand[0], s_cand[1], s_cand[2], s_cand[3]};
    float acc[4][kSums];  // warp 0: group lanes lane, lane + 32, lane + 64, lane + 96
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int k = 0; k < kSums; ++k) acc[q][k] = 0.0f;
    }
    float spec[3], spec_trig[2];  // warp 0: the candidate after a rejection
    if (state && it >= 0 && more) {
      float shrunk[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) shrunk[k] = steps[k] * shrink;
      next_candidate(pose, shrunk, gn, spec, spec_trig);
    }
    for (int base = 0; base < r; base += kBeamThreads) {
      const int i = base + bt;
      const bool last = base + kBeamThreads >= r;
      if (!state) {
        float term[kSums] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (i < r && s_bw[i] != 0.0f) {  // weight 0 (invalid) adds +0.0: skipped
          const float bw = s_bw[i];
          float dx, dy, dth;
          const float pr = beam_grad<kCode>(red, at, h, w, p, s_pts[2 * i + 0], s_pts[2 * i + 1],
                                            ox, oy, scale, unknown, dx, dy, dth);
          term[0] = bw * pr;
          term[1] = bw;
          term[2] = bw * dx;
          term[3] = bw * dy;
          term[4] = bw * dth;
        }
#pragma unroll
        for (int k = 0; k < kSums; ++k) s_terms[k][bt] = term[k];
      }
      if (t == 32 && last) beam_clk.part(0);
      if (t == 0 && last) clk.part(kSpeculate);
      __syncthreads();
      if (t == 0 && last) clk.part(kTermsBarrier);
      if (state) {  // each group lane's beams of this chunk, in order
        overlap::fold_terms<kSums>(acc, &s_terms[0][0], kBeamThreads, kBeamThreads, lane);
      }
      if (!last) __syncthreads();  // the next chunk's terms overwrite these
    }
    if (state) {
      if (t == 0) clk.part(kFold);
      float s[kSums];
      overlap::fold_tree<kSums>(acc, s);
      if (t == 0) clk.part(kTree);
      // one division a lane: lanes 0-2 a component of the gradient (s / d),
      // the others the score, overlap::weighted_mean(s[0], s[1])
      const float d = fmaxf(s[1], 1e-9f);
      const float quo = (lane == 0 ? s[2] : lane == 1 ? s[3] : lane == 2 ? s[4] : s[0]) / d;
      const float pr = from_lane(quo, 3);
      if (it < 0 || pr > prob) {  // strict, and never true for a NaN score
        if (it >= 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) pose[k] = cand[k];
        }
        prob = pr;
#pragma unroll
        for (int k = 0; k < 3; ++k) g[k] = from_lane(quo, k);
        if (more) {
          const float norm = sqrtf((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]);
          const float den = norm + static_cast<float>(1e-12);
          const float gq = (lane == 0 ? g[0] : lane == 1 ? g[1] : g[2]) / den;
#pragma unroll
          for (int k = 0; k < 3; ++k) gn[k] = from_lane(gq, k);
          next_candidate(pose, steps, gn, cand, trig);
        }
      } else {  // g, and so gn, stay: the candidate is the one computed ahead
#pragma unroll
        for (int k = 0; k < 3; ++k) steps[k] *= shrink;
        if (more) {
#pragma unroll
          for (int k = 0; k < 3; ++k) cand[k] = spec[k];
          trig[0] = spec_trig[0];
          trig[1] = spec_trig[1];
        }
      }
      if (lane == 0) {
        if (it >= 0) trace_out[it] = prob;
        if (more) {
          s_cand[0] = cand[0];
          s_cand[1] = cand[1];
          s_cand[2] = trig[0];
          s_cand[3] = trig[1];
        }
      }
      if (t == 0) clk.part(kStep);
    }
    __syncthreads();
    if (t == 0) {
      clk.part(kHandOff);
      clk.end_pass();
    }
    if (t == 32) beam_clk.end_pass();
  }
  if (t == 32) beam_clk.write_at(m, 40);
  if (t == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) pose_out[k] = pose[k];
    *prob_out = prob;
    clk.write(m);
    PROBE_STAMP(m, probe::kEnd);
    PROBE_STAMP_NS(m, probe::kEndNs);
  }
}

template <int kCode>
int launch(const float* v, int m, int h, int w, const float* pts, const float* beam_w, int r,
           const float* origin, const float* init_pose, float scale, float unknown,
           float step_xy, float step_theta, float shrink, int iterations,
           const overlap::Reducer& red, float* pose_out, float* prob_out, float* trace_out,
           cudaStream_t stream) {
  const size_t shared = 12 * static_cast<size_t>(r);  // the points and weights
  if (shared > 32 * 1024) {  // with the static arrays, above the default cap: opt in
    const cudaError_t err = cudaFuncSetAttribute(gradient_refine_kernel<kCode>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gradient_refine_kernel<kCode><<<m, kThreads, shared, stream>>>(
      v, h, w, pts, beam_w, r, origin, init_pose, scale, unknown, step_xy, step_theta, shrink,
      iterations, red, pose_out, prob_out, trace_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

PROBE_EXPORT(gradient_refine_probe_stamps)

// v f32[m, h, w], pts f32[m, r, 2], beam_w f32[m, r], origin f32[m, 2],
// init_pose f32[m, 3] -> pose_out f32[m, 3], prob_out f32[m], trace_out
// f32[m, iterations], all contiguous; a beam reads the plane by the reducer
// (reducer, radius, extent: see overlap_sample.cuh). Launches on `stream`
// (PyTorch's current stream), does not synchronise and allocates nothing.
// Returns the cudaError_t of the launch (0 = ok; cudaErrorInvalidValue for
// a bad reducer).
extern "C" int gradient_refine_launch(const float* v, int m, int h, int w, const float* pts,
                                      const float* beam_w, int r, const float* origin,
                                      const float* init_pose, float scale, float unknown,
                                      float step_xy, float step_theta, float shrink,
                                      int iterations, int reducer, int radius, float extent,
                                      float* pose_out, float* prob_out, float* trace_out,
                                      void* stream) {
  overlap::Reducer red;
  if (!overlap::make_reducer(reducer, radius, extent, &red) || m < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (red.kind == overlap::kBilinear) {
    return launch<kBilinearTaps>(v, m, h, w, pts, beam_w, r, origin, init_pose, scale, unknown,
                                 step_xy, step_theta, shrink, iterations, red, pose_out,
                                 prob_out, trace_out, s);
  }
  if (red.kind == overlap::kOverlap && red.radius == 1) {
    return launch<kOverlapR1>(v, m, h, w, pts, beam_w, r, origin, init_pose, scale, unknown,
                              step_xy, step_theta, shrink, iterations, red, pose_out, prob_out,
                              trace_out, s);
  }
  if (red.kind == overlap::kOverlap && red.radius == 2) {
    return launch<kOverlapR2>(v, m, h, w, pts, beam_w, r, origin, init_pose, scale, unknown,
                              step_xy, step_theta, shrink, iterations, red, pose_out, prob_out,
                              trace_out, s);
  }
  return launch<kAny>(v, m, h, w, pts, beam_w, r, origin, init_pose, scale, unknown, step_xy,
                      step_theta, shrink, iterations, red, pose_out, prob_out, trace_out, s);
}
