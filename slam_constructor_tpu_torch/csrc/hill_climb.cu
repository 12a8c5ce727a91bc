// hill_climb.cu: the hill-climbing matcher's whole refine in one launch, one
// block a map, for Hopper (sm_90a). Plain C interface, bound from Python with
// ctypes (slam_constructor_tpu_torch/ops/kernels.py::hill_climb, built by
// ops/_build.py).
//
// Replaces the loop of slam_constructor_tpu/ops/matchers.py:
// hill_climbing_match (a lax.scan of rounds, each scoring six poses through
// scoring.score_poses, whose TPU kernel is pallas_kernels.py:
// sample_plane_bilinear, or the gather path for the other reducers) with
// what kernels.hill_climb_loop computes over overlap_score.cu, bit for bit,
// for every reducer: the first score, then `iterations` rounds of
// six axis steps, the best kept if strictly better, else the steps shrunk
// (climb.cuh). M maps, each with its own plane, scan, origin and start pose,
// are M blocks of one launch; a map of the batch gets the bits of a single
// climb on it, as overlap_score_batched's slots get overlap_score's.
//
// What bounds it on an H100: the chain of 1 + iterations passes, each a
// round of taps, a group tree and two block barriers. At mit_csail's shape
// (360 beams, 1024^2 at 0.05 m, 10 rounds) the taps touch about a thousand
// cells and the work is under 0.5 MFLOP: the bound is well under a
// microsecond. Run as 11 launches with ~12 PyTorch ops between them, the
// host's dispatch set the pace of the refine.
//
// Design: a block of 6 x 128 threads a map (climb.cuh); the scan's points
// and weights staged in shared memory once; the plane read through __ldg
// (it is far larger than shared memory; a climb moves less than a few cells,
// so after the first pass the taps hit L1); the state in shared memory,
// updated by thread 0. Nothing is read on the host, nothing allocated, no
// atomics. Numerics: see overlap_sample.cuh (no fast math, --fmad=false).

#include <cuda_runtime.h>

#include "climb.cuh"
#include "overlap_sample.cuh"

namespace {

__global__ void __launch_bounds__(climb::kThreads)
hill_climb_kernel(const float* __restrict__ v, int h, int w, const float* __restrict__ pts,
                  const float* __restrict__ beam_w, int r, const float* __restrict__ origin,
                  const float* __restrict__ pose, float scale, float unknown, float step_xy,
                  float step_theta, float shrink, int iterations, const overlap::Reducer red,
                  float* __restrict__ pose_out,
                  float* __restrict__ prob_out, float* __restrict__ trace_out) {
  extern __shared__ float smem[];
  __shared__ climb::State st;
  float* s_pts = smem;        // f32[r][2]
  float* s_bw = smem + 2 * r;  // f32[r]

  const long long m = blockIdx.x;
  v += m * h * w;
  pts += m * r * 2;
  beam_w += m * r;
  origin += m * 2;
  for (int i = threadIdx.x; i < 2 * r; i += blockDim.x) s_pts[i] = __ldg(pts + i);
  for (int i = threadIdx.x; i < r; i += blockDim.x) s_bw[i] = __ldg(beam_w + i);
  if (threadIdx.x == 0) {
    st.pose[0] = pose[3 * m + 0];
    st.pose[1] = pose[3 * m + 1];
    st.pose[2] = pose[3 * m + 2];
    st.steps[0] = step_xy;
    st.steps[1] = step_xy;
    st.steps[2] = step_theta;
  }
  __syncthreads();
  climb::run(st, overlap::LdgPlane{v, w}, h, w, s_pts, s_bw, r, __ldg(origin + 0),
             __ldg(origin + 1), scale, unknown, red, iterations, shrink,
             trace_out + m * iterations,
             [](int) {});
  if (threadIdx.x == 0) {
    pose_out[3 * m + 0] = st.pose[0];
    pose_out[3 * m + 1] = st.pose[1];
    pose_out[3 * m + 2] = st.pose[2];
    prob_out[m] = st.prob;
  }
}

}  // namespace

// v f32[m, h, w], pts f32[m, r, 2], beam_w f32[m, r], origin f32[m, 2], pose
// f32[m, 3] -> pose_out f32[m, 3], prob_out f32[m], trace_out f32[m,
// iterations], all contiguous; a beam's endpoint read by the reducer
// (reducer, radius, extent): overlap_sample.cuh. Launches on `stream`
// (PyTorch's current stream), does not synchronise and allocates nothing.
// Returns the cudaError_t of the launch (0 = ok).
extern "C" int hill_climb_launch(const float* v, int m, int h, int w, const float* pts,
                                 const float* beam_w, int r, const float* origin,
                                 const float* pose, float scale, float unknown, float step_xy,
                                 float step_theta, float shrink, int iterations, int reducer,
                                 int radius, float extent, float* pose_out, float* prob_out,
                                 float* trace_out, void* stream) {
  overlap::Reducer red;
  if (!overlap::make_reducer(reducer, radius, extent, &red)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m <= 0) return 0;
  const size_t shared = 12 * static_cast<size_t>(r);  // the points and weights
  if (shared + sizeof(climb::State) > 48 * 1024) {  // above the default cap: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        hill_climb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hill_climb_kernel<<<m, climb::kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      v, h, w, pts, beam_w, r, origin, pose, scale, unknown, step_xy, step_theta, shrink,
      iterations, red, pose_out, prob_out, trace_out);
  return static_cast<int>(cudaGetLastError());
}
