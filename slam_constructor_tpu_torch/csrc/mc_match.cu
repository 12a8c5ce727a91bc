// mc_match.cu: one whole Monte-Carlo scan match in one launch, on a Hopper
// (sm_90a) thread-block cluster. Plain C interface, bound from Python with
// ctypes (slam_constructor_tpu_torch/ops/kernels.py::mc_match, built by
// ops/_build.py).
//
// On the matcher's path it takes the place of the TPU kernel
// slam_constructor_tpu/ops/pallas_kernels.py: sample_plane_bilinear (body
// _bilinear_kernel) together with everything ops/matchers.py:
// monte_carlo_match does around ops/scoring.py:score_poses at the overlap
// reducer, extent 1:
//
//   best = init_pose; best_prob = score(init_pose); sigma = (sxy, sxy, sth)
//   for r in 0 .. rounds - 1:
//     cand[c] = (best.xy + noise[r, c, :2] * sigma.xy,
//                wrap_angle(best.theta + noise[r, c, 2] * sigma.theta))
//     i = argmax_c score(cand[c])            (ties: the first index)
//     trace[r] = score(cand[i])
//     if score(cand[i]) > best_prob: best, best_prob = cand[i], its score
//     bad = 0 if it was better else bad + 1
//     if bad >= bad_rounds_before_anneal: sigma *= 0.5; bad = 0
//
// with wrap_angle(t) = atan2f(sinf(t), cosf(t)) and score() the weighted
// mean of overlap_sample.cuh over the scan's beams. The standard normals
// `noise` are drawn outside, by PyTorch.
//
// What bounds it on an H100: neither bytes nor operations. The plane, the
// scan and the noise are ~0.27 MB (0.08 us at 3.35 TB/s) and a match of
// 1 + 12 x 64 poses x 360 beams is ~15 MFLOP (0.2 us at 67 TFLOP/s). What
// it takes is 1 + rounds dependent steps, each a few trips to L2 for the
// plane's taps and one cluster barrier. Run as 1 + rounds launches of
// overlap_score.cu with ~25 small PyTorch ops between them
// (kernels.mc_match_rounds), the host's dispatch of those, not the device,
// sets the pace of a scan.
//
// Design.
// - One cluster of 8 blocks x 1024 threads. A block holds 8 groups of 128
//   threads, a group scores one candidate, so the cluster scores 64
//   candidates at once; more candidates take further passes in the same
//   round, fewer leave groups idle. Idle groups still reach every barrier.
// - A group scores its pose exactly as a block of overlap_score.cu does
//   (the shared header: same beam order a thread, same tree), and the
//   candidate arithmetic is written op by op as the PyTorch loop does it,
//   so the fused match gives the same bits as the match with one
//   overlap_score launch a round.
// - pts and beam_w (12 B a beam) and all the noise (12 B a candidate and
//   round) are copied once into each block's shared memory, with plain
//   coalesced loads (4.3 KB and 9-12 KB on the main paths: a few loads a
//   thread, nothing to pipeline), and serve every candidate of every round:
//   no round waits for device memory except for the plane's taps.
// - The plane stays in global memory behind __ldg: 256 KB does not fit a
//   block's 227 KB of shared memory, and spread over the cluster a tap
//   would cost a distributed-shared-memory read that is no faster than the
//   L2 (or L1) hit it replaces.
// - Scores meet through distributed shared memory: each group writes its
//   score into its own block's buffer, one cluster barrier, then the first
//   warp of EVERY block reads all K scores (map_shared_rank) and computes
//   argmax, keep-if-better and the anneal redundantly, so the match state
//   lives replicated in every block and nothing is broadcast. The score
//   buffers alternate between rounds, so one barrier a round is enough: a
//   block can only write a buffer again after every block has passed the
//   next round's barrier, and so has finished reading it.
// - The first pose is scored by group 0 of every block redundantly, which
//   needs no exchange. Block 0 writes trace[r] and at the end pose and
//   prob. No atomics, no global scratch, nothing read on the host.
// - A NaN score counts as the largest in the argmax, as torch.argmax does,
//   and is never "better" (the comparison is a strict >).
//
// Numerics: built without --use_fast_math and with --fmad=false; see
// overlap_sample.cuh. noise * sigma and best + that are two roundings.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "overlap_sample.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterBlocks = 8;
constexpr int kGroups = 8;  // groups (candidates) a block
constexpr int kThreads = kGroups * overlap::kGroupThreads;
constexpr int kPerPass = kClusterBlocks * kGroups;  // candidates a pass
static_assert(kThreads == 1024, "a block is 8 groups of 128 threads");

struct MatchState {
  float pose[3];
  float prob;
  float sigma[3];
  int bad;
};

// Candidate of one row of standard normals around the best pose so far.
__device__ __forceinline__ void candidate(const MatchState& st, const float* nz,
                                          float out[3]) {
  const float nx = nz[0] * st.sigma[0];
  const float ny = nz[1] * st.sigma[1];
  const float nt = nz[2] * st.sigma[2];
  out[0] = st.pose[0] + nx;
  out[1] = st.pose[1] + ny;
  const float t = st.pose[2] + nt;
  out[2] = atan2f(sinf(t), cosf(t));
}

// Whether score a (of candidate ai) comes before score b (of bi) in the
// argmax: NaN first, then the larger, then the lower index. A total order,
// so the result does not depend on the order of the comparisons.
__device__ __forceinline__ bool comes_first(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an != bn) return an;
  if (!an && av != bv) return av > bv;
  return ai < bi;
}

__global__ void __cluster_dims__(kClusterBlocks, 1, 1) __launch_bounds__(kThreads, 1)
mc_match_kernel(const float* __restrict__ v, int h, int w,
                const float* __restrict__ pts, const float* __restrict__ beam_w, int r,
                const float* __restrict__ origin, const float* __restrict__ init_pose,
                const float* __restrict__ noise, int rounds, int k, float scale,
                float unknown, float sigma_xy, float sigma_theta, int bad_limit,
                float* __restrict__ pose_out, float* __restrict__ prob_out,
                float* __restrict__ trace_out) {
  extern __shared__ float smem[];
  __shared__ float s_num[kThreads];
  __shared__ float s_den[kThreads];
  __shared__ MatchState st;

  const int passes = (k + kPerPass - 1) / kPerPass;
  const int per_buffer = kGroups * passes;  // this block's scores of a round
  float* s_pts = smem;                      // f32[2 r]
  float* s_bw = smem + 2 * r;               // f32[r]
  float* s_scores = smem + 3 * r;           // f32[2][per_buffer]
  float* s_noise = s_scores + 2 * per_buffer;  // f32[rounds][k][3]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = threadIdx.x / overlap::kGroupThreads;
  const int t = threadIdx.x % overlap::kGroupThreads;
  float* g_num = s_num + g * overlap::kGroupThreads;
  float* g_den = s_den + g * overlap::kGroupThreads;
  const int barrier_id = 1 + g;  // 0 is __syncthreads()'s

  for (int i = threadIdx.x; i < 2 * r; i += kThreads) s_pts[i] = __ldg(pts + i);
  for (int i = threadIdx.x; i < r; i += kThreads) s_bw[i] = __ldg(beam_w + i);
  for (int i = threadIdx.x; i < rounds * k * 3; i += kThreads) s_noise[i] = __ldg(noise + i);
  if (threadIdx.x == 0) {
    st.pose[0] = __ldg(init_pose + 0);
    st.pose[1] = __ldg(init_pose + 1);
    st.pose[2] = __ldg(init_pose + 2);
    st.sigma[0] = sigma_xy;
    st.sigma[1] = sigma_xy;
    st.sigma[2] = sigma_theta;
    st.bad = 0;
  }
  __syncthreads();
  const float ox = __ldg(origin + 0);
  const float oy = __ldg(origin + 1);

  if (g == 0) {  // the first pose, in every block
    const overlap::Pose p{st.pose[0], st.pose[1], cosf(st.pose[2]), sinf(st.pose[2])};
    float num, den;
    overlap::beam_sums(v, h, w, p, s_pts, s_bw, r, t, ox, oy, scale, unknown, num, den);
    overlap::group_reduce(num, den, g_num, g_den, t, barrier_id);
    if (t == 0) st.prob = overlap::weighted_mean(num, den);
  }
  __syncthreads();

  for (int round = 0; round < rounds; ++round) {
    float* mine = s_scores + (round & 1) * per_buffer;
    for (int pass = 0; pass < passes; ++pass) {
      const int c = pass * kPerPass + rank * kGroups + g;
      if (c >= k) continue;  // the whole group: it waits at the cluster barrier
      float cand[3];
      candidate(st, s_noise + (round * k + c) * 3, cand);
      const overlap::Pose p{cand[0], cand[1], cosf(cand[2]), sinf(cand[2])};
      float num, den;
      overlap::beam_sums(v, h, w, p, s_pts, s_bw, r, t, ox, oy, scale, unknown, num, den);
      overlap::group_reduce(num, den, g_num, g_den, t, barrier_id);
      if (t == 0) mine[pass * kGroups + g] = overlap::weighted_mean(num, den);
    }
    cluster.sync();  // every block's scores of this round are written

    if (threadIdx.x < 32) {
      float best_v = -CUDART_INF_F;
      int best_i = 0x7fffffff;  // a lane without a candidate loses to any
      for (int c = threadIdx.x; c < k; c += 32) {
        const int pass = c / kPerPass;
        const int in_pass = c - pass * kPerPass;
        const float* theirs = cluster.map_shared_rank(mine, in_pass / kGroups);
        const float sc = theirs[pass * kGroups + in_pass % kGroups];
        if (comes_first(sc, c, best_v, best_i)) {
          best_v = sc;
          best_i = c;
        }
      }
#pragma unroll
      for (int lanes = 16; lanes > 0; lanes >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best_v, lanes);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i, lanes);
        if (comes_first(ov, oi, best_v, best_i)) {
          best_v = ov;
          best_i = oi;
        }
      }
      if (threadIdx.x == 0) {
        const bool better = best_v > st.prob;
        if (better) {
          float cand[3];  // the winner's pose, from the state it was drawn from
          candidate(st, s_noise + (round * k + best_i) * 3, cand);
          st.pose[0] = cand[0];
          st.pose[1] = cand[1];
          st.pose[2] = cand[2];
          st.prob = best_v;
        }
        int bad = better ? 0 : st.bad + 1;
        if (bad >= bad_limit) {
          st.sigma[0] *= 0.5f;
          st.sigma[1] *= 0.5f;
          st.sigma[2] *= 0.5f;
          bad = 0;
        }
        st.bad = bad;
        if (rank == 0) trace_out[round] = best_v;
      }
    }
    __syncthreads();  // the new state, before the next round reads it
  }

  // no block leaves while another may still read its scores
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    pose_out[0] = st.pose[0];
    pose_out[1] = st.pose[1];
    pose_out[2] = st.pose[2];
    prob_out[0] = st.prob;
  }
}

}  // namespace

// Launches one cluster on `stream` (PyTorch's current stream), does not
// synchronise and allocates nothing. `shared_bytes` is the dynamic shared
// memory the caller asks for a block: at least (3 r + 2 * 8 *
// ceil(k / 64) + 3 rounds k) floats, and with the kernel's static 8.2 KB
// within the 227 KB a block can have. Returns the cudaError_t of the launch
// (0 = ok).
extern "C" int mc_match_launch(const float* v, int h, int w, const float* pts,
                               const float* beam_w, int r, const float* origin,
                               const float* init_pose, const float* noise, int rounds,
                               int k, float scale, float unknown, float sigma_xy,
                               float sigma_theta, int bad_limit, float* pose_out,
                               float* prob_out, float* trace_out, int shared_bytes,
                               void* stream) {
  if (h <= 0 || w <= 0 || r < 0 || rounds < 0 || k < 0 || (rounds > 0 && k == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int passes = (k + kPerPass - 1) / kPerPass;
  const size_t needed = (3 * static_cast<size_t>(r) + 2 * kGroups * passes +
                         3 * static_cast<size_t>(rounds) * k) * sizeof(float);
  if (shared_bytes < 0 || static_cast<size_t>(shared_bytes) < needed) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the default is 48 KB a block, static part (8.2 KB) included
  if (shared_bytes > 32 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mc_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mc_match_kernel<<<kClusterBlocks, kThreads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      v, h, w, pts, beam_w, r, origin, init_pose, noise, rounds, k, scale, unknown, sigma_xy,
      sigma_theta, bad_limit, pose_out, prob_out, trace_out);
  return static_cast<int>(cudaGetLastError());
}
