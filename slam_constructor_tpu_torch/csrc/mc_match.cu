// mc_match.cu: whole Monte-Carlo scan matches in one launch, one Hopper
// (sm_90a) thread-block cluster a match. Plain C interface, bound from
// Python with ctypes (slam_constructor_tpu_torch/ops/kernels.py::mc_match
// for one match, ::mc_match_batched for P of them on planes already cut
// out, ::mc_match_windows for P of them on windows of their maps read in
// place; built by ops/_build.py).
//
// On the matcher's path it takes the place of the TPU kernel
// slam_constructor_tpu/ops/pallas_kernels.py: sample_plane_bilinear (body
// _bilinear_kernel) together with everything ops/matchers.py:
// monte_carlo_match does around ops/scoring.py:score_poses at the overlap
// reducer, extent 1; with P matches in one launch it is also what
// models/gmapping.py gets from vmap(match_particle) over its particles,
// window_view and the plane where(known, occ, unknown) included:
//
//   for each match p (a particle, with its own plane or window of its map,
//   scan, origin, prior and noise):
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
// with wrap_angle(t) = atan2f(sinf(t), cosf(t)) (glibc's, libm.cuh) and score() the weighted
// mean of overlap_sample.cuh over the scan's beams, each beam's endpoint
// read by the match's reducer (the bilinear taps above; or the obstacle,
// max, mean or general overlap reducer of the reference's gather path, a
// uniform code tested before the beam loop, so no reducer adds an
// instantiation; the other reducers' loop is called, not inlined, which
// keeps the bilinear loop as fast as it was). GMappingConfig()'s defaults
// match 30 whole 256^2 maps with the obstacle reducer: one tap a beam. The
// draws come in `noise` (standard normals, or the reference's erf_inv
// values with sigma times sqrt(2)), or the kernel draws them itself from a
// key (threefry.cuh) in its prologue, bit for bit with ops/prng.py.
//
// What bounds it on an H100: neither bytes nor operations. The RBPF's 30
// windows of 160^2, its scans and noise are ~3.2 MB cut out (0.95 us at
// 3.35 TB/s), ~3.9 MB read in place (occupancy and mask, each window once;
// 1.18 us), and its 30 x (1 + 5 x 20) poses x 180 beams are ~29 MFLOP (0.4
// us at 67 TFLOP/s); a single match of the tiny path is ~0.27 MB and ~15
// MFLOP. What it takes is 1 + rounds dependent steps, each a few trips to L2 for the
// plane's taps and one cluster barrier. Run as 1 + rounds launches of
// overlap_score.cu with ~25 small PyTorch ops between them
// (kernels.mc_match_rounds), or as one launch a particle, the host's
// dispatch of those, not the device, sets the pace of a scan.
//
// Design.
// - One cluster a match, of B blocks x 1024 threads, B = ceil(K / 8) and at
//   most 8, chosen at launch (cudaLaunchKernelEx with a cluster-dimension
//   attribute; the kernel is instantiated for each B, for planes and for
//   windows read in place). The grid is (B, P):
//   cluster p is row blockIdx.y = p and works on match p's slices of every
//   array. A block holds 8 groups of 128
//   threads and a group scores one candidate, so a cluster scores 8 B
//   candidates at once; more candidates (K > 64) take further passes in the
//   same round. Idle groups still reach every barrier. At the RBPF's K = 20,
//   B = 3: 30 particles are 90 blocks of one SM each, one wave on 132 SMs,
//   where 8-block clusters would leave 44 of 64 groups idle and need two.
//   The tiny, viny and full paths (K = 64) keep B = 8.
// - A group scores its pose exactly as a block of overlap_score.cu does
//   (the shared header: same beam order a thread, same tree), and the
//   candidate arithmetic is written op by op as the PyTorch loop does it,
//   so a match gives the same bits as the match with one overlap_score
//   launch a round, whatever B, P and the match's place in the grid.
// - The single match of the tiny, viny and full paths takes the scan and,
//   on tiny and viny, the state's pose and the odometry delta in place of
//   pts, beam_w and the prior (kernels.mc_match_scan): each block computes
//   the kept beams' endpoints (r cos b, r sin b with libm.cuh's sincos, a
//   beam a thread) and weights (valid x the point weight) into its shared
//   memory, and its thread 0 the prior compose(pose, odom) (libm::compose),
//   the bits of libm.cu's libm_cossin and libm_pose: the step launches
//   neither.
// - pts and beam_w (12 B a beam) and all the match's noise (12 B a
//   candidate and round) are copied once into each block's shared memory,
//   with plain coalesced loads (4.3 KB and 9-12 KB on the single-match
//   paths, 2.2 and 1.2 KB for a particle of the RBPF: a few loads a thread,
//   nothing to pipeline), and serve every candidate of every round: no
//   round waits for device memory except for the plane's taps. Draws from
//   a key are made once a cluster: each block draws its own candidates'
//   (an eighth of them on the single-match paths, one hash chain a thread:
//   hashing the rounds' keys once a block in one warp was slower) and
//   stores each into every block's copy through distributed shared memory;
//   the first round's cluster barrier publishes them before any block
//   forms another block's winner.
// - The plane stays in global memory behind __ldg: 256 KB does not fit a
//   block's 227 KB of shared memory, and spread over the cluster a tap
//   would cost a distributed-shared-memory read that is no faster than the
//   L2 (or L1) hit it replaces.
// - A window of a map is read in place (overlap::MapWindow, the second
//   instantiation): a tap reads the occupancy (a float every occ_stride,
//   a channel of the map's cells) and the known mask at the window's cell
//   of the map and forms where(known, occ, unknown) itself; tap validity
//   uses the window's bounds. So a match on a window gives the bits of the
//   same match on the window cut out, with no copy: the RBPF's 30 maps of
//   256^2 (15.7 MB with their masks) stay in L2. The window's first cell is
//   read on the device (row[p], col[p], from grid.window_corner) and clamped
//   into the map, so a corner never leaves it.
// - Scores meet through distributed shared memory: each group writes its
//   score into its own block's buffer, one cluster barrier, then the first
//   warp of EVERY block reads all K scores (map_shared_rank) and computes
//   argmax, keep-if-better and the anneal redundantly, so the match state
//   lives replicated in every block and nothing is broadcast. The argmax is
//   a total order (comes_first), so the winner does not depend on which
//   group scored which candidate. The score buffers alternate between
//   rounds, so one barrier a round is enough: a block can only write a
//   buffer again after every block has passed the next round's barrier,
//   and so has finished reading it.
// - The first pose is scored by group 0 of every block redundantly, which
//   needs no exchange. Block 0 of a cluster writes trace[r] and at the end
//   pose and prob. No atomics, no global scratch, nothing read on the host.
// - A NaN score counts as the largest in the argmax, as torch.argmax does,
//   and is never "better" (the comparison is a strict >).
//
// Numerics: built without --use_fast_math and with --fmad=false; see
// overlap_sample.cuh. With handed-in standard normals noise * sigma and best
// + that are two roundings; with the reference's erf_inv draws (drawn from
// a key here, or handed in: `fused`) the candidate is one fused
// multiply-add, as the reference's jitted code has it: its normal * sigma is
// erf_inv(u) * (sqrt(2) * sigma) (XLA reassociates the constant), fused
// with the add.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "libm.cuh"
#include "overlap_sample.cuh"
#include "threefry.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxClusterBlocks = 8;  // the portable cluster size
constexpr int kGroups = 8;            // groups (candidates) a block
constexpr int kThreads = kGroups * overlap::kGroupThreads;
static_assert(kThreads == 1024, "a block is 8 groups of 128 threads");

// Blocks a cluster: enough groups for the K candidates of a round, at most 8.
int cluster_blocks(int k) {
  const int b = (k + kGroups - 1) / kGroups;
  return b < 1 ? 1 : (b > kMaxClusterBlocks ? kMaxClusterBlocks : b);
}

// The candidates a round that block `rank` of a cluster of `blocks` scores:
// c = pass * 8 blocks + rank * 8 + g for g < 8, while c < k.
__device__ __forceinline__ int own_candidates(int k, int rank, int blocks) {
  const int per_pass = blocks * kGroups;
  int own = 0;
  for (int first = rank * kGroups; first < k; first += per_pass) own += min(k - first, kGroups);
  return own;
}

// The cluster barrier in two halves: arrive (no memory ordering), then wait
// for every thread of the cluster to have arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

struct MatchState {
  float pose[3];
  float prob;
  float sigma[3];
  int bad;
};

// Candidate of one row of draws around the best pose so far, the heading
// wrapped (libm.cuh: the reference's sinf, cosf, atan2f): fused, best + draw
// * sigma in one multiply-add, as the reference's jitted code forms it from
// its erf_inv draws; else (handed-in standard normals: the RBPF's draws and
// the tests that inject the reference's normals) two roundings.
__device__ __forceinline__ void candidate(const MatchState& st, const float* nz, bool fused,
                                          float out[3]) {
  float c[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    c[d] = fused ? libm::fma32(nz[d], st.sigma[d], st.pose[d])
                 : __fadd_rn(st.pose[d], __fmul_rn(nz[d], st.sigma[d]));
  }
  out[0] = c[0];
  out[1] = c[1];
  out[2] = libm::wrap_angle(c[2]);
}

// a pose's heading as the score reads it: cos and sin (one reduction)
__device__ __forceinline__ overlap::Pose score_pose(float x, float y, float th) {
  float s, c;
  libm::sincos(th, &s, &c);
  return overlap::Pose{x, y, c, s};
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

// Launched with clusters of kBlocks blocks (the whole x extent of the
// grid) and gridDim.y = P matches. The width is a template parameter, so the
// candidate-to-block arithmetic divides by constants, as it did when the
// width was fixed at 8. kWindow: match p reads the h x w window at (row[p],
// col[p]) of map p in place (occ, known: P maps of map_h x map_w cells);
// else occ is the P planes f32[P, h, w] themselves.
template <int kBlocks, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
mc_match_kernel(const float* __restrict__ occ, const unsigned char* __restrict__ known,
                int occ_stride, int map_h, int map_w, const long long* __restrict__ win_row,
                const long long* __restrict__ win_col, int h, int w,
                const float* __restrict__ pts, const float* __restrict__ beam_w, int r,
                const float* __restrict__ ranges, const float* __restrict__ bearings,
                const unsigned char* __restrict__ valid, const float* __restrict__ point_w,
                int n_beams, int stride, const float* __restrict__ origin,
                const float* __restrict__ init_pose, const float* __restrict__ odom,
                const float* __restrict__ noise, const uint32_t* __restrict__ key,
                uint32_t* __restrict__ next_key, int fused, int rounds, int k, float scale,
                float unknown, float sigma_xy, float sigma_theta, int bad_limit,
                const overlap::Reducer red, float* __restrict__ pose_out,
                float* __restrict__ prob_out, float* __restrict__ trace_out) {
  extern __shared__ float smem[];
  __shared__ float s_num[kThreads];
  __shared__ float s_den[kThreads];
  __shared__ MatchState st;

  // match p's slice of every array; its plane, or its window of map p
  const size_t p = blockIdx.y;
  const auto plane = [&] {
    if constexpr (kWindow) {
      const long long row0 = min(max(__ldg(win_row + p), 0LL), static_cast<long long>(map_h - h));
      const long long col0 = min(max(__ldg(win_col + p), 0LL), static_cast<long long>(map_w - w));
      const size_t first = (p * map_h + row0) * map_w + col0;  // the window's first cell
      return overlap::MapWindow{occ + first * occ_stride, known + first, map_w, occ_stride,
                                unknown};
    } else {
      return overlap::LdgPlane{occ + p * h * w, w};
    }
  }();
  origin += p * 2;
  init_pose += p * 3;
  if (noise != nullptr) noise += p * rounds * k * 3;
  pose_out += p * 3;
  prob_out += p;
  trace_out += p * rounds;

  if (threadIdx.x == 0) {
    PROBE_STAMP(blockIdx.y * gridDim.x + blockIdx.x, probe::kStart);
    PROBE_STAMP_NS(blockIdx.y * gridDim.x + blockIdx.x, probe::kStartNs);
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr int per_pass = kBlocks * kGroups;  // candidates a pass
  const int passes = (k + per_pass - 1) / per_pass;
  const int per_buffer = kGroups * passes;  // this block's scores of a round
  float* s_pts = smem;                      // f32[2 r]
  float* s_bw = smem + 2 * r;               // f32[r]
  float* s_scores = smem + 3 * r;           // f32[2][per_buffer]
  float* s_noise = s_scores + 2 * per_buffer;  // f32[rounds][k][3]

  const int g = threadIdx.x / overlap::kGroupThreads;
  const int t = threadIdx.x % overlap::kGroupThreads;
  float* g_num = s_num + g * overlap::kGroupThreads;
  float* g_den = s_den + g * overlap::kGroupThreads;
  const int barrier_id = 1 + g;  // 0 is __syncthreads()'s

  const bool keyed = noise == nullptr && key != nullptr;  // the same in every block
  if (keyed) cluster_arrive_relaxed();  // this block has started: others may write to it
  if (ranges != nullptr) {
    // the scan's kept beams (every stride-th), as scoring.prepare_scan has
    // them: the endpoint (r cos b, r sin b) with the reference's sincosf
    // (libm_cossin's bits), the weight valid x the point weight
    const size_t first = p * static_cast<size_t>(n_beams);
    for (int j = threadIdx.x; j < r; j += kThreads) {
      const size_t i = first + static_cast<size_t>(j) * stride;
      float sn, cs;
      libm::sincos(__ldg(bearings + i), &sn, &cs);
      const float rg = __ldg(ranges + i);
      s_pts[2 * j + 0] = __fmul_rn(rg, cs);
      s_pts[2 * j + 1] = __fmul_rn(rg, sn);
      const float v = __ldg(valid + i) ? 1.0f : 0.0f;
      s_bw[j] = point_w != nullptr ? __fmul_rn(v, __ldg(point_w + i)) : v;
    }
  } else {
    for (int i = threadIdx.x; i < 2 * r; i += kThreads) s_pts[i] = __ldg(pts + p * 2 * r + i);
    for (int i = threadIdx.x; i < r; i += kThreads) s_bw[i] = __ldg(beam_w + p * r + i);
  }
  if (noise != nullptr) {
    for (int i = threadIdx.x; i < rounds * k * 3; i += kThreads) s_noise[i] = __ldg(noise + i);
  } else if (keyed) {
    // the draws from match p's key, spread over the cluster: each block
    // draws those of the candidates it scores (its groups' c, every round)
    // and writes each into every block's s_noise, so a block reads its own
    // candidates' draws locally and any round's winner's after that
    // round's cluster barrier. With next_key, (next, sub) = split(key) and
    // the match draws from sub (the engine's step); then split(sub,
    // rounds)[r] and erf_inv(uniform) of element (c, d) under it,
    // jax.random.normal's draw before its multiply by sqrt(2), which the
    // caller folds into sigma.
    const int own = own_candidates(k, rank, kBlocks);
    const int per_round = own * 3;
    uint32_t s0 = __ldg(key + 2 * p), s1 = __ldg(key + 2 * p + 1);
    if (next_key != nullptr) {
      if (rank == 0 && threadIdx.x == 0) {
        uint32_t n0, n1;
        tf::threefry(s0, s1, 0u, 0u, n0, n1);
        next_key[2 * p] = n0;
        next_key[2 * p + 1] = n1;
      }
      if (threadIdx.x < rounds * per_round) tf::threefry(s0, s1, 0u, 1u, s0, s1);
    }
    cluster_wait();  // every block of the cluster has started
    for (int j = threadIdx.x; j < rounds * per_round; j += kThreads) {
      const int rd = j / per_round;
      const int lc = (j - rd * per_round) / 3;  // the block's lc-th candidate
      const int d = j - rd * per_round - lc * 3;
      const int c = (lc / kGroups) * kBlocks * kGroups + rank * kGroups + lc % kGroups;
      uint32_t r0, r1;
      tf::threefry(s0, s1, 0u, static_cast<uint32_t>(rd), r0, r1);
      const int i = (rd * k + c) * 3 + d;
      const float v = tf::erf_inv_draw(r0, r1, static_cast<uint32_t>(c * 3 + d));
      s_noise[i] = v;
#pragma unroll
      for (int b = 0; b < kBlocks; ++b) {
        if (b != rank) cluster.map_shared_rank(s_noise, b)[i] = v;
      }
    }
  }
  if (threadIdx.x == 0) {
    if (odom != nullptr) {  // the prior: compose(pose, odom), libm_pose's bits
      odom += p * 3;
      libm::compose(__ldg(init_pose + 0), __ldg(init_pose + 1), __ldg(init_pose + 2),
                    __ldg(odom + 0), __ldg(odom + 1), __ldg(odom + 2), st.pose);
    } else {
      st.pose[0] = __ldg(init_pose + 0);
      st.pose[1] = __ldg(init_pose + 1);
      st.pose[2] = __ldg(init_pose + 2);
    }
    st.sigma[0] = sigma_xy;
    st.sigma[1] = sigma_xy;
    st.sigma[2] = sigma_theta;
    st.bad = 0;
  }
  __syncthreads();
  const float ox = __ldg(origin + 0);
  const float oy = __ldg(origin + 1);
  const int stamped = blockIdx.y * gridDim.x + blockIdx.x;  // the probe's slots
  if (threadIdx.x == 0) PROBE_STAMP(stamped, probe::kSetup);

  if (g == 0) {  // the first pose, in every block
    const overlap::Pose q = score_pose(st.pose[0], st.pose[1], st.pose[2]);
    float num, den;
    overlap::beam_sums_at<true>(plane, h, w, q, s_pts, s_bw, r, t, ox, oy, scale, unknown, red,
                                num, den);
    overlap::group_reduce(num, den, g_num, g_den, t, barrier_id);
    if (t == 0) st.prob = overlap::weighted_mean(num, den);
  }
  __syncthreads();
  if (threadIdx.x == 0) PROBE_STAMP(stamped, probe::kFirst);

  for (int round = 0; round < rounds; ++round) {
    float* mine = s_scores + (round & 1) * per_buffer;
    for (int pass = 0; pass < passes; ++pass) {
      const int c = pass * per_pass + rank * kGroups + g;
      if (c >= k) continue;  // the whole group: it waits at the cluster barrier
      // lane 0 of each warp forms the group's candidate and its heading's
      // sine and cosine (double-precision polynomials) for its 31 lanes
      overlap::Pose q{};
      if ((threadIdx.x & 31) == 0) {
        float cand[3];
        candidate(st, s_noise + (round * k + c) * 3, fused, cand);
        q = score_pose(cand[0], cand[1], cand[2]);
      }
      q.x = __shfl_sync(0xffffffffu, q.x, 0);
      q.y = __shfl_sync(0xffffffffu, q.y, 0);
      q.c = __shfl_sync(0xffffffffu, q.c, 0);
      q.s = __shfl_sync(0xffffffffu, q.s, 0);
      const int part = probe::kRound + probe::kParts * round;  // the probe's slots
      if (threadIdx.x == 0 && pass == 0) PROBE_STAMP(stamped, part + 0);
      float num, den;
      overlap::beam_sums_at<true>(plane, h, w, q, s_pts, s_bw, r, t, ox, oy, scale, unknown, red,
                                  num, den);
      if (threadIdx.x == 0 && pass == 0) PROBE_STAMP(stamped, part + 1);
      overlap::group_reduce(num, den, g_num, g_den, t, barrier_id);
      if (t == 0) mine[pass * kGroups + g] = overlap::weighted_mean(num, den);
      if (threadIdx.x == 0 && pass == 0) PROBE_STAMP(stamped, part + 2);
    }
    cluster.sync();  // every block's scores of this round are written

    if (threadIdx.x < 32) {
      float best_v = -CUDART_INF_F;
      int best_i = 0x7fffffff;  // a lane without a candidate loses to any
      for (int c = threadIdx.x; c < k; c += 32) {
        const int pass = c / per_pass;
        const int in_pass = c - pass * per_pass;
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
      if (threadIdx.x == 0) PROBE_STAMP(stamped, probe::kRound + probe::kParts * round + 3);
      if (threadIdx.x == 0) {
        const bool better = best_v > st.prob;
        if (better) {
          float cand[3];  // the winner's pose, from the state it was drawn from
          candidate(st, s_noise + (round * k + best_i) * 3, fused, cand);
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
    if (threadIdx.x == 0) PROBE_STAMP(stamped, probe::kRound + probe::kParts * round + 4);
  }

  // no block leaves while another may still read its scores
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    pose_out[0] = st.pose[0];
    pose_out[1] = st.pose[1];
    pose_out[2] = st.pose[2];
    prob_out[0] = st.prob;
  }
  if (threadIdx.x == 0) {
    PROBE_STAMP(stamped, probe::kEnd);
    PROBE_STAMP_NS(stamped, probe::kEndNs);
  }
}

using Kernel = decltype(&mc_match_kernel<1, false>);

template <bool kWindow>
Kernel kernel_for(int blocks) {
  switch (blocks) {
    case 1: return mc_match_kernel<1, kWindow>;
    case 2: return mc_match_kernel<2, kWindow>;
    case 3: return mc_match_kernel<3, kWindow>;
    case 4: return mc_match_kernel<4, kWindow>;
    case 5: return mc_match_kernel<5, kWindow>;
    case 6: return mc_match_kernel<6, kWindow>;
    case 7: return mc_match_kernel<7, kWindow>;
    default: return mc_match_kernel<8, kWindow>;
  }
}

}  // namespace

// Launches n_p matches, one cluster of ceil(k / 8) (at most 8) blocks each,
// on `stream` (PyTorch's current stream); does not synchronise and
// allocates nothing. Match p's plane: with known == nullptr, occ[p] (an h x
// w plane; map_h == h, map_w == w, occ_stride 1, row and col unused); else
// the h x w window whose first cell is (row[p], col[p]) (clamped into the
// map) of map p: occ (a float every occ_stride, map_h x map_w cells a map)
// where known (bool) holds, `unknown` elsewhere, read in place. It reads
// pts[p] (r x 2) and beam_w[p], or with ranges the scan (ranges, bearings,
// valid, point_w or null: n_beams a match), whose every stride-th beam
// gives the r endpoints and weights, computed here; origin[p] (the plane's
// or window's),
// init_pose[p] (with odom, the pose that odom[p] moves: the prior is
// compose(init_pose[p], odom[p]) as libm_pose computes it), noise[p]
// (rounds x k x 3; erf_inv draws with `fused`) or,
// with noise == nullptr, draws erf_inv values from key[p] (two words; with
// next_key, from split(key[p])[1], and writes split(key[p])[0] to
// next_key[p]) and writes pose_out[p],
// prob_out[p], trace_out[p] (rounds). `shared_bytes` is the dynamic shared
// memory the caller asks for a block: at least (3 r + 2 * 8 * passes + 3
// rounds k) floats, passes = ceil(k / (8 * blocks)), and with the kernel's
// static 8.2 KB within the 227 KB a block can have. A beam's endpoint is
// read by the reducer (reducer, radius, extent): overlap_sample.cuh; every
// reducer runs the same instantiations and launch geometry. Returns the
// cudaError_t of the launch (0 = ok).
extern "C" int mc_match_launch(const float* occ, const unsigned char* known, int occ_stride,
                               int n_p, int map_h, int map_w, const long long* row,
                               const long long* col, int h, int w, const float* pts,
                               const float* beam_w, int r, const float* ranges,
                               const float* bearings, const unsigned char* valid,
                               const float* point_w, int n_beams, int stride,
                               const float* origin, const float* init_pose,
                               const float* odom, const float* noise,
                               const uint32_t* key, uint32_t* next_key, int fused,
                               int rounds, int k, float scale, float unknown, float sigma_xy,
                               float sigma_theta, int bad_limit, int reducer, int radius,
                               float extent, float* pose_out, float* prob_out, float* trace_out,
                               int shared_bytes, void* stream) {
  const bool window = known != nullptr;
  overlap::Reducer red;
  if (!overlap::make_reducer(reducer, radius, extent, &red) || n_p <= 0 || n_p > 65535 || h <= 0 || w <= 0 || h > map_h || w > map_w || r < 0 ||
      rounds < 0 || k < 0 || (rounds > 0 && k == 0) || occ_stride < 1 ||
      (ranges != nullptr ? (bearings == nullptr || valid == nullptr || stride < 1 ||
                            static_cast<long long>(r - 1) * stride >= n_beams)
                         : (r > 0 && (pts == nullptr || beam_w == nullptr))) ||
      (noise != nullptr && key != nullptr) ||
      (noise == nullptr && key == nullptr && rounds > 0 && k > 0) ||
      (window ? (row == nullptr || col == nullptr)
              : (occ_stride != 1 || h != map_h || w != map_w))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = cluster_blocks(k);
  const Kernel kernel = window ? kernel_for<true>(blocks) : kernel_for<false>(blocks);
  const int passes = (k + blocks * kGroups - 1) / (blocks * kGroups);
  const size_t needed = (3 * static_cast<size_t>(r) + 2 * kGroups * passes +
                         3 * static_cast<size_t>(rounds) * k) * sizeof(float);
  if (shared_bytes < 0 || static_cast<size_t>(shared_bytes) < needed) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the default is 48 KB a block, static part (8.2 KB) included
  if (shared_bytes > 32 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, n_p, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(shared_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, occ, known, occ_stride, map_h, map_w, row, col, h, w, pts, beam_w, r,
      ranges, bearings, valid, point_w, n_beams, stride, origin, init_pose, odom, noise, key,
      next_key, fused || key != nullptr, rounds, k, scale, unknown,
      sigma_xy, sigma_theta, bad_limit, red, pose_out, prob_out, trace_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

PROBE_EXPORT(mc_match_probe_stamps)
