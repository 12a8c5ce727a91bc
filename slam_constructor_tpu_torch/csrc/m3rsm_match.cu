// m3rsm_match.cu: whole M3RSM matches in one launch, one Hopper (sm_90a)
// thread-block cluster a request: the level-synchronous branch and bound
// over the max-occupancy pyramid, then the hill climb below a cell. Plain C
// interface, bound from Python with ctypes (slam_constructor_tpu_torch/ops/
// kernels.py::m3rsm_search, built by ops/_build.py).
//
// Replaces what XLA compiled on the TPU for slam_constructor_tpu/ops/
// m3rsm.py: m3rsm_match (the search loop over _score_level, the top_k of
// the frontier, the children, the argmax) and the matchers.py:
// hill_climbing_match it refines with (its score_poses at the overlap
// reducer, extent 1, the TPU kernel pallas_kernels.py:sample_plane_bilinear
// on the matcher's path). For request b:
//
//   rects = the top level's rects (theta index, row, col offset)
//   for level = top .. 0:
//     score[k] = level_score(rects[k]) + tiebreak(rects[k])
//     if level > 0:
//       keep the best min(beam_width, K) by a stable descending sort (equal
//       scores in index order, NaN first, -0.0 equal to 0.0) and split kept
//       rect number n into its 4 children, rects 4n .. 4n + 3 one level down
//   win = argmax score (ties: the first index)
//   pose = (prior.x + win.tx * scale, prior.y + win.ty * scale,
//           wrap_angle(prior.theta + thetas[win.t])),  prob = score[win]
//   hill climb (iterations > 0): prob = score(pose); each round scores the
//     six poses pose + unit_a * steps (theta wrapped), takes the best (ties:
//     the first), keeps it if strictly better, else halves (shrink) the
//     steps; trace[round] = prob
//
// with wrap_angle(t) = atan2f(sinf(t), cosf(t)), the hill climb's score the
// weighted mean of overlap_sample.cuh (by the match's reducer: M3RSMConfig()
// scores with the obstacle reducer) over its own beams (the scan on every
// stride-th beam, scoring.prepare) on the search's level-0 window of the map
// where(known, occ, unknown), read in place: a cell off the window reads
// `unknown`, as the window cut out there does.
//
// What bounds it on an H100: neither bytes nor operations. The viny_m3rsm
// path's match reads its 160^2 window at five levels, its endpoint cells and
// mask (about 0.3 MB) and does about 4 M operations: under 0.1 us. What it
// takes is the chain of 5 levels and 1 + 8 hill-climb rounds, each a round of
// taps, a reduction and a barrier, and within a level the throughput of the
// scattered taps on the few SMs of one cluster (a level of 192 rects is
// 276,480 taps). Run as 5 + 9 launches with ~40 PyTorch ops between them,
// the host's dispatch set the pace of a scan.
//
// Design.
// - One cluster a request of B = min(K_max, 8) blocks x 1024 threads (K_max
//   the largest frontier), chosen at launch (cudaLaunchKernelEx with a
//   cluster-dimension attribute; the kernel is instantiated for each B).
//   Requests on the grid's y axis.
// - Each block first places the request's window (its corner and world
//   origin from the prior) and computes every theta's endpoint cells into
//   shared memory, in the f32 arithmetic of kernels.m3rsm_window_cells
//   (IEEE division, no contraction), so every level reads its cells there;
//   and it copies the windows of the levels above 0 (34 KB on viny_m3rsm's
//   160^2 window) into shared memory, where a tap is a bank read and not a
//   scattered L1 access, when they are at most 96 KB and fit beside the rest
//   (m3rsm_match_shared_bytes); else they are read in place, as level 0's
//   window (100 KB) always is.
// - A warp scores one rect at a time. A lane keeps the partial sums of the
//   four threads lane, lane + 32, lane + 64, lane + 96 of m3rsm_level.cu's
//   128-thread group apart (beams j, j + 128, ... for thread j) and adds
//   them, then the lanes' sums, in that group's tree order, so a rect's score
//   has the bits of the per-level launch. Rect c of a level goes to block c %
//   B, so a level's taps spread over every SM of the cluster; viny_m3rsm's
//   frontiers (at most 192 rects) are one pass a level.
// - Each block keeps its warps' scores; after one cluster barrier a level
//   every block reads all K scores through distributed shared memory and
//   replicates the selection: a rect's place in the stable descending sort
//   is its rank, the count of rects that come before it (a larger order key,
//   or an equal key at a lower index), counted by one thread a rect over
//   the keys, read four at a time. The rects ranked below beam_width
//   write their children into the block's own next frontier at 4 x rank. So
//   the frontier lives replicated in every block and nothing is broadcast;
//   the score buffers alternate between levels, so one cluster barrier a
//   level is enough (as in mc_match.cu).
// - After the last level every block has read the scores; block 0 alone
//   takes the argmax and runs the hill climb, and the other blocks leave.
//   The climb is climb.cuh's, which hill_climb.cu runs too: the 6
//   candidates of a round are 6 groups of 128 threads at once, each scoring
//   its pose exactly as a block of overlap_score.cu does.
// - Nothing is read on the host, nothing allocated, no atomics.
//
// Numerics: built without --use_fast_math and with --fmad=false; see
// overlap_sample.cuh. The pose arithmetic is the PyTorch loop's, op by op.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "climb.cuh"
#include "overlap_sample.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxClusterBlocks = 8;  // the portable cluster size
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;  // rects a block scores at once
// most floats of the level windows above level 0 staged in shared memory
constexpr int kMaxStagedFloats = 24 * 1024;
constexpr int kMaxLevels = 8;          // pyramid levels above the finest
static_assert(climb::kThreads <= kThreads, "a hill-climb round is one pass of block 0");

// the probe's slots (overlap_sample.cuh) of a block: after the set-up, and
// for level n (from the top) 3 + 3 n when warp 0 has scored, 4 + 3 n when the
// block has read every score, 5 + 3 n when its next frontier is written;
// then the last barrier, the argmax, the first hill-climb score and a slot
// a round
constexpr int kProbeSetup = 2, kProbeLevel = 3, kProbeFinal = 30, kProbeArgmax = 31;
constexpr int kProbeFirst = 32, kProbeRound = 33;
// the set-up's parts: the copies and the window's corner, then thread 0's
// share of the endpoint cells (the staged windows end at kProbeSetup)
constexpr int kProbeCopies = 29, kProbeCells = 61;

// Blocks a cluster: one a rect of the largest frontier, at most 8, so that
// a level's taps spread over as many SMs as the cluster can have.
int cluster_blocks(int k_max) {
  return k_max < 1 ? 1 : (k_max > kMaxClusterBlocks ? kMaxClusterBlocks : k_max);
}

// The pyramid's planes: level l of map m at plane[l] + m * map_stride[l]
// (map_stride 0: one map shared by every request), hp x wp floats; the
// search window's extent at level l is wh x ww.
struct Pyramid {
  const float* plane[kMaxLevels + 1];
  long long map_stride[kMaxLevels + 1];
  int hp[kMaxLevels + 1], wp[kMaxLevels + 1];
  int wh[kMaxLevels + 1], ww[kMaxLevels + 1];
  int staged[kMaxLevels + 1];  // where level l's window starts in the staged floats
  int n_staged;                // 0: every level read in place
};

// Everything else of a launch; pointers at request 0's slices.
struct Search {
  const float* occ;  // the maps: occupancy, a float every occ_stride
  const unsigned char* known;
  const float* origin;  // f32[B, 2] the maps' world origins
  const float* pts;     // f32[B, R, 2] endpoints in the sensor frame
  const float* mask;    // f32[B, R] the beams' weights
  const float* prior;   // f32[B, 3]
  const int* top;       // i32[K0, 3] the top level's rects
  const float* thetas;  // f32[T]
  float* pose_out;      // f32[B, 3]
  float* prob_out;      // f32[B]
  float* trace_out;     // f32[B, iterations]
  long long map_cells;  // cells from one map to the next (0: shared)
  int map_h, map_w, occ_stride;
  int window;  // the window's side (0: the whole map)
  int n_t, r, stride, r2, k0, levels, beam_width, k_max, iterations;
  float scale, unknown, step_xy, step_theta, shrink;
  overlap::Reducer red;  // how the hill climb's score reads a beam
};

// the larger of a and b, NaN if either is NaN (fmaxf would drop a NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// A request's prior-centred window of a level plane, read in place: its
// first cell and its wh x ww extent; a cell outside it reads `unknown` even
// where the plane holds a value, as the reference slices the plane first.
struct LevelWindow {
  const float* __restrict__ plane;  // at the window's first cell
  int pitch;                        // the plane's row, in floats
  int wh, ww;
  float unknown;
  __device__ __forceinline__ float operator()(int row, int col) const {
    const bool in = row >= 0 && row < wh && col >= 0 && col < ww;
    return in ? __ldg(plane + static_cast<long long>(row) * pitch + col) : unknown;
  }
};

// The same window staged in shared memory, `pitch` floats a row.
struct StagedWindow {
  const float* cells;
  int pitch;
  int wh, ww;
  float unknown;
  __device__ __forceinline__ float operator()(int row, int col) const {
    const bool in = row >= 0 && row < wh && col >= 0 && col < ww;
    return in ? cells[row * pitch + col] : unknown;
  }
};

// The window at `level` of a map's level plane (hp x wp floats) whose
// first level-0 cell is (row0, col0); cut at the plane's edge.
__device__ __forceinline__ LevelWindow level_window(const float* plane, int hp, int wp,
                                                   int row0, int col0, int level, int wh,
                                                   int ww, float unknown) {
  const int rw = row0 >> level;
  const int cw = col0 >> level;
  return LevelWindow{plane + static_cast<long long>(rw) * wp + cw, wp, min(wh, hp - rw),
                     min(ww, wp - cw), unknown};
}

// A rect's score sums (valid in lane 0) as m3rsm_level.cu's group of 128
// threads forms them: thread j = lane + 32 u takes beams j, j + 128, ...
//
//   fine = cells[i] + (ty, tx);  v = max over the corners d of
//   at[(fine + d) >> level], d in {0, e}^2, e = 2^level - 1;
//   num += v * mask[i];  den += mask[i]
//
// then overlap::group_reduce's order: s[j] + s[j + 64], then + s[j + 32],
// then the shuffle tree over the 32 lanes.
template <class Window>
__device__ __forceinline__ void rect_sums(const Window& at, const int* cells,
                                          const float* mask, int r, int level, int ty, int tx,
                                          int lane, float& num, float& den) {
  const int e = (1 << level) - 1;
  float sn[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int base = lane; base < r; base += overlap::kGroupThreads) {
    float v[4], mw[4];  // the four threads' taps loaded together, so they overlap
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + 32 * u;
      v[u] = 0.0f;
      mw[u] = 0.0f;
      if (i < r) {
        const int fr = cells[2 * i + 0] + ty;
        const int fc = cells[2 * i + 1] + tx;
        float x = at(fr >> level, fc >> level);
        if (e != 0) {
          x = max_nan(x, at(fr >> level, (fc + e) >> level));
          x = max_nan(x, at((fr + e) >> level, fc >> level));
          x = max_nan(x, at((fr + e) >> level, (fc + e) >> level));
        }
        v[u] = x;
        mw[u] = mask[i];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (base + 32 * u < r) {
        sn[u] += v[u] * mw[u];
        sd[u] += mw[u];
      }
    }
  }
  num = (sn[0] + sn[2]) + (sn[1] + sn[3]);
  den = (sd[0] + sd[2]) + (sd[1] + sd[3]);
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    num += __shfl_down_sync(0xffffffffu, num, stride);
    den += __shfl_down_sync(0xffffffffu, den, stride);
  }
}

// The search's tie-break, added to a rect's mean: -1e-6 x (|ty| + |tx| +
// |t - n_theta / 2|), the rect nearest the prior first among equal scores.
__device__ __forceinline__ float tiebreak(int t, int ty, int tx, int n_theta) {
  const int d = abs(ty) + abs(tx) + abs(t - n_theta / 2);
  return static_cast<float>(d) * -1e-6f;
}

// The order of the search's stable descending sort as an unsigned key: a
// larger key comes first. NaN first (every NaN alike), -0.0 equal to 0.0.
__device__ __forceinline__ unsigned order_key(float v) {
  if (v != v) return 0xffffffffu;
  const unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// One pass of a level's rects: rect c of the level is scored by warp (c %
// (32 B)) / B of block c % B in pass c / (32 B), so that the rects spread
// over every block of the cluster.
template <int kBlocks, class Window>
__device__ __forceinline__ void score_level(const Window& at, const int* rects, int k_max,
                                            int k, int level, const int* s_c0, int r,
                                            const float* s_mask, int n_t, int rank, int warp,
                                            int lane, float* mine) {
  constexpr int per_pass = kBlocks * kWarps;
  const int passes = (k + per_pass - 1) / per_pass;
  for (int pass = 0; pass < passes; ++pass) {
    const int c = pass * per_pass + warp * kBlocks + rank;
    if (c >= k) continue;  // the whole warp: it waits at the cluster barrier
    const int rt = rects[c], ry = rects[k_max + c], rx = rects[2 * k_max + c];
    float num, den;
    rect_sums(at, s_c0 + rt * r * 2, s_mask, r, level, ry, rx, lane, num, den);
    if (lane == 0) {
      mine[pass * kWarps + warp] =
          overlap::weighted_mean(num, den) + tiebreak(rt, ry, rx, n_t);
    }
  }
}

template <int kBlocks>
__global__ void __launch_bounds__(kThreads, 1)
m3rsm_match_kernel(const Pyramid pyr, const Search s) {
  extern __shared__ float smem[];
  __shared__ float s_warp_v[kWarps];
  __shared__ int s_warp_i[kWarps];
  __shared__ climb::State st;  // the hill climb's
  __shared__ int s_corner[2];      // the window's first level-0 cell (row, col)
  __shared__ float s_origin[2];    // the window's world origin

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int stamped = blockIdx.y * gridDim.x + blockIdx.x;  // the probe's slots
  if (threadIdx.x == 0) {
    PROBE_STAMP(stamped, probe::kStart);
    PROBE_STAMP_NS(stamped, probe::kStartNs);
  }

  constexpr int per_pass = kBlocks * kWarps;  // rects a pass
  const int k_max = s.k_max;
  const int per_buffer = kWarps * ((k_max + per_pass - 1) / per_pass);
  float* s_all = smem;  // f32[k_max]: a level's scores, or their keys (16-byte aligned)
  int* s_c0 = reinterpret_cast<int*>(s_all + k_max);        // i32[T][R][2]
  float* s_mask = reinterpret_cast<float*>(s_c0 + 2 * s.n_t * s.r);  // f32[r]
  float* s_q = s_mask + s.r;                                // f32[2 r] the endpoints
  float* s_pts = s_q + 2 * s.r;                             // f32[2 r2]
  float* s_bw = s_pts + 2 * s.r2;                           // f32[r2]
  float* s_scores = s_bw + s.r2;                            // f32[2][per_buffer]
  int* s_rects = reinterpret_cast<int*>(s_scores + 2 * per_buffer);  // i32[2][3][k_max]
  float* s_trig = reinterpret_cast<float*>(s_rects + 6 * k_max);  // f32[2][T]
  float* s_stage = s_trig + 2 * s.n_t;                      // the staged level windows

  // --- the window and the endpoint cells (kernels.m3rsm_window_cells) ----
  const float px = s.prior[3 * b + 0], py = s.prior[3 * b + 1], pt = s.prior[3 * b + 2];
  if (threadIdx.x == 0) {
    const float ox = s.origin[2 * b + 0], oy = s.origin[2 * b + 1];
    if (s.window > 0) {
      const int side = s.window, step = 1 << s.levels;
      // the jitted reference's product with the reciprocal, and its window
      // origin one multiply-add (kernels.m3rsm_window_cells)
      const float inv = overlap::inv_scale(s.scale);
      const int cx = static_cast<int>(floorf((px - ox) * inv));
      const int cy = static_cast<int>(floorf((py - oy) * inv));
      const int c0w = min(max(cx - side / 2, 0), s.map_w - side) / step * step;
      const int r0w = min(max(cy - side / 2, 0), s.map_h - side) / step * step;
      s_corner[0] = r0w;
      s_corner[1] = c0w;
      s_origin[0] = libm::fma32(static_cast<float>(c0w), s.scale, ox);
      s_origin[1] = libm::fma32(static_cast<float>(r0w), s.scale, oy);
    } else {
      s_corner[0] = s_corner[1] = 0;
      s_origin[0] = ox;
      s_origin[1] = oy;
    }
  }
  for (int i = threadIdx.x; i < s.n_t; i += kThreads) {
    const float ang = pt + s.thetas[i];
    s_trig[i] = libm::cos(ang);
    s_trig[s.n_t + i] = libm::sin(ang);
  }
  const float* mask = s.mask + b * s.r;
  for (int i = threadIdx.x; i < s.r; i += kThreads) s_mask[i] = __ldg(mask + i);
  for (int i = threadIdx.x; i < 2 * s.r; i += kThreads) s_q[i] = __ldg(s.pts + b * 2 * s.r + i);
  if (rank == 0) {  // the hill climb's beams: every stride-th
    const float* pts = s.pts + b * 2 * s.r;
    for (int j = threadIdx.x; j < s.r2; j += kThreads) {
      s_pts[2 * j + 0] = __ldg(pts + 2 * j * s.stride + 0);
      s_pts[2 * j + 1] = __ldg(pts + 2 * j * s.stride + 1);
      s_bw[j] = __ldg(mask + j * s.stride);
    }
  }
  for (int i = threadIdx.x; i < s.k0; i += kThreads) {
    s_rects[i] = __ldg(s.top + 3 * i + 0);
    s_rects[k_max + i] = __ldg(s.top + 3 * i + 1);
    s_rects[2 * k_max + i] = __ldg(s.top + 3 * i + 2);
  }
  __syncthreads();
  if (threadIdx.x == 0) PROBE_STAMP(stamped, kProbeCopies);
  const int row0 = s_corner[0], col0 = s_corner[1];
  {
    const float wx = s_origin[0], wy = s_origin[1];
    const float inv = overlap::inv_scale(s.scale);
    for (int i = threadIdx.x; i < s.n_t * s.r; i += kThreads) {
      const int th = i / s.r, beam = i - th * s.r;
      const overlap::Pose at{px, py, s_trig[th], s_trig[s.n_t + th]};
      float ex, ey;
      overlap::endpoint_cells(at, s_q[2 * beam + 0], s_q[2 * beam + 1], wx, wy, inv, ex, ey);
      s_c0[2 * i + 0] = static_cast<int>(floorf(ey));
      s_c0[2 * i + 1] = static_cast<int>(floorf(ex));
    }
  }
  if (threadIdx.x == 0) PROBE_STAMP(stamped, kProbeCells);
  // the windows of the levels above 0, as each level's score reads them
  for (int level = 1; pyr.n_staged > 0 && level <= s.levels; ++level) {
    const LevelWindow at = level_window(
        pyr.plane[level] + b * pyr.map_stride[level], pyr.hp[level], pyr.wp[level], row0, col0,
        level, pyr.wh[level], pyr.ww[level], s.unknown);
    float* to = s_stage + pyr.staged[level];
    const int n = at.wh * at.ww;
    constexpr int kBatch = 8;  // loads in flight a thread
    for (int base = threadIdx.x; base < n; base += kBatch * kThreads) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads;
        const int row = i / at.ww, col = i - row * at.ww;
        v[u] = i < n ? __ldg(at.plane + static_cast<long long>(row) * at.pitch + col) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (base + u * kThreads < n) to[base + u * kThreads] = v[u];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) PROBE_STAMP(stamped, kProbeSetup);

  // --- the branch and bound -------------------------------------------------
  int k = s.k0;
  int* rects = s_rects;                 // this level's frontier
  int* next = s_rects + 3 * k_max;      // the next level's
  for (int level = s.levels, n = 0; level >= 0; --level, ++n) {
    float* mine = s_scores + (n & 1) * per_buffer;
    const LevelWindow at = level_window(
        pyr.plane[level] + b * pyr.map_stride[level], pyr.hp[level], pyr.wp[level], row0, col0,
        level, pyr.wh[level], pyr.ww[level], s.unknown);
    if (level > 0 && pyr.n_staged > 0) {
      const StagedWindow staged{s_stage + pyr.staged[level], at.ww, at.wh, at.ww,
                                       s.unknown};
      score_level<kBlocks>(staged, rects, k_max, k, level, s_c0, s.r, s_mask, s.n_t, rank,
                           warp, lane, mine);
    } else {
      score_level<kBlocks>(at, rects, k_max, k, level, s_c0, s.r, s_mask, s.n_t, rank, warp,
                           lane, mine);
    }
    if (threadIdx.x == 0) PROBE_STAMP(stamped, kProbeLevel + 3 * n);
    cluster.sync();  // every block's scores of this level are written

    if (level > 0 || rank == 0) {
      for (int i = threadIdx.x; i < k; i += kThreads) {
        const int q = i % per_pass;  // block q % B, warp q / B of pass i / (32 B)
        const float* theirs = cluster.map_shared_rank(mine, q % kBlocks);
        const float v = theirs[(i / per_pass) * kWarps + q / kBlocks];
        s_all[i] = level > 0 ? __uint_as_float(order_key(v)) : v;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) PROBE_STAMP(stamped, kProbeLevel + 3 * n + 1);
    if (level == 0) break;

    // the stable descending sort's first `take` places, by rank; the keys
    // read four at a time (every lane of a warp the same: a broadcast)
    const int take = min(s.beam_width, k);
    const int step = 1 << (level - 1);  // a child's offset one level down
    const unsigned* keys = reinterpret_cast<const unsigned*>(s_all);
    const uint4* keys4 = reinterpret_cast<const uint4*>(s_all);
    for (int i = threadIdx.x; i < k; i += kThreads) {
      const unsigned ki = keys[i];
      const auto before = [&](unsigned kj, int j) {
        return static_cast<int>((kj > ki) | ((kj == ki) & (j < i)));
      };
      int place = 0;
#pragma unroll 4
      for (int j4 = 0; j4 < k / 4; ++j4) {
        const uint4 q = keys4[j4];
        place += before(q.x, 4 * j4) + before(q.y, 4 * j4 + 1) + before(q.z, 4 * j4 + 2) +
                 before(q.w, 4 * j4 + 3);
      }
      for (int j = k / 4 * 4; j < k; ++j) place += before(keys[j], j);
      if (place < take) {
        const int o = 4 * place;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          next[o + ch] = rects[i];
          next[k_max + o + ch] = rects[k_max + i] + ((ch & 1) ? step : 0);
          next[2 * k_max + o + ch] = rects[2 * k_max + i] + ((ch & 2) ? step : 0);
        }
      }
    }
    __syncthreads();  // the next frontier is written; this one is free
    if (threadIdx.x == 0) PROBE_STAMP(stamped, kProbeLevel + 3 * n + 2);
    int* done = rects;
    rects = next;
    next = done;
    k = 4 * take;
  }
  // no block leaves while another may still read its scores
  cluster.sync();
  if (threadIdx.x == 0) PROBE_STAMP(stamped, kProbeFinal);
  if (rank != 0) {
    if (threadIdx.x == 0) {
      PROBE_STAMP(stamped, probe::kEnd);
      PROBE_STAMP_NS(stamped, probe::kEndNs);
    }
    return;
  }

  // --- the winner: argmax over level 0, ties to the first ----------------
  {
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;  // a thread without a rect loses to any
    for (int i = threadIdx.x; i < k; i += kThreads) {
      if (climb::comes_first(s_all[i], i, bv, bi)) {
        bv = s_all[i];
        bi = i;
      }
    }
#pragma unroll
    for (int lanes = 16; lanes > 0; lanes >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, lanes);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, lanes);
      if (climb::comes_first(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_warp_v[warp] = bv;
      s_warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = s_warp_v[lane];
      bi = s_warp_i[lane];
#pragma unroll
      for (int lanes = 16; lanes > 0; lanes >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, lanes);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, lanes);
        if (climb::comes_first(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
    }
    if (threadIdx.x == 0) {
      const int rt = rects[bi], ry = rects[k_max + bi], rx = rects[2 * k_max + bi];
      st.pose[0] = px + static_cast<float>(rx) * s.scale;
      st.pose[1] = py + static_cast<float>(ry) * s.scale;
      const float a = pt + s.thetas[rt];
      st.pose[2] = libm::wrap_angle(a);
      st.prob = bv;
      st.steps[0] = s.step_xy;
      st.steps[1] = s.step_xy;
      st.steps[2] = s.step_theta;
      PROBE_STAMP(stamped, kProbeArgmax);
    }
    __syncthreads();
  }

  // --- the hill climb on the level-0 window of the map, read in place -----
  if (s.iterations > 0) {
    const long long first =
        b * s.map_cells + static_cast<long long>(row0) * s.map_w + col0;  // the window's first cell
    const overlap::MapWindow win{s.occ + first * s.occ_stride, s.known + first, s.map_w,
                                 s.occ_stride, s.unknown};
    const int h = min(pyr.wh[0], pyr.hp[0] - row0);
    const int w = min(pyr.ww[0], pyr.wp[0] - col0);
    climb::run(st, win, h, w, s_pts, s_bw, s.r2, s_origin[0], s_origin[1], s.scale, s.unknown,
               s.red, s.iterations, s.shrink, s.trace_out + b * s.iterations, [&](int round) {
                 if (round < 0) {
                   PROBE_STAMP(stamped, kProbeFirst);
                 } else if (kProbeRound + round < kProbeCells) {
                   PROBE_STAMP(stamped, kProbeRound + round);
                 }
               });
  }
  if (threadIdx.x == 0) {
    s.pose_out[3 * b + 0] = st.pose[0];
    s.pose_out[3 * b + 1] = st.pose[1];
    s.pose_out[3 * b + 2] = st.pose[2];
    s.prob_out[b] = st.prob;
    PROBE_STAMP(stamped, probe::kEnd);
    PROBE_STAMP_NS(stamped, probe::kEndNs);
  }
}

using Kernel = decltype(&m3rsm_match_kernel<1>);

Kernel kernel_for(int blocks) {
  switch (blocks) {
    case 1: return m3rsm_match_kernel<1>;
    case 2: return m3rsm_match_kernel<2>;
    case 3: return m3rsm_match_kernel<3>;
    case 4: return m3rsm_match_kernel<4>;
    case 5: return m3rsm_match_kernel<5>;
    case 6: return m3rsm_match_kernel<6>;
    case 7: return m3rsm_match_kernel<7>;
    default: return m3rsm_match_kernel<8>;
  }
}

// Floats of the level windows above level 0, and where each starts.
int window_floats(int win_h, int win_w, int levels, int* starts) {
  int n = 0;
  for (int l = 1; l <= levels; ++l) {
    starts[l] = n;
    n += ((win_h + (1 << l) - 1) >> l) * ((win_w + (1 << l) - 1) >> l);
  }
  return n;
}

// Dynamic shared memory a block needs besides the staged windows, in bytes:
// every theta's endpoint cells (2 n_t r ints), the mask and the endpoints
// (3 r floats), the hill climb's beams (3 r2), two buffers of the block's
// scores, a level's scores (k_max), two frontiers of k_max rects (6 k_max
// ints) and the thetas' trig (2 n_t).
long long base_bytes(int n_t, int r, int r2, int k_max) {
  const int blocks = cluster_blocks(k_max);
  const long long per_buffer =
      static_cast<long long>(kWarps) * ((k_max + blocks * kWarps - 1) / (blocks * kWarps));
  return 4LL * (2LL * n_t * r + 3LL * r + 3LL * r2 + 2 * per_buffer + k_max + 6LL * k_max +
                2LL * n_t);
}

// The hill climb's beams: every stride-th, none without a round.
int climb_beams(int r, int stride, int iterations) {
  return iterations > 0 && stride > 0 ? (r + stride - 1) / stride : 0;
}

// Whether a launch of `shared_bytes` stages its `n` window floats.
bool stages(long long shared_bytes, long long base, int n) {
  return n > 0 && n <= kMaxStagedFloats && shared_bytes >= base + 4LL * n;
}

}  // namespace

// The dynamic shared memory, in bytes, that a launch of m3rsm_match_launch
// with these sizes asks for (`bytes`: the level windows above 0 staged when
// there are at most kMaxStagedFloats of them and they fit), and what a block
// of its kernel may ask for on the current device (`cap`). The caller
// refuses the sizes where bytes > cap, and else passes `bytes` to the launch.
// Returns the cudaError_t of the queries (0 = ok).
extern "C" int m3rsm_match_shared_bytes(int h, int w, int window, int levels, int n_t, int r,
                                        int stride, int iterations, int k_max,
                                        long long* bytes, long long* cap) {
  if (levels < 0 || levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel_for(cluster_blocks(k_max)));
  if (err != cudaSuccess) return static_cast<int>(err);
  *cap = static_cast<long long>(optin) - static_cast<long long>(attr.sharedSizeBytes);
  int starts[kMaxLevels + 1];
  const int n = window_floats(window > 0 ? window : h, window > 0 ? window : w, levels, starts);
  const long long base = base_bytes(n_t, r, climb_beams(r, stride, iterations), k_max);
  *bytes = n <= kMaxStagedFloats && base + 4LL * n <= *cap ? base + 4LL * n : base;
  return 0;
}

// Launches b matches, one cluster of min(k_max, 8) blocks each, on
// `stream` (PyTorch's current stream); does not synchronise and
// allocates nothing. pyramid: the levels + 1 planes of n_planes maps (1:
// shared by every request; else b) in one buffer, level l f32[n_planes,
// ceil(h / 2^l), ceil(w / 2^l)] after level l - 1; occ (a float every
// occ_stride) and known (bool) the maps' level 0, h x w cells each, origin
// f32[b, 2] their world origins. window: the side of each request's
// prior-centred window (a multiple of 2^levels, h and w too; 0: the whole
// map). pts f32[b, r, 2] (sensor frame), mask f32[b, r], the hill climb on
// beams ::stride; prior f32[b, 3], top i32[k0, 3], thetas f32[n_t]. Writes
// pose_out f32[b, 3], prob_out f32[b], trace_out f32[b, iterations].
// k_max: the largest frontier of the search (k0, then 4 min(beam_width, K)
// a level); shared_bytes: m3rsm_match_shared_bytes's `bytes` for these
// sizes. The hill climb reads a beam by the reducer (reducer, radius,
// extent): overlap_sample.cuh. Returns the cudaError_t of the launch (0 =
// ok).
extern "C" int m3rsm_match_launch(
    const float* pyramid, int n_planes, int h, int w, int levels, const float* occ,
    const unsigned char* known, int occ_stride, const float* origin, int window,
    const float* pts, const float* mask, int r, int stride, const float* prior, int b,
    const int* top, int k0, const float* thetas, int n_t, int beam_width, float scale,
    float unknown, float step_xy, float step_theta, float shrink, int iterations, int reducer,
    int radius, float extent, float* pose_out, float* prob_out, float* trace_out, int k_max,
    int shared_bytes, void* stream) {
  const int r2 = climb_beams(r, stride, iterations);
  if (levels < 0 || levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Pyramid pyr{};
  overlap::Reducer s_red{};
  const int win_h = window > 0 ? window : h, win_w = window > 0 ? window : w;
  const long long base = base_bytes(n_t, r, r2, k_max);
  const int n = window_floats(win_h, win_w, levels, pyr.staged);
  pyr.n_staged = stages(shared_bytes, base, n) ? n : 0;
  if (b <= 0 || b > 65535 || h <= 0 || w <= 0 || (n_planes != 1 && n_planes != b) ||
      window < 0 || window > h || window > w ||
      (window > 0 && (window % (1 << levels) || h % (1 << levels) || w % (1 << levels))) ||
      n_t <= 0 || r < 0 || stride < 1 || k0 <= 0 || beam_width <= 0 || k_max < k0 ||
      iterations < 0 || occ_stride < 1 || shared_bytes < base ||
      !overlap::make_reducer(reducer, radius, extent, &s_red)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long offset = 0;
  for (int l = 0; l <= levels; ++l) {
    const int hl = (h + (1 << l) - 1) >> l;
    const int wl = (w + (1 << l) - 1) >> l;
    pyr.plane[l] = pyramid + offset;
    pyr.map_stride[l] = n_planes == 1 ? 0 : static_cast<long long>(hl) * wl;
    pyr.hp[l] = hl;
    pyr.wp[l] = wl;
    pyr.wh[l] = (win_h + (1 << l) - 1) >> l;
    pyr.ww[l] = (win_w + (1 << l) - 1) >> l;
    offset += static_cast<long long>(n_planes) * hl * wl;
  }
  Search s{};
  s.red = s_red;
  s.occ = occ;
  s.known = known;
  s.origin = origin;
  s.pts = pts;
  s.mask = mask;
  s.prior = prior;
  s.top = top;
  s.thetas = thetas;
  s.pose_out = pose_out;
  s.prob_out = prob_out;
  s.trace_out = trace_out;
  s.map_cells = n_planes == 1 ? 0 : static_cast<long long>(h) * w;
  s.map_h = h;
  s.map_w = w;
  s.occ_stride = occ_stride;
  s.window = window;
  s.n_t = n_t;
  s.r = r;
  s.stride = stride;
  s.r2 = r2;
  s.k0 = k0;
  s.levels = levels;
  s.beam_width = beam_width;
  s.k_max = k_max;
  s.iterations = iterations;
  s.scale = scale;
  s.unknown = unknown;
  s.step_xy = step_xy;
  s.step_theta = step_theta;
  s.shrink = shrink;

  const int blocks = cluster_blocks(k_max);
  const Kernel kernel = kernel_for(blocks);
  // the default is 48 KB a block, the static part included
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
  cfg.gridDim = dim3(blocks, b, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(shared_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, pyr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

PROBE_EXPORT(m3rsm_match_probe_stamps)
