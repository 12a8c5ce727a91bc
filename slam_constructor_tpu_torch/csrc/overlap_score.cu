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
// poses of a 7^3 grid: up to 10,976 (pose, map) pairs in one launch, planes
// of 57.6 KB each that stay in L2.
//
// Design: three layouts, each with the same bits (the sums of
// overlap_sample.cuh's 128-thread group in overlap::group_reduce's order),
// picked by one fixed rule on the launch's pairs and beams (layout_of):
//  - a beam a thread (few pairs: the score is one beam's chain of loads,
//    IEEE divisions and dependent taps, so every beam gets a thread): a
//    block of ceil(R / 32) warps (at most 32; past 1,024 beams a thread takes
//    beams t, t + 1024, ... in chunks) scores one (pose, map), the map on
//    the grid's y axis. Every thread takes its pose's libm::sincos itself
//    (the reference's sinf and cosf, csrc/libm.cuh),
//    loads its endpoint and weight, taps, and writes its beam's (num, den)
//    terms to shared memory (+0.0 for a beam of weight 0); after one block
//    barrier warp 0 folds them in the group's order (overlap::fold_terms,
//    fold_tree) and writes the score. No thread waits on another before its
//    beam;
//  - a warp a pair (many pairs: the card busy for waves, where instructions
//    a beam count): lane l keeps group lanes l, l + 32, l + 64 and l + 96's
//    sums in its registers, takes its beams four at a time with their taps
//    issued together, then fold_tree: no shared memory, no barrier;
//  - between them a group of 128 threads a pair, the kernel's first layout
//    (thread 0's cos and sin, a barrier, the threads striding over the
//    beams, group_reduce), which neither of the others beat there.
// The plane is read through __ldg (it is larger than a block's 227 KB of
// shared memory, and staging it does not speed up the taps: PERF.md);
// beams of weight 0 (invalid) add +0.0, so a score is the same bits from
// run to run and layout to layout. Numerics: see overlap_sample.cuh.
//
// overlap_score_partial_launch (parallel/halo.py, parallel/blockshard.py):
// the same score split by rows for a plane sharded over ranks. A rank
// holds the rows [g0, g0 + he) of an h x w plane (its own rows and `halo`
// rows of each neighbour) and, for each pose, sums only the beams whose
// endpoint's centre row, clamp(floor(y), 0, h - 1), lies in its owned rows
// [row0, row1): out[k] = (sum of bw * p, sum of bw). The ranks' sums over
// a partition of the rows add up to the whole score's num and den. The
// endpoint's position and every tap are the whole plane's (y in global
// rows, off the h x w map reads `unknown`); only the address of a cell is
// shifted by g0, so a beam's probability has the bits overlap_score gives
// it. Which beams count depends on the pose, so no beam weight can say it:
// hence a mode of its own. A beam a thread, the ownership test first (a
// beam the band does not own adds +0.0); its sums are the group's, so a
// band that holds the whole plane gives overlap_score's (num, den). Bound:
// as overlap_score's, launch cost.

#include <climits>

#include <cuda_runtime.h>

#include "overlap_sample.cuh"

namespace {

constexpr int kGroup = overlap::kGroupThreads;
constexpr int kMaxThreads = 1024;  // a beam-a-thread block's most threads
constexpr int kWarpsPerBlock = 4;  // a warp-a-pair block's (pose, map) pairs

// The layout rule, on the launch's (pose, map) pairs and beams (measured:
// PERF.md section 6). A beam a thread while its warps, pairs x
// ceil(R / 32), fit in one wave of the card, 32 warps to each of an H100's
// 132 SMs: every beam then starts at once and a pair takes one beam's
// chain. A warp a pair from kWarpLayoutPairs pairs on: the card is busy
// for waves, and a warp spends fewer instructions a beam (one libm::sincos a
// pair, no barrier, no shared memory). Between them the group of 128
// threads a pair, the kernel's first layout, which neither beat there.
constexpr long long kBeamLayoutWarps = 132 * 32;
constexpr long long kWarpLayoutPairs = 4096;
enum Layout : int { kBeamLayout = 0, kGroupLayout = 1, kWarpLayout = 2 };

Layout layout_of(long long pairs, int r) {
  const long long warps = pairs * ((static_cast<long long>(r < 1 ? 1 : r) + 31) / 32);
  if (warps <= kBeamLayoutWarps) return kBeamLayout;
  return pairs >= kWarpLayoutPairs ? kWarpLayout : kGroupLayout;
}

// Stamps (a -DSLAM_KERNEL_PROBE build, scripts/torch_port/kernel_probe.py
// --stamps): thread 0 of a block, or lane 0 of a warp a pair, for the first
// probe::kBlocks of them, writes clock64() at the end of each part of its
// work from slot 2 on, the count of parts in slot 61 and its layout's stamp
// code in slot 60: 1 the group (set-up: trig and barrier, beams, tree), 2 a
// beam a thread (set-up, its beam, the barrier, fold and tree), 3 a warp a
// pair (set-up, beams, tree).
constexpr int kLayoutSlot = 60, kPartsSlot = 61;

// Cell (row, col) of the whole plane, read from a band that holds its rows
// [g0, g0 + he): the caller keeps the taps it reads inside them.
struct BandPlane {
  const float* __restrict__ v;
  int w;
  int g0;
  __device__ __forceinline__ float operator()(int row, int col) const {
    return __ldg(v + static_cast<long long>(row - g0) * w + col);
  }
};

// What a launch scores: the plane (through its reader), the scan, the
// origin, the reducer; in the partial mode the owned rows [row0, row1) of
// an h-row plane.
template <class Plane>
struct Scan {
  Plane at;
  int h, w;
  const float* __restrict__ pts;     // f32[r][2]
  const float* __restrict__ beam_w;  // f32[r]
  int r;
  float ox, oy, scale, unknown;
  overlap::Reducer red;
  int row0, row1;
};

// Beam i's terms (bw * p, bw) seen from p, or (+0.0, +0.0) for a beam of
// weight 0 and, in the partial mode, for a beam whose endpoint's centre row,
// clamp(floor(y), 0, h - 1) as sample_at() places it (a NaN row goes to row
// 0, as the reference's int cast and clip do), lies outside the owned rows.
template <bool kPartial, class Plane>
__device__ __forceinline__ void beam_terms(const Scan<Plane>& s, const overlap::Pose& p, int i,
                                           float& num, float& den) {
  num = 0.0f;
  den = 0.0f;
  const float bw = __ldg(s.beam_w + i);
  if (bw == 0.0f) return;
  const float2 q = __ldg(reinterpret_cast<const float2*>(s.pts) + i);
  if constexpr (kPartial) {
    float x, y;
    overlap::endpoint_cells(p, q.x, q.y, s.ox, s.oy, overlap::inv_scale(s.scale), x, y);
    const float fy = floorf(y);
    const float own = fy >= 0.0f ? fminf(fy, static_cast<float>(s.h - 1)) : 0.0f;
    if (!(own >= static_cast<float>(s.row0) && own < static_cast<float>(s.row1))) return;
  }
  const float pr =
      s.red.kind == overlap::kBilinear
          ? overlap::sample_at(s.at, s.h, s.w, p, q.x, q.y, s.ox, s.oy, s.scale, s.unknown)
          : overlap::reduce_at(s.red, s.at, s.h, s.w, p, q.x, q.y, s.ox, s.oy, s.scale,
                               s.unknown);
  num = bw * pr;
  den = bw;
}

// A lane's round of the bilinear reducer in a warp a pair: beams first +
// 32 q (q = 0..3), their endpoints and weights loaded together, their
// positions computed, their 16 taps issued together, then each beam's
// probability and terms added to acc[q], group lane (first mod 128) + 32 q's
// sums: sample_at()'s operations in its order, beam by beam, so its bits; a
// beam of weight 0 or past the scan adds nothing.
template <class Plane>
__device__ __forceinline__ void bilinear_round(const Scan<Plane>& s, const overlap::Pose& p,
                                               int first, float (&acc)[4][2]) {
  float bw[4];
  float2 q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = first + 32 * j;
    const bool in = i < s.r;
    bw[j] = in ? __ldg(s.beam_w + i) : 0.0f;
    q[j] = in ? __ldg(reinterpret_cast<const float2*>(s.pts) + i) : make_float2(0.0f, 0.0f);
  }
  overlap::Taps t[4];
  const float inv = overlap::inv_scale(s.scale);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float x, y;
    overlap::endpoint_cells(p, q[j].x, q[j].y, s.ox, s.oy, inv, x, y);
    t[j] = overlap::read_taps(s.at, s.h, s.w, x, y);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (bw[j] != 0.0f) {
      acc[j][0] += bw[j] * overlap::tap_value(t[j], s.unknown);
      acc[j][1] += bw[j];
    }
  }
}

// The pose poses[0..2] with the cosine and sine of its heading.
__device__ __forceinline__ overlap::Pose pose_at(const float* __restrict__ pose) {
  float sn, cs;
  libm::sincos(__ldg(pose + 2), &sn, &cs);
  return overlap::Pose{__ldg(pose + 0), __ldg(pose + 1), cs, sn};
}

// A beam a thread: the block scores the pose at `pose` and returns the
// group's (num, den) in every lane of warp 0 (others: unspecified). Stamps
// under block index `b`.
template <bool kPartial, class Plane>
__device__ __forceinline__ void beam_block_sums(const Scan<Plane>& s, const float* pose, int b,
                                                float (&sums)[2]) {
  __shared__ float s_terms[2][kMaxThreads];
  const int t = threadIdx.x;
  const int n_t = blockDim.x;
  if (t == 0) {
    PROBE_STAMP(b, probe::kStart);
    PROBE_STAMP_NS(b, probe::kStartNs);
  }
  const overlap::Pose p = pose_at(pose);
  if (t == 0) PROBE_STAMP(b, 2);
  float acc[4][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
  for (int base = 0; base < s.r; base += n_t) {
    if (base + t < s.r) {
      float num, den;
      beam_terms<kPartial>(s, p, base + t, num, den);
      s_terms[0][t] = num;
      s_terms[1][t] = den;
    }
    if (t == 0 && base == 0) PROBE_STAMP(b, 3);
    __syncthreads();
    if (t == 0 && base == 0) PROBE_STAMP(b, 4);
    if (t < 32) overlap::fold_terms<2>(acc, &s_terms[0][0], kMaxThreads, min(n_t, s.r - base), t);
    if (base + n_t < s.r) __syncthreads();  // the next chunk's terms overwrite these
  }
  if (t < 32) overlap::fold_tree<2>(acc, sums);
  if (t == 0) {
    PROBE_STAMP(b, 5);
    PROBE_SET(b, kLayoutSlot, 2);
    PROBE_SET(b, kPartsSlot, 4);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
overlap_score_beams_kernel(const float* __restrict__ v, int h, int w,
                           const float* __restrict__ poses, const float* __restrict__ pts,
                           const float* __restrict__ beam_w, int r,
                           const float* __restrict__ origin, float scale, float unknown,
                           const overlap::Reducer red, float* __restrict__ out) {
  const int k = blockIdx.x;
  const int n_k = gridDim.x;
  const long long m = blockIdx.y;
  origin += 2 * m;
  const Scan<overlap::LdgPlane> s{{v + m * h * w, w}, h, w, pts + 2 * m * r, beam_w + m * r, r,
                                  __ldg(origin + 0), __ldg(origin + 1), scale, unknown, red, 0, h};
  const int b = static_cast<int>(m) * n_k + k;
  float sums[2];
  beam_block_sums<false>(s, poses + 3 * (m * n_k + k), b, sums);
  if (threadIdx.x == 0) {
    out[m * n_k + k] = overlap::weighted_mean(sums[0], sums[1]);
    PROBE_STAMP(b, probe::kEnd);
    PROBE_STAMP_NS(b, probe::kEndNs);
  }
}

// A group of 128 threads a (pose, map), the map on the grid's y axis: the
// kernel's first layout, kept as it was for the grids between the other
// two (thread 0 takes the pose's cos and sin, the threads stride over the
// beams, overlap::group_reduce's tree).
__global__ void __launch_bounds__(kGroup)
overlap_score_group_kernel(const float* __restrict__ v, int h, int w,
                           const float* __restrict__ poses, const float* __restrict__ pts,
                           const float* __restrict__ beam_w, int r,
                           const float* __restrict__ origin, float scale, float unknown,
                           const overlap::Reducer red, float* __restrict__ out) {
  __shared__ float trig[2];
  __shared__ float s_num[kGroup];
  __shared__ float s_den[kGroup];

  const int k = blockIdx.x;
  const int n_k = gridDim.x;
  const size_t m = blockIdx.y;
  const int b = static_cast<int>(m) * n_k + k;
  if (threadIdx.x == 0) {
    PROBE_STAMP(b, probe::kStart);
    PROBE_STAMP_NS(b, probe::kStartNs);
  }
  v += m * h * w;
  poses += m * n_k * 3;
  pts += m * r * 2;
  beam_w += m * r;
  origin += m * 2;
  out += m * n_k;
  if (threadIdx.x == 0) {
    const float th = poses[3 * k + 2];
    trig[0] = libm::cos(th);
    trig[1] = libm::sin(th);
  }
  __syncthreads();
  if (threadIdx.x == 0) PROBE_STAMP(b, 2);
  const overlap::Pose p{poses[3 * k + 0], poses[3 * k + 1], trig[0], trig[1]};

  float num, den;
  overlap::beam_sums(v, h, w, p, pts, beam_w, r, threadIdx.x, __ldg(origin + 0),
                     __ldg(origin + 1), scale, unknown, red, num, den);
  if (threadIdx.x == 0) PROBE_STAMP(b, 3);
  overlap::group_reduce(num, den, s_num, s_den, threadIdx.x, 0);
  if (threadIdx.x == 0) {
    PROBE_STAMP(b, 4);
    out[k] = overlap::weighted_mean(num, den);
    PROBE_SET(b, kLayoutSlot, 1);
    PROBE_SET(b, kPartsSlot, 3);
    PROBE_STAMP(b, probe::kEnd);
    PROBE_STAMP_NS(b, probe::kEndNs);
  }
}

// A warp a (pose, map), pair = m * n_k + k, kWarpsPerBlock pairs a block:
// lane l keeps group lanes l, l + 32, l + 64 and l + 96's sums in its
// registers (beams l + 32 q + 128 j, in order), then fold_tree.
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
overlap_score_warps_kernel(const float* __restrict__ v, int h, int w, int n_k, int n_pairs,
                           const float* __restrict__ poses, const float* __restrict__ pts,
                           const float* __restrict__ beam_w, int r,
                           const float* __restrict__ origin, float scale, float unknown,
                           const overlap::Reducer red, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= n_pairs) return;  // the whole warp
  if (lane == 0) {
    PROBE_STAMP(pair, probe::kStart);
    PROBE_STAMP_NS(pair, probe::kStartNs);
  }
  const long long m = pair / n_k;
  origin += 2 * m;
  const Scan<overlap::LdgPlane> s{{v + m * h * w, w}, h, w, pts + 2 * m * r, beam_w + m * r, r,
                                  __ldg(origin + 0), __ldg(origin + 1), scale, unknown, red, 0, h};
  const overlap::Pose p = pose_at(poses + 3 * static_cast<long long>(pair));
  if (lane == 0) PROBE_STAMP(pair, 2);
  float acc[4][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
  if (red.kind == overlap::kBilinear) {
    for (int base = 0; base < r; base += kGroup) bilinear_round(s, p, base + lane, acc);
  } else {
    for (int base = 0; base < r; base += kGroup) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = base + lane + 32 * q;
        if (i < r) {
          float num, den;
          beam_terms<false>(s, p, i, num, den);
          acc[q][0] += num;
          acc[q][1] += den;
        }
      }
    }
  }
  if (lane == 0) PROBE_STAMP(pair, 3);
  float sums[2];
  overlap::fold_tree<2>(acc, sums);
  if (lane == 0) {
    PROBE_STAMP(pair, 4);
    out[pair] = overlap::weighted_mean(sums[0], sums[1]);
    PROBE_SET(pair, kLayoutSlot, 3);
    PROBE_SET(pair, kPartsSlot, 3);
    PROBE_STAMP(pair, probe::kEnd);
    PROBE_STAMP_NS(pair, probe::kEndNs);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
overlap_score_partial_kernel(const float* __restrict__ band, int g0, int h, int w,
                             const float* __restrict__ poses, const float* __restrict__ pts,
                             const float* __restrict__ beam_w, int r,
                             const float* __restrict__ origin, float scale, float unknown,
                             const overlap::Reducer red, int row0, int row1,
                             float* __restrict__ out) {
  const int k = blockIdx.x;
  const Scan<BandPlane> s{{band, w, g0}, h, w, pts, beam_w, r, __ldg(origin + 0),
                          __ldg(origin + 1), scale, unknown, red, row0, row1};
  float sums[2];
  beam_block_sums<true>(s, poses + 3 * k, k, sums);
  if (threadIdx.x == 0) {
    out[2 * k + 0] = sums[0];
    out[2 * k + 1] = sums[1];
    PROBE_STAMP(k, probe::kEnd);
    PROBE_STAMP_NS(k, probe::kEndNs);
  }
}

// A beam-a-thread block: a warp a beam up to 1,024 beams (32 warps).
int beam_threads(int r) {
  return r <= 0 ? 32 : r >= kMaxThreads ? kMaxThreads : 32 * ((r + 31) / 32);
}

}  // namespace

PROBE_EXPORT(overlap_score_probe_stamps)

// The layout a launch of `pairs` (pose, map) pairs and r beams runs: 0 a
// beam a thread, 1 a group a pair, 2 a warp a pair (kernels.overlap_score_layout,
// for the card tests that hold the layouts to each other at each boundary).
extern "C" int overlap_score_layout(long long pairs, int r) { return layout_of(pairs, r); }

// band f32[he, w]: rows [g0, g0 + he) of an h x w plane, which must hold
// every row a tap of an owned beam reads (the wrapper checks it); poses
// f32[k, 3], pts f32[r, 2], beam_w f32[r], origin f32[2] -> out f32[k, 2],
// (num, den) over the beams whose centre row lies in [row0, row1).
extern "C" int overlap_score_partial_launch(const float* band, int g0, int he, int h, int w,
                                            const float* poses, int k, const float* pts,
                                            const float* beam_w, int r, const float* origin,
                                            float scale, float unknown, int reducer, int radius,
                                            float extent, int row0, int row1, float* out,
                                            void* stream) {
  overlap::Reducer red;
  if (!overlap::make_reducer(reducer, radius, extent, &red) || he <= 0 || h <= 0 || w <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k <= 0) return 0;
  overlap_score_partial_kernel<<<k, beam_threads(r), 0, static_cast<cudaStream_t>(stream)>>>(
      band, g0, h, w, poses, pts, beam_w, r, origin, scale, unknown, red, row0, row1, out);
  return static_cast<int>(cudaGetLastError());
}

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
  const auto s = static_cast<cudaStream_t>(stream);
  const long long pairs = static_cast<long long>(k) * m;
  switch (layout_of(pairs, r)) {
    case kBeamLayout:
      overlap_score_beams_kernel<<<dim3(k, m), beam_threads(r), 0, s>>>(
          v, h, w, poses, pts, beam_w, r, origin, scale, unknown, red, out);
      break;
    case kGroupLayout:
      overlap_score_group_kernel<<<dim3(k, m), kGroup, 0, s>>>(v, h, w, poses, pts, beam_w, r,
                                                                origin, scale, unknown, red, out);
      break;
    case kWarpLayout:
      if (pairs > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
      overlap_score_warps_kernel<<<(pairs + kWarpsPerBlock - 1) / kWarpsPerBlock,
                                   32 * kWarpsPerBlock, 0, s>>>(
          v, h, w, k, static_cast<int>(pairs), poses, pts, beam_w, r, origin, scale, unknown, red,
          out);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
