// overlap_sample.cuh: the per-beam arithmetic of the scan-overlap score,
// shared by overlap_score.cu (one launch scores K poses on M planes),
// overlap_score_grad.cu (the score and its pose gradient) and mc_match.cu
// (one launch runs whole Monte-Carlo matches), so that all give the same
// bits for the same pose. A plane is read through an accessor: the
// plane itself (LdgPlane), or a window of a map read in place (MapWindow),
// which gives the cells the cut-out window would hold.
//
// sample_at() is the math of the TPU kernel's body (slam_constructor_tpu/ops/
// pallas_kernels.py: _bilinear_kernel): per axis i0 = floor(pos - 0.5) and
// w0 = i0 + 1.5 - pos; taps i0 and i0 + 1 count only inside [0, n);
// coverage = (sum of row taps) * (sum of col taps); the result is
// ssum + (1 - coverage) * unknown, so mass off the map reads `unknown`.
//
// Numerics: the sources that include this are built without
// --use_fast_math and with --fmad=false, so each product and sum rounds on
// its own, as the plain PyTorch twin's separate ops do. The arithmetic
// order is the reference's: world = p + R(theta) pt (x = px + c qx - s qy),
// minus the origin, then DIVIDED by scale (IEEE division, no reciprocal).

#pragma once

#include <cuda_runtime.h>

namespace overlap {

// threads that share one pose: they stride over the beams and their
// partial sums meet in a fixed-order tree
constexpr int kGroupThreads = 128;
static_assert(kGroupThreads == 128, "group_reduce is written for four warps");

struct AxisTaps {
  float a0, a1;  // weights of taps i0 and i0 + 1, zero where off the map
  float d0, d1;  // their derivatives along the axis: -1 and +1, zero off the map
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
  t.d0 = ok0 ? -1.0f : 0.0f;
  t.d1 = ok1 ? 1.0f : 0.0f;
  // clamp in float before converting: the comparison also sends NaN to 0
  const float c0 = f >= 0.0f ? fminf(f, fn - 1.0f) : 0.0f;
  const float c1 = f + 1.0f >= 0.0f ? fminf(f + 1.0f, fn - 1.0f) : 0.0f;
  t.i0 = static_cast<int>(c0);
  t.i1 = static_cast<int>(c1);
  return t;
}

// A pose with the cosine and sine of its heading.
struct Pose {
  float x, y, c, s;
};

// The plane's cell (row, col) read through __ldg from v f32[h, w].
struct LdgPlane {
  const float* __restrict__ v;
  int w;
  __device__ __forceinline__ float operator()(int row, int col) const {
    return __ldg(v + row * w + col);
  }
};

// Cell (row, col) of a window of a map, read in place: where(known, occ,
// unknown) at the map's cell (row, col) counted from the window's first
// cell. occ steps occ_stride floats a cell (a channel of the map's cells);
// a row of the map is `pitch` cells.
struct MapWindow {
  const float* __restrict__ occ;            // at the window's first cell
  const unsigned char* __restrict__ known;  // at the window's first cell
  int pitch;
  int occ_stride;
  float unknown;
  __device__ __forceinline__ float operator()(int row, int col) const {
    const int i = row * pitch + col;
    const float o = __ldg(occ + static_cast<long long>(i) * occ_stride);
    return __ldg(known + i) ? o : unknown;
  }
};

// The 2 x 2 taps of a fractional cell position (x, y) on an h x w plane
// whose cells `at(row, col)` reads. A tap off the map has weight 0 and
// reads 0, as the one-hot of the reference never matches it.
struct Taps {
  AxisTaps ry, cx;
  float v00, v10, v01, v11;
};

template <class Plane>
__device__ __forceinline__ Taps read_taps(const Plane& at, int h, int w, float x, float y) {
  Taps t;
  t.ry = axis_taps(y, h);
  t.cx = axis_taps(x, w);
  const AxisTaps& ry = t.ry;
  const AxisTaps& cx = t.cx;
  t.v00 = (ry.a0 != 0.0f && cx.a0 != 0.0f) ? at(ry.i0, cx.i0) : 0.0f;
  t.v10 = (ry.a1 != 0.0f && cx.a0 != 0.0f) ? at(ry.i1, cx.i0) : 0.0f;
  t.v01 = (ry.a0 != 0.0f && cx.a1 != 0.0f) ? at(ry.i0, cx.i1) : 0.0f;
  t.v11 = (ry.a1 != 0.0f && cx.a1 != 0.0f) ? at(ry.i1, cx.i1) : 0.0f;
  return t;
}

// The overlap probability from the taps: rows first, then columns (the
// order of the reference's a @ plane . b); mass off the map reads unknown.
__device__ __forceinline__ float tap_value(const Taps& t, float unknown) {
  const AxisTaps& ry = t.ry;
  const AxisTaps& cx = t.cx;
  const float ssum = (ry.a0 * t.v00 + ry.a1 * t.v10) * cx.a0 +
                     (ry.a0 * t.v01 + ry.a1 * t.v11) * cx.a1;
  const float coverage = (ry.a0 + ry.a1) * (cx.a0 + cx.a1);
  return ssum + (1.0f - coverage) * unknown;
}

// Overlap probability of the endpoint (qx, qy), given in the sensor frame,
// seen from `p`, on an h x w plane whose cells `at(row, col)` reads.
template <class Plane>
__device__ __forceinline__ float sample_at(const Plane& at, int h, int w, const Pose& p,
                                           float qx, float qy, float ox, float oy,
                                           float scale, float unknown) {
  const float wx = (p.x + p.c * qx) - p.s * qy;
  const float wy = (p.y + p.s * qx) + p.c * qy;
  const float x = (wx - ox) / scale;
  const float y = (wy - oy) / scale;
  return tap_value(read_taps(at, h, w, x, y), unknown);
}

// sample_at() and its gradient with respect to the pose (gx, gy, gth). In
// cell units the value is bilinear in (x, y): each axis weight moves by -1
// (tap i0) or +1 (tap i1) where the tap lies on the map, and the mass that
// leaves the map enters through the `unknown` fill, (1 - coverage) *
// unknown. Then the chain to the pose: d(x, y)/d(px, py) = 1 / scale and
// d(wx, wy)/dtheta = (-s qx - c qy, c qx - s qy). The value is sample_at's
// bits. Where a coordinate sits on a cell centre (a tap changes) the
// derivative is the one of the side the floor picks.
template <class Plane>
__device__ __forceinline__ float sample_grad_at(const Plane& at, int h, int w, const Pose& p,
                                                float qx, float qy, float ox, float oy,
                                                float scale, float unknown, float& gx,
                                                float& gy, float& gth) {
  const float wx = (p.x + p.c * qx) - p.s * qy;
  const float wy = (p.y + p.s * qx) + p.c * qy;
  const float x = (wx - ox) / scale;
  const float y = (wy - oy) / scale;
  const Taps t = read_taps(at, h, w, x, y);
  const AxisTaps& ry = t.ry;
  const AxisTaps& cx = t.cx;
  const float dx = ((ry.a0 * t.v00 + ry.a1 * t.v10) * cx.d0 +
                    (ry.a0 * t.v01 + ry.a1 * t.v11) * cx.d1) -
                   ((ry.a0 + ry.a1) * (cx.d0 + cx.d1)) * unknown;
  const float dy = ((ry.d0 * t.v00 + ry.d1 * t.v10) * cx.a0 +
                    (ry.d0 * t.v01 + ry.d1 * t.v11) * cx.a1) -
                   ((ry.d0 + ry.d1) * (cx.a0 + cx.a1)) * unknown;
  gx = dx / scale;
  gy = dy / scale;
  gth = (dx * (-p.s * qx - p.c * qy) + dy * (p.c * qx - p.s * qy)) / scale;
  return tap_value(t, unknown);
}

// One thread's share of a pose's score: beams t, t + kGroupThreads, ... in
// that order; beams of weight 0 (invalid) are skipped.
template <class Plane>
__device__ __forceinline__ void beam_sums_at(const Plane& at, int h, int w, const Pose& p,
                                             const float* pts, const float* beam_w, int r,
                                             int t, float ox, float oy, float scale,
                                             float unknown, float& num, float& den) {
  num = 0.0f;
  den = 0.0f;
  for (int i = t; i < r; i += kGroupThreads) {
    const float bw = beam_w[i];
    if (bw == 0.0f) continue;
    const float pr = sample_at(at, h, w, p, pts[2 * i + 0], pts[2 * i + 1], ox, oy, scale,
                               unknown);
    num += bw * pr;
    den += bw;
  }
}

__device__ __forceinline__ void beam_sums(const float* __restrict__ v, int h, int w,
                                          const Pose& p, const float* pts,
                                          const float* beam_w, int r, int t, float ox,
                                          float oy, float scale, float unknown,
                                          float& num, float& den) {
  beam_sums_at(LdgPlane{v, w}, h, w, p, pts, beam_w, r, t, ox, oy, scale, unknown, num, den);
}

// Barrier `id` for the kGroupThreads threads of one group (id 0 is the one
// __syncthreads() uses; a block of several groups gives each its own).
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kGroupThreads) : "memory");
}

// Sums the group's per-thread (num, den) in a fixed order, so a score is
// the same bits on every run and in every kernel: the tree s[t] += s[t +
// stride] for stride = 64, 32, ..., 1, the levels across warps through
// shared memory (s_num, s_den: kGroupThreads floats each, the group's
// own), the levels inside the first warp through shuffles, which add the
// same pairs. The sums are valid in thread t == 0. The last barrier frees
// s_num and s_den for the group's next use.
__device__ __forceinline__ void group_reduce(float& num, float& den, float* s_num,
                                             float* s_den, int t, int barrier_id) {
  s_num[t] = num;
  s_den[t] = den;
  group_sync(barrier_id);
  if (t < 64) {
    num = s_num[t] + s_num[t + 64];
    den = s_den[t] + s_den[t + 64];
    s_num[t] = num;
    s_den[t] = den;
  }
  group_sync(barrier_id);
  if (t < 32) {
    num = s_num[t] + s_num[t + 32];
    den = s_den[t] + s_den[t + 32];
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1) {
      num += __shfl_down_sync(0xffffffffu, num, stride);
      den += __shfl_down_sync(0xffffffffu, den, stride);
    }
  }
  group_sync(barrier_id);
}

// The score from the reduced sums.
__device__ __forceinline__ float weighted_mean(float num, float den) {
  return num / fmaxf(den, 1e-9f);
}

}  // namespace overlap

// Stamps for scripts/torch_port/kernel_probe.py, which builds the sources
// with -DSLAM_KERNEL_PROBE: one thread a block writes clock64() at the
// boundaries of its work into the slots of its block, and %globaltimer at
// its start and end, so the probe can split a round into parts and turn
// cycles into time. The package's own build defines nothing of it.
namespace probe {
constexpr int kSlots = 64;    // a block's slots
constexpr int kBlocks = 256;  // blocks stamped (the first ones of the grid)
// slots: start (clock64, globaltimer), set-up done, first score done, then
// kParts a round from kRound on, and the end (clock64, globaltimer)
constexpr int kStart = 0, kStartNs = 1, kSetup = 2, kFirst = 3, kRound = 4, kParts = 5;
constexpr int kEnd = 62, kEndNs = 63;
}  // namespace probe

#ifdef SLAM_KERNEL_PROBE
namespace probe {
static __device__ unsigned long long stamps[kBlocks * kSlots];
__device__ __forceinline__ unsigned long long ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void stamp(int block, int slot, unsigned long long v) {
  if (block < kBlocks && slot < kSlots) stamps[block * kSlots + slot] = v;
}
}  // namespace probe
#define PROBE_STAMP(block, slot) probe::stamp((block), (slot), clock64())
#define PROBE_STAMP_NS(block, slot) probe::stamp((block), (slot), probe::ns())
// a source's host function that copies its stamps out: int name(void* dst)
#define PROBE_EXPORT(name)                                                        \
  extern "C" int name(void* dst) {                                                 \
    return static_cast<int>(cudaMemcpyFromSymbol(dst, probe::stamps,              \
                                                 sizeof(probe::stamps)));          \
  }
#else
#define PROBE_STAMP(block, slot) ((void)(block), (void)(slot))
#define PROBE_STAMP_NS(block, slot) ((void)(block), (void)(slot))
#define PROBE_EXPORT(name)
#endif
