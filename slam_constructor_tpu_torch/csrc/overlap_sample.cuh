// overlap_sample.cuh: the per-beam arithmetic of the scan score, shared by
// overlap_score.cu (one launch scores K poses on M planes),
// overlap_score_grad.cu (the score and its pose gradient), mc_match.cu (one
// launch runs whole Monte-Carlo matches) and climb.cuh (the hill climb of
// hill_climb.cu and m3rsm_match.cu), so that all give the same bits for the
// same pose. A plane is read through an accessor: the plane itself
// (LdgPlane), or a window of a map read in place (MapWindow), which gives
// the cells the cut-out window would hold.
//
// A beam's endpoint reads the plane as its Reducer says (reduce_at(), the
// reference's gather path, slam_constructor_tpu/ops/scoring.py:score_poses):
// kBilinear, the overlap reducer at extent 1 with a window of at least one
// cell, is sample_at() below (the Pallas kernel's bilinear taps); kObstacle
// reads the cell (floor(y), floor(x)); kMax and kMean the max and the mean
// of the (2 radius + 1)^2 cells around it, rows outer and columns inner (the
// reference's meshgrid(ij) order); kOverlap the general overlap reducer: each
// of those cells weighted by its overlap with the endpoint's square of side
// `extent`, the sum divided by the sum of the weights. A cell off the map
// (or off the window read in place) reads `unknown` for these, as
// grid.gather_plane fills it. The cell is compared in float before it is
// converted, so a NaN or huge position lands off the map. The code is one
// uniform value a launch: beam_sums_at() keeps the bilinear loop as it was
// and takes the other reducers in a second loop (inlined, or called).
//
// sample_at() is the math of the TPU kernel's body (slam_constructor_tpu/ops/
// pallas_kernels.py: _bilinear_kernel): per axis i0 = floor(pos - 0.5) and
// w0 = i0 + 1.5 - pos; taps i0 and i0 + 1 count only inside [0, n);
// coverage = (sum of row taps) * (sum of col taps); the result is
// ssum + (1 - coverage) * unknown, so mass off the map reads `unknown`.
//
// Numerics: the sources that include this are built without
// --use_fast_math and with --fmad=false, so each product and sum rounds on
// its own, as the plain PyTorch twin's separate ops do. An endpoint's cell
// coordinates are the reference's jitted arithmetic (endpoint_cells(),
// grid.endpoint_cells): the rotation fused into two multiply-adds a
// coordinate, minus the origin, times the float32 reciprocal of the cell size.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "libm.cuh"

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

// On a cell's centre (pos - 0.5 an integer) the taps are that cell (weight
// 1) and the next (weight 0), or with `left` the one before (weight 0) and
// that cell: the same value, the derivative of either side.
__device__ __forceinline__ AxisTaps axis_taps(float pos, int n, bool left = false) {
  const float f = left ? ceilf(pos - 0.5f) - 1.0f : floorf(pos - 0.5f);
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

// 1 / scale rounded once: what XLA folds the reference's division by the
// static cell size into (ROADMAP trap m).
__device__ __forceinline__ float inv_scale(float scale) { return 1.0f / scale; }

// The cell coordinates (x, y) of the endpoint (qx, qy), given in the sensor
// frame, seen from `p`, on a plane whose lower-left corner is (ox, oy): the
// reference's jitted (apply_pose(p, q) - origin) / scale, that is
// (fma(-s, qy, fma(c, qx, px)) - ox) * inv (grid.endpoint_cells).
__device__ __forceinline__ void endpoint_cells(const Pose& p, float qx, float qy, float ox,
                                               float oy, float inv, float& x, float& y) {
  x = (libm::fma32(-p.s, qy, libm::fma32(p.c, qx, p.x)) - ox) * inv;
  y = (libm::fma32(p.c, qy, libm::fma32(p.s, qx, p.y)) - oy) * inv;
}

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
// reads 0, as the one-hot of the reference never matches it. A tap of
// weight 0 on the map (on a cell's centre) is read: the derivative on its
// side takes its cell. A derivative d0 or d1 is nonzero where its tap
// lies on the map.
struct Taps {
  AxisTaps ry, cx;
  float v00, v10, v01, v11;
};

template <class Plane>
__device__ __forceinline__ Taps read_taps(const Plane& at, int h, int w, float x, float y,
                                          bool left = false) {
  Taps t;
  t.ry = axis_taps(y, h, left);
  t.cx = axis_taps(x, w, left);
  const AxisTaps& ry = t.ry;
  const AxisTaps& cx = t.cx;
  t.v00 = (ry.d0 != 0.0f && cx.d0 != 0.0f) ? at(ry.i0, cx.i0) : 0.0f;
  t.v10 = (ry.d1 != 0.0f && cx.d0 != 0.0f) ? at(ry.i1, cx.i0) : 0.0f;
  t.v01 = (ry.d0 != 0.0f && cx.d1 != 0.0f) ? at(ry.i0, cx.i1) : 0.0f;
  t.v11 = (ry.d1 != 0.0f && cx.d1 != 0.0f) ? at(ry.i1, cx.i1) : 0.0f;
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
  const float inv = inv_scale(scale);
  float x, y;
  endpoint_cells(p, qx, qy, ox, oy, inv, x, y);
  return tap_value(read_taps(at, h, w, x, y), unknown);
}

// The derivatives of tap_value() along x and along y, in cell units: each
// axis weight moves by -1 (tap i0) or +1 (tap i1) where the tap lies on the
// map, and the mass that leaves the map enters through the `unknown` fill,
// (1 - coverage) * unknown.
__device__ __forceinline__ float tap_dx(const Taps& t, float unknown) {
  const AxisTaps& ry = t.ry;
  const AxisTaps& cx = t.cx;
  return ((ry.a0 * t.v00 + ry.a1 * t.v10) * cx.d0 + (ry.a0 * t.v01 + ry.a1 * t.v11) * cx.d1) -
         ((ry.a0 + ry.a1) * (cx.d0 + cx.d1)) * unknown;
}
__device__ __forceinline__ float tap_dy(const Taps& t, float unknown) {
  const AxisTaps& ry = t.ry;
  const AxisTaps& cx = t.cx;
  return ((ry.d0 * t.v00 + ry.d1 * t.v10) * cx.a0 + (ry.d0 * t.v01 + ry.d1 * t.v11) * cx.a1) -
         ((ry.d0 + ry.d1) * (cx.a0 + cx.a1)) * unknown;
}

// sample_at() and its gradient with respect to the pose (gx, gy, gth): the
// value is bilinear in (x, y) (tap_dx, tap_dy), then the chain to the pose:
// d(x, y)/d(px, py) = inv_scale(scale), the reciprocal the value multiplies
// by (the reference's jax.grad of the product), and d(wx, wy)/dtheta =
// (-s qx - c qy, c qx - s qy). The value is sample_at's bits. Where a
// coordinate sits on a cell's centre (a tap changes) the derivative is the
// mean of its two sides', 0.5 dR + 0.5 dL, as the reference's jax.grad
// gives it (its max and min split a tie evenly); the plain twin halves and
// adds the two sides' taps likewise.
template <class Plane>
__device__ __forceinline__ float sample_grad_at(const Plane& at, int h, int w, const Pose& p,
                                                float qx, float qy, float ox, float oy,
                                                float scale, float unknown, float& gx,
                                                float& gy, float& gth) {
  const float inv = inv_scale(scale);
  float x, y;
  endpoint_cells(p, qx, qy, ox, oy, inv, x, y);
  const Taps t = read_taps(at, h, w, x, y);
  float dx = tap_dx(t, unknown);
  float dy = tap_dy(t, unknown);
  const float xc = x - 0.5f;
  const float yc = y - 0.5f;
  if (floorf(xc) == xc || floorf(yc) == yc) {
    // off a centre the left taps are the same, and so is the mean
    const Taps l = read_taps(at, h, w, x, y, true);
    dx = 0.5f * dx + 0.5f * tap_dx(l, unknown);
    dy = 0.5f * dy + 0.5f * tap_dy(l, unknown);
  }
  gx = dx * inv;
  gy = dy * inv;
  gth = (dx * (-p.s * qx - p.c * qy) + dy * (p.c * qx - p.s * qy)) * inv;
  return tap_value(t, unknown);
}

// How a beam's endpoint reads the plane: the codes of kernels.Reducer.
enum ReducerKind : int { kBilinear = 0, kObstacle = 1, kMax = 2, kMean = 3, kOverlap = 4 };

struct Reducer {
  int kind;      // a ReducerKind
  int radius;    // the window's radius in cells (kMax, kMean, kOverlap)
  float extent;  // the side of the endpoint's square in cells (kOverlap)
};

// jnp.maximum / jnp.minimum: NaN if either is NaN (fmaxf and fminf drop it).
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) || isnan(b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) || isnan(b) ? a + b : fminf(a, b);
}

// The plane at the cell (fy, fx) (floats that hold integers, or NaN), or
// `unknown` where it lies off the h x w plane; compared before the cast.
template <class Plane>
__device__ __forceinline__ float cell_or_unknown(const Plane& at, int h, int w, float fy, float fx,
                                                 float unknown) {
  const bool ok = fy >= 0.0f && fy < static_cast<float>(h) && fx >= 0.0f &&
                  fx < static_cast<float>(w);
  return ok ? at(static_cast<int>(fy), static_cast<int>(fx)) : unknown;
}

// The probability of the endpoint (qx, qy), given in the sensor frame, seen
// from `p`, by a reducer other than kBilinear (see the head of this file).
// The position is sample_at()'s, op by op.
template <class Plane>
__device__ __forceinline__ float reduce_at(const Reducer& red, const Plane& at, int h, int w,
                                           const Pose& p, float qx, float qy, float ox,
                                           float oy, float scale, float unknown) {
  const float inv = inv_scale(scale);
  float x, y;
  endpoint_cells(p, qx, qy, ox, oy, inv, x, y);
  const float fx = floorf(x);
  const float fy = floorf(y);
  if (red.kind == kObstacle) return cell_or_unknown(at, h, w, fy, fx, unknown);
  const int n = red.radius;
  if (red.kind == kOverlap) {
    // the square [e - half, e + half) per axis, e the position in its cell,
    // against cell d's [d, d + 1): the reference's closed form
    const float half = 0.5f * red.extent;
    const float ex = x - fx;
    const float ey = y - fy;
    float num = 0.0f, wsum = 0.0f;
    for (int dr = -n; dr <= n; ++dr) {
      const float d = static_cast<float>(dr);
      const float len_y = max_nan(min_nan(d + 1.0f, ey + half) - max_nan(d, ey - half), 0.0f);
      for (int dc = -n; dc <= n; ++dc) {
        const float e = static_cast<float>(dc);
        const float len_x = max_nan(min_nan(e + 1.0f, ex + half) - max_nan(e, ex - half), 0.0f);
        const float wgt = len_x * len_y;
        wsum += wgt;
        num += cell_or_unknown(at, h, w, fy + d, fx + e, unknown) * wgt;
      }
    }
    return num / max_nan(wsum, 1e-9f);
  }
  // kMax, kMean: rows outer, columns inner; a NaN cell makes the max NaN
  float acc = red.kind == kMax ? -CUDART_INF_F : 0.0f;
  for (int dr = -n; dr <= n; ++dr) {
    for (int dc = -n; dc <= n; ++dc) {
      const float v = cell_or_unknown(at, h, w, fy + static_cast<float>(dr),
                                      fx + static_cast<float>(dc), unknown);
      if (red.kind == kMax) {
        acc = (v > acc || isnan(v)) ? v : acc;
      } else {
        acc += v;
      }
    }
  }
  if (red.kind == kMax) return acc;
  const int side = 2 * n + 1;
  return acc / static_cast<float>(side * side);
}

// The derivative of one axis' overlap length max(min(d + 1, e + half) -
// max(d, e - half), 0) by the position e: +1 while the square's upper edge
// lies inside cell d's, -1 while its lower edge does, 0 where the length is
// 0. At a kink (an edge of the square on a cell's edge) the side the
// comparisons pick.
__device__ __forceinline__ float overlap_len_grad(float d, float e, float half, float len) {
  if (!(len > 0.0f)) return 0.0f;
  return (e + half < d + 1.0f ? 1.0f : 0.0f) - (e - half > d ? 1.0f : 0.0f);
}

// reduce_at() and its gradient with respect to the pose (gx, gy, gth); the
// value is reduce_at's bits (the same operations in the same order).
// kObstacle, kMax and kMean are piecewise constant in the pose: their
// derivative is 0, as the reference's jax.grad gives. kOverlap: the value
// p = num / max(wsum, 1e-9), num = sum_c v_c wgt_c, wgt_c = len_x len_y,
// each length piecewise linear in the endpoint's position in its cell, so
// dp = (dnum - p dwsum) / wsum (dnum / 1e-9 where the floor holds). At
// radius 0 the square meets one cell and, above the floor, p is that
// cell's value: the derivative is 0 there (the quotient rule would leave
// rounding noise, which the reference's autodiff turns into a full unit
// step). Then the chain to the pose, as sample_grad_at's.
template <class Plane>
__device__ __forceinline__ float reduce_grad_at(const Reducer& red, const Plane& at, int h, int w,
                                                const Pose& p, float qx, float qy, float ox,
                                                float oy, float scale, float unknown, float& gx,
                                                float& gy, float& gth) {
  gx = 0.0f;
  gy = 0.0f;
  gth = 0.0f;
  if (red.kind != kOverlap) return reduce_at(red, at, h, w, p, qx, qy, ox, oy, scale, unknown);
  const float inv = inv_scale(scale);
  float x, y;
  endpoint_cells(p, qx, qy, ox, oy, inv, x, y);
  const float fx = floorf(x);
  const float fy = floorf(y);
  const int n = red.radius;
  const float half = 0.5f * red.extent;
  const float ex = x - fx;
  const float ey = y - fy;
  float num = 0.0f, wsum = 0.0f;
  float dnum_x = 0.0f, dnum_y = 0.0f, dw_x = 0.0f, dw_y = 0.0f;
  for (int dr = -n; dr <= n; ++dr) {
    const float d = static_cast<float>(dr);
    const float len_y = max_nan(min_nan(d + 1.0f, ey + half) - max_nan(d, ey - half), 0.0f);
    const float dlen_y = overlap_len_grad(d, ey, half, len_y);
    for (int dc = -n; dc <= n; ++dc) {
      const float e = static_cast<float>(dc);
      const float len_x = max_nan(min_nan(e + 1.0f, ex + half) - max_nan(e, ex - half), 0.0f);
      const float dlen_x = overlap_len_grad(e, ex, half, len_x);
      const float wgt = len_x * len_y;
      const float v = cell_or_unknown(at, h, w, fy + d, fx + e, unknown);
      wsum += wgt;
      num += v * wgt;
      const float wdx = dlen_x * len_y;
      const float wdy = len_x * dlen_y;
      dw_x += wdx;
      dw_y += wdy;
      dnum_x += v * wdx;
      dnum_y += v * wdy;
    }
  }
  const float den = max_nan(wsum, 1e-9f);
  const float val = num / den;
  float dx = 0.0f, dy = 0.0f;
  if (!(wsum >= 1e-9f)) {  // the floor holds: p = num / 1e-9
    dx = dnum_x / den;
    dy = dnum_y / den;
  } else if (n > 0) {
    dx = (dnum_x - val * dw_x) / den;
    dy = (dnum_y - val * dw_y) / den;
  }
  gx = dx * inv;
  gy = dy * inv;
  gth = (dx * (-p.s * qx - p.c * qy) + dy * (p.c * qx - p.s * qy)) * inv;
  return val;
}

// A beam's probability by `red` and its pose gradient: sample_grad_at() for
// kBilinear, reduce_grad_at() for the others (the value has the bits of
// sample_at() or reduce_at()).
template <class Plane>
__device__ __forceinline__ float grad_at(const Reducer& red, const Plane& at, int h, int w,
                                         const Pose& p, float qx, float qy, float ox, float oy,
                                         float scale, float unknown, float& gx, float& gy,
                                         float& gth) {
  if (red.kind == kBilinear) {
    return sample_grad_at(at, h, w, p, qx, qy, ox, oy, scale, unknown, gx, gy, gth);
  }
  return reduce_grad_at(red, at, h, w, p, qx, qy, ox, oy, scale, unknown, gx, gy, gth);
}

// beam_sums_at() for a reducer other than kBilinear: the same beams in the
// same order.
template <class Plane>
__device__ __forceinline__ void beam_sums_reduced(const Plane& at, int h, int w, const Pose& p,
                                                  const float* pts, const float* beam_w, int r,
                                                  int t, float ox, float oy, float scale,
                                                  float unknown, const Reducer& red, float& num,
                                                  float& den) {
  float n = 0.0f, d = 0.0f;
  for (int i = t; i < r; i += kGroupThreads) {
    const float bw = beam_w[i];
    if (bw == 0.0f) continue;
    const float pr = reduce_at(red, at, h, w, p, pts[2 * i + 0], pts[2 * i + 1], ox, oy, scale,
                               unknown);
    n += bw * pr;
    d += bw;
  }
  num = n;
  den = d;
}

// The same, not inlined: a kernel that passes kOutlined to beam_sums_at()
// keeps in its bilinear loop the code and the registers it has without the
// other reducers, and pays one call a pass for them.
template <class Plane>
__device__ __noinline__ void beam_sums_outlined(const Plane& at, int h, int w, const Pose& p,
                                                const float* pts, const float* beam_w, int r,
                                                int t, float ox, float oy, float scale,
                                                float unknown, const Reducer& red, float& num,
                                                float& den) {
  beam_sums_reduced(at, h, w, p, pts, beam_w, r, t, ox, oy, scale, unknown, red, num, den);
}

// One thread's share of a pose's score: beams t, t + kGroupThreads, ... in
// that order; beams of weight 0 (invalid) are skipped. kOutlined: the
// reducers other than kBilinear through a call (mc_match.cu: measured
// faster there; inlined, its windows read in place ran 10% slower), else
// inlined (faster in overlap_score.cu and climb.cuh, and in m3rsm_match.cu,
// where the call costs 17%).
template <bool kOutlined = false, class Plane>
__device__ __forceinline__ void beam_sums_at(const Plane& at, int h, int w, const Pose& p,
                                             const float* pts, const float* beam_w, int r,
                                             int t, float ox, float oy, float scale,
                                             float unknown, const Reducer& red, float& num,
                                             float& den) {
  if (red.kind != kBilinear) {
    if constexpr (kOutlined) {
      beam_sums_outlined(at, h, w, p, pts, beam_w, r, t, ox, oy, scale, unknown, red, num, den);
    } else {
      beam_sums_reduced(at, h, w, p, pts, beam_w, r, t, ox, oy, scale, unknown, red, num, den);
    }
    return;
  }
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
                                          const Reducer& red, float& num, float& den) {
  beam_sums_at(LdgPlane{v, w}, h, w, p, pts, beam_w, r, t, ox, oy, scale, unknown, red, num,
               den);
}

// The reducer's code, radius and extent as a launch takes them; false where
// they are not one of the codes above with a radius of 0 to 4096 cells and a
// finite, positive extent.
__host__ __device__ inline bool make_reducer(int kind, int radius, float extent, Reducer* out) {
  if (kind < kBilinear || kind > kOverlap || radius < 0 || radius > 4096 ||
      !(extent > 0.0f && extent < 1e30f)) {
    return false;
  }
  *out = Reducer{kind, radius, extent};
  return true;
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

// One warp's fold of a group's per-beam terms, in the order group_reduce
// gives them: lane l adds to acc[q][k] (q = 0..3) the terms of group lane
// l + 32 q, that is of beams l + 32 q + kGroupThreads j, j = 0, 1, ..., in
// that order, among the first n beams of a chunk; terms[k * stride + i] is
// term k of the chunk's beam i. A chunk of a multiple of kGroupThreads beams
// continues every group lane's sums where the chunk before it left them. A
// beam that is skipped may hold +0.0: a sum that starts at +0.0 is never
// -0.0, so adding +0.0 leaves it as skipping the beam does.
template <int kSums>
__device__ __forceinline__ void fold_terms(float (&acc)[4][kSums], const float* terms, int stride,
                                           int n, int lane) {
  const int groups = (n + kGroupThreads - 1) / kGroupThreads;
#pragma unroll
  for (int j = 0; j < groups; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = lane + 32 * q + kGroupThreads * j;
      if (n % kGroupThreads == 0 || i < n) {
#pragma unroll
        for (int k = 0; k < kSums; ++k) acc[q][k] += terms[k * stride + i];
      }
    }
  }
}

// The group's sums from a warp's fold (fold_terms, or four group lanes'
// sums kept in each lane's registers): the tree's s[l] + s[l + 64], then +
// s[l + 32], as (s[l] + s[l + 64]) + (s[l + 32] + s[l + 96]), then xor
// shuffles from 16 down to 1, which give lane 0 the pairs of group_reduce's
// shfl_down and every lane the same bits (an add is commutative).
template <int kSums>
__device__ __forceinline__ void fold_tree(const float (&acc)[4][kSums], float (&s)[kSums]) {
#pragma unroll
  for (int k = 0; k < kSums; ++k) s[k] = (acc[0][k] + acc[2][k]) + (acc[1][k] + acc[3][k]);
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], stride);
  }
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
#define PROBE_SET(block, slot, value) probe::stamp((block), (slot), (value))
// a source's host function that copies its stamps out: int name(void* dst)
#define PROBE_EXPORT(name)                                                        \
  extern "C" int name(void* dst) {                                                 \
    return static_cast<int>(cudaMemcpyFromSymbol(dst, probe::stamps,              \
                                                 sizeof(probe::stamps)));          \
  }
#else
#define PROBE_STAMP(block, slot) ((void)(block), (void)(slot))
#define PROBE_STAMP_NS(block, slot) ((void)(block), (void)(slot))
#define PROBE_SET(block, slot, value) ((void)(block), (void)(slot), (void)(value))
#define PROBE_EXPORT(name)
#endif
