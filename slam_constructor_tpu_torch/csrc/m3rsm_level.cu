// m3rsm_level.cu: M3RSM's score of the frontier's rects at one pyramid
// level (K4b), for B requests in one launch, for Hopper (sm_90a). Plain C
// interface, bound from Python with ctypes (slam_constructor_tpu_torch/ops/
// kernels.py, built by ops/_build.py).
//
// Replaces what XLA compiled on the TPU for slam_constructor_tpu/ops/
// m3rsm.py:_score_level (the one-hot matmul sampling there, a gather on the
// CPU). For request b, rect k = (theta index t, row offset ty, col offset
// tx) and beam i:
//
//   fine  = c0[b, t, i] + (ty, tx)       the endpoint's level-0 cell
//   v     = max over corners d of window[(fine + d) >> level]
//           d in {(0,0), (0,e), (e,0), (e,e)}, e = 2^level - 1 (one at level 0)
//   score = sum_i v * mask[b, i] / max(sum_i mask[b, i], 1e-9)
//
// The window is the request's prior-centred window of the level plane: its
// first cell (corner[b] >> level) and its wh x ww extent; a cell outside it
// reads `unknown` even where the plane holds a value, as the reference
// slices the plane first. The plane is read in place, never cut out. `>>`
// on a negative cell is arithmetic (a floor), as XLA's shift of an i32 is.
//
// Design: one block of 128 threads a (rect, request), the request on the
// grid's y axis; the threads stride over the beams, keep their partial sums
// in a fixed order and meet in overlap_sample.cuh's fixed-order tree, so a
// score is the same bits from run to run. The plane is read through __ldg;
// the main path's planes (a 160^2 window of a 256^2 map at level 0, 9 KB at
// level 3) stay in L2.
//
// What bounds it on an H100: launch cost. The main path's largest launch is
// 192 rects x 360 beams x 4 taps, 1.1 MB of taps from L2, 0.3 us at 3.35
// TB/s; the bytes it must read (plane, cells, rects, mask) are about 40 KB.

#include <cuda_runtime.h>

#include "overlap_sample.cuh"

namespace {

constexpr int kThreads = overlap::kGroupThreads;

// the larger of a and b, NaN if either is NaN (fmaxf would drop a NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Window {
  const float* __restrict__ plane;  // at the window's first cell
  int pitch;                        // the plane's row, in floats
  int wh, ww;                       // the window's extent at this level
  float unknown;
  __device__ __forceinline__ float operator()(int row, int col) const {
    const bool in = row >= 0 && row < wh && col >= 0 && col < ww;
    return in ? __ldg(plane + static_cast<long long>(row) * pitch + col) : unknown;
  }
};

__global__ void __launch_bounds__(kThreads)
m3rsm_level_kernel(const float* __restrict__ plane, long long map_stride, int hp, int wp,
                   const int* __restrict__ corner, int level, int wh, int ww,
                   const int* __restrict__ c0, int n_t, int r,
                   const int* __restrict__ cands, const float* __restrict__ mask,
                   float unknown, float* __restrict__ out) {
  __shared__ float s_num[kThreads];
  __shared__ float s_den[kThreads];

  const int k = blockIdx.x;
  const int n_k = gridDim.x;
  const long long b = blockIdx.y;
  const int* cand = cands + (b * n_k + k) * 3;
  const int t = cand[0], ty = cand[1], tx = cand[2];
  const int* cells = c0 + (b * n_t + t) * r * 2;
  mask += b * r;
  const int rw = corner[2 * b + 0] >> level;
  const int cw = corner[2 * b + 1] >> level;
  // a window that would reach past the plane is cut at its edge
  const Window at{plane + b * map_stride + static_cast<long long>(rw) * wp + cw, wp,
                  min(wh, hp - rw), min(ww, wp - cw), unknown};
  const int e = (1 << level) - 1;

  float num = 0.0f, den = 0.0f;
  for (int i = threadIdx.x; i < r; i += kThreads) {
    const int fr = cells[2 * i + 0] + ty;
    const int fc = cells[2 * i + 1] + tx;
    float v = at(fr >> level, fc >> level);
    if (e != 0) {
      v = max_nan(v, at(fr >> level, (fc + e) >> level));
      v = max_nan(v, at((fr + e) >> level, fc >> level));
      v = max_nan(v, at((fr + e) >> level, (fc + e) >> level));
    }
    const float mw = mask[i];
    num += v * mw;
    den += mw;
  }
  overlap::group_reduce(num, den, s_num, s_den, threadIdx.x, 0);
  if (threadIdx.x == 0) out[b * n_k + k] = overlap::weighted_mean(num, den);
}

}  // namespace

// plane f32[n_planes, hp, wp] (n_planes == 1: shared by all b requests;
// else n_planes == b, one a request), corner i32[b, 2] (the window's first
// level-0 cell, row and col), c0 i32[b, n_t, r, 2], cands i32[b, k, 3],
// mask f32[b, r] -> out f32[b, k], all contiguous. Launches on `stream`
// (PyTorch's current stream), does not synchronise and allocates nothing.
// Returns the cudaError_t of the launch (0 = ok).
extern "C" int m3rsm_level_launch(const float* plane, int n_planes, int hp, int wp,
                                  const int* corner, int level, int wh, int ww,
                                  const int* c0, int n_t, int r, const int* cands, int k,
                                  const float* mask, int b, float unknown, float* out,
                                  void* stream) {
  if (k <= 0 || b <= 0) return 0;
  if (b > 65535 || level < 0 || level > 30 || (n_planes != 1 && n_planes != b)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long map_stride = n_planes == 1 ? 0 : static_cast<long long>(hp) * wp;
  const dim3 grid(k, b);
  m3rsm_level_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      plane, map_stride, hp, wp, corner, level, wh, ww, c0, n_t, r, cands, mask, unknown,
      out);
  return static_cast<int>(cudaGetLastError());
}
