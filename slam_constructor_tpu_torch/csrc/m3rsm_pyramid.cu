// m3rsm_pyramid.cu: the max-pooled occupancy pyramid of M3RSM (K4a), built
// whole or refreshed in one aligned region, for Hopper (sm_90a). Plain C
// interface, bound from Python with ctypes (slam_constructor_tpu_torch/ops/
// kernels.py, built by ops/_build.py).
//
// Replaces what XLA compiled on the TPU for slam_constructor_tpu/ops/
// m3rsm.py: build_pyramid (level 0 is where(known, occ, unknown); level l + 1
// is the 2 x 2 max of level l, an odd side padded with `unknown`) and
// update_pyramid (the same for the size x size region around a centre cell,
// its corner clipped into the map and aligned down to 2^levels, written into
// the planes in place), with the engine's lax.cond(q > 0, ...) around the
// update as a flag read on the device.
//
// Design: one block a tile of 2^L x 2^L level-0 cells (L = levels), the
// tile under one top-level cell. The block reads the tile's occupancy and
// mask in place (the occupancy may be a channel of the map's cells, `occ_stride`
// floats a cell), forms where(known, occ, unknown) in registers, writes level
// 0, and pools level by level in shared memory, writing every level's cells
// of the tile. A level-0 cell past the map reads `unknown`; that equals the
// reference's padding at every level, since a padded cell there is the max
// of cells that are all missing. A max is exact, so the planes are the
// reference's bit for bit; the max propagates NaN, as XLA's does.
//
// Build: the grid covers the whole map, padded up to 2^L, for each of M
// maps. Update: the grid covers the (size / 2^L)^2 tiles of the region; its
// corner comes from the centre cell on the device, and every block returns
// at once when the map's gate is not above 0 (no host sync).
//
// What bounds it on an H100: launch cost. The main path's refresh is a
// 144^2 region of a 256^2 map at L = 4: 81 blocks of 256 threads reading
// 104 KB and writing 110 KB, about 0.06 us at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 6;  // a 64 x 64 tile: 21.8 KB of shared memory
constexpr int kMaxThreads = 1024;

struct Levels {
  float* p[kMaxLevels + 1];  // level l of map 0; map m starts h[l] * w[l] floats on
  int h[kMaxLevels + 1];
  int w[kMaxLevels + 1];
};

// the larger of a and b, NaN if either is NaN (fmaxf would drop a NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void m3rsm_pyramid_kernel(const float* __restrict__ occ, int occ_stride,
                                     const unsigned char* __restrict__ known, int h,
                                     int w, int levels, float unknown, Levels out,
                                     const long long* __restrict__ center, int size,
                                     const float* __restrict__ gate) {
  extern __shared__ float buf[];  // level l of the tile at offset sum_{j<l} (T >> j)^2
  const int m = blockIdx.z;
  if (gate != nullptr && !(gate[m] > 0.0f)) return;
  const int tile = 1 << levels;
  long long r_base = static_cast<long long>(blockIdx.y) * tile;
  long long c_base = static_cast<long long>(blockIdx.x) * tile;
  if (center != nullptr) {
    // m3rsm.py:update_pyramid: clip(centre - size // 2, 0, dim - size),
    // then down to a multiple of 2^levels
    long long r0 = center[2 * m + 0] - size / 2;
    long long c0 = center[2 * m + 1] - size / 2;
    r0 = r0 < 0 ? 0 : (r0 > h - size ? h - size : r0);
    c0 = c0 < 0 ? 0 : (c0 > w - size ? w - size : c0);
    r_base += (r0 / tile) * tile;
    c_base += (c0 / tile) * tile;
  }
  const long long map0 = static_cast<long long>(m) * h * w;
  for (int i = threadIdx.x; i < tile * tile; i += blockDim.x) {
    const long long r = r_base + (i >> levels);
    const long long c = c_base + (i & (tile - 1));
    float v = unknown;
    if (r < h && c < w) {
      const long long cell = map0 + r * w + c;
      v = known[cell] ? __ldg(occ + cell * occ_stride) : unknown;
      out.p[0][cell] = v;
    }
    buf[i] = v;
  }
  int off = 0;
  for (int l = 1, n = tile; l <= levels; ++l) {
    __syncthreads();
    const int half = n >> 1;
    const int next = off + n * n;
    const long long rb = r_base >> l, cb = c_base >> l;
    const int hl = out.h[l], wl = out.w[l];
    float* plane = out.p[l] + static_cast<long long>(m) * hl * wl;
    for (int i = threadIdx.x; i < half * half; i += blockDim.x) {
      const int r = i / half, c = i % half;
      const float* s = buf + off + (2 * r) * n + 2 * c;
      // the 2 x 2 window in row-major order, as reduce_window visits it
      const float v = max_nan(max_nan(max_nan(s[0], s[1]), s[n]), s[n + 1]);
      buf[next + i] = v;
      if (rb + r < hl && cb + c < wl) plane[(rb + r) * wl + cb + c] = v;
    }
    off = next;
    n = half;
  }
}

}  // namespace

// occ f32 (cell (m, r, c) at occ[((m * h + r) * w + c) * occ_stride]),
// known bool[m, h, w], planes: levels + 1 pointers, plane l f32[m, ceil(h /
// 2^l), ceil(w / 2^l)] contiguous. center == nullptr builds every level of
// the m maps; otherwise center i64[m, 2] (row, col) and the aligned size x
// size region around it is refreshed (h, w and size multiples of 2^levels,
// size <= h, w), only in the maps whose gate f32[m] is above 0 (gate ==
// nullptr: all). Launches on `stream` (PyTorch's current stream), does not
// synchronise and allocates nothing. Returns the cudaError_t of the launch
// (0 = ok).
extern "C" int m3rsm_pyramid_launch(const float* occ, int occ_stride,
                                    const unsigned char* known, int m, int h, int w,
                                    int levels, float unknown, float* const* planes,
                                    const long long* center, int size, const float* gate,
                                    void* stream) {
  if (m <= 0 || h <= 0 || w <= 0) return 0;
  if (levels < 0 || levels > kMaxLevels || m > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = 1 << levels;
  Levels out{};
  int shared = 0;
  for (int l = 0; l <= levels; ++l) {
    out.p[l] = planes[l];
    out.h[l] = (h + (1 << l) - 1) >> l;
    out.w[l] = (w + (1 << l) - 1) >> l;
    shared += (tile >> l) * (tile >> l) * static_cast<int>(sizeof(float));
  }
  dim3 grid((w + tile - 1) / tile, (h + tile - 1) / tile, m);
  if (center != nullptr) {
    if (size <= 0 || size % tile || h % tile || w % tile || size > h || size > w) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    grid = dim3(size / tile, size / tile, m);
  }
  const int threads = tile * tile < kMaxThreads ? tile * tile : kMaxThreads;
  m3rsm_pyramid_kernel<<<grid, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      occ, occ_stride, known, h, w, levels, unknown, out, center, size, gate);
  return static_cast<int>(cudaGetLastError());
}
