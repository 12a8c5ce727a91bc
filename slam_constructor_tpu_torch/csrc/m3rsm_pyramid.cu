// m3rsm_pyramid.cu: the max-pooled occupancy pyramid of M3RSM (K4a), built
// whole or refreshed in one aligned region into fresh planes, for Hopper
// (sm_90a). Plain C interface, bound from Python with ctypes
// (slam_constructor_tpu_torch/ops/kernels.py, built by ops/_build.py).
//
// Replaces what XLA compiled on the TPU for slam_constructor_tpu/ops/
// m3rsm.py: build_pyramid (level 0 is where(known, occ, unknown); level l + 1
// is the 2 x 2 max of level l, an odd side padded with `unknown`) and
// update_pyramid (the same for the size x size region around a centre cell,
// its corner clipped into the map and aligned down to 2^levels, written over
// a copy of the old planes: the reference's dynamic_update_slice leaves them
// as they were), with the engine's lax.cond(q > 0, ...) around the update as
// a flag read on the device.
//
// Design: a tile is the 2^L x 2^L level-0 cells under one top-level cell (L
// = levels); a block takes a strip of `tiles` tiles side by side, tiles =
// max(1, 256 / 4^L), so that it carries at least 256 threads and a warp
// reads a row of the strip's occupancy and mask bytes as neighbouring
// addresses. The block forms level 0 in shared memory and writes it, then
// pools level by level in shared memory, writing every level's cells of the
// strip. A tile is either pooled from the map (the build; a refresh's tiles
// inside its region when the gate is above 0) or copied from the old planes
// (every other tile of a refresh, all of them when the gate is not above
// 0): a top-level cell covers exactly one tile, so a tile's cells at every
// level come from it alone. A level-0 cell past the map reads `unknown`;
// that equals the reference's padding at every level, since a padded cell
// there is the max of cells that are all missing. Copies and maxima are
// exact, so the planes are the reference's bit for bit; the max propagates
// NaN, as XLA's does.
//
// A pyramid lives in one buffer: level l f32[m, ceil(h / 2^l), ceil(w /
// 2^l)] right after level l - 1, so a launch takes one pointer for all its
// planes. The build's grid covers the maps, padded up to 2^L; a refresh's
// the whole map, its region's corner computed from the centre cell on the
// device (no host sync).
//
// What bounds it on an H100: launch cost. The main path's refresh of a
// 144^2 region of a 256^2 map at L = 4 reads the region's occupancy and
// mask (104 KB) and the old planes outside it (239 KB) and writes the new
// planes (349 KB): 0.21 us at 3.35 TB/s, 256 blocks of 256 threads. The loop
// closer's build of 32 submaps of 120^2 at L = 3 reads 2.3 MB and writes
// 2.5 MB (1.4 us): 1,920 blocks of 256 threads.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 6;  // a 64 x 64 tile: 21.8 KB of shared memory
constexpr int kMaxThreads = 1024;
constexpr int kStripCells = 256;  // level-0 cells a block pools at the least

struct Levels {
  float* out[kMaxLevels + 1];        // level l of map 0; map m starts h[l] * w[l] floats on
  const float* old[kMaxLevels + 1];  // the old planes (a refresh), the same layout
  int h[kMaxLevels + 1];
  int w[kMaxLevels + 1];
};

// the larger of a and b, NaN if either is NaN (fmaxf would drop a NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__global__ void m3rsm_pyramid_kernel(const float* __restrict__ occ, int occ_stride,
                                     const unsigned char* __restrict__ known, int h, int w,
                                     int levels, int tiles, float unknown, Levels pl,
                                     const long long* __restrict__ center, int size,
                                     const float* __restrict__ gate) {
  extern __shared__ float buf[];  // level l of the strip at offset sum_{j<l} (T >> j)(S >> j)
  const int m = blockIdx.z;
  const int tile = 1 << levels;
  const int strip = tiles * tile;  // the strip's width in level-0 cells
  const long long r_base = static_cast<long long>(blockIdx.y) * tile;
  const long long c_base = static_cast<long long>(blockIdx.x) * strip;
  // the pooled region [r0, r0 + rs) x [c0, c0 + cs): the whole map for a
  // build; for a refresh m3rsm.py:update_pyramid's clip(centre - size // 2,
  // 0, dim - size), down to a multiple of 2^levels, or nothing where the
  // gate is shut
  long long r0 = 0, c0 = 0, rs = h, cs = w;
  if (center != nullptr) {
    if (gate != nullptr && !(gate[m] > 0.0f)) {
      rs = cs = 0;
    } else {
      r0 = center[2 * m + 0] - size / 2;
      c0 = center[2 * m + 1] - size / 2;
      r0 = r0 < 0 ? 0 : (r0 > h - size ? h - size : r0);
      c0 = c0 < 0 ? 0 : (c0 > w - size ? w - size : c0);
      r0 = (r0 / tile) * tile;
      c0 = (c0 / tile) * tile;
      rs = cs = size;
    }
  }
  const bool build = center == nullptr;
  const bool rows_in = r_base >= r0 && r_base < r0 + rs;
  // whether the tile holding level-0 column `col` of the strip is pooled
  const auto pooled = [&](int col) {
    const long long c = c_base + col;
    return build || (rows_in && c >= c0 && c < c0 + cs);
  };

  const int shift = __ffs(strip) - 1;  // strip is a power of two
  const long long map0 = static_cast<long long>(m) * h * w;
  for (int i = threadIdx.x; i < tile * strip; i += blockDim.x) {
    const int rr = i >> shift, cc = i & (strip - 1);
    const long long r = r_base + rr;
    const long long c = c_base + cc;
    float v = unknown;
    if (r < h && c < w) {
      const long long cell = map0 + r * w + c;
      v = pooled(cc) ? (known[cell] ? __ldg(occ + cell * occ_stride) : unknown)
                     : __ldg(pl.old[0] + cell);
      pl.out[0][cell] = v;
    }
    buf[i] = v;
  }
  int off = 0;
  for (int l = 1, nh = tile, nw = strip; l <= levels; ++l) {
    __syncthreads();
    const int hh = nh >> 1, hw = nw >> 1;
    const int next = off + nh * nw;
    const long long rb = r_base >> l, cb = c_base >> l;
    const int hl = pl.h[l], wl = pl.w[l];
    const long long mapl = static_cast<long long>(m) * hl * wl;
    for (int i = threadIdx.x; i < hh * hw; i += blockDim.x) {
      const int rr = i / hw, cc = i - rr * hw;
      const bool in_map = rb + rr < hl && cb + cc < wl;
      const long long cell = mapl + (rb + rr) * wl + cb + cc;
      float v;
      if (pooled(cc << l)) {
        const float* s = buf + off + (2 * rr) * nw + 2 * cc;
        // the 2 x 2 window in row-major order, as reduce_window visits it
        v = max_nan(max_nan(max_nan(s[0], s[1]), s[nw]), s[nw + 1]);
      } else {
        v = in_map ? __ldg(pl.old[l] + cell) : unknown;
      }
      buf[next + i] = v;
      if (in_map) pl.out[l][cell] = v;
    }
    off = next;
    nh = hh;
    nw = hw;
  }
}

}  // namespace

// occ f32 (cell (m, r, c) at occ[((m * h + r) * w + c) * occ_stride]),
// known bool[m, h, w]; out: a pyramid's buffer (levels + 1 planes, plane l
// f32[m, ceil(h / 2^l), ceil(w / 2^l)] after plane l - 1). old == nullptr
// builds every level of the m maps; otherwise old is the buffer of the
// pyramid to refresh, center i64[m, 2] (row, col), and out receives old
// with the aligned size x size region around the centre re-pooled (h, w and
// size multiples of 2^levels, size <= h, w), only in the maps whose gate
// f32[m] is above 0 (gate == nullptr: all); old is not written. Launches on
// `stream` (PyTorch's current stream), does not synchronise and allocates
// nothing. Returns the cudaError_t of the launch (0 = ok).
extern "C" int m3rsm_pyramid_launch(const float* occ, int occ_stride,
                                    const unsigned char* known, int m, int h, int w,
                                    int levels, float unknown, float* out, const float* old,
                                    const long long* center, int size, const float* gate,
                                    void* stream) {
  if (m <= 0 || h <= 0 || w <= 0) return 0;
  if (levels < 0 || levels > kMaxLevels || m > 65535 || (old == nullptr) != (center == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = 1 << levels;
  const int tiles = tile * tile >= kStripCells ? 1 : kStripCells / (tile * tile);
  const int strip = tiles * tile;
  Levels pl{};
  long long offset = 0;
  int shared = 0;
  for (int l = 0; l <= levels; ++l) {
    pl.h[l] = (h + (1 << l) - 1) >> l;
    pl.w[l] = (w + (1 << l) - 1) >> l;
    pl.out[l] = out + offset;
    pl.old[l] = old == nullptr ? nullptr : old + offset;
    offset += static_cast<long long>(m) * pl.h[l] * pl.w[l];
    shared += (tile >> l) * (strip >> l) * static_cast<int>(sizeof(float));
  }
  if (center != nullptr &&
      (size <= 0 || size % tile || h % tile || w % tile || size > h || size > w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_x = (w + tile - 1) / tile;
  const dim3 grid((tiles_x + tiles - 1) / tiles, (h + tile - 1) / tile, m);
  const int threads = tile * strip < kMaxThreads ? tile * strip : kMaxThreads;
  m3rsm_pyramid_kernel<<<grid, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      occ, occ_stride, known, h, w, levels, tiles, unknown, pl, center, size, gate);
  return static_cast<int>(cudaGetLastError());
}
