// scan_insert.cu: the scan insert with its cell fold (K3), one map or P maps
// a call, for Hopper (sm_90a). Plain C interface, bound from Python with
// ctypes (slam_constructor_tpu_torch/ops/kernels.py::scan_insert, built by
// ops/_build.py).
//
// Replaces what the reference's raycast.insert_scan computes
// (slam_constructor_tpu/ops/raycast.py:500 -> scan_observation_planes :397
// -> grid.apply_observations, slam_constructor_tpu/ops/grid.py:124), which
// the TPU ran as XLA one-hot matmuls (raycast.py:89 _scatter_matmul, :126
// _scatter_matmul_multi), and the RBPF's windowed insert of every particle
// (slam_constructor_tpu/models/gmapping.py:389 insert_one): the port's
// kernels.scan_insert_ref, which is raycast.scan_observation_planes (or its
// batched form) and grid.apply_observations, bit for bit. Per map:
//
//   free:     the DDA trace, R beams x n_free samples at (i + 0.5) * step,
//             a sample counted 1.0 in its cell where it lies before
//             range - hole/2, on the map (or window), and in another cell
//             than the beam's sample before it; or (free_plane) the polar
//             fill of K2 (polar_free.cu), launched on its own before.
//   occupied: the endpoint (const: 1.0 to w and s; area: its square's
//             overlap with the 3 x 3 cells around it), then the wall blur
//             (B samples a beam, ramp to w, ramp^2 to s), for beams that
//             are valid with range <= max_range, summed a cell in sample
//             order: every endpoint sample first, then every blur sample,
//             each beam-major (raycast.py:194's concatenation).
//   fold:     w = q (w_free + w_occ), s = q s_occ, then the cell model
//             (BayesBaseCell, BayesAvgCell, TBMCell) in the port's op order
//             on every cell of the map or window; the weight channel n + w.
//             Cells outside a window are copied.
//
// Two launches a call:
// 1. rasterise_kernel: block m < P sums map m's occupied evidence; the
//    other blocks trace the free space, a warp a beam, 32 samples a step,
//    until the beam's free limit. The occupied block stages each beam's
//    direction, range and evidence flag in shared memory, keys its samples
//    (at most R (9 + B); cell << 32 | sample index, an invalid or off-map
//    sample ~0) in shared memory and sorts them (bitonic; a stage whose
//    pairs lie within a warp's 64 keys synchronises the warp alone): within
//    a cell the samples stay in sample order, and the thread at the head of
//    a cell's run sums it one sample after the other from 0, the order of
//    the CPU's index_put_ (and of XLA's CPU scatter). No atomics on
//    fractions, so the same bits on every run. The free counts are
//    atomicAdd's of 1.0: integers below 2^24, exact in any order.
// 2. fold_kernel<model>: a block a row segment of 256 cells of one map,
//    staged through shared memory so that the interleaved channels are read
//    and written in coalesced runs; inside the window a cell reads its
//    counts and sums from the scratch (a float4 a cell, zeroed behind it,
//    so the next call finds it clean: no memset) and is folded; outside it
//    is copied.
//
// What bounds it on an H100: bytes, far below what a call costs. The fold
// reads and writes every cell of the map(s): 256^2 x 2 channels is 1 MB in
// and out, 0.3 us at 3.35 TB/s (30 maps of 256^2: 31 MB, 9.4 us; tum_2d's
// 30 of 1024^2: 504 MB, 150 us); the trace and the sums read ~10 KB of scan
// and do ~10^5-10^6 samples of ~16 f32 operations. What the time goes to
// instead (PERF.md): the single occupied block's sort, a chain of
// log2(n)^2 / 2 stages (66 for the bench's 1,800 samples, 2,048 keys:
// ~15 us of a 27 us rasterisation), and the fold's memory traffic (the
// scratch as three separate planes, read and zeroed a float each, made
// the fold of 30 maps 4x slower: 112-150 us against 27-37).
//
// Numerics: built without --use_fast_math and with --fmad=false, so every
// product and sum rounds on its own, as the twin's separate PyTorch ops do,
// in the twin's order; divisions by the cell size are IEEE divisions
// (grid.div_scale), the directions cosf/sinf of pose[2] + bearing, the TBM
// powers expf(k logf(max(base, 1e-9))), BayesBase's powf(1 - q, w), the
// four masses summed (m0 + m2) + (m1 + m3), the order of the card's sum over
// the last dimension (PyTorch's reduce: a lane a mass, then a shuffle tree
// with offsets 2 and 1). A NaN sample position is dropped.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // a rasterise block: the sort's block, 32 beams' warps
constexpr int kWarps = kThreads / 32;
constexpr int kFoldThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;

enum Model { kBayesBase = 0, kBayesAvg = 1, kTbm = 2 };

struct Insert {
  const float* cells;  // f32[P, H, W, C]
  float* out;          // f32[P, H, W, C]
  int p, h, w, c;
  const float* origin;  // f32[P, 2]: the maps' world origins
  int windowed;         // each map's window around its pose (else the whole map)
  int sh, sw;           // the window's side (the map's without one)
  float scale, scale2;  // the cell size and its square (as the twin rounds them)
  const float* pose;    // f32[P, 3]
  const float* ranges;  // f32 a beam, map m's scan at m * *_stride
  const float* bearings;
  const unsigned char* valid;  // bool
  long long ranges_stride, bearings_stride, valid_stride;
  int r;
  int n_free;       // DDA samples a beam (0: the polar fill in free_plane)
  float step;       // the DDA step
  float hole_half;  // hole_width / 2
  float max_range;
  int area;                 // the area estimator (else const)
  int blur;                 // B blur samples a beam (0: no blur)
  const float* blur_table;  // f32[3, B]: bt, ramp, ramp^2
  const float* free_plane;  // f32[P, sh, sw] (polar) or null
  float4* scratch;          // [P, sh, sw]: (free count, occupied w, occupied s, 0), zero
  int n_keys;               // the sort's size: a power of two >= R (E + B)
  const float* q;           // f32[] or null (1)
  int model;
  float quality;   // TBMCell.quality
  float base;      // BayesBaseCell: 1 - quality; TBMCell: 1 - quality
  float decay;     // TBMCell.conflict_decay
  float keep;      // 1 - conflict_decay
  float eps;       // 1e-9
};

// Map m's window: its first cell and its world origin. grid.window_corner's
// arithmetic: floor((pose - origin) / scale) less half the window, clamped
// into the map; the window's origin origin + [col, row] * scale.
struct Corner {
  long long row, col;
  float ox, oy;
};

__device__ __forceinline__ Corner corner_of(const Insert& s, int m) {
  const float mx = __ldg(s.origin + 2 * m), my = __ldg(s.origin + 2 * m + 1);
  if (!s.windowed) return {0, 0, mx, my};
  const float cx = floorf((__ldg(s.pose + 3 * m) - mx) / s.scale);
  const float cy = floorf((__ldg(s.pose + 3 * m + 1) - my) / s.scale);
  const long long col = min(max(static_cast<long long>(cx) - s.sw / 2, 0ll),
                            static_cast<long long>(s.w - s.sw));
  const long long row = min(max(static_cast<long long>(cy) - s.sh / 2, 0ll),
                            static_cast<long long>(s.h - s.sh));
  return {row, col, mx + static_cast<float>(col) * s.scale, my + static_cast<float>(row) * s.scale};
}

// PyTorch's clamp(min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }

__device__ __forceinline__ bool on_window(float fr, float fc, int sh, int sw) {
  return fr >= 0.0f && fr < static_cast<float>(sh) && fc >= 0.0f && fc < static_cast<float>(sw);
}

// The free trace of one beam by one warp: 32 samples at a time, the
// previous sample's cell by a shuffle (carried over between chunks), until
// a chunk's last sample lies past the beam's free limit.
__device__ void free_trace(const Insert& s, int m, int beam) {
  const int lane = threadIdx.x % 32;
  if (!__ldg(s.valid + m * s.valid_stride + beam)) return;
  const float* pose = s.pose + 3 * m;
  const float px = __ldg(pose), py = __ldg(pose + 1);
  const float ang = __ldg(pose + 2) + __ldg(s.bearings + m * s.bearings_stride + beam);
  const float dx = cosf(ang), dy = sinf(ang);
  const float limit = __ldg(s.ranges + m * s.ranges_stride + beam) - s.hole_half;
  const Corner corner = corner_of(s, m);
  const float ox = corner.ox, oy = corner.oy;
  float4* counts = s.scratch + static_cast<long long>(m) * s.sh * s.sw;
  float carry_r = 0.0f, carry_c = 0.0f;
  for (int base = 0; base < s.n_free; base += 32) {
    const int i = base + lane;
    const float t = (static_cast<float>(i) + 0.5f) * s.step;
    const bool in = i < s.n_free && t < limit;
    const float x = px + t * dx;
    const float y = py + t * dy;
    const float fc = floorf((x - ox) / s.scale);
    const float fr = floorf((y - oy) / s.scale);
    float pr = __shfl_up_sync(kFull, fr, 1);
    float pc = __shfl_up_sync(kFull, fc, 1);
    if (lane == 0) {
      pr = carry_r;
      pc = carry_c;
    }
    if (in && (i == 0 || fr != pr || fc != pc) && on_window(fr, fc, s.sh, s.sw)) {
      atomicAdd(&counts[static_cast<int>(fr) * s.sw + static_cast<int>(fc)].x, 1.0f);
    }
    carry_r = __shfl_sync(kFull, fr, 31);
    carry_c = __shfl_sync(kFull, fc, 31);
    // the free limit is a prefix of the samples
    if (!__shfl_sync(kFull, static_cast<int>(in), 31)) break;
  }
}

// What the occupied samples of map m need, loaded once a block: the pose,
// the window's origin and, in shared memory, each beam's direction, range
// and whether it carries endpoint evidence.
struct Frame {
  float px, py, ox, oy;
};

__device__ __forceinline__ Frame stage_beams(const Insert& s, int m, float4* s_beams) {
  const Corner corner = corner_of(s, m);
  const float* pose = s.pose + 3 * m;
  const float theta = __ldg(pose + 2);
  for (int b = threadIdx.x; b < s.r; b += kThreads) {
    const float ang = theta + __ldg(s.bearings + m * s.bearings_stride + b);
    const float range = __ldg(s.ranges + m * s.ranges_stride + b);
    const bool ep = __ldg(s.valid + m * s.valid_stride + b) && range <= s.max_range;
    s_beams[b] = make_float4(cosf(ang), sinf(ang), range, ep ? 1.0f : 0.0f);
  }
  return {__ldg(pose), __ldg(pose + 1), corner.ox, corner.oy};
}

// The key of occupied sample i (cell << 32 | i, or kNoKey where it adds
// nothing: invalid, or off the window); for the area estimator its weight
// goes to s_area[i].
__device__ unsigned long long sample_key(const Insert& s, const Frame& f, const float4* s_beams,
                                         int i, int n_ep, float* s_area) {
  const int e = s.area ? 9 : 1;
  const bool blur = i >= n_ep;
  const int j = blur ? i - n_ep : i;
  const int beam = blur ? j / s.blur : j / e;
  const int k = blur ? j - beam * s.blur : j - beam * e;
  const float4 b = s_beams[beam];  // dx, dy, range, endpoint evidence
  bool ok = b.w != 0.0f;
  float fr, fc;
  if (blur) {
    const float tb = b.z + s.hole_half * __ldg(s.blur_table + k);
    const float x = f.px + tb * b.x;
    const float y = f.py + tb * b.y;
    fc = floorf((x - f.ox) / s.scale);
    fr = floorf((y - f.oy) / s.scale);
    ok = ok && tb > 0.0f;
  } else {
    const float ex = f.px + b.z * b.x;
    const float ey = f.py + b.z * b.y;
    fc = floorf((ex - f.ox) / s.scale);
    fr = floorf((ey - f.oy) / s.scale);
    if (s.area) {
      // the k-th of the 3 x 3 cells around the endpoint's, rows outer;
      // floats that hold integers, as the twin's int64 cells cast back
      fr += static_cast<float>(k / 3 - 1);
      fc += static_cast<float>(k % 3 - 1);
      const float lo_x = fc * s.scale + f.ox;
      const float lo_y = fr * s.scale + f.oy;
      const float ov_x =
          clamp_min(fminf(lo_x + s.scale, ex + s.hole_half) - fmaxf(lo_x, ex - s.hole_half), 0.0f);
      const float ov_y =
          clamp_min(fminf(lo_y + s.scale, ey + s.hole_half) - fmaxf(lo_y, ey - s.hole_half), 0.0f);
      const float a = ok ? (ov_x * ov_y) / s.scale2 : 0.0f;
      s_area[i] = a;
      ok = a > 0.0f;
    }
  }
  if (!ok || !on_window(fr, fc, s.sh, s.sw)) return kNoKey;
  const unsigned cell = static_cast<unsigned>(static_cast<int>(fr) * s.sw + static_cast<int>(fc));
  return (static_cast<unsigned long long>(cell) << 32) | static_cast<unsigned>(i);
}

// Map m's occupied evidence, by the whole block: the beams staged, the
// keys, a bitonic sort, then each cell's run summed in sample order into
// the scratch.
__device__ void occupied_sums(const Insert& s, int m, unsigned long long* keys, float4* s_beams,
                              float* s_area) {
  const int e = s.area ? 9 : 1;
  const int n_ep = s.r * e;
  const int n = n_ep + s.r * s.blur;
  const Frame f = stage_beams(s, m, s_beams);
  __syncthreads();
  for (int i = threadIdx.x; i < s.n_keys; i += kThreads) {
    keys[i] = i < n ? sample_key(s, f, s_beams, i, n_ep, s_area) : kNoKey;
  }
  __syncthreads();
  // a warp's 32 pairs of a stage with j <= 32 lie in 64 keys of its own, so
  // between two such stages the warp synchronises alone; a block barrier
  // comes before and after every stage with j > 32
  int last_j = 0;
  for (int k = 2; k <= s.n_keys; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (last_j > 32 || j > 32) {
        __syncthreads();
      } else if (last_j) {
        __syncwarp();
      }
      last_j = j;
      const int lj = __ffs(j) - 1;
      for (int t = threadIdx.x; t < s.n_keys / 2; t += kThreads) {
        // the t-th pair of the stage: lo has bit lj clear, hi = lo + j
        const int lo = ((t >> lj) << (lj + 1)) | (t & (j - 1));
        const int hi = lo + j;
        const unsigned long long a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & k) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
    }
  }
  __syncthreads();
  float4* sums = s.scratch + static_cast<long long>(m) * s.sh * s.sw;
  for (int i = threadIdx.x; i < s.n_keys; i += kThreads) {
    const unsigned long long key = keys[i];
    const unsigned cell = static_cast<unsigned>(key >> 32);
    if (key == kNoKey || (i > 0 && static_cast<unsigned>(keys[i - 1] >> 32) == cell)) continue;
    float sw = 0.0f, ss = 0.0f;
    for (int j = i; j < s.n_keys && static_cast<unsigned>(keys[j] >> 32) == cell; ++j) {
      const int idx = static_cast<int>(keys[j] & 0xffffffffull);
      if (idx < n_ep) {
        const float v = s.area ? s_area[idx] : 1.0f;
        sw += v;
        ss += v;
      } else {
        const int b = (idx - n_ep) % s.blur;
        sw += __ldg(s.blur_table + s.blur + b);
        ss += __ldg(s.blur_table + 2 * s.blur + b);
      }
    }
    sums[cell].y = sw;
    sums[cell].z = ss;
  }
}

__global__ void __launch_bounds__(kThreads) rasterise_kernel(const Insert s) {
  extern __shared__ unsigned long long smem[];  // keys, then the beams, then the areas
  if (blockIdx.x < static_cast<unsigned>(s.p)) {
    float4* s_beams = reinterpret_cast<float4*>(smem + s.n_keys);
    occupied_sums(s, blockIdx.x, smem, s_beams, reinterpret_cast<float*>(s_beams + s.r));
    return;
  }
  const int per_map = (s.r + kWarps - 1) / kWarps;
  const int b = blockIdx.x - s.p;
  const int m = b / per_map;
  const int beam = (b - m * per_map) * kWarps + threadIdx.x / 32;
  if (beam < s.r) free_trace(s, m, beam);
}

// One cell of the model's fold: belief b[0 .. C-2], weight n, observation
// (w, sv); writes the C - 1 belief channels to o. The twin's op order
// (ops/cells.py).
template <int kModel>
__device__ __forceinline__ void fold_cell(const Insert& s, const float* b, float n, float w,
                                          float sv, float* o) {
  if constexpr (kModel == kBayesAvg) {
    const float den = n + w;
    const float p = (b[0] * n + sv) / clamp_min(den, s.eps);
    o[0] = den > 0.0f ? p : b[0];
  } else if constexpr (kModel == kBayesBase) {
    const float keep = powf(s.base, w);
    const float mean = sv / clamp_min(w, s.eps);
    const float p = keep * b[0] + (1.0f - keep) * mean;
    o[0] = w > 0.0f ? p : b[0];
  } else {
    if (!(w > 0.0f)) {
      for (int ch = 0; ch < 4; ++ch) o[ch] = b[ch];
      return;
    }
    const float obs = sv / clamp_min(w, s.eps);
    const float k = floorf(w);
    const float frac = w - k;
    const float oo = s.quality * obs;
    const float ee = s.quality * (1.0f - obs);
    const float pu = expf(k * logf(clamp_min(s.base, s.eps)));
    const float po = expf(k * logf(clamp_min(oo + s.base, s.eps)));
    const float pe = expf(k * logf(clamp_min(ee + s.base, s.eps)));
    const float mo0 = b[0], me0 = b[1], mu0 = b[2], mx0 = b[3];
    const float total = ((mo0 + me0) + mu0) + mx0;
    const float mo = mo0 * po + mu0 * (po - pu);
    const float me = me0 * pe + mu0 * (pe - pu);
    const float mu = mu0 * pu;
    const float mx = clamp_min(((total - mo) - me) - mu, 0.0f);
    const float qi = s.quality * frac;
    const float oi = qi * obs, ei = qi * (1.0f - obs), ui = 1.0f - qi;
    const float no = mo * (oi + ui) + mu * oi;
    const float ne = me * (ei + ui) + mu * ei;
    float nu = mu * ui;
    float nx = (mx * ((oi + ei) + ui) + mo * ei) + me * oi;
    nu = nu + s.decay * nx;
    nx = nx * s.keep;
    // the card's sum over the last dimension of 4: lanes 0 + 2 and 1 + 3,
    // then the two (a shuffle tree with the offsets decreasing)
    const float den = clamp_min((no + nu) + (ne + nx), s.eps);
    o[0] = no / den;
    o[1] = ne / den;
    o[2] = nu / den;
    o[3] = nx / den;
  }
}

// Row blockIdx.y of map blockIdx.z, kFoldThreads columns a block: the
// window's cells folded from the scratch (zeroed behind), the others copied.
// A row's cells are staged through shared memory, so that every load and
// store of the C interleaved channels is a coalesced run of floats.
template <int kModel>
__global__ void __launch_bounds__(kFoldThreads) fold_kernel(const Insert s) {
  constexpr int kC = kModel == kTbm ? 5 : 2;
  __shared__ float tile[kFoldThreads * kC];
  const int m = blockIdx.z, i = blockIdx.y, j0 = blockIdx.x * kFoldThreads;
  const int n = min(kFoldThreads, s.w - j0) * kC;
  const long long first = (static_cast<long long>(m) * s.h + i) * s.w + j0;
  const float* src = s.cells + first * kC;
  float* dst = s.out + first * kC;
  const Corner corner = corner_of(s, m);
  const int li = i - static_cast<int>(corner.row);
  const int lo = max(static_cast<int>(corner.col) - j0, 0);
  const int hi = min(static_cast<int>(corner.col) + s.sw - j0, kFoldThreads);
  if (li < 0 || li >= s.sh || lo >= hi) {  // no cell of the window
    for (int f = threadIdx.x; f < n; f += kFoldThreads) dst[f] = __ldg(src + f);
    return;
  }
  for (int f = threadIdx.x; f < n; f += kFoldThreads) tile[f] = __ldg(src + f);
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= lo && t < hi && t * kC < n) {
    const long long local =
        (static_cast<long long>(m) * s.sh + li) * s.sw + (j0 + t - static_cast<int>(corner.col));
    // one 16-byte load of the cell's counts and sums, one store of zeros
    const float4 v = s.scratch[local];
    s.scratch[local] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float w_free = s.free_plane ? __ldg(s.free_plane + local) : v.x;
    float w = w_free + v.y, sv = v.z;
    if (s.q) {
      const float q = __ldg(s.q);
      w = q * w;
      sv = q * sv;
    }
    float b[kC], o[kC];
#pragma unroll
    for (int ch = 0; ch < kC; ++ch) b[ch] = tile[t * kC + ch];
    fold_cell<kModel>(s, b, b[kC - 1], w, sv, o);
    o[kC - 1] = b[kC - 1] + w;
#pragma unroll
    for (int ch = 0; ch < kC; ++ch) tile[t * kC + ch] = o[ch];
  }
  __syncthreads();
  for (int f = threadIdx.x; f < n; f += kFoldThreads) dst[f] = tile[f];
}

}  // namespace

// Inserts map m's scan at pose[m] into map m of `cells` (f32[p, h, w, c],
// contiguous, world origin origin[m]) on the sh x sw window around pose[m]
// (windowed; else the whole map), writing every cell to `out` (the same
// shape): rasterise_kernel, then fold_kernel, on `stream` (PyTorch's
// current stream). scratch: f32[p, sh, sw, 4] of zeros, left zero; n_keys:
// a power of two >= r (9 or 1 + blur); the rasterise block asks for n_keys
// 8-byte keys, r 16-byte beams (and r 9 floats with the area estimator) of
// dynamic shared memory, which the caller keeps within the card's opt-in
// cap. Does not
// synchronise and allocates nothing. Returns the cudaError_t of the
// launches (0 = ok).
extern "C" int scan_insert_launch(
    const float* cells, float* out, int p, int h, int w, int c, int windowed,
    const float* origin, int sh, int sw, float scale, float scale2,
    const float* pose, const float* ranges, long long ranges_stride, const float* bearings,
    long long bearings_stride, const unsigned char* valid, long long valid_stride, int r,
    int n_free, float step, float hole_half, float max_range, int area, int blur,
    const float* blur_table, const float* free_plane, float* scratch, int n_keys, const float* q,
    int model, float quality, float base, float decay, float keep, float eps, void* stream) {
  if (p <= 0 || h <= 0 || w <= 0 || r <= 0 || sh <= 0 || sw <= 0 || sh > h || sw > w ||
      (!windowed && (sh != h || sw != w)) || n_keys <= 0 ||
      (n_keys & (n_keys - 1)) || model < kBayesBase || model > kTbm ||
      c != (model == kTbm ? 5 : 2) || h > 65535 || p > 65535 || (blur > 0 && !blur_table) ||
      (n_free <= 0 && !free_plane)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Insert s;
  s.cells = cells;
  s.out = out;
  s.p = p;
  s.h = h;
  s.w = w;
  s.c = c;
  s.windowed = windowed;
  s.origin = origin;
  s.sh = sh;
  s.sw = sw;
  s.scale = scale;
  s.scale2 = scale2;
  s.pose = pose;
  s.ranges = ranges;
  s.bearings = bearings;
  s.valid = valid;
  s.ranges_stride = ranges_stride;
  s.bearings_stride = bearings_stride;
  s.valid_stride = valid_stride;
  s.r = r;
  s.n_free = free_plane ? 0 : n_free;
  s.step = step;
  s.hole_half = hole_half;
  s.max_range = max_range;
  s.area = area;
  s.blur = blur;
  s.blur_table = blur_table;
  s.free_plane = free_plane;
  s.scratch = reinterpret_cast<float4*>(scratch);
  s.n_keys = n_keys;
  s.q = q;
  s.model = model;
  s.quality = quality;
  s.base = base;
  s.decay = decay;
  s.keep = keep;
  s.eps = eps;

  const size_t shared = static_cast<size_t>(n_keys) * sizeof(unsigned long long) +
                        static_cast<size_t>(r) * sizeof(float4) +
                        (area ? static_cast<size_t>(r) * 9 * sizeof(float) : 0);
  // the default is 48 KB a block
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rasterise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long free_blocks =
      s.n_free > 0 ? static_cast<long long>(p) * ((r + kWarps - 1) / kWarps) : 0;
  rasterise_kernel<<<static_cast<unsigned>(p + free_blocks), kThreads, shared, st>>>(s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 fold_grid((w + kFoldThreads - 1) / kFoldThreads, h, p);
  if (model == kBayesAvg) {
    fold_kernel<kBayesAvg><<<fold_grid, kFoldThreads, 0, st>>>(s);
  } else if (model == kBayesBase) {
    fold_kernel<kBayesBase><<<fold_grid, kFoldThreads, 0, st>>>(s);
  } else {
    fold_kernel<kTbm><<<fold_grid, kFoldThreads, 0, st>>>(s);
  }
  return static_cast<int>(cudaGetLastError());
}
