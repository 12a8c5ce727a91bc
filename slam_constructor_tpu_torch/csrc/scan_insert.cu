// scan_insert.cu: the scan insert with its cell fold (K3), one map or P maps
// a call, the shared-plane rasteriser (N scans summed into P planes), and K3
// over a block pool (the tiled map, the copy-on-write RBPF maps: a prepare
// launch and an insert launch, "The block pool" below), for Hopper
// (sm_90a). Plain C interface, bound from Python with ctypes
// (slam_constructor_tpu_torch/ops/kernels.py::scan_insert, ::scan_planes,
// ::pool_prepare, ::pool_touched and ::pool_insert, built by ops/_build.py).
//
// Replaces what the reference's raycast.insert_scan computes
// (slam_constructor_tpu/ops/raycast.py:500 -> scan_observation_planes :397
// -> grid.apply_observations, slam_constructor_tpu/ops/grid.py:124), which
// the TPU ran as XLA one-hot matmuls (raycast.py:89 _scatter_matmul, :126
// _scatter_matmul_multi), the RBPF's windowed insert of every particle
// (slam_constructor_tpu/models/gmapping.py:389 insert_one), and the loop
// closer's vmap over scan_observation_planes summed into shared planes
// (slam_constructor_tpu/models/posegraph.py:421-427, :798-803, :842-861):
// the port's kernels.scan_insert_ref (raycast.scan_observation_planes or
// kernels.scan_planes_ref, then grid.apply_observations) and
// kernels.scan_planes_ref, bit for bit. Per plane:
//
//   free:     the DDA trace, R beams x n_free samples at (i + 0.5) * step,
//             a sample counted 1.0 in its cell where it lies before
//             range - hole/2, on the plane, and in another cell than the
//             beam's sample before it; or (free_plane) the polar fill of K2
//             (polar_free.cu), launched on its own before.
//   occupied: the endpoint (const: 1.0 to w and s; area: its square's
//             overlap with the 3 x 3 cells around it), then the wall blur
//             (B samples a beam, ramp to w, ramp^2 to s), for beams that
//             are valid with range <= max_range, summed a cell in sample
//             order from 0: every endpoint sample first, then every blur
//             sample, each beam-major (raycast.py:194's concatenation);
//             for shared planes scan after scan, in increasing scan index.
//   fold:     w = q (w_free + w_occ), s = q s_occ, then the cell model
//             (BayesBaseCell, BayesAvgCell, TBMCell) in the port's op order
//             on every cell of the map or window; the weight channel n + w.
//             Cells outside a window are copied. The planes form writes
//             (w_free + w_occ, s_occ) instead.
//
// One launch a call. A block owns a band of `rows` rows of one map's window
// (or plane), every column: the band's free counts, occupied sums and
// staged cells live in its shared memory, so no global scratch is needed.
// Other blocks of the same launch copy the cells outside the windows.
// A band block, for each scan of its plane in order:
// 1. stages the scan's beams (direction, range, flags) in shared memory,
//    kThreads beams at a time;
// 2. free trace: a sample's row floor((fma(t_i, dy, py) - oy) * (1 / scale)),
//    t_i = (i + 0.5) step, is monotone in i (every IEEE op in that chain
//    is), so a beam's samples in the band are one range of i, found by a
//    search from where the real line crosses, with the same arithmetic
//    (none where an end of the beam lies in the band); the ranges of all
//    the beams are laid end to end (a block prefix sum), a thread counts a
//    run of them (the previous sample's cell carried along) with
//    shared-memory integer atomics: exact in any order;
// 3. occupied: the beams whose samples can reach the band (the rows of the
//    endpoint, of its 3 x 3 cells and of the first and last blur sample,
//    the same arithmetic: monotone along the beam) are compacted in order;
//    their samples are evaluated kThreads at a time in sample order, those
//    in the band compacted in order (ballots, a prefix over the warps), and
//    added by ordered_add: np.add.at's order for every cell, whatever the
//    number of samples. Nothing is sorted, and there is no size limit but
//    a band's row in shared memory.
// The band's cells are copied into shared memory with cp.async (4- and
// 16-byte copies, in the cells' own alignment) at the block's start, while
// the band rasterises; the fold runs there and the band is written back in
// 16-byte runs.
//
// What bounds it on an H100: bytes, far below what a call costs. The fold
// reads and writes every cell of the map(s): 256^2 x 2 channels is 1 MB in
// and out, 0.3 us at 3.35 TB/s (30 maps of 256^2: 31 MB, 9.4 us; tum_2d's
// 30 of 1024^2: 504 MB, 150 us); the trace and the sums read ~10 KB of
// scan and do ~10^5-10^6 samples of ~16 f32 operations. What a call costs
// instead (PERF.md; k3_probe.py --stamps splits a band block by phase):
// the slowest band block's chain of phases, each a few thousand cycles
// apart at barriers. On one map that is the band of the walls nearest the
// robot (its occupied samples) and the robot's row (every beam starts
// there); on 30 maps the band around the robot (~9,500 free samples in 18
// rows of 160); a band block holds ~4 us of fixed cost (the staged cells'
// and the scan's loads, the beams' staging, the block prefix, the fold).
//
// Numerics: built without --use_fast_math and with --fmad=false, so every
// product and sum rounds on its own, as the twin's separate PyTorch ops do,
// in the twin's order; a sample's cell is a product with the float32
// reciprocal of the cell size (grid.cell_coord: the reference's jitted
// form), the window corners too (grid.window_corner), the
// directions the reference's cosf/sinf of pose[2] + bearing (libm.cuh), the
// TBM powers exp(k log(max(base, 1e-9))) with XLA's exp and log (libm.cuh),
// BayesBase's powf(1 - q, w), the
// four masses summed (m0 + m2) + (m1 + m3), the order of the card's sum over
// the last dimension (PyTorch's reduce: a lane a mass, then a shuffle tree
// with offsets 2 and 1). A NaN sample position is dropped.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "libm.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;  // a block: beams staged a chunk, samples a chunk
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// band blocks a launch aimed at: two a streaming multiprocessor of an H100
constexpr int kTargetBlocks = 264;
// a band's planes and staged cells at most, so that two blocks fit an SM
constexpr int kBandBytes = 80 * 1024;
constexpr int kMaxShared = 227 * 1024;  // the opt-in cap a block
constexpr int kCopyBytes = 64 * 1024;   // the cells a copy block moves

enum Mode { kBayesBase = 0, kBayesAvg = 1, kTbm = 2, kPlanes = 3 };

// with -DSLAM_KERNEL_PROBE: thread 0 of each of the first kProbeBlocks
// blocks sums the clock64() cycles of each phase of its work over its
// scans and writes them to its slots at its end, which
// scan_insert_probe_stamps copies out and zeroes. The package's own build
// defines nothing of it.
constexpr int kProbeBlocks = 1024, kProbeSlots = 16;
enum Phase {
  kSetup = 0, kStage, kSearch, kScan, kFreeItems, kOccEval, kAddCount, kAddList, kAddWalk,
  kFoldWait, kFold,
  kItems = 11, kEntries, kFreeCount  // not cycles: the occupied items, the samples kept, free items
};
#ifdef SLAM_KERNEL_PROBE
__device__ unsigned long long probe_cycles[kProbeBlocks * kProbeSlots];
#endif
// with -DSLAM_KERNEL_PROBE, the block pool's launches too: the prepare's
// phases by cluster block (kPrepSlots each, pool_prepare_kernel's stamps)
// and the insert's items (cycles, free items, occupied items, the item)
constexpr int kProbePrepBlocks = 16, kPrepSlots = 12, kProbeItems = 4096;
#ifdef SLAM_KERNEL_PROBE
__device__ unsigned long long probe_prep[kProbePrepBlocks * kPrepSlots];
__device__ unsigned long long probe_items[kProbeItems * 4];
#endif

__host__ __device__ constexpr int channels_of(int mode) {
  return mode == kTbm ? 5 : (mode == kPlanes ? 0 : 2);
}

struct Insert {
  const float* cells;  // fold: f32[P, H, W, C]
  float* out;          // fold: f32[P, H, W, C]
  float* w_out;        // planes: f32[P, sh, sw]
  float* s_out;
  int p, h, w;
  int windowed;                // fold: each map's window around its pose
  const float* origin;         // fold: the maps' origins; planes: each scan's
  long long origin_stride;     // floats from one origin to the next (0: shared)
  int sh, sw;                  // the window's (plane's) side
  float scale, scale2;         // the cell size and its square (as the twin rounds them)
  float inv_scale, inv_scale2;  // their float32 reciprocals: a sample's cell, an area's share
  int n_scans;                 // planes: the scans (fold: one a map)
  const long long* plane_of;   // planes: i64[n_scans] or null (scan s is plane s)
  const float* pose;           // f32[n_scans, 3]
  const float* ranges;         // f32 a beam, scan s's at s * *_stride
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
  const float* q;           // fold: f32[] or null (1)
  float quality;  // TBMCell.quality
  float base;     // BayesBaseCell: 1 - quality; TBMCell: 1 - quality
  float decay;    // TBMCell.conflict_decay
  float keep;     // 1 - conflict_decay
  float eps;      // 1e-9
  int rows;       // a band's rows
  int n_bands;    // bands a map
  int spr;        // 16-byte slots a staged row (fold)
  int copy_rows;  // rows of a map a copy block covers
  int n_copy;     // copy blocks a map (0: nothing outside the windows)
  // the block pool: f32[n_slots, B, B, c], updated in place
  float* pool;
  int n_slots, block, th, tw, c;
  int mode;                 // pool_prepare_kernel: kTouch, kGiven, kCow or kTiled
  unsigned char* touched;   // u8[p, th, tw]: the marks (kGiven: the input)
  int* tables;              // i32[p, th, tw]: each scan's slot of each tile, -1 = none
  int* refcnt;              // i32[n_slots]: the CoW pool's references, or null
  unsigned char* overflow;  // bool[]: the CoW pool's latch
  int* n_alloc;             // i32[]: the tiled map's slots asked for (live below it)
  const float* init;        // f32[c]: the init cell (kCow)
  int k_max;                // kCow: new blocks a step at most
  int robot_bands;          // row bands of a banded tile (the robot's, its neighbours)
  int* work;                // the work list (kWork* header, items, scratch, owners)
};

// Map m's window: its first cell and its world origin. grid.window_corner's
// arithmetic: floor((pose - origin) * (1 / scale)) less half the window,
// clamped into the map; the window's origin origin + [col, row] * scale.
struct Corner {
  long long row, col;
  float ox, oy;
};

__device__ __forceinline__ Corner corner_of(const Insert& s, int m) {
  const float mx = __ldg(s.origin + 2 * m), my = __ldg(s.origin + 2 * m + 1);
  if (!s.windowed) return {0, 0, mx, my};
  const float cx = floorf(__fmul_rn(__ldg(s.pose + 3 * m) - mx, s.inv_scale));
  const float cy = floorf(__fmul_rn(__ldg(s.pose + 3 * m + 1) - my, s.inv_scale));
  const long long col = min(max(static_cast<long long>(cx) - s.sw / 2, 0ll),
                            static_cast<long long>(s.w - s.sw));
  const long long row = min(max(static_cast<long long>(cy) - s.sh / 2, 0ll),
                            static_cast<long long>(s.h - s.sh));
  return {row, col, mx + static_cast<float>(col) * s.scale, my + static_cast<float>(row) * s.scale};
}

// PyTorch's clamp(min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }

// A scan's frame: the pose's position and the plane's (window's) origin.
struct Frame {
  float px, py, ox, oy;
};

// The beam flags staged beside a beam's direction and range.
constexpr float kValid = 1.0f, kEvidence = 2.0f;  // valid, and valid with range <= max_range

// a sample's cell coordinate: the reference's jitted code fuses the
// sample's position p + t d into one multiply-add and divides by the
// constant cell size as a product with its float32 reciprocal (ROADMAP
// trap m), and so does the insert
__device__ __forceinline__ float cell_of(float p, float d, float t, float o, float inv_scale) {
  return floorf(__fmul_rn(__fmaf_rn(t, d, p) - o, inv_scale));
}

// The first i in [lo, hi) where pred(i) holds (pred false ... true), else hi.
template <typename Pred>
__device__ __forceinline__ int lower_bound(int lo, int hi, Pred pred) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (pred(mid)) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// The first i in [lo, hi) where pred(i) holds, else hi, starting from a
// guess: two evaluations where the guess is right, a gallop and a binary
// search where it is not.
template <typename Pred>
__device__ __forceinline__ int first_true(int lo, int hi, float guess, Pred pred) {
  if (lo >= hi) return hi;
  const float gf = guess == guess ? fminf(fmaxf(guess, static_cast<float>(lo)),
                                          static_cast<float>(hi - 1))
                                  : static_cast<float>(lo);
  const int g = static_cast<int>(gf);
  if (pred(g)) {  // the answer lies in [lo, g]
    int at = g, d = 1;
    while (at - d >= lo && pred(at - d)) {
      at -= d;
      d <<= 1;
    }
    return lower_bound(max(lo, at - d + 1), at, pred);
  }
  int f = g, d = 1;  // pred(f) is false: the answer lies in (g, hi]
  while (f + d < hi && !pred(f + d)) {
    f += d;
    d <<= 1;
  }
  return lower_bound(f + 1, min(hi, f + d), pred);
}

// Samples [lo, hi) of a beam narrowed to those whose cell coordinate
// coord(i) (monotone in i: every IEEE op of its chain is) lies in [a0, a1);
// cross(a) guesses where the real line crosses a. No search at an end of the
// range that lies inside. Returns (first, end), end <= first for none.
template <typename Coord, typename Cross>
__device__ __forceinline__ int2 narrow(int lo, int hi, float a0, float a1, Coord coord,
                                       Cross cross) {
  if (lo >= hi) return make_int2(lo, lo);
  const float fa = coord(lo), fb = coord(hi - 1);
  if (!(fminf(fa, fb) < a1 && fmaxf(fa, fb) >= a0 && fa == fa && fb == fb)) {
    return make_int2(lo, lo);
  }
  const bool first_in = fa >= a0 && fa < a1, last_in = fb >= a0 && fb < a1;
  int l = lo, h = hi;
  if (fa <= fb) {
    if (!first_in) l = first_true(lo, hi, cross(a0), [&](int i) { return coord(i) >= a0; });
    if (!last_in) h = first_true(l, hi, cross(a1), [&](int i) { return coord(i) >= a1; });
  } else {
    if (!first_in) l = first_true(lo, hi, cross(a1), [&](int i) { return coord(i) < a1; });
    if (!last_in) h = first_true(l, hi, cross(a0), [&](int i) { return coord(i) < a0; });
  }
  return make_int2(l, h);
}

// Block-wide exclusive prefix of two counts; `total` gets the sums. Ends
// with a barrier, so the caller may read what it wrote before the call.
__device__ __forceinline__ int2 block_scan(int2 v, int2* s_part, int2& total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int2 inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(kFull, inc.x, o), y = __shfl_up_sync(kFull, inc.y, o);
    if (lane >= o) {
      inc.x += x;
      inc.y += y;
    }
  }
  if (lane == 31) s_part[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int2 part = lane < kWarps ? s_part[lane] : make_int2(0, 0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, part.x, o), y = __shfl_up_sync(kFull, part.y, o);
      if (lane >= o) {
        part.x += x;
        part.y += y;
      }
    }
    if (lane < kWarps) s_part[kWarps + lane] = part;  // inclusive
  }
  __syncthreads();
  total = s_part[2 * kWarps - 1];
  const int2 before = warp ? s_part[kWarps + warp - 1] : make_int2(0, 0);
  return make_int2(before.x + inc.x - v.x, before.y + inc.y - v.y);
}

// The band's shared memory.
struct Band {
  float4* beam;   // [kThreads]: dx, dy, range, flags
  int* start;     // [kThreads + 1]: each beam's first free item, then the total
  int* first;     // [kThreads]: each beam's first sample in the band
  int* rel;       // [kThreads]: the beams with occupied samples that can reach the band
  int* list_cell; // [2][kThreads]: a chunk's occupied samples in the band, in order
  float* list_w;
  float* list_s;
  int* warp_count;  // [2][kWarps]: ordered_add's kept samples a warp
  int2* part;       // [2 kWarps]
  int* free;        // [rows sw]: the free counts (integers: exact in any order)
  float* occ_w;     // [rows sw]: the occupied sums
  float* occ_s;
  float* cells;     // [rows][4 spr]: the band's staged cells (fold)
  int r0, rows;     // the band's first row of the window, its rows
  int c0, cw;       // its first column and its columns (the pool: a tile's)
  int n_chunks;     // chunks of the ordered accumulation so far (its buffer)
#ifdef SLAM_KERNEL_PROBE
  long long t;                      // the clock at the last phase's end
  long long cycles[kProbeSlots];    // the cycles of each phase so far
#endif
};

// The probe build: the cycles since the last phase's end go to `phase`
// (kept in thread 0's registers until the block's end).
__device__ __forceinline__ void phase_done(Band& b, int phase) {
#ifdef SLAM_KERNEL_PROBE
  if (threadIdx.x == 0) {
    const long long now = clock64();
    b.cycles[phase] += now - b.t;
    b.t = now;
  }
#else
  (void)b;
  (void)phase;
#endif
}

// Adds a chunk's occupied samples (`keep` of each thread's) onto the
// band's running sums in sample order: the kept ones compacted in thread
// order (a ballot a warp, a prefix over the warps), then each warp walks
// them for the cells it owns (below). That is np.add.at's order for every
// cell. (Measured slower on an H100: one warp walking them all, with
// the leader of each cell adding its group from shared memory after a
// __match_any_sync, or with 32 shuffle rounds a window; the cells dealt to
// the warps as separate lists after a prefix over warps and buckets.)
__device__ __forceinline__ void ordered_add(Band& b, bool keep, int local, float w, float sv) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int buf = b.n_chunks++ & 1;
  int* counts = b.warp_count + buf * kWarps;
  int* lc = b.list_cell + buf * kThreads;
  float* lw = b.list_w + buf * kThreads;
  float* ls = b.list_s + buf * kThreads;
  const unsigned bal = __ballot_sync(kFull, keep);
  if (lane == 0) counts[warp] = __popc(bal);
  __syncthreads();
  phase_done(b, kAddCount);
  int before = 0, total = 0;
#pragma unroll
  for (int j = 0; j < kWarps; ++j) {
    const int c = counts[j];
    before += j < warp ? c : 0;
    total += c;
  }
  if (keep) {
    const int pos = before + __popc(bal & ((1u << lane) - 1u));
    lc[pos] = local;
    lw[pos] = w;
    ls[pos] = sv;
  }
  if (total == 0) return;  // uniform: nothing to add (the next chunk's barrier orders the buffers)
  __syncthreads();
  phase_done(b, kAddList);
#ifdef SLAM_KERNEL_PROBE
  if (threadIdx.x == 0) b.cycles[kEntries] += total;
#endif
  // the band's cells are dealt to the warps (cell % kWarps): each warp walks
  // the whole list, a window of 32 at a time, taking its own samples in
  // lane order; every lane of its own adds those of its cell up to itself
  // onto the cell's stored sum, and the cell's last one stores it
  for (int e0 = 0; e0 < total; e0 += 32) {
    const int e = e0 + lane;
    const int cell = e < total ? lc[e] : -1;
    const bool mine = cell >= 0 && cell % kWarps == warp;
    const unsigned own = __ballot_sync(kFull, mine);
    if (!own) continue;
    const float vw = mine ? lw[e] : 0.0f, vs = mine ? ls[e] : 0.0f;
    float aw = mine ? b.occ_w[cell] : 0.0f, as = mine ? b.occ_s[cell] : 0.0f;
    bool last = mine;
    for (unsigned m = own; m; m &= m - 1) {
      const int k = __ffs(m) - 1;
      const int ck = __shfl_sync(kFull, cell, k);
      const float wk = __shfl_sync(kFull, vw, k), sk = __shfl_sync(kFull, vs, k);
      if (mine && ck == cell) {
        if (k <= lane) {
          aw += wk;
          as += sk;
        } else {
          last = false;
        }
      }
    }
    if (last) {
      b.occ_w[cell] = aw;
      b.occ_s[cell] = as;
    }
    __syncwarp();
  }
  phase_done(b, kAddWalk);
}

// One occupied sample of a staged beam: kind 0 the endpoint's k-th (of 1,
// or of the 9 cells with the area estimator), kind 1 the k-th blur sample.
// Returns whether it adds evidence; its cell (fr, fc) and values (w, sv).
__device__ __forceinline__ bool occupied_sample(const Insert& s, const Frame& f, float4 b,
                                                int kind, int k, float& fr, float& fc, float& w,
                                                float& sv) {
  bool ok = b.w >= kEvidence;
  if (kind == 1) {
    const float tb = b.z + s.hole_half * __ldg(s.blur_table + k);
    fc = cell_of(f.px, b.x, tb, f.ox, s.inv_scale);
    fr = cell_of(f.py, b.y, tb, f.oy, s.inv_scale);
    w = __ldg(s.blur_table + s.blur + k);
    sv = __ldg(s.blur_table + 2 * s.blur + k);
    return ok && tb > 0.0f;
  }
  const float ex = __fmaf_rn(b.z, b.x, f.px);
  const float ey = __fmaf_rn(b.z, b.y, f.py);
  fc = floorf(__fmul_rn(ex - f.ox, s.inv_scale));
  fr = floorf(__fmul_rn(ey - f.oy, s.inv_scale));
  if (!s.area) {
    w = sv = 1.0f;
    return ok;
  }
  // the k-th of the 3 x 3 cells around the endpoint's, rows outer; floats
  // that hold integers, as the twin's int64 cells cast back
  fr += static_cast<float>(k / 3 - 1);
  fc += static_cast<float>(k % 3 - 1);
  const float lo_x = fc * s.scale + f.ox;
  const float lo_y = fr * s.scale + f.oy;
  const float ov_x =
      clamp_min(fminf(lo_x + s.scale, ex + s.hole_half) - fmaxf(lo_x, ex - s.hole_half), 0.0f);
  const float ov_y =
      clamp_min(fminf(lo_y + s.scale, ey + s.hole_half) - fmaxf(lo_y, ey - s.hole_half), 0.0f);
  const float a = ok ? __fmul_rn(ov_x * ov_y, s.inv_scale2) : 0.0f;
  w = sv = a;
  return a > 0.0f;
}

// Whether rows [lo, hi] (either order; NaN: no) meet the band.
__device__ __forceinline__ bool meets(float a, float c, float r0, float r1) {
  return fminf(a, c) < r1 && fmaxf(a, c) >= r0 && a == a && c == c;
}

// Beams [b0, b0 + n) of scan `scan` of the band's plane: staged, their free
// samples in the band counted (pass 0, DDA), their occupied samples of
// `kinds` (1: endpoints, 2: blur, 3: both, in that order) added in order.
// The pool (kPool): the band is one tile (its columns too), each occupied
// sample is scaled by q, and `seed` starts the occupied sums from q times
// the free counts once the last free samples are in, so that a cell's sum
// is the samples' in order, free ones first (the pool's one scatter).
template <bool kPool>
__device__ __forceinline__ void beam_chunk(const Insert& s, Band& b, const Frame& f, int scan,
                                           int b0, int n, int kinds, bool trace, bool seed,
                                           float q) {
  const int t = threadIdx.x;
  const float r0 = static_cast<float>(b.r0), r1 = static_cast<float>(b.r0 + b.rows);
  const float c0 = static_cast<float>(b.c0), c1 = static_cast<float>(b.c0 + b.cw);
  __syncthreads();  // the previous chunk is done with the staged beams and lists
  if (t < n) {
    const int beam = b0 + t;
    const float ang =
        __ldg(s.pose + 3 * scan + 2) + __ldg(s.bearings + scan * s.bearings_stride + beam);
    const float range = __ldg(s.ranges + scan * s.ranges_stride + beam);
    const bool valid = __ldg(s.valid + scan * s.valid_stride + beam);
    const float flags = !valid ? 0.0f : (range <= s.max_range ? kEvidence : kValid);
    b.beam[t] = make_float4(libm::cos(ang), libm::sin(ang), range, flags);
  }
  __syncthreads();
  phase_done(b, kStage);
  const float4 bm = t < n ? b.beam[t] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // --- the free trace's range of samples in the band, and the cull -------
  int count = 0, lo = 0;
  if (trace && bm.w >= kValid) {
    const float limit = bm.z - s.hole_half;
    const float step = s.step;
    // samples before the free limit: a prefix of the beam; each search
    // starts from where the real line crosses, t = (i + 0.5) step
    const int n_lim = first_true(0, s.n_free, ceilf(limit / step - 0.5f), [&](int i) {
      return !((static_cast<float>(i) + 0.5f) * step < limit);
    });
    auto row = [&](int i) {
      const float t_i = (static_cast<float>(i) + 0.5f) * step;
      return cell_of(f.py, bm.y, t_i, f.oy, s.inv_scale);
    };
    // the sample at which the beam's row crosses row boundary r, on the real line
    auto cross = [&](float r) {
      return ceilf(((r * s.scale + f.oy) - f.py) / (bm.y * step) - 0.5f);
    };
    int2 range = narrow(0, n_lim, r0, r1, row, cross);
    if constexpr (kPool) {  // and the tile's columns
      auto col = [&](int i) {
        const float t_i = (static_cast<float>(i) + 0.5f) * step;
        return cell_of(f.px, bm.x, t_i, f.ox, s.inv_scale);
      };
      auto cross_c = [&](float c) {
        return ceilf(((c * s.scale + f.ox) - f.px) / (bm.x * step) - 0.5f);
      };
      range = narrow(range.x, range.y, c0, c1, col, cross_c);
    }
    if (range.y > range.x) {
      lo = range.x;
      count = range.y - range.x;
    }
  }
  // --- whether the beam's occupied samples can reach the band ------------
  int rel = 0;
  if (t < n && bm.w >= kEvidence) {
    const float er = floorf(__fmul_rn(__fmaf_rn(bm.z, bm.y, f.py) - f.oy, s.inv_scale));
    const float ar = s.area ? 1.0f : 0.0f;
    if ((kinds & 1) && meets(er - ar, er + ar, r0, r1)) {
      if constexpr (kPool) {
        const float ec = floorf(__fmul_rn(__fmaf_rn(bm.z, bm.x, f.px) - f.ox, s.inv_scale));
        rel = meets(ec - ar, ec + ar, c0, c1);
      } else {
        rel = 1;
      }
    }
    if ((kinds & 2) && s.blur > 0) {
      const float ta = bm.z + s.hole_half * __ldg(s.blur_table);
      const float tz = bm.z + s.hole_half * __ldg(s.blur_table + s.blur - 1);
      if (meets(cell_of(f.py, bm.y, ta, f.oy, s.inv_scale),
                cell_of(f.py, bm.y, tz, f.oy, s.inv_scale), r0, r1)) {
        if constexpr (kPool) {
          if (meets(cell_of(f.px, bm.x, ta, f.ox, s.inv_scale),
                    cell_of(f.px, bm.x, tz, f.ox, s.inv_scale), c0, c1)) {
            rel = 1;
          }
        } else {
          rel = 1;
        }
      }
    }
  }
  phase_done(b, kSearch);
  int2 total;
  const int2 at = block_scan(make_int2(count, rel), b.part, total);
  b.start[t] = at.x;
  if (t == 0) b.start[kThreads] = total.x;
  b.first[t] = lo;
  if (rel) b.rel[at.y] = t;
  __syncthreads();
  phase_done(b, kScan);
  // --- the free samples: a run of consecutive items a thread, its beam
  // found once and the previous sample's cell carried along. (Measured no
  // faster on an H100: a warp a run with its lanes interleaved.) ----------
#ifdef SLAM_KERNEL_PROBE
  if (t == 0) b.cycles[kFreeCount] += total.x;
#endif
  const int per = (total.x + kThreads - 1) / kThreads;
  int item = t * per;
  const int end = min(item + per, total.x);
  if (item < end) {
    int j = -1;  // the beam whose range holds the item: the last start <= item
    float pr = 0.0f, pc = 0.0f;  // the previous sample's cell along beam j
    bool have_prev = false;
    for (; item < end; ++item) {
      if (j < 0 || b.start[j + 1] <= item) {  // the next beam with items (start[kThreads]: total)
        j = lower_bound(j + 1, kThreads, [&](int k) { return b.start[k] > item; }) - 1;
        have_prev = false;
      }
      const float4 bj = b.beam[j];
      const int i = b.first[j] + (item - b.start[j]);
      if (!have_prev && i > 0) {
        const float tp = (static_cast<float>(i - 1) + 0.5f) * s.step;
        pr = cell_of(f.py, bj.y, tp, f.oy, s.inv_scale);
        pc = cell_of(f.px, bj.x, tp, f.ox, s.inv_scale);
      }
      const float ti = (static_cast<float>(i) + 0.5f) * s.step;
      const float fc = cell_of(f.px, bj.x, ti, f.ox, s.inv_scale);
      const float fr = cell_of(f.py, bj.y, ti, f.oy, s.inv_scale);
      const bool fresh = i == 0 || fr != pr || fc != pc;
      if (fresh && fr >= r0 && fr < r1 && fc >= c0 && fc < c1) {
        atomicAdd(&b.free[(static_cast<int>(fr) - b.r0) * b.cw + (static_cast<int>(fc) - b.c0)], 1);
      }
      pr = fr;
      pc = fc;
      have_prev = true;
    }
  }
  phase_done(b, kFreeItems);
  if (seed) {  // every free sample of the band is counted: the sums start from them
    __syncthreads();
    for (int j = t; j < b.rows * b.cw; j += kThreads) {
      b.occ_w[j] = q * static_cast<float>(b.free[j]);
    }
    // (ordered_add's barrier, the next chunk's or the fold's orders these before any use)
  }
  // --- the occupied samples of the beams that can reach the band ----------
  const int e = s.area ? 9 : 1;
  const int n_ep = (kinds & 1) ? total.y * e : 0;
  const int n_items = n_ep + ((kinds & 2) ? total.y * s.blur : 0);
  for (int base = 0; base < n_items; base += kThreads) {
    const int item = base + t;
    bool keep = false;
    int local = 0;
    float w = 0.0f, sv = 0.0f;
    if (item < n_items) {
      const bool ep = item < n_ep;
      const int k = ep ? item : item - n_ep;
      const int per = ep ? e : s.blur;
      const int idx = b.rel[k / per];
      float fr, fc;
      keep = occupied_sample(s, f, b.beam[idx], ep ? 0 : 1, k % per, fr, fc, w, sv);
      keep = keep && fr >= r0 && fr < r1 && fc >= c0 && fc < c1;
      if (keep) local = (static_cast<int>(fr) - b.r0) * b.cw + (static_cast<int>(fc) - b.c0);
      if constexpr (kPool) {
        w = q * w;
        sv = q * sv;
      }
    }
    phase_done(b, kOccEval);
    ordered_add(b, keep, local, w, sv);
  }
#ifdef SLAM_KERNEL_PROBE
  if (t == 0) b.cycles[kItems] += n_items;
#endif
}

// Scan `scan` into the band: the free trace and the endpoints a chunk of
// beams at a time, then the blur (beams staged again where they took more
// than one chunk); one call site of beam_chunk, so its code is inlined once.
// The pool (kPool): where the scan takes more than one chunk, the free
// trace of every chunk first, then the endpoints, then the blur.
template <bool kPool>
__device__ __forceinline__ void band_scan(const Insert& s, Band& b, const Frame& f, int scan,
                                          float q) {
  const int n_chunks = (s.r + kThreads - 1) / kThreads;
  const int passes = n_chunks == 1 ? 1 : (kPool ? 2 : 1) + (s.blur > 0 ? 1 : 0);
  for (int c = 0; c < passes * n_chunks; ++c) {
    const int pass = c / n_chunks, b0 = (c - pass * n_chunks) * kThreads;
    const int kinds = n_chunks == 1 ? 3 : (kPool ? pass : (pass == 0 ? 1 : 2));
    beam_chunk<kPool>(s, b, f, scan, b0, min(kThreads, s.r - b0), kinds,
                      s.n_free > 0 && pass == 0, kPool && pass == 0 && c == n_chunks - 1, q);
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Slot j of the band's staged row rr: the 16 bytes of global floats
// [a + 4j, a + 4j + 4), a = g & ~3 (g the row's first float); the row's
// floats [g, g + n) sit at rr * 4 spr + (x - a) in shared memory. `load`:
// global -> shared (cp.async), else shared -> global.
template <bool kLoad>
__device__ __forceinline__ void band_slot(const Insert& s, const Band& b, float* gbase, long long g,
                                          int n, int rr, int j) {
  const long long a = g & ~3ll, lo = a + 4ll * j;
  if (lo >= g + n) return;
  float* staged = b.cells + rr * 4 * s.spr + 4 * j;
  if (lo >= g && lo + 4 <= g + n) {
    if (kLoad) {
      cp_async16(staged, gbase + lo);
    } else {
      *reinterpret_cast<float4*>(gbase + lo) = *reinterpret_cast<const float4*>(staged);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (lo + k >= g && lo + k < g + n) {
      if (kLoad) {
        cp_async4(staged + k, gbase + lo + k);
      } else {
        gbase[lo + k] = staged[k];
      }
    }
  }
}

// The band's window rows of map m: every slot of every row, kThreads at a time.
template <bool kLoad, int kC>
__device__ void band_rows(const Insert& s, const Band& b, int m, const Corner& c, float* gbase) {
  const int n = s.sw * kC;
  for (int item = threadIdx.x; item < b.rows * s.spr; item += kThreads) {
    const int rr = item / s.spr, j = item - rr * s.spr;
    const long long g = ((static_cast<long long>(m) * s.h + c.row + b.r0 + rr) * s.w + c.col) * kC;
    band_slot<kLoad>(s, b, gbase, g, n, rr, j);
  }
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
    // q o + base and q (1 - o) + base each one fused multiply-add
    const float pu = libm::exp(k * libm::log(clamp_min(s.base, s.eps)));
    const float po = libm::exp(k * libm::log(clamp_min(libm::fma32(obs, s.quality, s.base), s.eps)));
    const float pe = libm::exp(
        k * libm::log(clamp_min(libm::fma32(1.0f - obs, s.quality, s.base), s.eps)));
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

// Floats [a, b) of src to dst by `n` threads from `tid`: 16-byte runs
// where both are aligned alike (they are: the same layout, bases 16-byte
// aligned), single floats at the ends.
__device__ __forceinline__ void copy_floats(const float* src, float* dst, long long a, long long b,
                                            int tid, int n) {
  if (a >= b) return;
  const long long va = (a + 3) >> 2, vb = b >> 2;
  if (va >= vb) {
    for (long long i = a + tid; i < b; i += n) dst[i] = __ldg(src + i);
    return;
  }
  for (long long i = a + tid; i < 4 * va; i += n) dst[i] = __ldg(src + i);
  for (long long i = 4 * vb + tid; i < b; i += n) dst[i] = __ldg(src + i);
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* d4 = reinterpret_cast<float4*>(dst);
  long long v = va + tid;
  for (; v + 3ll * n < vb; v += 4ll * n) {
    const float4 x0 = __ldcs(s4 + v), x1 = __ldcs(s4 + v + n), x2 = __ldcs(s4 + v + 2 * n),
                 x3 = __ldcs(s4 + v + 3 * n);
    __stcs(d4 + v, x0);
    __stcs(d4 + v + n, x1);
    __stcs(d4 + v + 2 * n, x2);
    __stcs(d4 + v + 3 * n, x3);
  }
  for (; v < vb; v += n) __stcs(d4 + v, __ldcs(s4 + v));
}

// Copy block cb: rows [y0, y1) of map cb / n_copy, the cells outside its
// window. Whole rows by the block, the rows the window crosses a warp each.
template <int kC>
__device__ void copy_outside(const Insert& s, int cb) {
  const int m = cb / s.n_copy;
  const int y0 = (cb - m * s.n_copy) * s.copy_rows, y1 = min(y0 + s.copy_rows, s.h);
  const Corner c = corner_of(s, m);
  const long long row_f = static_cast<long long>(s.w) * kC;
  const long long map0 = static_cast<long long>(m) * s.h * row_f;
  const long long lo = y0, hi = y1;
  const int ya = static_cast<int>(min(max(c.row, lo), hi));
  const int yb = static_cast<int>(min(max(c.row + s.sh, lo), hi));
  copy_floats(s.cells, s.out, map0 + y0 * row_f, map0 + ya * row_f, threadIdx.x, kThreads);
  copy_floats(s.cells, s.out, map0 + yb * row_f, map0 + y1 * row_f, threadIdx.x, kThreads);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int y = ya + warp; y < yb; y += kWarps) {
    const long long r = map0 + y * row_f;
    copy_floats(s.cells, s.out, r, r + c.col * kC, lane, 32);
    copy_floats(s.cells, s.out, r + (c.col + s.sw) * kC, r + row_f, lane, 32);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 2) insert_kernel(const Insert s) {
  constexpr int kC = channels_of(kMode);
  const int bid = blockIdx.x;
  if (bid >= s.p * s.n_bands) {
    if constexpr (kMode != kPlanes) copy_outside<kC>(s, bid - s.p * s.n_bands);
    return;
  }
  const int m = bid / s.n_bands, band = bid - m * s.n_bands;
  extern __shared__ float4 smem[];
  Band b;
  b.beam = smem;
  b.part = reinterpret_cast<int2*>(smem + kThreads);  // 2 kWarps: a multiple of 16 bytes
  b.cells = reinterpret_cast<float*>(b.part + 2 * kWarps);
  b.free = reinterpret_cast<int*>(b.cells + (kMode == kPlanes ? 0 : s.rows * 4 * s.spr));
  b.occ_w = reinterpret_cast<float*>(b.free + s.rows * s.sw);
  b.occ_s = b.occ_w + s.rows * s.sw;
  b.list_w = b.occ_s + s.rows * s.sw;
  b.list_s = b.list_w + 2 * kThreads;
  int* ints = reinterpret_cast<int*>(b.list_s + 2 * kThreads);
  b.list_cell = ints;
  b.start = b.list_cell + 2 * kThreads;
  b.first = b.start + kThreads + 4;
  b.rel = b.first + kThreads;
  b.warp_count = b.rel + kThreads;
  b.r0 = band * s.rows;
  b.rows = min(s.rows, s.sh - b.r0);
  b.c0 = 0;
  b.cw = s.sw;
  b.n_chunks = 0;
#ifdef SLAM_KERNEL_PROBE
  b.t = clock64();
  for (int k = 0; k < kProbeSlots; ++k) b.cycles[k] = 0;
#endif
  const int n_cells = b.rows * s.sw;

  Corner corner{0, 0, 0.0f, 0.0f};
  const float q = s.q ? __ldg(s.q) : 1.0f;  // loaded now, used by the fold
  if constexpr (kMode != kPlanes) {
    corner = corner_of(s, m);
    // the band's cells on their way while it rasterises
    band_rows<true, kC>(s, b, m, corner, const_cast<float*>(s.cells));
  }
  for (int j = threadIdx.x; j < n_cells; j += kThreads) {
    b.free[j] = 0;
    b.occ_w[j] = 0.0f;
    b.occ_s[j] = 0.0f;
  }
  // (band_scan's first barrier orders these before any use)
  phase_done(b, kSetup);

  if constexpr (kMode != kPlanes) {
    const Frame f{__ldg(s.pose + 3 * m), __ldg(s.pose + 3 * m + 1), corner.ox, corner.oy};
    band_scan<false>(s, b, f, m, 1.0f);
  } else {
    for (int scan = s.plane_of ? 0 : m; scan < (s.plane_of ? s.n_scans : m + 1); ++scan) {
      if (s.plane_of && __ldg(s.plane_of + scan) != m) continue;
      const Frame f{__ldg(s.pose + 3 * scan), __ldg(s.pose + 3 * scan + 1),
                    __ldg(s.origin + scan * s.origin_stride),
                    __ldg(s.origin + scan * s.origin_stride + 1)};
      band_scan<false>(s, b, f, scan, 1.0f);
    }
  }
  __syncthreads();

  const long long plane0 = (static_cast<long long>(m) * s.sh + b.r0) * s.sw;
  if constexpr (kMode == kPlanes) {
    for (int j = threadIdx.x; j < n_cells; j += kThreads) {
      const float wf =
          s.free_plane ? __ldg(s.free_plane + plane0 + j) : static_cast<float>(b.free[j]);
      s.w_out[plane0 + j] = wf + b.occ_w[j];
      s.s_out[plane0 + j] = b.occ_s[j];
    }
  } else {
    cp_async_wait_all();
    __syncthreads();
    phase_done(b, kFoldWait);
    for (int j = threadIdx.x; j < n_cells; j += kThreads) {
      const int rr = j / s.sw, cc = j - rr * s.sw;
      const long long g =
          ((static_cast<long long>(m) * s.h + corner.row + b.r0 + rr) * s.w + corner.col) * kC;
      float* cell = b.cells + rr * 4 * s.spr + static_cast<int>(g & 3) + cc * kC;
      const float w_free =
          s.free_plane ? __ldg(s.free_plane + plane0 + j) : static_cast<float>(b.free[j]);
      float w = w_free + b.occ_w[j], sv = b.occ_s[j];
      if (s.q) {
        w = q * w;
        sv = q * sv;
      }
      float in[kC], o[kC];
#pragma unroll
      for (int ch = 0; ch < kC; ++ch) in[ch] = cell[ch];
      fold_cell<kMode>(s, in, in[kC - 1], w, sv, o);
      o[kC - 1] = in[kC - 1] + w;
#pragma unroll
      for (int ch = 0; ch < kC; ++ch) cell[ch] = o[ch];
    }
    __syncthreads();
    band_rows<false, kC>(s, b, m, corner, s.out);
  }
  phase_done(b, kFold);
#ifdef SLAM_KERNEL_PROBE
  if (threadIdx.x == 0 && blockIdx.x < kProbeBlocks) {
    for (int k = 0; k < kProbeSlots; ++k) {
      probe_cycles[blockIdx.x * kProbeSlots + k] = b.cycles[k];
    }
  }
#endif
}

// --- The block pool ----------------------------------------------------------
//
// A step's scans go into P block tables over one pool in two launches, and
// nothing else runs on the host. They replace what the reference computes
// before and in its pool scatter (slam_constructor_tpu/ops/cow.py:82
// prepare_write and :143 scatter_observations; ops/blockmap.py:87
// allocate_tiles and :117), which the TPU ran as XLA sorts, gathers and
// scatters.
//
// pool_prepare_kernel, one thread-block cluster (16 blocks of 512 threads
// where the card places it, else 8): every block marks the tiles of its
// share of the beams in a bitset in its shared memory (a beam's free trace
// walked by the samples where its row or column passes a tile boundary,
// not sample by sample); block 0 ORs the bitsets through distributed
// shared memory and writes the marks once, then compacts the needed
// entries and the free slots by block prefix sums (cow.prepare_write's
// order, trap o kept) or allocates the tiled map's tiles, on the state
// cached in its shared memory; after the cluster barrier block 0 writes
// each slot's owner and the insert's work list while the other blocks copy
// or reset the new blocks (only those: the sources are used slots, the
// destinations free ones). pool_kernel, a fixed grid of about two blocks
// an SM, takes the list's items from an atomic counter: the banded tiles
// in row bands (the tile around each particle's robot, where every beam
// starts, and its neighbours where the list stays within the grid), every
// other touched tile a block, every other live slot folded with no
// observation.
//
// What bounds them on an H100: bytes, far below a launch. The prepare moves
// the tables, refcounts and marks (a few KB) and each new block read and
// written once (a few a step on the RBPF once it has converged, up to ~180
// of 8 KB at its first step: 2.8 MB, 0.8 us); its time is the marking of
// ~680 beams a block on 16 SMs and block 0's chain of prefix sums and
// barriers (PERF.md). The insert moves each live block twice (~4 MB,
// 1.2 us); its time is the slowest item's chain of phases (a band's free
// items and a fixed cost of ~10,000 cycles an item), which the bands split.

// The work list (i32): a header, the items, the prepare's scratch (the
// needed entries in order, their new slots, the copy sources), then each
// slot's owner (pool_owners' meaning: p th tw + tile of the touched entry
// that owns the slot alone, else -1).
constexpr int kWorkTake = 0, kWorkDone = 1, kWorkCount = 2, kWorkBands = 3, kWorkCopies = 4;
constexpr int kWorkHead = 8;
// an item: slot << 4 | code; code < kMaxRobotBands: that band of rows of a
// banded tile (the tile around a particle's robot, and its neighbours where
// the list stays within the grid's blocks); kItemTile: a whole touched
// tile; kItemFold: a live slot folded with no observation
constexpr int kMaxRobotBands = 8, kItemTile = 14, kItemFold = 15;

// the items at most: the banded tiles' bands (the robots' tiles, or with
// their neighbours up to the grid's blocks), then one a slot
__host__ __device__ inline long long pool_items_max(const Insert& s) {
  const long long bands = static_cast<long long>(s.p) * s.robot_bands;
  return (bands > kTargetBlocks ? bands : kTargetBlocks) + s.n_slots;
}
__host__ __device__ inline int* pool_items(const Insert& s) { return s.work + kWorkHead; }
__host__ __device__ inline int* pool_sel(const Insert& s) {
  return pool_items(s) + pool_items_max(s);
}
__host__ __device__ inline int* pool_dst(const Insert& s) { return pool_sel(s) + s.n_slots; }
__host__ __device__ inline int* pool_src(const Insert& s) { return pool_dst(s) + s.n_slots; }
__host__ __device__ inline int* pool_owner(const Insert& s) { return pool_src(s) + s.n_slots; }

// The cells [off, off + n) of the pool (floats) to or from shared memory:
// 16-byte copies where both ends are 16-byte aligned (the pool is), single
// floats otherwise.
template <bool kLoad>
__device__ __forceinline__ void slot_cells(float* staged, float* pool, long long off, int n) {
  float* g = pool + off;
  if (((off | n) & 3) == 0) {
    for (int j = threadIdx.x; j < n / 4; j += kThreads) {
      if (kLoad) {
        cp_async16(staged + 4 * j, g + 4 * j);
      } else {
        reinterpret_cast<float4*>(g)[j] = reinterpret_cast<const float4*>(staged)[j];
      }
    }
    return;
  }
  for (int j = threadIdx.x; j < n; j += kThreads) {
    if (kLoad) {
      cp_async4(staged + j, g + j);
    } else {
      g[j] = staged[j];
    }
  }
}

// The pool insert: a fixed grid of blocks takes the prepare's items in
// order from an atomic counter. A band item or a tile item runs the band
// machinery on its rows of its owner's tile (the columns narrowed too, the
// sums seeded with the free counts: the pool's one scatter's order, so a
// band's cells are the whole tile's bit for bit) and folds them; a fold
// item folds its slot with no observation (the reference folds the whole
// pool; that is not the identity, BayesAvg's (p n + 0) / n may move p by an
// ulp). Dead slots have no item. Each slot's cells are read and written by
// the blocks of its own items only, each band its own rows, so the pool is
// updated in place. No block reads the tables.
template <int kModel>
__global__ void __launch_bounds__(kThreads, 2) pool_kernel(const Insert s) {
  constexpr int kC = channels_of(kModel);
  const int bb = s.block * s.block;
  const int n_tiles = s.th * s.tw;
  const int* items = pool_items(s);
  const int* owner = pool_owner(s);
  const int count = s.work[kWorkCount];
  const int nb = s.work[kWorkBands];
  const int band_rows = (s.block + nb - 1) / nb;
  const float q = s.q ? __ldg(s.q) : 1.0f;
  extern __shared__ float4 smem[];
  __shared__ int taken;
  Band b;
  b.beam = smem;
  b.part = reinterpret_cast<int2*>(smem + kThreads);
  b.cells = reinterpret_cast<float*>(b.part + 2 * kWarps);
  b.free = reinterpret_cast<int*>(b.cells + ((bb * kC + 3) & ~3));
  b.occ_w = reinterpret_cast<float*>(b.free + bb);
  b.occ_s = b.occ_w + bb;
  b.list_w = b.occ_s + bb;
  b.list_s = b.list_w + 2 * kThreads;
  int* ints = reinterpret_cast<int*>(b.list_s + 2 * kThreads);
  b.list_cell = ints;
  b.start = b.list_cell + 2 * kThreads;
  b.first = b.start + kThreads + 4;
  b.rel = b.first + kThreads;
  b.warp_count = b.rel + kThreads;
  b.n_chunks = 0;
#ifdef SLAM_KERNEL_PROBE
  b.t = clock64();
  for (int k = 0; k < kProbeSlots; ++k) b.cycles[k] = 0;
#endif
  for (;;) {
    __syncthreads();  // the last item is done with the shared memory and `taken` is read
    if (threadIdx.x == 0) taken = atomicAdd(s.work + kWorkTake, 1);
    __syncthreads();
    const int it = taken;
    if (it >= count) break;
    const int item = items[it];
    const int slot = item >> 4, code = item & 15;
    const long long slot0 = static_cast<long long>(slot) * bb * kC;
#ifdef SLAM_KERNEL_PROBE
    const long long item_t0 = clock64();
    const long long free0 = b.cycles[kFreeCount], occ0 = b.cycles[kItems];
#endif
    if (code == kItemFold) {
      float* g = s.pool + slot0;
      for (int j = threadIdx.x; j < bb; j += kThreads) {
        float in[kC], o[kC];
#pragma unroll
        for (int ch = 0; ch < kC; ++ch) in[ch] = g[j * kC + ch];
        fold_cell<kModel>(s, in, in[kC - 1], 0.0f, 0.0f, o);
        o[kC - 1] = in[kC - 1] + 0.0f;
#pragma unroll
        for (int ch = 0; ch < kC; ++ch) g[j * kC + ch] = o[ch];
      }
      continue;
    }
    const int own = owner[slot];
    const int scan = own / n_tiles, tile = own - scan * n_tiles;
    const int tr = tile / s.tw, tc = tile - tr * s.tw;
    const int r_lo = code == kItemTile ? 0 : code * band_rows;
    b.r0 = tr * s.block + r_lo;
    b.rows = code == kItemTile ? s.block : min(band_rows, s.block - r_lo);
    b.c0 = tc * s.block;
    b.cw = s.block;
    const int n_cells = b.rows * s.block;
    const long long off = slot0 + static_cast<long long>(r_lo) * s.block * kC;
    slot_cells<true>(b.cells, s.pool, off, n_cells * kC);  // on their way while the band rasterises
    for (int j = threadIdx.x; j < n_cells; j += kThreads) {
      b.free[j] = 0;
      b.occ_w[j] = 0.0f;
      b.occ_s[j] = 0.0f;
    }
    phase_done(b, kSetup);
    const Frame f{__ldg(s.pose + 3 * scan), __ldg(s.pose + 3 * scan + 1), __ldg(s.origin),
                  __ldg(s.origin + 1)};
    band_scan<true>(s, b, f, scan, q);
    cp_async_wait_all();
    __syncthreads();
    phase_done(b, kFoldWait);
    for (int j = threadIdx.x; j < n_cells; j += kThreads) {
      float* cell = b.cells + j * kC;
      float in[kC], o[kC];
#pragma unroll
      for (int ch = 0; ch < kC; ++ch) in[ch] = cell[ch];
      const float w = b.occ_w[j];
      fold_cell<kModel>(s, in, in[kC - 1], w, b.occ_s[j], o);
      o[kC - 1] = in[kC - 1] + w;
#pragma unroll
      for (int ch = 0; ch < kC; ++ch) cell[ch] = o[ch];
    }
    __syncthreads();
    slot_cells<false>(b.cells, s.pool, off, n_cells * kC);
    phase_done(b, kFold);
#ifdef SLAM_KERNEL_PROBE
    if (threadIdx.x == 0 && it < kProbeItems) {
      probe_items[4 * it] = clock64() - item_t0;
      probe_items[4 * it + 1] = b.cycles[kFreeCount] - free0;
      probe_items[4 * it + 2] = b.cycles[kItems] - occ0;
      probe_items[4 * it + 3] = static_cast<unsigned long long>(item);
    }
#endif
  }
  // the last block out sets the counters back: the launch can be replayed
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(s.work + kWorkDone, 1) == static_cast<int>(gridDim.x) - 1) {
      s.work[kWorkTake] = 0;
      s.work[kWorkDone] = 0;
    }
  }
#ifdef SLAM_KERNEL_PROBE
  if (threadIdx.x == 0 && blockIdx.x < kProbeBlocks) {
    for (int k = 0; k < kProbeSlots; ++k) {
      probe_cycles[blockIdx.x * kProbeSlots + k] = b.cycles[k];
    }
  }
#endif
}

// --- The prepare launch --------------------------------------------------------

enum PrepMode { kTouch = 0, kGiven = 1, kCow = 2, kTiled = 3 };

// the marks of 262,144 table entries, a bit each, in a block's shared memory
constexpr int kMaxMarkWords = 8192;
constexpr int kMaxClusterBlocks = 16;  // non-portable: 8 where the card cannot place 16
// block 0 keeps the tables, refcounts and owners in its shared memory where
// they fit in this much with the marks (else it works on them in place in
// device memory, the same code through generic pointers)
constexpr int kPrepCacheBytes = 160 * 1024;
// consecutive entries or slots a thread takes in block 0's prefix sums
constexpr int kRun = 8;

// The marks' staging area in shared memory: a chunk of kThreads beams.
struct MarkChunk {
  float4* beam;  // [kThreads]: dx, dy, range, flags
  float4* ends;  // [kThreads]: the row and column of the first and last free sample
  int4* bound;   // [kThreads]: the first row boundary, their count, the same for columns
  int* n_free;   // [kThreads]: free samples before the limit
  int* scan;     // [kThreads]: the beam's scan
  int* start;    // [kThreads + 1]: each beam's first item, then the total
};

__host__ __device__ constexpr int mark_chunk_bytes() { return kThreads * (16 * 3 + 12) + 16; }

// The boundaries (multiples of bk, within [0, extent]) that a coordinate
// monotone along the beam passes between a (the first sample's) and z (the
// last one's): the first boundary's index m and their count; rising, the m
// with a < m bk <= z, falling the m with z < m bk <= a, from the largest.
__device__ __forceinline__ int2 boundaries(float a, float z, int bk, int n_bk, float extent) {
  const bool up = a <= z;
  const float lo = up ? a : z, hi = up ? z : a;
  // the smallest m with m bk > lo, the largest with m bk <= hi
  const int m_lo = lo < 0.0f ? 0 : (lo >= extent ? n_bk + 1 : static_cast<int>(lo) / bk + 1);
  const int m_hi = hi < 0.0f ? -1 : (hi >= extent ? n_bk : static_cast<int>(hi) / bk);
  const int count = max(0, m_hi - m_lo + 1);
  return make_int2(up ? m_lo : m_hi, count);
}

// Sets, in `bits` (shared memory), the bit of each tile of table p that
// the beams [g0, g1) (beam g of scan g / R) put a sample of weight q w > 0
// in on the table: pool_touched_ref's marks. A sample's row and column are
// each monotone along the beam (every IEEE op of their chains is), so the
// free trace's tile changes only where one of them passes a tile boundary:
// its tiles are the first sample's and, for each boundary it passes, the
// tile of the first sample past it, found by the band's search from where
// the real line crosses. The beams of a chunk are staged a thread each
// (their free limit and the cells at both ends), then every boundary and
// every occupied sample is an item of its own, a run of them a thread. A
// cell is the twin's floor of an IEEE division (cell_of).
__device__ void mark_beams(const Insert& s, int g0, int g1, float q, unsigned* bits,
                           const MarkChunk& c, int2* part) {
  const int t = threadIdx.x, bk = s.block;
  const float rows = static_cast<float>(s.th * bk), cols = static_cast<float>(s.tw * bk);
  const float step = s.step;
  const int e_occ = s.area ? 9 : 1;
  for (int base = g0; base < g1; base += kThreads) {
    const int n_beams = min(kThreads, g1 - base);
    // --- a beam a thread: its frame, free limit, ends and boundaries ------
    int items = 0;
    if (t < n_beams) {
      const int g = base + t;
      const int scan = g / s.r, beam = g - scan * s.r;
      float4 bm = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 ends = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      int4 bound = make_int4(0, 0, 0, 0);
      int n = 0;
      if (__ldg(s.valid + scan * s.valid_stride + beam)) {
        const float ang =
            __ldg(s.pose + 3 * scan + 2) + __ldg(s.bearings + scan * s.bearings_stride + beam);
        const float range = __ldg(s.ranges + scan * s.ranges_stride + beam);
        bm = make_float4(libm::cos(ang), libm::sin(ang), range, range <= s.max_range ? kEvidence : kValid);
        if (q > 0.0f) {  // a free sample's weight is q
          const float limit = range - s.hole_half;
          n = first_true(0, s.n_free, ceilf(__fdividef(limit, step) - 0.5f), [&](int i) {
            return !((static_cast<float>(i) + 0.5f) * step < limit);
          });
        }
        if (n > 0) {
          const float px = __ldg(s.pose + 3 * scan), py = __ldg(s.pose + 3 * scan + 1);
          const float ox = __ldg(s.origin), oy = __ldg(s.origin + 1);
          const float t0 = 0.5f * step, t1 = (static_cast<float>(n - 1) + 0.5f) * step;
          ends = make_float4(cell_of(py, bm.y, t0, oy, s.inv_scale),
                             cell_of(py, bm.y, t1, oy, s.inv_scale),
                             cell_of(px, bm.x, t0, ox, s.inv_scale),
                             cell_of(px, bm.x, t1, ox, s.inv_scale));
          if (ends.x == ends.x && ends.y == ends.y && ends.z == ends.z && ends.w == ends.w) {
            const int2 br = boundaries(ends.x, ends.y, bk, s.th, rows);
            const int2 bc = boundaries(ends.z, ends.w, bk, s.tw, cols);
            bound = make_int4(br.x, br.y, bc.x, bc.y);
            items = 1 + br.y + bc.y;
          } else {
            n = 0;
          }
        }
        if (bm.w >= kEvidence) items += e_occ + s.blur;
      }
      c.beam[t] = bm;
      c.ends[t] = ends;
      c.bound[t] = bound;
      c.n_free[t] = n;
      c.scan[t] = scan;
    }
    int2 total;
    const int at = block_scan(make_int2(items, 0), part, total).x;
    c.start[t] = at;
    if (t == 0) c.start[kThreads] = total.x;
    __syncthreads();
    // --- the items, a run of consecutive ones a thread ---------------------
    const int per = (total.x + kThreads - 1) / kThreads;
    int item = t * per;
    const int end = min(item + per, total.x);
    int j = -1, last = -1;
    for (; item < end; ++item) {
      if (j < 0 || c.start[j + 1] <= item) {  // the beam whose items hold this one
        j = lower_bound(j + 1, kThreads, [&](int x) { return c.start[x] > item; }) - 1;
      }
      const int scan = c.scan[j];
      const float4 bm = c.beam[j];
      const Frame f{__ldg(s.pose + 3 * scan), __ldg(s.pose + 3 * scan + 1), __ldg(s.origin),
                    __ldg(s.origin + 1)};
      const int n = c.n_free[j];
      const int4 bd = c.bound[j];
      int k = item - c.start[j];
      float fr = -1.0f, fc = -1.0f;
      bool hit = false;
      if (n > 0 && k <= bd.y + bd.w) {  // the free trace: the first sample, or a boundary's
        const float4 ends = c.ends[j];
        auto row = [&](int i) {
          return cell_of(f.py, bm.y, (static_cast<float>(i) + 0.5f) * step, f.oy, s.inv_scale);
        };
        auto col = [&](int i) {
          return cell_of(f.px, bm.x, (static_cast<float>(i) + 0.5f) * step, f.ox, s.inv_scale);
        };
        int i0 = 0;
        if (k > 0) {  // a boundary that the row (k <= bd.y) or the column passes
          const bool is_row = k <= bd.y;
          const float p0 = is_row ? f.py : f.px, d0 = is_row ? bm.y : bm.x;
          const float o0 = is_row ? f.oy : f.ox;
          const bool up = is_row ? ends.x <= ends.y : ends.z <= ends.w;
          const int kb = is_row ? k - 1 : k - 1 - bd.y, m0 = is_row ? bd.x : bd.z;
          const float a = static_cast<float>((up ? m0 + kb : m0 - kb) * bk);
          // a guess: a fast division will do
          const float guess = ceilf(__fdividef((a * s.scale + o0) - p0, d0 * step) - 0.5f);
          i0 = first_true(1, n, guess, [&](int i) {
            const float v = cell_of(p0, d0, (static_cast<float>(i) + 0.5f) * step, o0, s.inv_scale);
            return up ? v >= a : v < a;
          });
        }
        fr = i0 == 0 ? ends.x : row(i0);
        fc = i0 == 0 ? ends.z : col(i0);
        hit = true;
      } else {  // an occupied sample
        if (n > 0) k -= 1 + bd.y + bd.w;
        float w, sv;
        hit = occupied_sample(s, f, bm, k < e_occ ? 0 : 1, k < e_occ ? k : k - e_occ, fr,
                                    fc, w, sv) && q * w > 0.0f;
      }
      if (hit && fr >= 0.0f && fr < rows && fc >= 0.0f && fc < cols) {
        const int e = scan * s.th * s.tw + (static_cast<int>(fr) / bk) * s.tw +
                      static_cast<int>(fc) / bk;
        // most beams of a scan mark the same few tiles: an atomic only
        // where the bit is not yet set
        const unsigned m = 1u << (e & 31);
        if (e != last && !(*static_cast<volatile unsigned*>(bits + (e >> 5)) & m)) {
          atomicOr(bits + (e >> 5), m);
        }
        last = e;
      }
    }
    __syncthreads();  // the chunk's staging is free again
  }
}

__device__ __forceinline__ bool marked(const unsigned* bits, int e) {
  return (bits[e >> 5] >> (e & 31)) & 1u;
}

// Block 0's view of the state: the marks, and the tables, refcounts and
// owners in its shared memory (copied in, written back) or in place in
// device memory.
struct PrepView {
  unsigned* bits;
  int* tables;  // [p th tw]
  int* refcnt;  // [n_slots] or null
  int* owner;   // [n_slots]
  int* robot;   // [p]: the tile that holds each scan's pose (cached only)
  int* kinds;   // [n_slots]: each slot's kind in the work list
  bool cached;
};

// Entries [0, n) a round of kThreads kRun: `flag(e)` (bool) of each, then
// `take(e, rank)` for those that hold, the rank their place in increasing e
// among them. A warp takes kRun 32 consecutive entries, a lane every 32nd
// (ballots keep the order), one block prefix a round over the warps'
// counts. Returns how many hold.
template <typename Flag, typename Take>
__device__ __forceinline__ int compact(int n, int2* part, Flag flag, Take take) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned below = (1u << lane) - 1u;
  int taken = 0;
  for (int base = 0; base < n; base += kThreads * kRun) {
    const int w0 = base + warp * 32 * kRun;
    unsigned hold[kRun];
    int count = 0;
    // (loops, not unrolled: block 0 runs this code once a launch, and the
    // instruction fetches of unrolled copies cost more than the loop)
#pragma unroll 1
    for (int k = 0; k < kRun; ++k) {
      const int e = w0 + 32 * k + lane;
      hold[k] = __ballot_sync(kFull, e < n && flag(e));
      count += __popc(hold[k]);
    }
    int2 total;
    const int before = block_scan(make_int2(lane == 0 ? count : 0, 0), part, total).x;
    int at = taken + __shfl_sync(kFull, before, 0);
#pragma unroll 1
    for (int k = 0; k < kRun; ++k) {
      if (hold[k] >> lane & 1u) take(w0 + 32 * k + lane, at + __popc(hold[k] & below));
      at += __popc(hold[k]);
    }
    taken += total.x;
  }
  return taken;
}

// The copy-on-write compaction (cow.prepare_write): the needed (scan,
// tile) entries (touched, and unmapped or shared) in row-major order, at
// most min(k_max, N) kept; the free slots (refcount 0) in increasing order;
// the k-th needed entry takes the k-th free slot (a fresh tile's block reset
// to the init cell, a shared one's copied), the tables and refcounts
// updated; demand past k_max or the free slots latches the overflow and
// keeps those entries' tables (trap o). Block 0.
__device__ void prepare_cow(const Insert& s, const PrepView& v, int2* part) {
  const int t = threadIdx.x, n = s.n_slots, n_entries = s.p * s.th * s.tw;
  int *sel = pool_sel(s), *dst = pool_dst(s), *src = pool_src(s);
  const int cap = min(s.k_max, n);
  const int k_needed = compact(
      n_entries, part,
      [&](int e) {
        if (!marked(v.bits, e)) return false;
        const int slot = v.tables[e];
        return slot < 0 || v.refcnt[min(slot, n - 1)] > 1;
      },
      [&](int e, int at) {
        if (at < cap) sel[at] = e;
      });
  const int k_use = min(k_needed, cap);
  const int n_free = compact(
      n, part, [&](int slot) { return v.refcnt[slot] == 0; },
      [&](int slot, int at) {
        if (at < k_use) dst[at] = slot;
      });
  const int k_eff = min(k_use, n_free);
  __syncthreads();  // sel and dst are written, every refcount read
  for (int k = t; k < k_eff; k += kThreads) {
    const int e = sel[k], d = dst[k];
    const int old = v.tables[e];  // -1: a fresh tile; else the shared block it copies
    src[k] = old;
    v.tables[e] = d;
    v.refcnt[d] = 1;
    if (old >= 0) atomicSub(v.refcnt + old, 1);
  }
  if (t == 0) {
    *s.overflow = (*s.overflow || k_needed > min(n_free, s.k_max)) ? 1 : 0;
    s.work[kWorkCopies] = k_eff;
  }
  __syncthreads();
}

// The tiled map's allocation (blockmap.allocate_tiles): each touched tile
// without a block gets slot n_alloc + its rank in row-major order, -1 past
// the capacity; n_alloc counts the demand. Block 0.
__device__ void prepare_tiled(const Insert& s, const PrepView& v, int2* part) {
  const int n_alloc = *s.n_alloc;
  const int fresh = compact(
      s.th * s.tw, part, [&](int e) { return marked(v.bits, e) && v.tables[e] < 0; },
      [&](int e, int at) { v.tables[e] = n_alloc + at < s.n_slots ? n_alloc + at : -1; });
  if (threadIdx.x == 0) *s.n_alloc = n_alloc + fresh;
  __syncthreads();
}

// The tile that holds scan p's pose (-1: off the table, or NaN).
__device__ __forceinline__ int robot_tile(const Insert& s, int p) {
  const float fc = floorf((__ldg(s.pose + 3 * p) - __ldg(s.origin)) / s.scale);
  const float fr = floorf((__ldg(s.pose + 3 * p + 1) - __ldg(s.origin + 1)) / s.scale);
  if (!(fr >= 0.0f && fr < static_cast<float>(s.th * s.block) && fc >= 0.0f &&
        fc < static_cast<float>(s.tw * s.block))) {
    return -1;
  }
  return (static_cast<int>(fr) / s.block) * s.tw + static_cast<int>(fc) / s.block;
}

// Each slot's owner, then the work list, slot by slot in increasing order:
// first the bands of the banded tiles' slots (a robot's tile, and its
// neighbours where the list then holds at most kTargetBlocks bands and
// tiles), then the slots that another touched tile owns, then the live
// slots that nothing owns. Block 0.
__device__ void work_list(const Insert& s, const PrepView& v, int2* part, long long* sub) {
  const int t = threadIdx.x, n = s.n_slots, n_tiles = s.th * s.tw, n_entries = s.p * n_tiles;
  int* items = pool_items(s);
  const int live_end = v.refcnt ? 0 : min(*s.n_alloc, n);
  for (int slot = t; slot < n; slot += kThreads) v.owner[slot] = -1;
  if (v.robot) {
    for (int p = t; p < s.p; p += kThreads) v.robot[p] = robot_tile(s, p);
  }
  __syncthreads();
  for (int e = t; e < n_entries; e += kThreads) {
    if (!marked(v.bits, e)) continue;
    const int slot = v.tables[e];
    if (slot >= 0 && slot < n && (v.refcnt ? v.refcnt[slot] == 1 : slot < live_end)) {
      v.owner[slot] = e;
    }
  }
  __syncthreads();
#ifdef SLAM_KERNEL_PROBE
  if (t == 0) sub[0] = clock64();
#endif
  const int nb = s.robot_bands;
  // each slot's kind, once: 0 none, 1 a robot's tile, 2 a tile next to it,
  // 3 another owned tile, 4 live and folded
  int2 mine = make_int2(0, 0);
  for (int slot = t; slot < n; slot += kThreads) {
    const int own = v.owner[slot];
    int k = 0;
    if (own < 0) {
      k = (v.refcnt ? v.refcnt[slot] > 0 : slot < live_end) ? 4 : 0;
    } else {
      const int p = own / n_tiles, tile = own - p * n_tiles;
      const int robot = v.robot ? v.robot[p] : robot_tile(s, p);
      const int dr = tile / s.tw - robot / s.tw, dc = tile % s.tw - robot % s.tw;
      k = tile == robot ? 1 : (robot >= 0 && dr >= -1 && dr <= 1 && dc >= -1 && dc <= 1 ? 2 : 3);
    }
    v.kinds[slot] = k;
    mine.x += k == 1 || k == 2;
    mine.y += k == 3;
  }
  // the robots' neighbours are banded too where the list then stays within
  // the grid's blocks (a map, not the RBPF's many)
  int2 owned;
  block_scan(mine, part, owned);  // (its barriers order the kinds before their use)
  const bool near = owned.x * nb + owned.y <= kTargetBlocks;
  auto kind = [&](int slot) { return v.kinds[slot]; };
  auto banded = [&](int k) { return k == 1 || (near && k == 2); };
  const int n_band = nb * compact(n, part, [&](int slot) { return banded(kind(slot)); },
                                  [&](int slot, int at) {
                                    for (int j = 0; j < nb; ++j) items[at * nb + j] = slot << 4 | j;
                                  });
#ifdef SLAM_KERNEL_PROBE
  if (t == 0) sub[1] = clock64();
#endif
  const int n_tile = compact(n, part, [&](int slot) {
                               const int k = kind(slot);
                               return k == 3 || (!near && k == 2);
                             },
                             [&](int slot, int at) { items[n_band + at] = slot << 4 | kItemTile; });
#ifdef SLAM_KERNEL_PROBE
  if (t == 0) sub[2] = clock64();
#endif
  const int folds = compact(n, part, [&](int slot) { return kind(slot) == 4; },
                            [&](int slot, int at) {
                              items[n_band + n_tile + at] = slot << 4 | kItemFold;
                            });
#ifdef SLAM_KERNEL_PROBE
  if (t == 0) sub[3] = clock64();
#endif
  if (t == 0) {
    if (s.mode != kCow) s.work[kWorkCopies] = 0;
    s.work[kWorkCount] = n_band + n_tile + folds;
    s.work[kWorkBands] = nb;
    s.work[kWorkTake] = 0;
    s.work[kWorkDone] = 0;
  }
}

// The new blocks of the copy-on-write compaction, `me`-th of `workers`:
// block k's cells are the source block's (the block it shares) or the init
// cell; 8 float4 copies in flight a thread. The sources are used slots and
// the destinations free ones, so no copy reads what another writes.
__device__ void copy_blocks(const Insert& s, int me, int workers) {
  const int k_eff = __ldcg(s.work + kWorkCopies);
  const int *dst = pool_dst(s), *src = pool_src(s);
  const int per = s.block * s.block * s.c;
  const int mine = k_eff > me ? (k_eff - me + workers - 1) / workers : 0;
  if ((per & 3) == 0) {
    const int per4 = per / 4;
    const long long total = static_cast<long long>(mine) * per4;
    constexpr int kDepth = 8;
    for (long long i0 = threadIdx.x; i0 < total; i0 += kDepth * kThreads) {
      float4 v[kDepth];
      long long at[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const long long i = i0 + static_cast<long long>(u) * kThreads;
        at[u] = -1;
        v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i < total) {
          const int kk = static_cast<int>(i / per4), j = static_cast<int>(i - kk * per4);
          const int k = me + kk * workers;
          const int from = __ldcg(src + k);
          at[u] = static_cast<long long>(__ldcg(dst + k)) * per4 + j;
          if (from >= 0) {
            v[u] = reinterpret_cast<const float4*>(s.pool)[static_cast<long long>(from) * per4 + j];
          } else {
            v[u] = make_float4(__ldg(s.init + (4 * j) % s.c), __ldg(s.init + (4 * j + 1) % s.c),
                               __ldg(s.init + (4 * j + 2) % s.c), __ldg(s.init + (4 * j + 3) % s.c));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        if (at[u] >= 0) reinterpret_cast<float4*>(s.pool)[at[u]] = v[u];
      }
    }
    return;
  }
  const long long total = static_cast<long long>(mine) * per;
  for (long long i = threadIdx.x; i < total; i += kThreads) {
    const int kk = static_cast<int>(i / per), j = static_cast<int>(i - static_cast<long long>(kk) * per);
    const int k = me + kk * workers;
    const int from = __ldcg(src + k);
    s.pool[static_cast<long long>(__ldcg(dst + k)) * per + j] =
        from >= 0 ? s.pool[static_cast<long long>(from) * per + j] : __ldg(s.init + j % s.c);
  }
}

// A prepare block's shared memory: the marks (a bit an entry, rounded up
// to 16 bytes), then the marks' staging area, which block 0 reuses after
// the marks for the tables, owners, refcounts and robot tiles where they fit
// in kPrepCacheBytes.
__host__ __device__ inline int prep_words(const Insert& s) {
  return (((s.p * s.th * s.tw + 31) >> 5) + 3) & ~3;
}
__host__ __device__ inline long long prep_cache_ints(const Insert& s) {
  return static_cast<long long>(s.p) * s.th * s.tw + (s.refcnt ? 3ll : 2ll) * s.n_slots + s.p;
}
__host__ __device__ inline bool prep_cached(const Insert& s) {
  return s.mode != kTouch && 4 * (prep_words(s) + prep_cache_ints(s)) <= kPrepCacheBytes;
}
inline size_t prep_shared_bytes(const Insert& s) {
  const long long cache = prep_cached(s) ? 4 * prep_cache_ints(s) : 0;
  const long long chunk = s.mode != kGiven ? mark_chunk_bytes() : 0;
  return static_cast<size_t>(4ll * prep_words(s) + (cache > chunk ? cache : chunk));
}

// The prepare launch: one cluster. Every block marks the tiles of an even
// share of the P R beams in a bitset of its own (kGiven: the marks are
// given); block 0 ORs the blocks' bitsets through distributed shared
// memory, writes the marks out once, and (kCow) compacts or (kTiled)
// allocates, on the tables and refcounts copied into its shared memory
// where they fit; after the cluster barrier block 0 writes the owners and
// the work list while the others (kCow) copy the new blocks. kTouch stops
// after the marks.
__global__ void __launch_bounds__(kThreads, 1) pool_prepare_kernel(const Insert s) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int t = threadIdx.x;
  extern __shared__ unsigned prep_smem[];
  __shared__ int2 part[2 * kWarps];
  unsigned* bits = prep_smem;
  const int n_entries = s.p * s.th * s.tw, n_words = prep_words(s);
  unsigned* area = bits + n_words;  // the marks' staging, then block 0's cache
#ifdef SLAM_KERNEL_PROBE
  // the probe build: thread 0's clock at each phase's end, the slowest
  // thread's marking, kept by cluster block
  __shared__ unsigned long long slowest;
  long long stamp[kPrepSlots] = {};
  stamp[0] = clock64();
  if (t == 0) slowest = 0;
#endif
  for (int w = t; w < n_words; w += kThreads) bits[w] = 0;
  __syncthreads();
  if (s.mode != kGiven) {
    const float q = s.q ? __ldg(s.q) : 1.0f;
    const int n_beams = s.p * s.r;
    const int share = (n_beams + cs - 1) / cs;
    const int g0 = min(n_beams, rank * share), g1 = min(n_beams, g0 + share);
    MarkChunk chunk;
    chunk.beam = reinterpret_cast<float4*>(area);
    chunk.ends = chunk.beam + kThreads;
    chunk.bound = reinterpret_cast<int4*>(chunk.ends + kThreads);
    chunk.n_free = reinterpret_cast<int*>(chunk.bound + kThreads);
    chunk.scan = chunk.n_free + kThreads;
    chunk.start = chunk.scan + kThreads;
#ifdef SLAM_KERNEL_PROBE
    const long long mine0 = clock64();
#endif
    mark_beams(s, g0, g1, q, bits, chunk, part);
#ifdef SLAM_KERNEL_PROBE
    atomicMax(&slowest, static_cast<unsigned long long>(clock64() - mine0));
#endif
  }
#ifdef SLAM_KERNEL_PROBE
  __syncthreads();
  stamp[1] = clock64();
#endif
  cluster.sync();  // every block's marks are in
#ifdef SLAM_KERNEL_PROBE
  stamp[2] = clock64();
#endif
  PrepView v{bits, s.tables, s.refcnt, pool_owner(s), nullptr, pool_sel(s), prep_cached(s)};
  if (rank == 0) {
    if (v.cached) {  // the state into shared memory, while the marks are ORed
      int* cache = reinterpret_cast<int*>(area);
      for (int e = t; e < n_entries; e += kThreads) cache[e] = s.tables[e];
      v.tables = cache;
      v.owner = cache + n_entries;
      v.kinds = v.owner + s.n_slots;
      v.robot = v.kinds + s.n_slots;
      if (s.refcnt) {
        v.refcnt = v.robot + s.p;
        for (int k = t; k < s.n_slots; k += kThreads) v.refcnt[k] = s.refcnt[k];
      }
    }
    if (s.mode == kGiven) {
      for (int w = t; w < n_words; w += kThreads) {
        unsigned m = 0;
        for (int j = 0; j < 32 && 32 * w + j < n_entries; ++j) {
          m |= (s.touched[32 * w + j] ? 1u : 0u) << j;
        }
        bits[w] = m;
      }
    } else {
      for (int i = t; i < n_words * (cs - 1); i += kThreads) {  // the other blocks' words
        const int w = i / (cs - 1), r = 1 + i % (cs - 1);
        const unsigned m = cluster.map_shared_rank(bits, r)[w];
        if (m) atomicOr(bits + w, m);
      }
    }
    __syncthreads();
    if (s.mode != kGiven) {
      for (int e = t; e < n_entries; e += kThreads) s.touched[e] = marked(bits, e);
    }
#ifdef SLAM_KERNEL_PROBE
    stamp[3] = clock64();
#endif
    if (s.mode == kCow) prepare_cow(s, v, part);
    if (s.mode == kTiled) prepare_tiled(s, v, part);
    __threadfence();  // the copy list, for the other blocks
#ifdef SLAM_KERNEL_PROBE
    __syncthreads();
    stamp[4] = clock64();
#endif
  }
  cluster.sync();  // block 0 is done with the other blocks' bitsets; the copy list is out
#ifdef SLAM_KERNEL_PROBE
  stamp[5] = clock64();
#endif
  if (s.mode != kTouch) {
    if (rank == 0) {
#ifdef SLAM_KERNEL_PROBE
      work_list(s, v, part, stamp + 8);
#else
      work_list(s, v, part, nullptr);
#endif
      if (v.cached) {  // the state back to device memory
        __syncthreads();
        if (s.mode == kCow || s.mode == kTiled) {
          for (int e = t; e < n_entries; e += kThreads) s.tables[e] = v.tables[e];
        }
        if (s.mode == kCow) {
          for (int k = t; k < s.n_slots; k += kThreads) s.refcnt[k] = v.refcnt[k];
        }
        int* owner = pool_owner(s);
        for (int k = t; k < s.n_slots; k += kThreads) owner[k] = v.owner[k];
      }
    }
    if (s.mode == kCow && (rank > 0 || cs == 1)) {
      copy_blocks(s, cs > 1 ? rank - 1 : 0, max(1, cs - 1));
    }
  }
#ifdef SLAM_KERNEL_PROBE
  __syncthreads();
  stamp[6] = clock64();
  if (t == 0 && rank < kProbePrepBlocks) {
    // the marks (the block's), the slowest thread's marks, the wait at the
    // first barrier, block 0's OR, its compaction, the second barrier, the
    // list or the copies, and the whole
    // (block 0: the owners, the robots' bands, the tiles, the folds)
    const long long d[kPrepSlots] = {stamp[1] - stamp[0], static_cast<long long>(slowest),
                                     stamp[2] - stamp[1], rank == 0 ? stamp[3] - stamp[2] : 0,
                                     rank == 0 ? stamp[4] - stamp[3] : 0,
                                     stamp[5] - (rank == 0 ? stamp[4] : stamp[2]),
                                     stamp[6] - stamp[5], stamp[6] - stamp[0],
                                     rank == 0 ? stamp[8] - stamp[5] : 0,
                                     rank == 0 ? stamp[9] - stamp[8] : 0,
                                     rank == 0 ? stamp[10] - stamp[9] : 0,
                                     rank == 0 ? stamp[11] - stamp[10] : 0};
    for (int k = 0; k < kPrepSlots; ++k) probe_prep[rank * kPrepSlots + k] = d[k];
  }
#endif
}

int spr_of(int sw, int c) { return c ? (sw * c + 3) / 4 + 1 : 0; }

// A band's rows: enough bands for kTargetBlocks over the P maps, as many
// rows as fit kBandBytes (at least one); `rows` > 0 asks for that many.
int band_rows_of(int p, int sh, int sw, int c, int rows) {
  if (rows > 0) return min(rows, sh);  // the launch refuses more than a block's shared memory
  const int bands = min(sh, max(1, (kTargetBlocks + p - 1) / p));
  const long long per_row = 12ll * sw + 16ll * spr_of(sw, c);
  const int fit = static_cast<int>(max(1ll, kBandBytes / per_row));
  return max(1, min((sh + bands - 1) / bands, fit));
}

size_t shared_bytes(int rows, int sw, int c) {
  return static_cast<size_t>(kThreads) * 16                      // beams
         + static_cast<size_t>(kWarps) * 2 * 8                   // scan parts
         + static_cast<size_t>(rows) * 16 * spr_of(sw, c)        // staged cells
         + static_cast<size_t>(rows) * sw * 12                   // free, occ_w, occ_s
         + static_cast<size_t>(kThreads) * 4 * (2 + 2 + 2 + 3) + 16  // lists, start, first, rel
         + static_cast<size_t>(kWarps) * 2 * 4;                  // ordered_add's counts
}

template <int kMode>
int launch(Insert& s, int rows_req, cudaStream_t st) {
  constexpr int kC = channels_of(kMode);
  s.rows = band_rows_of(s.p, s.sh, s.sw, kC, rows_req);
  s.n_bands = (s.sh + s.rows - 1) / s.rows;
  s.spr = spr_of(s.sw, kC);
  const size_t shared = shared_bytes(s.rows, s.sw, kC);
  if (shared > static_cast<size_t>(kMaxShared)) return static_cast<int>(cudaErrorInvalidValue);
  const bool outside = kMode != kPlanes && s.windowed && (s.sh < s.h || s.sw < s.w);
  s.copy_rows = outside ? max(1, kCopyBytes / (s.w * kC * 4)) : 1;
  s.n_copy = outside ? (s.h + s.copy_rows - 1) / s.copy_rows : 0;
  const long long blocks = static_cast<long long>(s.p) * (s.n_bands + s.n_copy);
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  // the default is 48 KB a block
  if (shared > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(insert_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  insert_kernel<kMode><<<static_cast<unsigned>(blocks), kThreads, shared, st>>>(s);
  return static_cast<int>(cudaGetLastError());
}

size_t pool_shared_bytes(int block, int c) {
  const size_t bb = static_cast<size_t>(block) * block;
  return static_cast<size_t>(kThreads) * 16 + static_cast<size_t>(kWarps) * 2 * 8 +
         ((bb * c + 3) & ~static_cast<size_t>(3)) * 4 + bb * 12 +
         static_cast<size_t>(kThreads) * 4 * (2 + 2 + 2 + 3) + 16 + static_cast<size_t>(kWarps) * 2 * 4;
}

template <int kModel>
int launch_pool(Insert& s, cudaStream_t st) {
  const size_t shared = pool_shared_bytes(s.block, channels_of(kModel));
  if (shared > static_cast<size_t>(kMaxShared)) return static_cast<int>(cudaErrorInvalidValue);
  if (shared > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(pool_kernel<kModel>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // about two blocks an SM, fewer where the list cannot hold as many items
  const long long blocks = min(static_cast<long long>(kTargetBlocks), pool_items_max(s));
  pool_kernel<kModel><<<static_cast<unsigned>(blocks), kThreads, shared, st>>>(s);
  return static_cast<int>(cudaGetLastError());
}

// The prepare launch's cluster: 16 blocks where the card can place such a
// cluster (a non-portable size), else the portable 8. Asked once a process.
int prepare_cluster_blocks() {
  static int chosen = 0;
  if (chosen) return chosen;
  cudaFuncSetAttribute(pool_prepare_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  for (int blocks = kMaxClusterBlocks; blocks > 1; blocks /= 2) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks, 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, pool_prepare_kernel, &cfg) == cudaSuccess && n > 0) {
      chosen = blocks;
      return chosen;
    }
    cudaGetLastError();  // the refused size's error is not the launch's
  }
  chosen = 1;
  return chosen;
}

int launch_prepare(Insert& s, cudaStream_t st) {
  const int blocks = prepare_cluster_blocks();
  const size_t shared = prep_shared_bytes(s);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        pool_prepare_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = shared;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, pool_prepare_kernel, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

void set_scan(Insert& s, const float* pose, const float* ranges, long long ranges_stride,
              const float* bearings, long long bearings_stride, const unsigned char* valid,
              long long valid_stride, int r, int n_free, float step, float hole_half,
              float max_range, int area, int blur, const float* blur_table,
              const float* free_plane) {
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
}

}  // namespace

// Inserts map m's scan at pose[m] into map m of `cells` (f32[p, h, w, c],
// contiguous, 16-byte aligned, world origin origin[m]) on the sh x sw
// window around pose[m] (windowed; else the whole map), writing every cell
// to `out` (the same shape, 16-byte aligned): one launch of insert_kernel
// on `stream` (PyTorch's current stream), a block a band of `rows` rows of
// a window (0: chosen from p, sh, sw) and blocks that copy the cells
// outside the windows. Does not synchronise and allocates nothing. Returns
// the cudaError_t of the launch (0 = ok).
extern "C" int scan_insert_launch(
    const float* cells, float* out, int p, int h, int w, int c, int windowed,
    const float* origin, int sh, int sw, float scale, float scale2,
    const float* pose, const float* ranges, long long ranges_stride, const float* bearings,
    long long bearings_stride, const unsigned char* valid, long long valid_stride, int r,
    int n_free, float step, float hole_half, float max_range, int area, int blur,
    const float* blur_table, const float* free_plane, const float* q, int model, float quality,
    float base, float decay, float keep, float eps, int rows, void* stream) {
  if (p <= 0 || h <= 0 || w <= 0 || r <= 0 || sh <= 0 || sw <= 0 || sh > h || sw > w ||
      (!windowed && (sh != h || sw != w)) || model < kBayesBase || model > kTbm ||
      c != (model == kTbm ? 5 : 2) || (blur > 0 && !blur_table) ||
      (n_free <= 0 && !free_plane) || (reinterpret_cast<uintptr_t>(cells) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Insert s{};
  s.cells = cells;
  s.out = out;
  s.p = p;
  s.h = h;
  s.w = w;
  s.windowed = windowed;
  s.origin = origin;
  s.origin_stride = 2;
  s.sh = sh;
  s.sw = sw;
  s.scale = scale;
  s.inv_scale = 1.0f / scale;
  s.scale2 = scale2;
  s.inv_scale2 = 1.0f / scale2;
  s.n_scans = p;
  set_scan(s, pose, ranges, ranges_stride, bearings, bearings_stride, valid, valid_stride, r,
           n_free, step, hole_half, max_range, area, blur, blur_table, free_plane);
  s.q = q;
  s.quality = quality;
  s.base = base;
  s.decay = decay;
  s.keep = keep;
  s.eps = eps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (model == kBayesAvg) return launch<kBayesAvg>(s, rows, st);
  if (model == kBayesBase) return launch<kBayesBase>(s, rows, st);
  return launch<kTbm>(s, rows, st);
}

// Rasterises n_scans scans into n_planes planes of sh x sw: w_out and s_out
// f32[n_planes, sh, sw] (contiguous) get each plane's (w_free + w_occ,
// s_occ). Scan i (pose[i], its rows at i * *_stride, its plane's world
// origin at origin + i * origin_stride) goes into plane plane_of[i]
// (i64, read on the device; null: plane i, n_planes == n_scans); each
// plane's occupied samples are summed scan after scan in increasing i.
// free_plane f32[n_planes, sh, sw] (polar) or null (the DDA trace). One
// launch, a block a band of `rows` rows (0: chosen) of a plane.
extern "C" int scan_planes_launch(
    float* w_out, float* s_out, int n_planes, int sh, int sw, const float* origin,
    long long origin_stride, float scale, float scale2, int n_scans, const long long* plane_of,
    const float* pose, const float* ranges, long long ranges_stride, const float* bearings,
    long long bearings_stride, const unsigned char* valid, long long valid_stride, int r,
    int n_free, float step, float hole_half, float max_range, int area, int blur,
    const float* blur_table, const float* free_plane, int rows, void* stream) {
  if (n_planes <= 0 || sh <= 0 || sw <= 0 || r <= 0 || n_scans < 0 ||
      (!plane_of && n_scans != n_planes) || (blur > 0 && !blur_table) ||
      (n_free <= 0 && !free_plane)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Insert s{};
  s.w_out = w_out;
  s.s_out = s_out;
  s.p = n_planes;
  s.h = sh;
  s.w = sw;
  s.origin = origin;
  s.origin_stride = origin_stride;
  s.sh = sh;
  s.sw = sw;
  s.scale = scale;
  s.inv_scale = 1.0f / scale;
  s.scale2 = scale2;
  s.inv_scale2 = 1.0f / scale2;
  s.n_scans = n_scans;
  s.plane_of = plane_of;
  set_scan(s, pose, ranges, ranges_stride, bearings, bearings_stride, valid, valid_stride, r,
           n_free, step, hole_half, max_range, area, blur, blur_table, free_plane);
  return launch<kPlanes>(s, rows, static_cast<cudaStream_t>(stream));
}

// The prepare launch (one thread-block cluster on `stream`) for scan p
// (pose[p], its rows at p * *_stride) and table p of tables i32[p, th, tw]
// over the slots of `pool` f32[n_slots, block, block, c] (contiguous,
// 16-byte aligned; world origin origin[0..1] of tile (0, 0)); touched
// u8[p, th, tw]; work i32[kWorkHead + pool_items_max + 4 n_slots] (the
// header, the items, three scratch lists, the owners). mode
// 0 (kTouch): writes the marks to touched (a tile where a sample of scan p
// adds evidence, q w > 0, on table p's cells) and nothing else;
// 1 (kGiven): reads the marks from touched, leaves the tables as they are
// and writes the owners and the work list, live slots those with
// refcnt > 0 (refcnt given) or below *n_alloc; 2 (kCow): the marks, then
// the copy-on-write compaction of at most k_max new blocks into tables,
// refcnt and *overflow and the new blocks' cells (a copy of the shared
// block, or init f32[c]) in place, then the owners and the work list;
// 3 (kTiled, p == 1): the marks, then slots for the touched tiles without
// one from *n_alloc (updated), then the owners and the work list. *q scales
// each sample (null: 1). Returns the cudaError_t.
extern "C" int pool_prepare_launch(
    int mode, unsigned char* touched, int* tables, int* refcnt, unsigned char* overflow,
    int* n_alloc, float* pool, int n_slots, int block, int c, const float* init, int k_max,
    int n_bands, int* work, int p, int th, int tw, const float* origin, float scale,
    float scale2, const float* pose, const float* ranges, long long ranges_stride,
    const float* bearings, long long bearings_stride, const unsigned char* valid,
    long long valid_stride, int r, int n_free, float step, float hole_half, float max_range,
    int area, int blur, const float* blur_table, const float* q, void* stream) {
  const long long entries = static_cast<long long>(p) * th * tw;
  if (mode < kTouch || mode > kTiled || p <= 0 || th <= 0 || tw <= 0 || block <= 0 || r <= 0 ||
      n_free <= 0 || (blur > 0 && !blur_table) || !touched ||
      entries > 32ll * kMaxMarkWords || static_cast<long long>(p) * r > 0x7fffffffll ||
      (mode != kTouch && (n_slots <= 0 || n_bands < 1 || n_bands > kMaxRobotBands || !work ||
                          !tables || (!refcnt && !n_alloc) ||
                          static_cast<long long>(n_slots) >= (1ll << 27))) ||
      (mode == kCow && (!refcnt || !overflow || !pool || !init || c <= 0 || k_max < 0 ||
                        (reinterpret_cast<uintptr_t>(pool) & 15))) ||
      (mode == kTiled && (p != 1 || !n_alloc))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Insert s{};
  s.mode = mode;
  s.touched = touched;
  s.tables = tables;
  s.refcnt = mode == kTiled ? nullptr : refcnt;
  s.overflow = overflow;
  s.n_alloc = n_alloc;
  s.pool = pool;
  s.n_slots = n_slots;
  s.block = block;
  s.c = c;
  s.init = init;
  s.k_max = k_max;
  s.robot_bands = n_bands;
  s.work = work;
  s.p = p;
  s.th = th;
  s.tw = tw;
  s.origin = origin;
  s.scale = scale;
  s.inv_scale = 1.0f / scale;
  s.scale2 = scale2;
  s.inv_scale2 = 1.0f / scale2;
  s.n_scans = p;
  set_scan(s, pose, ranges, ranges_stride, bearings, bearings_stride, valid, valid_stride, r,
           n_free, step, hole_half, max_range, area, blur, blur_table, nullptr);
  s.q = q;
  return launch_prepare(s, static_cast<cudaStream_t>(stream));
}

// The block pool (K3 over a block table): scan p (pose[p], its rows at
// p * *_stride) into its tiles of tables i32[p, th, tw] over the slots of
// `pool` f32[n_slots, block, block, c] (contiguous, 16-byte aligned, world
// origin origin[0..1] of tile (0, 0)), folded, in place, by the items of
// `work` (pool_prepare_launch's, for the same p, n_slots and tables): a
// touched tile's slot takes its samples and is folded, in row bands for the
// banded tiles; every other live slot is folded with no
// observation; a dead slot is left as it is. A sample's weight and sum are
// scaled by *q (null: 1). The DDA free trace only. One launch of a fixed
// grid on `stream`; it sets the list's counters back, so it can be
// replayed. Returns the cudaError_t.
extern "C" int pool_insert_launch(
    float* pool, int n_slots, int block, int c, int* work, int n_bands, int p, int th, int tw,
    const float* origin, float scale, float scale2, const float* pose, const float* ranges,
    long long ranges_stride, const float* bearings, long long bearings_stride,
    const unsigned char* valid, long long valid_stride, int r, int n_free, float step,
    float hole_half, float max_range, int area, int blur, const float* blur_table,
    const float* q, int model, float quality, float base, float decay, float keep, float eps,
    void* stream) {
  if (n_slots <= 0 || block <= 0 || p <= 0 || th <= 0 || tw <= 0 || r <= 0 || n_free <= 0 ||
      n_bands < 1 || n_bands > kMaxRobotBands || model < kBayesBase || model > kTbm ||
      c != (model == kTbm ? 5 : 2) || (blur > 0 && !blur_table) || !work ||
      (reinterpret_cast<uintptr_t>(pool) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Insert s{};
  s.pool = pool;
  s.n_slots = n_slots;
  s.block = block;
  s.c = c;
  s.work = work;
  s.robot_bands = n_bands;
  s.p = p;
  s.th = th;
  s.tw = tw;
  s.origin = origin;
  s.scale = scale;
  s.inv_scale = 1.0f / scale;
  s.scale2 = scale2;
  s.inv_scale2 = 1.0f / scale2;
  s.n_scans = p;
  set_scan(s, pose, ranges, ranges_stride, bearings, bearings_stride, valid, valid_stride, r,
           n_free, step, hole_half, max_range, area, blur, blur_table, nullptr);
  s.q = q;
  s.quality = quality;
  s.base = base;
  s.decay = decay;
  s.keep = keep;
  s.eps = eps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (model == kBayesAvg) return launch_pool<kBayesAvg>(s, st);
  if (model == kBayesBase) return launch_pool<kBayesBase>(s, st);
  return launch_pool<kTbm>(s, st);
}

// The prepare launch's cluster size on this card (16 or 8).
extern "C" int pool_prepare_cluster_size() { return prepare_cluster_blocks(); }

#ifdef SLAM_KERNEL_PROBE
// The probe build: copies the block pool's stamps to `prep`
// (u64[kProbePrepBlocks][kPrepSlots]) and `items` (u64[kProbeItems][4])
// and zeroes them on the device.
extern "C" int pool_probe_stamps(void* prep, void* items) {
  cudaError_t err = cudaMemcpyFromSymbol(prep, probe_prep, sizeof(probe_prep));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(items, probe_items, sizeof(probe_items));
  void* at = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&at, probe_prep);
  if (err == cudaSuccess) err = cudaMemset(at, 0, sizeof(probe_prep));
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&at, probe_items);
  if (err == cudaSuccess) err = cudaMemset(at, 0, sizeof(probe_items));
  return static_cast<int>(err);
}

// The probe build: copies the cycles by block and phase to `dst`
// (u64[kProbeBlocks][kProbeSlots]) and zeroes them on the device.
extern "C" int scan_insert_probe_stamps(void* dst) {
  cudaError_t err = cudaMemcpyFromSymbol(dst, probe_cycles, sizeof(probe_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* at = nullptr;
  err = cudaGetSymbolAddress(&at, probe_cycles);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemset(at, 0, sizeof(probe_cycles)));
}
#endif

// The rows of a band that a launch of p maps (planes) of sh x sw cells of c
// channels (0: planes) takes when it is asked for none.
extern "C" int scan_insert_band_rows(int p, int sh, int sw, int c) {
  return band_rows_of(p, sh, sw, c, 0);
}
