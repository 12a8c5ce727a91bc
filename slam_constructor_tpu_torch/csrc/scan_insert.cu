// scan_insert.cu: the scan insert with its cell fold (K3), one map or P maps
// a call, and the shared-plane rasteriser (N scans summed into P planes),
// for Hopper (sm_90a). Plain C interface, bound from Python with ctypes
// (slam_constructor_tpu_torch/ops/kernels.py::scan_insert and ::scan_planes,
// built by ops/_build.py).
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
// 2. free trace: a sample's row floor(((py + t_i dy) - oy) / scale),
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
// in the twin's order; divisions by the cell size are IEEE divisions
// (grid.div_scale), the directions cosf/sinf of pose[2] + bearing, the TBM
// powers expf(k logf(max(base, 1e-9))), BayesBase's powf(1 - q, w), the
// four masses summed (m0 + m2) + (m1 + m3), the order of the card's sum over
// the last dimension (PyTorch's reduce: a lane a mass, then a shuffle tree
// with offsets 2 and 1). A NaN sample position is dropped.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

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
  // the block pool (pool_insert_launch): f32[n_slots, B, B, C], updated in place
  float* pool;
  const int* tables;    // i32[p, th, tw]: each scan's slot of each tile, -1 = none
  const int* refcnt;    // i32[n_slots] (live where > 0) or null
  const int* n_live;    // i32[] (the slots below it live) or null
  int n_slots, block, th, tw;
  unsigned char* touched;  // u8[n_scans, th, tw]: pool_touch_launch's output, the pool's input
  int n_seg;               // pool_touch_launch: threads a beam
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

// A scan's frame: the pose's position and the plane's (window's) origin.
struct Frame {
  float px, py, ox, oy;
};

// The beam flags staged beside a beam's direction and range.
constexpr float kValid = 1.0f, kEvidence = 2.0f;  // valid, and valid with range <= max_range

__device__ __forceinline__ float cell_of(float p, float d, float t, float o, float scale) {
  return floorf(((p + t * d) - o) / scale);
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
    fc = cell_of(f.px, b.x, tb, f.ox, s.scale);
    fr = cell_of(f.py, b.y, tb, f.oy, s.scale);
    w = __ldg(s.blur_table + s.blur + k);
    sv = __ldg(s.blur_table + 2 * s.blur + k);
    return ok && tb > 0.0f;
  }
  const float ex = f.px + b.z * b.x;
  const float ey = f.py + b.z * b.y;
  fc = floorf((ex - f.ox) / s.scale);
  fr = floorf((ey - f.oy) / s.scale);
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
  const float a = ok ? (ov_x * ov_y) / s.scale2 : 0.0f;
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
    b.beam[t] = make_float4(cosf(ang), sinf(ang), range, flags);
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
      return cell_of(f.py, bm.y, t_i, f.oy, s.scale);
    };
    // the sample at which the beam's row crosses row boundary r, on the real line
    auto cross = [&](float r) {
      return ceilf(((r * s.scale + f.oy) - f.py) / (bm.y * step) - 0.5f);
    };
    int2 range = narrow(0, n_lim, r0, r1, row, cross);
    if constexpr (kPool) {  // and the tile's columns
      auto col = [&](int i) {
        const float t_i = (static_cast<float>(i) + 0.5f) * step;
        return cell_of(f.px, bm.x, t_i, f.ox, s.scale);
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
    const float er = floorf(((f.py + bm.z * bm.y) - f.oy) / s.scale);
    const float ar = s.area ? 1.0f : 0.0f;
    if ((kinds & 1) && meets(er - ar, er + ar, r0, r1)) {
      if constexpr (kPool) {
        const float ec = floorf(((f.px + bm.z * bm.x) - f.ox) / s.scale);
        rel = meets(ec - ar, ec + ar, c0, c1);
      } else {
        rel = 1;
      }
    }
    if ((kinds & 2) && s.blur > 0) {
      const float ta = bm.z + s.hole_half * __ldg(s.blur_table);
      const float tz = bm.z + s.hole_half * __ldg(s.blur_table + s.blur - 1);
      if (meets(cell_of(f.py, bm.y, ta, f.oy, s.scale),
                cell_of(f.py, bm.y, tz, f.oy, s.scale), r0, r1)) {
        if constexpr (kPool) {
          if (meets(cell_of(f.px, bm.x, ta, f.ox, s.scale),
                    cell_of(f.px, bm.x, tz, f.ox, s.scale), c0, c1)) {
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
        pr = cell_of(f.py, bj.y, tp, f.oy, s.scale);
        pc = cell_of(f.px, bj.x, tp, f.ox, s.scale);
      }
      const float ti = (static_cast<float>(i) + 0.5f) * s.step;
      const float fc = cell_of(f.px, bj.x, ti, f.ox, s.scale);
      const float fr = cell_of(f.py, bj.y, ti, f.oy, s.scale);
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

// The cells of one pool slot (n floats at g) to or from shared memory:
// 16-byte copies where the slot is 16-byte aligned (n % 4 == 0 and the pool
// is), single floats otherwise.
template <bool kLoad>
__device__ __forceinline__ void slot_cells(float* staged, float* g, int n) {
  if ((n & 3) == 0) {
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

// The block pool: a block a slot. A slot that a touched (scan, tile) owns
// alone takes that tile's samples (the band machinery on one B x B tile,
// its columns too, the sums starting from the free counts: the pool's
// scatter's order) and is folded; every other live slot is folded with no
// observation (the reference folds the whole pool; that is not the
// identity, BayesAvg's (p n + 0) / n may move p by an ulp); a dead slot is
// left as it is. Each slot is read and written by its own block only, so
// the pool is updated in place. A live block finds its owner by reading
// the tables and the marks (a few KB, from L2): the one touched entry that
// names the slot, where the slot's refcount is 1 (the copy-on-write pool)
// or the table is one (the tiled map, whose slots are unique).
template <int kModel>
__global__ void __launch_bounds__(kThreads, 2) pool_kernel(const Insert s) {
  constexpr int kC = channels_of(kModel);
  const int slot = blockIdx.x;
  const int bb = s.block * s.block;
  float* g = s.pool + static_cast<long long>(slot) * bb * kC;
  const int ref = s.refcnt ? __ldg(s.refcnt + slot) : 1;
  if (s.refcnt ? ref <= 0 : slot >= __ldg(s.n_live)) return;  // dead: no table names it
  __shared__ int found, hits;
  if (threadIdx.x == 0) {
    found = -1;
    hits = 0;
  }
  __syncthreads();
  const int n_entries = s.p * s.th * s.tw;
  for (int k = threadIdx.x; k < n_entries; k += kThreads) {
    if (__ldg(s.tables + k) == slot && __ldg(s.touched + k)) {
      atomicAdd(&hits, 1);
      found = k;
    }
  }
  __syncthreads();
  const int own = hits == 1 && ref == 1 ? found : -1;
  const float q = s.q ? __ldg(s.q) : 1.0f;
  if (own < 0) {
    for (int j = threadIdx.x; j < bb; j += kThreads) {
      float in[kC], o[kC];
#pragma unroll
      for (int ch = 0; ch < kC; ++ch) in[ch] = g[j * kC + ch];
      fold_cell<kModel>(s, in, in[kC - 1], 0.0f, 0.0f, o);
      o[kC - 1] = in[kC - 1] + 0.0f;
#pragma unroll
      for (int ch = 0; ch < kC; ++ch) g[j * kC + ch] = o[ch];
    }
    return;
  }
  const int n_tiles = s.th * s.tw;
  const int scan = own / n_tiles, tile = own - scan * n_tiles;
  const int tr = tile / s.tw, tc = tile - tr * s.tw;
  extern __shared__ float4 smem[];
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
  b.r0 = tr * s.block;
  b.rows = s.block;
  b.c0 = tc * s.block;
  b.cw = s.block;
  b.n_chunks = 0;
#ifdef SLAM_KERNEL_PROBE
  b.t = clock64();
  for (int k = 0; k < kProbeSlots; ++k) b.cycles[k] = 0;
#endif
  slot_cells<true>(b.cells, g, bb * kC);  // on their way while the tile rasterises
  for (int j = threadIdx.x; j < bb; j += kThreads) {
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
  for (int j = threadIdx.x; j < bb; j += kThreads) {
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
  slot_cells<false>(b.cells, g, bb * kC);
  phase_done(b, kFold);
#ifdef SLAM_KERNEL_PROBE
  if (threadIdx.x == 0 && blockIdx.x < kProbeBlocks) {
    for (int k = 0; k < kProbeSlots; ++k) {
      probe_cycles[blockIdx.x * kProbeSlots + k] = b.cycles[k];
    }
  }
#endif
}

// Marks tile (r // B, c // B) of scan p's table where a sample of scan p
// adds evidence on the table: q w > 0 (the free trace's first sample in a
// cell, an endpoint's cell, a blur sample of weight > 0) in a cell inside
// the th B x tw B cells. Marks are order-free (stores of 1). A thread walks
// one segment of n_seg of a beam's free samples; segment 0 also takes the
// beam's occupied samples. The samples' arithmetic is the band's.
__global__ void __launch_bounds__(128) touch_kernel(const Insert s) {
  const long long id = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int per_scan = s.r * s.n_seg;
  const int scan = blockIdx.y;
  if (id >= per_scan) return;
  const int beam = static_cast<int>(id / s.n_seg), seg = static_cast<int>(id - beam * s.n_seg);
  const float ang =
      __ldg(s.pose + 3 * scan + 2) + __ldg(s.bearings + scan * s.bearings_stride + beam);
  const float range = __ldg(s.ranges + scan * s.ranges_stride + beam);
  const bool valid = __ldg(s.valid + scan * s.valid_stride + beam);
  if (!valid) return;
  const float4 bm = make_float4(cosf(ang), sinf(ang), range, range <= s.max_range ? kEvidence : kValid);
  const Frame f{__ldg(s.pose + 3 * scan), __ldg(s.pose + 3 * scan + 1), __ldg(s.origin),
                __ldg(s.origin + 1)};
  const float q = s.q ? __ldg(s.q) : 1.0f;
  const float rows = static_cast<float>(s.th * s.block), cols = static_cast<float>(s.tw * s.block);
  unsigned char* marks = s.touched + static_cast<long long>(scan) * s.th * s.tw;
  int last = -1;
  auto mark = [&](float fr, float fc, float w) {
    if (q * w > 0.0f && fr >= 0.0f && fr < rows && fc >= 0.0f && fc < cols) {
      const int tile = (static_cast<int>(fr) / s.block) * s.tw + static_cast<int>(fc) / s.block;
      // stored once a run of samples in a tile, and only where no thread
      // has yet: the beams meet in a few tiles, and stores to one address
      // queue in the L2, loads of it do not
      if (tile != last && !marks[tile]) marks[tile] = 1;
      last = tile;
    }
  };
  // the free trace: a cell's first sample counts; a later sample of the run
  // lies in the same cell, whose tile the first marked
  const float limit = bm.z - s.hole_half;
  const int per = (s.n_free + s.n_seg - 1) / s.n_seg;
  const int i1 = min(s.n_free, (seg + 1) * per);
  for (int i = seg * per; i < i1; ++i) {
    const float t_i = (static_cast<float>(i) + 0.5f) * s.step;
    if (!(t_i < limit)) break;
    mark(cell_of(f.py, bm.y, t_i, f.oy, s.scale), cell_of(f.px, bm.x, t_i, f.ox, s.scale), 1.0f);
  }
  if (seg != 0 || bm.w < kEvidence) return;
  const int e = s.area ? 9 : 1;
  for (int k = 0; k < e + s.blur; ++k) {
    float fr, fc, w, sv;
    if (occupied_sample(s, f, bm, k < e ? 0 : 1, k < e ? k : k - e, fr, fc, w, sv)) {
      mark(fr, fc, w);
    }
  }
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
  pool_kernel<kModel><<<static_cast<unsigned>(s.n_slots), kThreads, shared, st>>>(s);
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
  s.scale2 = scale2;
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
  s.scale2 = scale2;
  s.n_scans = n_scans;
  s.plane_of = plane_of;
  set_scan(s, pose, ranges, ranges_stride, bearings, bearings_stride, valid, valid_stride, r,
           n_free, step, hole_half, max_range, area, blur, blur_table, free_plane);
  return launch<kPlanes>(s, rows, static_cast<cudaStream_t>(stream));
}

// The block pool (K3 over a block table): scan p (pose[p], its rows at
// p * *_stride) into the touched tiles of table p (tables i32[p, th, tw],
// slots of `pool` f32[n_slots, block, block, c], contiguous, 16-byte
// aligned, world origin origin[0..1] of tile (0, 0); touched u8[p, th, tw]),
// folded, in place. A slot takes the samples of the one touched entry that
// names it, where it is owned alone (refcnt[k] == 1, or a single table when
// refcnt is null); the other slots are folded with no observation where
// live (refcnt[k] > 0, or k < *n_live when refcnt is null) and left alone
// where not. A sample's weight and sum are scaled by *q (null: 1). The DDA
// free trace only. One launch, a block a slot, on `stream`; returns the
// cudaError_t.
extern "C" int pool_insert_launch(
    float* pool, int n_slots, int block, int c, const int* tables, const unsigned char* touched,
    const int* refcnt, const int* n_live, int p, int th, int tw, const float* origin, float scale,
    float scale2,
    const float* pose, const float* ranges, long long ranges_stride, const float* bearings,
    long long bearings_stride, const unsigned char* valid, long long valid_stride, int r,
    int n_free, float step, float hole_half, float max_range, int area, int blur,
    const float* blur_table, const float* q, int model, float quality, float base, float decay,
    float keep, float eps, void* stream) {
  if (n_slots <= 0 || block <= 0 || p <= 0 || th <= 0 || tw <= 0 || r <= 0 || n_free <= 0 ||
      model < kBayesBase || model > kTbm || c != (model == kTbm ? 5 : 2) ||
      (blur > 0 && !blur_table) || (!refcnt && !n_live) || (!refcnt && p != 1) || !tables ||
      !touched || (reinterpret_cast<uintptr_t>(pool) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Insert s{};
  s.pool = pool;
  s.n_slots = n_slots;
  s.block = block;
  s.tables = tables;
  s.touched = const_cast<unsigned char*>(touched);
  s.refcnt = refcnt;
  s.n_live = n_live;
  s.p = p;
  s.th = th;
  s.tw = tw;
  s.origin = origin;
  s.scale = scale;
  s.scale2 = scale2;
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

// The tiles the samples of pool_insert_launch's scans touch: touched
// (u8[p, th, tw], zeroed by the caller) gets 1 where a sample of scan p adds
// evidence (q w > 0) in a cell of table p's th x tw tiles of block x block
// cells. One launch on `stream`, a thread a segment of a beam.
extern "C" int pool_touch_launch(
    unsigned char* touched, int p, int th, int tw, int block, const float* origin, float scale,
    float scale2, const float* pose, const float* ranges, long long ranges_stride,
    const float* bearings, long long bearings_stride, const unsigned char* valid,
    long long valid_stride, int r, int n_free, float step, float hole_half, float max_range,
    int area, int blur, const float* blur_table, const float* q, void* stream) {
  if (p <= 0 || th <= 0 || tw <= 0 || block <= 0 || r <= 0 || n_free <= 0 ||
      (blur > 0 && !blur_table) || p > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Insert s{};
  s.touched = touched;
  s.p = p;
  s.th = th;
  s.tw = tw;
  s.block = block;
  s.origin = origin;
  s.scale = scale;
  s.scale2 = scale2;
  s.n_scans = p;
  set_scan(s, pose, ranges, ranges_stride, bearings, bearings_stride, valid, valid_stride, r,
           n_free, step, hole_half, max_range, area, blur, blur_table, nullptr);
  s.q = q;
  s.n_seg = max(1, (n_free + 31) / 32);  // at most 32 free samples a thread
  const long long per_scan = static_cast<long long>(r) * s.n_seg;
  const long long blocks = (per_scan + 127) / 128;
  if (per_scan > 0x7fffffffll || blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  touch_kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(p)), 128, 0,
                 static_cast<cudaStream_t>(stream)>>>(s);
  return static_cast<int>(cudaGetLastError());
}

#ifdef SLAM_KERNEL_PROBE
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
