// climb.cuh: the hill climb of the scan score inside one block, shared by
// hill_climb.cu (the hill-climbing matcher's whole refine in one launch) and
// m3rsm_match.cu (the climb that ends an M3RSM match), so both give the
// bits of kernels.hill_climb_loop over overlap_score.cu, for every reducer
// (the climb's score reads a beam as its overlap::Reducer says):
//
//   prob = score(pose)
//   each round: cand_a = pose + unit_a * steps, a = 0..5 (+x, -x, +y, -y,
//     +theta, -theta), the heading wrapped with atan2f(sinf(t), cosf(t));
//     best = argmax score(cand_a) (NaN first, ties to the first); if it is
//     strictly better pose, prob = cand_best, its score, else steps *=
//     shrink; trace[round] = prob
//
// A candidate is scored by a group of 128 threads exactly as a block of
// overlap_score.cu scores a pose (overlap_sample.cuh: thread t's beams t, t +
// 128, ... in order, and the fixed-order group tree); the six candidates are
// six groups at once, each on its own named barrier (1 + group; 0 is
// __syncthreads()'s), each forming its pose from the round's pose and steps.
// Thread 0 keeps the state in shared memory and decides; two block barriers
// a round. Numerics: see overlap_sample.cuh (no fast math, --fmad=false);
// the pose arithmetic is the PyTorch loop's, op by op.

#pragma once

#include <cuda_runtime.h>

#include "overlap_sample.cuh"

namespace climb {

constexpr int kSteps = 6;  // candidates a round
constexpr int kThreads = kSteps * overlap::kGroupThreads;

// Whether score a (of index ai) comes before score b (of bi) in an argmax:
// NaN first, then the larger, then the lower index (torch.argmax's choice).
__device__ __forceinline__ bool comes_first(float av, int ai, float bv, int bi) {
  const bool an = isnan(av), bn = isnan(bv);
  if (an != bn) return an;
  if (!an && av != bv) return av > bv;
  return ai < bi;
}

// The heading's unit in a candidate: 0 for the steps in x and y, +1 and -1
// for the steps in theta.
__device__ __forceinline__ float heading_unit(int u) {
  return u == 0 ? 0.0f : (u == 1 ? 1.0f : -1.0f);
}

// The climb's state (written by thread 0 only) and a round's scratch.
struct State {
  float pose[3], steps[3], prob;
  float round[kSteps];
  float cand[kSteps][3];
  float num[kThreads], den[kThreads];  // the groups' trees
};

// Candidate g of a round: pose + unit_g * steps, the heading wrapped.
__device__ __forceinline__ void candidate(const State& st, int g, float cand[3]) {
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float unit = d == (g >> 1) ? ((g & 1) ? -1.0f : 1.0f) : 0.0f;
    cand[d] = st.pose[d] + unit * st.steps[d];
  }
  const float x = st.pose[2] + heading_unit(g < 4 ? 0 : g - 3) * st.steps[2];
  cand[2] = libm::wrap_angle(x);
}

// The score of pose (x, y, th) by the group of thread t (valid in t == 0):
// overlap_score.cu's sums and tree, the group's barrier `1 + g`.
template <class Plane>
__device__ __forceinline__ float group_score(State& st, const Plane& at, int h, int w, float x,
                                             float y, float th, const float* pts,
                                             const float* bw, int r, float ox, float oy,
                                             float scale, float unknown,
                                             const overlap::Reducer& red, int g, int t) {
  // lane 0 of each warp takes the heading's sine and cosine (double
  // precision polynomials) for its 31 lanes
  float sn = 0.0f, cs = 0.0f;
  if ((t & 31) == 0) libm::sincos(th, &sn, &cs);
  const overlap::Pose q{x, y, __shfl_sync(0xffffffffu, cs, 0), __shfl_sync(0xffffffffu, sn, 0)};
  float num, den;
  overlap::beam_sums_at(at, h, w, q, pts, bw, r, t, ox, oy, scale, unknown, red, num, den);
  overlap::group_reduce(num, den, st.num + g * overlap::kGroupThreads,
                        st.den + g * overlap::kGroupThreads, t, 1 + g);
  return overlap::weighted_mean(num, den);
}

// The whole climb from st.pose with st.steps (set, and a block barrier
// passed, before the call) on the plane `at` (h x w cells) with the scan's
// points and weights (pts f32[r, 2], bw f32[r], read by every thread), by
// a block of at least kThreads threads: st.prob, then `iterations` rounds,
// trace[round] = the round's prob. stamp(round) is called by thread 0 after
// the first score (round -1) and after each round's decision. Ends with a
// block barrier: st holds the result.
template <class Plane, class Stamp>
__device__ __forceinline__ void run(State& st, const Plane& at, int h, int w, const float* pts,
                                    const float* bw, int r, float ox, float oy, float scale,
                                    float unknown, const overlap::Reducer& red, int iterations,
                                    float shrink, float* trace, Stamp stamp) {
  const int g = threadIdx.x / overlap::kGroupThreads;
  const int t = threadIdx.x % overlap::kGroupThreads;
  if (g == 0) {
    const float p = group_score(st, at, h, w, st.pose[0], st.pose[1], st.pose[2], pts, bw, r,
                                ox, oy, scale, unknown, red, g, t);
    if (t == 0) st.prob = p;
  }
  __syncthreads();
  if (threadIdx.x == 0) stamp(-1);
  for (int round = 0; round < iterations; ++round) {
    if (g < kSteps) {
      float cand[3];
      candidate(st, g, cand);
      const float p = group_score(st, at, h, w, cand[0], cand[1], cand[2], pts, bw, r, ox, oy,
                                  scale, unknown, red, g, t);
      if (t == 0) {
        st.round[g] = p;
        st.cand[g][0] = cand[0];
        st.cand[g][1] = cand[1];
        st.cand[g][2] = cand[2];
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float bv = st.round[0];
      int bi = 0;
      for (int a = 1; a < kSteps; ++a) {
        if (comes_first(st.round[a], a, bv, bi)) {
          bv = st.round[a];
          bi = a;
        }
      }
      if (bv > st.prob) {  // strict, and never true for a NaN score
        st.pose[0] = st.cand[bi][0];
        st.pose[1] = st.cand[bi][1];
        st.pose[2] = st.cand[bi][2];
        st.prob = bv;
      } else {
        st.steps[0] *= shrink;
        st.steps[1] *= shrink;
        st.steps[2] *= shrink;
      }
      trace[round] = st.prob;
      stamp(round);
    }
    __syncthreads();
  }
}

}  // namespace climb
