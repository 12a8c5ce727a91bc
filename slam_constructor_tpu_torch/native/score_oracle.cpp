// Independent C++ implementation of the scan-likelihood score, used as a
// cross-validation oracle in tests: a from-scratch scalar re-derivation of
// the engine's scoring semantics (obstacle reducer + weighted-mean SPE with
// unknown-cell handling). Any coordinate-convention or masking bug in the
// vectorized kernels (the CUDA sampler and its PyTorch twin) shows up as a
// mismatch against this loop.
//
// Built by slam_constructor_tpu_torch/utils/native_oracle.py on first use:
// g++ -O2 -shared -fPIC, into build/native/ at the root of the checkout.

#include <cmath>
#include <cstdint>

extern "C" {

// Mean per-point consistency probability of a scan at pose (px, py, pth).
// occ/known: row-major [h][w] planes; origin (ox, oy) = world coords of the
// lower-left corner of cell (0,0); scale = meters per cell.
float slamscore_obstacle(
    const float* occ, const uint8_t* known, int h, int w,
    float ox, float oy, float scale, float unknown_prob,
    const float* ranges, const float* bearings, const uint8_t* valid, int r,
    int stride, float px, float py, float pth) {
  double num = 0.0, den = 0.0;
  for (int i = 0; i < r; ++i) {
    if (!valid[i]) continue;
    if (stride > 1 && (i % stride) != 0) continue;
    // endpoint in world frame
    float a = pth + bearings[i];
    float ex = px + ranges[i] * std::cos(a);
    float ey = py + ranges[i] * std::sin(a);
    // world -> cell (row, col)
    long col = (long)std::floor((ex - ox) / scale);
    long row = (long)std::floor((ey - oy) / scale);
    float p;
    if (row < 0 || row >= h || col < 0 || col >= w) {
      p = unknown_prob;
    } else if (!known[row * w + col]) {
      p = unknown_prob;
    } else {
      p = occ[row * w + col];
    }
    num += p;
    den += 1.0;
  }
  return den > 0 ? (float)(num / den) : 0.0f;
}

// SE(2) compose oracle (for geometry cross-checks)
void slamscore_compose(const float* a, const float* b, float* out) {
  float c = std::cos(a[2]), s = std::sin(a[2]);
  out[0] = a[0] + c * b[0] - s * b[1];
  out[1] = a[1] + s * b[0] + c * b[1];
  float th = a[2] + b[2];
  out[2] = std::atan2(std::sin(th), std::cos(th));
}

}  // extern "C"
