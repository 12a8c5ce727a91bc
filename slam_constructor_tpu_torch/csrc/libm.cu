// libm.cu: the reference's elementary functions (csrc/libm.cuh) over a
// tensor, for Hopper (sm_90a). Plain C interface, bound from Python with
// ctypes (slam_constructor_tpu_torch/ops/kernels.py libm_unary, libm_sincos,
// libm_atan2, libm_fma32, built by ops/_build.py); the plain versions are
// ops/libm.py's.
//
// Replaces no Pallas kernel: the reference's jnp.sin, jnp.cos, jnp.arctan,
// jnp.arctan2, jnp.exp, jnp.log and jnp.sqrt compile, on its CPU, to glibc's
// and XLA's own code (ops/libm.py says which), and its call sites are
// elementwise XLA ops (slam_constructor_tpu/ops/geometry.py:17-51,
// ops/scan.py:76, :98, models/engine.py:183, :189, ops/cells.py:105, ...).
// A call is one launch over n elements, a thread an element; sincos and
// wrap_angle share one range reduction. What bounds it on an H100: sin is
// ~20 double-precision operations (8 fused multiply-adds) and one int64
// product chain on the large path, so at the sites' sizes (3 to 65,536
// elements) the launch (~2 us) bounds it, not the card's FP64 rate or the
// 8-12 bytes an element moves.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "libm.cuh"

namespace {

// kCosSin writes (cos, sin) pairs: y holds 2 n floats
enum Op : int {
  kSin = 0, kCos = 1, kAtan = 2, kExp = 3, kLog = 4, kSqrt = 5, kWrap = 6, kCosSin = 7
};

__global__ void libm_unary_kernel(int op, const float* __restrict__ x, float* __restrict__ y,
                                  long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float v = x[i];
    float r;
    if (op == kCosSin) {
      libm::sincos(v, &r, y + 2 * i);  // r: sin, y[2 i]: cos
      y[2 * i + 1] = r;
      continue;
    }
    switch (op) {
      case kSin: r = libm::sin(v); break;
      case kCos: r = libm::cos(v); break;
      case kAtan: r = libm::atan(v); break;
      case kExp: r = libm::exp(v); break;
      case kLog: r = libm::log(v); break;
      case kSqrt: r = libm::sqrt(v); break;
      default: r = libm::wrap_angle(v); break;
    }
    y[i] = r;
  }
}

__global__ void libm_sincos_kernel(const float* __restrict__ x, float* __restrict__ s,
                                   float* __restrict__ c, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    libm::sincos(x[i], s + i, c + i);
  }
}

__global__ void libm_atan2_kernel(const float* __restrict__ y, const float* __restrict__ x,
                                  float* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    out[i] = libm::atan2(y[i], x[i]);
  }
}

// b or c null: the number bs or cs for every element
__global__ void libm_fma32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                  float bs, const float* __restrict__ c, float cs,
                                  float* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    out[i] = libm::fma32(a[i], b ? b[i] : bs, c ? c[i] : cs);
  }
}

// ops/geometry.py's compose (0), between (1) and inverse (2) of poses
// [n, 3]: the plain versions' operations, their sums of products fused as
// the reference's jitted code fuses them
__global__ void libm_pose_kernel(int op, const float* __restrict__ a,
                                 const float* __restrict__ b, float* __restrict__ out,
                                 long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float ax = a[3 * i], ay = a[3 * i + 1], at = a[3 * i + 2];
    if (op == 0) {  // libm.cuh's, which mc_match.cu's prologue runs too
      libm::compose(ax, ay, at, b[3 * i], b[3 * i + 1], b[3 * i + 2], out + 3 * i);
      continue;
    }
    float s, c, x, y, t;
    libm::sincos(at, &s, &c);
    if (op == 1) {
      const float dx = __fsub_rn(b[3 * i], ax), dy = __fsub_rn(b[3 * i + 1], ay);
      x = libm::fma32(c, dx, __fmul_rn(s, dy));
      y = libm::fma32(c, dy, __fmul_rn(-s, dx));
      t = libm::wrap_angle(__fsub_rn(b[3 * i + 2], at));
    } else {
      x = -libm::fma32(c, ax, __fmul_rn(s, ay));
      y = -libm::fma32(c, ay, __fmul_rn(-s, ax));
      t = libm::wrap_angle(-at);
    }
    out[3 * i] = x;
    out[3 * i + 1] = y;
    out[3 * i + 2] = t;
  }
}

// jax.scipy.special.logsumexp over rows of n, a row a thread, the sum in
// element order: m = max (0 where not finite), lse = log(sum exp(x - m)) + m.
// mode 0: out[row] = lse; 1: out = x - lse (normalised log-weights); 2: out
// = exp(x - lse), and lse into out2 when given; 3: out[row] = exp(-lse(2 (x
// - lse))), the effective sample size of normalised weights; 4: out[row] =
// sum exp(x - off[row]), a rank's share of a sharded log-sum-exp. A row's n
// is the RBPF's particles or proposal samples: tens.
// the log-sum-exp of scale * (x[j] - off) over a row (off 0: of x itself)
__device__ __forceinline__ float row_lse(const float* x, int n, float off, float scale) {
  float m = -CUDART_INF_F;
  for (int j = 0; j < n; ++j) {
    const float v = __fmul_rn(scale, __fsub_rn(x[j], off));
    m = (v > m || v != v) && m == m ? v : m;  // jnp.max: NaN propagates
  }
  if (!isfinite(m)) m = 0.0f;
  float sum = 0.0f;
  for (int j = 0; j < n; ++j) {
    sum = __fadd_rn(sum, libm::exp(__fsub_rn(__fmul_rn(scale, __fsub_rn(x[j], off)), m)));
  }
  return __fadd_rn(libm::log(sum), m);
}

__global__ void libm_rows_kernel(int mode, const float* __restrict__ x,
                                 const float* __restrict__ off, float* __restrict__ out,
                                 float* __restrict__ out2, int rows, int n) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const float* xr = x + static_cast<long long>(row) * n;
  if (mode == 4) {  // sum exp(x - off[row]) in element order: a rank's share
    float sum = 0.0f;
    for (int j = 0; j < n; ++j) sum = __fadd_rn(sum, libm::exp(__fsub_rn(xr[j], off[row])));
    out[row] = sum;
    return;
  }
  const float lse = row_lse(xr, n, 0.0f, 1.0f);
  if (mode == 0) {
    out[row] = lse;
  } else if (mode == 3) {
    out[row] = libm::exp(-row_lse(xr, n, lse, 2.0f));
  } else {
    float* o = out + static_cast<long long>(row) * n;
    for (int j = 0; j < n; ++j) {
      const float v = __fsub_rn(xr[j], lse);
      o[j] = mode == 1 ? v : libm::exp(v);
    }
    if (mode == 2 && out2 != nullptr) out2[row] = lse;
  }
}

constexpr int kThreads = 256;

unsigned blocks_for(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b < 132 * 64 ? b : 132 * 64);  // grid-stride beyond
}

}  // namespace

extern "C" {

int libm_unary_launch(int op, const void* x, void* y, long long n, void* stream) {
  if (n < 1) return 0;
  if (op < kSin || op > kCosSin) return int(cudaErrorInvalidValue);
  libm_unary_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      op, static_cast<const float*>(x), static_cast<float*>(y), n);
  return int(cudaGetLastError());
}

int libm_sincos_launch(const void* x, void* s, void* c, long long n, void* stream) {
  if (n < 1) return 0;
  libm_sincos_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(s), static_cast<float*>(c), n);
  return int(cudaGetLastError());
}

int libm_atan2_launch(const void* y, const void* x, void* out, long long n, void* stream) {
  if (n < 1) return 0;
  libm_atan2_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(x), static_cast<float*>(out), n);
  return int(cudaGetLastError());
}

int libm_fma32_launch(const void* a, const void* b, float bs, const void* c, float cs, void* out,
                      long long n, void* stream) {
  if (n < 1) return 0;
  libm_fma32_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), bs,
      static_cast<const float*>(c), cs, static_cast<float*>(out), n);
  return int(cudaGetLastError());
}

int libm_rows_launch(int mode, const void* x, const void* off, void* out, void* out2, int rows,
                     int n, void* stream) {
  if (rows < 1) return 0;
  if (mode < 0 || mode > 4 || n < 1 || (mode == 4 && off == nullptr)) {
    return int(cudaErrorInvalidValue);
  }
  libm_rows_kernel<<<(rows + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, static_cast<const float*>(x), static_cast<const float*>(off), static_cast<float*>(out),
      static_cast<float*>(out2), rows, n);
  return int(cudaGetLastError());
}

int libm_pose_launch(int op, const void* a, const void* b, void* out, long long n, void* stream) {
  if (n < 1) return 0;
  if (op < 0 || op > 2 || (op < 2 && b == nullptr)) return int(cudaErrorInvalidValue);
  libm_pose_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      op, static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out),
      n);
  return int(cudaGetLastError());
}

}  // extern "C"
