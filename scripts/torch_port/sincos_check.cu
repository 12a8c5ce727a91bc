// sincos_check.cu: whether sincosf gives the bits of sinf and cosf for every
// one of the 2^32 float inputs, built with the port's numerics flags (no
// fast math). csrc/gradient_refine.cu takes a sinf, cosf pair as one
// sincosf on that ground. Built and run by
// scripts/torch_port/kernel_probe.py --sincos; prints the inputs that
// differ (NaN against NaN counts as equal).

#include <cstdio>

#include <cuda_runtime.h>

__global__ void compare(unsigned long long* differ, unsigned long long base) {
  const unsigned i = static_cast<unsigned>(base + blockIdx.x * blockDim.x + threadIdx.x);
  const float x = __uint_as_float(i);
  float s, c;
  sincosf(x, &s, &c);
  const float s2 = sinf(x), c2 = cosf(x);
  const bool same_s = __float_as_uint(s) == __float_as_uint(s2) || (isnan(s) && isnan(s2));
  const bool same_c = __float_as_uint(c) == __float_as_uint(c2) || (isnan(c) && isnan(c2));
  if (!same_s || !same_c) atomicAdd(differ, 1ULL);
}

int main() {
  unsigned long long* differ = nullptr;
  cudaMalloc(&differ, sizeof(*differ));
  cudaMemset(differ, 0, sizeof(*differ));
  const unsigned long long chunk = 1ULL << 30;
  for (unsigned long long base = 0; base < (1ULL << 32); base += chunk) {
    compare<<<static_cast<unsigned>(chunk / 256), 256>>>(differ, base);
  }
  unsigned long long n = 0;
  cudaMemcpy(&n, differ, sizeof(n), cudaMemcpyDeviceToHost);
  const cudaError_t err = cudaGetLastError();
  printf("sincosf against sinf and cosf: %llu of the 2^32 inputs differ (%s)\n", n,
         cudaGetErrorString(err));
  return err == cudaSuccess && n == 0 ? 0 : 1;
}
