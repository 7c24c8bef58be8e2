// Toolchain check for Hopper (sm_90a): o = 2 * x.
//
// Replaces the toy Pallas kernel `k` of tools/tpu_smoke.py:73-76, which
// doubles an (8, 128) f32 block to show that the TPU toolchain builds and
// launches a kernel. Here it shows the same for nvcc, ctypes and the card,
// before the real kernels are built. Bound by launch latency: it moves
// 8 KB. One thread per element; the product by 2 is exact.

#include <cuda_runtime.h>

namespace {

__global__ void smoke_kernel(const float* __restrict__ x, float* __restrict__ o,
                             int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 2.0f * x[i];
}

// Nothing at all: what one launch costs on the card, the floor under a
// kernel as small as the one above.
__global__ void empty_kernel() {}

}  // namespace

extern "C" int sl_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

// Plain C entry point (loaded with ctypes); returns a cudaError_t value.
extern "C" int sl_smoke(const void* x, void* o, int n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  smoke_kernel<<<(n + threads - 1) / threads, threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(o), n);
  return cudaGetLastError();
}
