// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _rmsnorm_kernel in
// src/repro/kernels/rmsnorm/kernel.py (launched by rmsnorm's pallas_call).
// Per row of a (rows, d) matrix, in float32:
//
//   y = x * rsqrt(mean(x^2) + eps) * scale        cast back to x's type
//
// x and y are float32 or bfloat16, scale float32 or bfloat16 (the train
// path casts it to the compute type at point of use, the eval path keeps
// it float32).
//
// What bounds it: one read of x and one write of y (scale is d elements,
// read once per row from L2), and ~4 operations per element, so bytes:
// 2*rows*d*itemsize over 3.35 TB/s, 4.4 us at 1024 x 3584 in bfloat16 (the
// Qwen2-7B-width train step's shape). The design moves each byte once:
// one block per row; the row is loaded once, converted to float32 and
// kept resident in shared memory (14 KB at d = 3584) while the block
// reduces its sum of squares (warp shuffles, then one value per warp in
// shared memory); the second pass reads it from there and writes y. The
// TPU version's row padding is gone: the grid has exactly one block per
// row.
//
// Built with -fmad=false so (x * r) * scale rounds as in the plain
// PyTorch version (ref.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ y, int d, float eps) {
  extern __shared__ float row[];          // d floats: the row, resident
  __shared__ float partial[kWarps];
  __shared__ float rstd;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * d;
  const T* xr = x + base;
  T* yr = y + base;

  float ss = 0.f;
  for (int j = threadIdx.x; j < d; j += kThreads) {
    const float v = load_f32(xr + j);
    row[j] = v;
    ss += v * v;
  }
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? partial[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) rstd = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = rstd;
  for (int j = threadIdx.x; j < d; j += kThreads)
    store_from_f32(yr + j, row[j] * r * load_f32(scale + j));
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* y, int64_t rows, int d,
           double eps, void* stream) {
  if (rows <= 0) return 0;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  rmsnorm_kernel<T, S><<<static_cast<unsigned>(rows), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), d, static_cast<float>(eps));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes: returns the cudaError_t of the
// launch (0 on success). x_bf16 / scale_bf16 pick the element types.
extern "C" {

int rmsnorm_launch(const void* x, const void* scale, void* y, int64_t rows,
                   int d, double eps, int x_bf16, int scale_bf16,
                   void* stream) {
  if (x_bf16) {
    return scale_bf16
        ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, d, eps,
                                               stream)
        : launch<__nv_bfloat16, float>(x, scale, y, rows, d, eps, stream);
  }
  return scale_bf16
      ? launch<float, __nv_bfloat16>(x, scale, y, rows, d, eps, stream)
      : launch<float, float>(x, scale, y, rows, d, eps, stream);
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
