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
// read from L2), and ~4 operations per element, so bytes: 2*rows*d*itemsize
// over 3.35 TB/s, 4.4 us at 1024 x 3584 and 7.5 us at 8192 x 768 in
// bfloat16 (the Qwen2-7B-width and the Mamba2-130M train steps' shapes).
//
// The design moves each byte once. The vector body (rmsnorm_rows) keeps
// the row in registers as 16-byte vectors (8 bf16 or 4 float32): a lane
// loads VPL of them, and the row's scale beside them, squares and sums,
// reduces, and writes y from the same registers as 16-byte vectors. A row
// up to 4 vectors a lane (bf16 up to 1024 elements: the Mamba2 width)
// takes one warp, 8 rows to a block, with one warp shuffle reduction and
// no shared memory. A wider row spans WPR warps (2, 4 or 8) of a block,
// whose partial sums meet once in shared memory: one warp per row would
// leave 1024 warps for 1024 rows of 3584, 8 an SM, each with a serial
// chain of 14 loads, a reduction and 14 stores, too little to hide the
// memory's latency (it lost to F.rms_norm there). The wrapper picks (VPL,
// WPR), or (0, 0) for the row-per-block loop (rmsnorm_loop), which takes
// what the vectors do not: a row whose bytes are not a multiple of 16, a
// pointer that is not 16-byte aligned, or a row wider than 8 warps hold
// (bf16 beyond 8192 elements, float32 beyond 4096). The loop keeps the
// row in shared memory as float32 (14 KB at d = 3584), reduces with
// shuffles and one value per warp in shared memory, and reads the row
// back for the second pass.
//
// Built with -fmad=false so (x * r) * scale rounds as in the plain
// PyTorch version (ref.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// the vector body: the row in registers, one warp or a few per row
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;            // a block of the vector body

// element e of a run of 32-bit words holding float32 or bf16 pairs
template <typename E>
__device__ __forceinline__ float word_elem(const uint32_t* w, int e) {
  if constexpr (std::is_same<E, float>::value) return __uint_as_float(w[e]);
  else return __uint_as_float(e % 2 ? w[e / 2] & 0xffff0000u : w[e / 2] << 16);
}

// W 32-bit words from p (16-byte aligned; 8-byte for W = 2)
template <int W>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[W]) {
  if constexpr (W == 2) {
    const uint2 u = __ldg(static_cast<const uint2*>(p));
    w[0] = u.x;
    w[1] = u.y;
  } else {
#pragma unroll
    for (int c = 0; c < W / 4; ++c) {
      const uint4 u = __ldg(static_cast<const uint4*>(p) + c);
      w[4 * c] = u.x;
      w[4 * c + 1] = u.y;
      w[4 * c + 2] = u.z;
      w[4 * c + 3] = u.w;
    }
  }
}

template <typename T, typename S, int VPL, int WPR>
__global__ void __launch_bounds__(32 * kWarps)
rmsnorm_rows(const T* __restrict__ x, const S* __restrict__ scale,
             T* __restrict__ y, int64_t rows, int d, float eps) {
  constexpr int N = 16 / sizeof(T);          // elements of a vector
  constexpr int kScaleWords = N * static_cast<int>(sizeof(S)) / 4;
  constexpr int kStride = 32 * WPR;          // vectors between a lane's
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (kWarps / WPR) + warp / WPR;
  const bool live = row < rows;
  const int first = (warp % WPR) * 32 + lane;  // the lane's first vector
  const int nvec = d / N;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);

  uint32_t buf[VPL][4];
  uint32_t sw[VPL][kScaleWords];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = first + kStride * i;
    if (live && v < nvec) {
      const uint4 u = __ldcs(xr + v);
      buf[i][0] = u.x;
      buf[i][1] = u.y;
      buf[i][2] = u.z;
      buf[i][3] = u.w;
      load_words<kScaleWords>(scale + v * N, sw[i]);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float f = word_elem<T>(buf[i], e);
        ss += f * f;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if constexpr (WPR > 1) {
    __shared__ float partial[kWarps];
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) ss += partial[warp / WPR * WPR + w];
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int v = first + kStride * i;
    if (live && v < nvec) {
      uint32_t w[4];
      if constexpr (std::is_same<T, float>::value) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = __float_as_uint(word_elem<T>(buf[i], e) * r *
                                 word_elem<S>(sw[i], e));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 pair = __floats2bfloat162_rn(
              word_elem<T>(buf[i], 2 * e) * r * word_elem<S>(sw[i], 2 * e),
              word_elem<T>(buf[i], 2 * e + 1) * r *
                  word_elem<S>(sw[i], 2 * e + 1));
          w[e] = *reinterpret_cast<const uint32_t*>(&pair);
        }
      }
      __stcs(yr + v, make_uint4(w[0], w[1], w[2], w[3]));
    }
  }
}

// ---------------------------------------------------------------------------
// the row-per-block loop: any width up to the wrapper's MAX_D, any address
// ---------------------------------------------------------------------------

constexpr int kLoopThreads = 256;
constexpr int kLoopWarps = kLoopThreads / 32;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, typename S>
__global__ void __launch_bounds__(kLoopThreads)
rmsnorm_loop(const T* __restrict__ x, const S* __restrict__ scale,
             T* __restrict__ y, int d, float eps) {
  extern __shared__ float row[];          // d floats: the row, resident
  __shared__ float partial[kLoopWarps];
  __shared__ float rstd;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * d;
  const T* xr = x + base;
  T* yr = y + base;

  float ss = 0.f;
  for (int j = threadIdx.x; j < d; j += kLoopThreads) {
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
    float t = lane < kLoopWarps ? partial[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) rstd = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = rstd;
  for (int j = threadIdx.x; j < d; j += kLoopThreads)
    store_from_f32(yr + j, row[j] * r * load_f32(scale + j));
}

template <typename T, typename S, int VPL, int WPR>
int launch_rows(const void* x, const void* scale, void* y, int64_t rows,
                int d, double eps, cudaStream_t stream) {
  constexpr int kRows = kWarps / WPR;
  const int64_t blocks = (rows + kRows - 1) / kRows;
  rmsnorm_rows<T, S, VPL, WPR><<<static_cast<unsigned>(blocks), 32 * kWarps,
                                 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), rows, d, static_cast<float>(eps));
  return static_cast<int>(cudaGetLastError());
}

// The vector body's plans (VPL, WPR), as kernel.py's PLANS lists them
template <typename T, typename S>
int launch(const void* x, const void* scale, void* y, int64_t rows, int d,
           double eps, int vpl, int wpr, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vpl == 0 && wpr == 0) {
    const size_t smem = static_cast<size_t>(d) * sizeof(float);
    rmsnorm_loop<T, S><<<static_cast<unsigned>(rows), kLoopThreads, smem,
                         s>>>(static_cast<const T*>(x),
                              static_cast<const S*>(scale),
                              static_cast<T*>(y), d, static_cast<float>(eps));
    return static_cast<int>(cudaGetLastError());
  }
  switch (vpl * 16 + wpr) {
    case 1 * 16 + 1:
      return launch_rows<T, S, 1, 1>(x, scale, y, rows, d, eps, s);
    case 2 * 16 + 1:
      return launch_rows<T, S, 2, 1>(x, scale, y, rows, d, eps, s);
    case 4 * 16 + 1:
      return launch_rows<T, S, 4, 1>(x, scale, y, rows, d, eps, s);
    case 4 * 16 + 2:
      return launch_rows<T, S, 4, 2>(x, scale, y, rows, d, eps, s);
    case 4 * 16 + 4:
      return launch_rows<T, S, 4, 4>(x, scale, y, rows, d, eps, s);
    case 4 * 16 + 8:
      return launch_rows<T, S, 4, 8>(x, scale, y, rows, d, eps, s);
    default: return -1;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes: returns the cudaError_t of the
// launch (0 on success), or -1 for a plan with no instantiation. x_bf16 /
// scale_bf16 pick the element types; (vpl, wpr): the vector body's 16-byte
// vectors a lane holds and warps a row spans, or (0, 0) for the loop.
extern "C" {

int rmsnorm_launch(const void* x, const void* scale, void* y, int64_t rows,
                   int d, double eps, int x_bf16, int scale_bf16, int vpl,
                   int wpr, void* stream) {
  using bf16 = __nv_bfloat16;
  if (x_bf16) {
    return scale_bf16
        ? launch<bf16, bf16>(x, scale, y, rows, d, eps, vpl, wpr, stream)
        : launch<bf16, float>(x, scale, y, rows, d, eps, vpl, wpr, stream);
  }
  return scale_bf16
      ? launch<float, bf16>(x, scale, y, rows, d, eps, vpl, wpr, stream)
      : launch<float, float>(x, scale, y, rows, d, eps, vpl, wpr, stream);
}

const char* rmsnorm_error_string(int code) {
  if (code == -1) return "vector plan not compiled (see kernel.py's PLANS)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
