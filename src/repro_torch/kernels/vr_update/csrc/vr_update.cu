// Fused CentralVR/SAGA update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _vr_update_kernel in
// src/repro/kernels/vr_update/kernel.py (launched by vr_update_flat's
// pallas_call). Per element of a flat batch of p workers x d coordinates:
//
//   v       = g - g_old + gbar
//   x'      = prox(x*scale - eta*v)       scale = 1 - eta*decay (host-folded)
//   gtilde' = gtilde + g*inv_m
//   gbar'   = gbar + (g - g_old)*inv_m    stored only when saga is set
//
// table' = g by definition, so the kernel stores no table: the wrapper
// returns g itself. Without saga gbar' = gbar, and the wrapper returns
// gbar itself; gbar_out is then neither written nor read.
//
// The prox epilogue is elementwise: none, l1 (c1 = eta*lam1), elasticnet
// (c1 = eta*lam1, c2 = 1/(1 + 2*eta*lam2)) or box (c1 = lo, c2 = hi); the
// wrapper folds eta into the constants as the TPU kernel did at compile
// time, and passes every parameter at launch.
//
// What bounds it: 5 reads and 2 writes of p*d elements (3 writes with
// saga) and ~7 operations per element, so bytes: 7*p*d*itemsize over
// 3.35 TB/s, 0.134 us at p=8, d=1000 in float64 (the main path runs
// without saga). One launch per inner step costs more than that on the
// host and in the launch itself, so the epoch loop is launch-bound; the
// design is therefore the simplest one that moves each byte once: a
// grid-stride loop, one element per thread per iteration, no shared
// memory. The TPU version's tile padding is gone: the loop bound masks
// the ragged edge.
//
// Outputs may alias their inputs element for element (x'->x,
// gtilde'->gtilde, gbar'->gbar): a thread reads all five operands of an
// element before it writes that element, and no other thread touches it.
// Hence no __restrict__.
//
// Built with -fmad=false so each product and sum rounds on its own, as in
// the plain PyTorch version (ref.py).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum ProxKind { kProxNone = 0, kProxL1 = 1, kProxElasticNet = 2, kProxBox = 3 };

template <typename T>
__device__ __forceinline__ T sign_of(T v) {
  return v > T(0) ? T(1) : (v < T(0) ? T(-1) : T(0));
}

template <typename T>
__device__ __forceinline__ T soft_threshold(T v, T t) {
  const T mag = (v < T(0) ? -v : v) - t;
  return sign_of(v) * (mag > T(0) ? mag : T(0));
}

template <typename T>
__global__ void vr_update_kernel(const T* x, const T* g, const T* g_old,
                                 const T* gbar, const T* gtilde,
                                 T* x_out, T* gtilde_out, T* gbar_out,
                                 int64_t n, T eta, T inv_m, T scale,
                                 int saga, int prox, T c1, T c2) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const T gi = g[i];
    const T go = g_old[i];
    const T gb = gbar[i];
    const T gt = gtilde[i];
    const T v = gi - go + gb;
    T xn = x[i] * scale - eta * v;
    if (prox == kProxL1) {
      xn = soft_threshold(xn, c1);
    } else if (prox == kProxElasticNet) {
      xn = soft_threshold(xn, c1) * c2;
    } else if (prox == kProxBox) {
      xn = xn < c1 ? c1 : xn;
      xn = xn > c2 ? c2 : xn;
    }
    x_out[i] = xn;
    gtilde_out[i] = gt + gi * inv_m;
    if (saga) gbar_out[i] = gb + (gi - go) * inv_m;
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 resident blocks on each SM

template <typename T>
int launch(const void* x, const void* g, const void* g_old, const void* gbar,
           const void* gtilde, void* x_out, void* gtilde_out, void* gbar_out,
           int64_t n, double eta, double inv_m, double scale, int saga,
           int prox, double c1, double c2, void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  vr_update_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(g_old), static_cast<const T*>(gbar),
      static_cast<const T*>(gtilde), static_cast<T*>(x_out),
      static_cast<T*>(gtilde_out), static_cast<T*>(gbar_out), n,
      static_cast<T>(eta), static_cast<T>(inv_m), static_cast<T>(scale),
      saga, prox, static_cast<T>(c1), static_cast<T>(c2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes: returns the cudaError_t of the
// launch (0 on success).
extern "C" {

int vr_update_f32(const void* x, const void* g, const void* g_old,
                  const void* gbar, const void* gtilde, void* x_out,
                  void* gtilde_out, void* gbar_out, int64_t n, double eta,
                  double inv_m, double scale, int saga, int prox, double c1,
                  double c2, void* stream) {
  return launch<float>(x, g, g_old, gbar, gtilde, x_out, gtilde_out,
                       gbar_out, n, eta, inv_m, scale, saga, prox,
                       c1, c2, stream);
}

int vr_update_f64(const void* x, const void* g, const void* g_old,
                  const void* gbar, const void* gtilde, void* x_out,
                  void* gtilde_out, void* gbar_out, int64_t n, double eta,
                  double inv_m, double scale, int saga, int prox, double c1,
                  double c2, void* stream) {
  return launch<double>(x, g, g_old, gbar, gtilde, x_out, gtilde_out,
                        gbar_out, n, eta, inv_m, scale, saga,
                        prox, c1, c2, stream);
}

const char* vr_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
