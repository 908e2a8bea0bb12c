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
//
// Lanes: float32 and float64 (every operand in the one type), and the
// bfloat16 lane for bf16 master params: x, gbar, gtilde (and g_old, the
// table row) in bf16, the fresh gradient g (and, for SVRG, g_old, the
// snapshot gradient) in float32. The bf16 lane loads bf16, computes in
// float32 and rounds x', gtilde' and gbar' to bf16 (round to nearest
// even) on the store: the reference flattens every operand to float32,
// runs the kernel in float32 and casts each result back to its leaf's
// dtype (src/repro/kernels/vr_update/ops.py), so the rounding points are
// the same.

#include <cuda_bf16.h>
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

template <typename C, typename T>
__device__ __forceinline__ C load_as(const T* p, int64_t i) {
  return static_cast<C>(p[i]);
}

template <>
__device__ __forceinline__ float load_as<float, __nv_bfloat16>(
    const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

template <typename T, typename C>
__device__ __forceinline__ void store_as(T* p, int64_t i, C v) {
  p[i] = static_cast<T>(v);
}

template <>
__device__ __forceinline__ void store_as<__nv_bfloat16, float>(
    __nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// S: type of x, gbar, gtilde and the outputs; G: of g; O: of g_old;
// C: the type the arithmetic runs in
template <typename S, typename G, typename O, typename C>
__global__ void vr_update_kernel(const S* x, const G* g, const O* g_old,
                                 const S* gbar, const S* gtilde,
                                 S* x_out, S* gtilde_out, S* gbar_out,
                                 int64_t n, C eta, C inv_m, C scale,
                                 int saga, int prox, C c1, C c2) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const C gi = load_as<C>(g, i);
    const C go = load_as<C>(g_old, i);
    const C gb = load_as<C>(gbar, i);
    const C gt = load_as<C>(gtilde, i);
    const C v = gi - go + gb;
    C xn = load_as<C>(x, i) * scale - eta * v;
    if (prox == kProxL1) {
      xn = soft_threshold(xn, c1);
    } else if (prox == kProxElasticNet) {
      xn = soft_threshold(xn, c1) * c2;
    } else if (prox == kProxBox) {
      xn = xn < c1 ? c1 : xn;
      xn = xn > c2 ? c2 : xn;
    }
    store_as(x_out, i, xn);
    store_as(gtilde_out, i, gt + gi * inv_m);
    if (saga) store_as(gbar_out, i, gb + (gi - go) * inv_m);
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 resident blocks on each SM

template <typename S, typename G, typename O, typename C>
int launch(const void* x, const void* g, const void* g_old, const void* gbar,
           const void* gtilde, void* x_out, void* gtilde_out, void* gbar_out,
           int64_t n, double eta, double inv_m, double scale, int saga,
           int prox, double c1, double c2, void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  vr_update_kernel<S, G, O, C><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(x), static_cast<const G*>(g),
      static_cast<const O*>(g_old), static_cast<const S*>(gbar),
      static_cast<const S*>(gtilde), static_cast<S*>(x_out),
      static_cast<S*>(gtilde_out), static_cast<S*>(gbar_out), n,
      static_cast<C>(eta), static_cast<C>(inv_m), static_cast<C>(scale),
      saga, prox, static_cast<C>(c1), static_cast<C>(c2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes: returns the cudaError_t of the
// launch (0 on success).
extern "C" {

#define VR_UPDATE_ENTRY(NAME, S, G, O, C)                                    \
  int NAME(const void* x, const void* g, const void* g_old,                  \
           const void* gbar, const void* gtilde, void* x_out,                \
           void* gtilde_out, void* gbar_out, int64_t n, double eta,          \
           double inv_m, double scale, int saga, int prox, double c1,        \
           double c2, void* stream) {                                        \
    return launch<S, G, O, C>(x, g, g_old, gbar, gtilde, x_out, gtilde_out,  \
                              gbar_out, n, eta, inv_m, scale, saga, prox,    \
                              c1, c2, stream);                               \
  }

VR_UPDATE_ENTRY(vr_update_f32, float, float, float, float)
VR_UPDATE_ENTRY(vr_update_f64, double, double, double, double)
// bf16 state; g_old a bf16 table row, or SVRG's float32 snapshot gradient
VR_UPDATE_ENTRY(vr_update_bf16, __nv_bfloat16, float, __nv_bfloat16, float)
VR_UPDATE_ENTRY(vr_update_bf16_f32old, __nv_bfloat16, float, float, float)

const char* vr_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
