// One lazy sparse CentralVR epoch in one launch, for Hopper (sm_90a).
//
// It replaces no Pallas kernel: the TPU reference runs the sparse driver
// (src/repro/prox/lazy.py, sampling="sparse") as one jitted lax.scan,
// _lazy_epoch (lazy.py:215), whose step is a gather, the closed-form
// catch-up of the row's coordinates, a dot, the residual, the corrected
// step, a soft-threshold and three scatters. Written eagerly in PyTorch
// that is some fifty small launches a step, so the epoch is a persistent
// kernel here, the sparse sibling of vr_epoch.cu. Step t visits row
// i = perm[t] of the fixed-width rows (idx, val):
//
//   zJ   = psi^(t - last[J])(z[J])   psi(u) = S_c(u + drift), closed form
//   s    = l'(val[i] . zJ; b[i])
//   v    = (s - table[i]) * val[i] + gbar[J]     (vr; init epoch: s * val[i])
//   z[J] = S_c(zJ - eta * v)   last[J] = t + 1   table[i] = s
//   acc[J] += s * val[i] / n
//
// then every coordinate catches up to step T. drift = -eta * gbar (vr) or
// 0; c = eta * lam1 of the l1 prox (0 without one). This is the arithmetic
// of ref.py's lazy_epoch_ref op for op; -fmad=false keeps every product
// and sum rounded on its own.
//
// What bounds it. Bytes: the visited rows' indices and values (12 bytes
// an entry), labels, orders and the table, z and gbar in and z and acc
// out (about 20.1 MB an epoch of 20,242 rows of 74 at d 47,236, 18 MB of
// it the rows: 6.0 us at 3.35 TB/s). But the steps form a serial chain
// (step t+1 may read what step t wrote), so the chain sets the pace: per
// step one round
// trip to L2 for the row's state, up to four closed-form rounds (a float64
// division each), a block reduction, one exp, the stores and a barrier.
// The design keeps that chain short:
//
// * One block; a thread per entry of the row (threads = the width
//   rounded up to whole warps, at most 128; wider rows give each thread
//   E = 2, 4 or 8 entries: width <= 1024). Indices
//   are distinct within a row, so no two threads of a step write one
//   address, and the barrier that ends a step orders its stores before
//   the next step's loads.
// * What does not depend on the state is fetched a step ahead into
//   registers: the next row's index, coordinates, values and label, and
//   its gbar entries (read-only), so the chain waits only on z, last and
//   acc. The next row's table entry too: it was written before the
//   barrier that ended the last step, or it is this step's row (a
//   repeated index), whose new s every thread holds.
// * The dot: each thread sums its own entries in a fixed order, an
//   xor-shuffle tree all-reduces each warp, warp partials go to shared
//   memory and every thread sums them in warp order after one barrier:
//   the margin, and s, are bit-identical in every thread.
// * The catch-up clamps its step counts to [0, rem] in float64 before
//   any cast to int: a tiny drift (|gbar_j| ~ 1e-15, or 1e-300) makes
//   ceil(z / drift) exceed 2^31 or overflow, and a double-to-int cast out
//   of range is undefined in C++.
// * last is int32 scratch; the launch zeroes it and acc and copies z and
//   the table into the outputs first, so one launch is one epoch call.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum LossKind { kLogistic = 0, kRidge = 1, kHuber = 2, kPseudoHuber = 3 };
enum Error { kErrPlan = 1000 };

constexpr int kMaxThreads = 128;

struct Params {
  const int32_t* idx;       // (n, width) coordinates, distinct within a row
  const double* val;        // (n, width)
  const double* b;          // (n,)
  const int64_t* perm;      // (T,) rows in visit order
  const double* z_in;       // (d,)
  const double* table_in;   // (n,)
  const double* gbar;       // (d,) read with vr
  double* z;                // (d,) out
  double* table;            // (n,) out
  double* acc;              // (d,) out
  int32_t* last;            // (d,) scratch: the step each coordinate is at
  int n, width, d, T;
  double eta, c, n_f, delta;        // n_f: n as a double
  int vr, loss;
};

__device__ __forceinline__ double sign_of(double v) {
  return v > 0.0 ? 1.0 : (v < 0.0 ? -1.0 : 0.0);
}

__device__ __forceinline__ double soft_threshold(double v, double t) {
  const double mag = (v < 0.0 ? -v : v) - t;
  return sign_of(v) * (mag > 0.0 ? mag : 0.0);
}

// s = l'(z; b), as vr_epoch.cu and convex._pointwise_residual compute it
__device__ __forceinline__ double residual(double z, double bb, int loss,
                                           double delta) {
  if (loss == kLogistic) {
    const double u = -bb * z;
    return -bb * __drcp_rn(1.0 + exp(-u));
  }
  if (loss == kRidge) return 2.0 * (z - bb);
  const double r = z - bb;
  if (loss == kHuber) {
    const double lo = r < -delta ? -delta : r;
    return lo > delta ? delta : lo;
  }
  const double q = r / delta;
  return r / sqrt(1.0 + q * q);
}

// ceil(num / den) - 1, the steps that keep the sign, clamped to [0, rem]
// in float64 before the cast (NaN counts as 0)
__device__ __forceinline__ int ceil_steps(double num, double den, int rem) {
  const double q = num / (den == 0.0 ? 1.0 : den);
  double t = ceil(q) - 1.0;
  t = t > 0.0 ? t : 0.0;
  t = t < static_cast<double>(rem) ? t : static_cast<double>(rem);
  return static_cast<int>(t);
}

// psi^rem(z), psi(u) = S_c(u + b): ref.lazy_apply for one coordinate. A
// round with nothing left to do changes nothing, so the loop stops there.
__device__ __forceinline__ double lazy_apply(double z, int rem, double b,
                                             double c) {
  const double dp = b - c;
  const double dn = b + c;
  const bool absorbing = (b < 0.0 ? -b : b) <= c;
#pragma unroll 1
  for (int r = 0; r < 4 && rem > 0; ++r) {
    int t;
    if (z > 0.0) {
      t = dp >= 0.0 ? rem : ceil_steps(z, -dp, rem);
      z = z + static_cast<double>(t) * dp;
    } else if (z < 0.0) {
      t = dn <= 0.0 ? rem : ceil_steps(-z, dn, rem);
      z = z + static_cast<double>(t) * dn;
    } else {
      t = absorbing ? rem : 0;
    }
    rem -= t;
    if (rem > 0) {
      z = soft_threshold(z + b, c);
      rem -= 1;
    }
  }
  return z;
}

__device__ __forceinline__ double warp_allreduce(double v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    v = v + __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// the margin of the block: every warp's all-reduced partial, then the
// partials in warp order, after one barrier
__device__ __forceinline__ double block_allreduce(double part, double* red,
                                                  int nw) {
  part = warp_allreduce(part);
  if (nw == 1) return part;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
  __syncthreads();
  double z = red[0];
  for (int k = 1; k < nw; ++k) z = z + red[k];
  return z;
}

// E entries a thread: entry e = tid + k * threads of the row, k < E
template <int E>
__global__ void __launch_bounds__(kMaxThreads)
lazy_epoch_kernel(const Params P) {
  __shared__ double red[kMaxThreads / 32];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nw = nt >> 5;
  const int width = P.width;

  for (int j = tid; j < P.d; j += nt) {
    P.z[j] = P.z_in[j];
    P.last[j] = 0;
    P.acc[j] = 0.0;
  }
  for (int i = tid; i < P.n; i += nt) P.table[i] = P.table_in[i];

  // the current row (coordinate, value, gbar entry) and the next one's
  int cj[E], nj[E];
  double cw[E], cg[E], nwv[E], ng[E];
  int ci = 0, ni = 0;
  double cb = 0.0, nb = 0.0;     // labels
  double cs = 0.0, ns = 0.0;     // table entries (the stored residual)

  auto fetch_row = [&](int i, int* jj, double* ww, double& bb) {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int e = tid + k * nt;
      jj[k] = e < width ? P.idx[int64_t(i) * width + e] : 0;
      ww[k] = e < width ? P.val[int64_t(i) * width + e] : 0.0;
    }
    bb = P.b[i];
  };
  auto fetch_gbar = [&](const int* jj, double* gg) {
#pragma unroll
    for (int k = 0; k < E; ++k)
      gg[k] = (P.vr && tid + k * nt < width) ? P.gbar[jj[k]] : 0.0;
  };

  if (P.T > 0) {
    ci = static_cast<int>(P.perm[0]);
    fetch_row(ci, cj, cw, cb);
    fetch_gbar(cj, cg);
    cs = P.table_in[ci];
  }
  int nn = P.T > 1 ? static_cast<int>(P.perm[1]) : 0;
  __syncthreads();

  for (int t = 0; t < P.T; ++t) {
    // what the next step reads that no step writes: fetched now, used
    // at the end of this step
    const bool more = t + 1 < P.T;
    if (more) {
      ni = nn;
      fetch_row(ni, nj, nwv, nb);
      // the barrier that ended the last step ordered every earlier table
      // write before this read; this step's own write is taken below
      ns = P.table[ni];
      nn = t + 2 < P.T ? static_cast<int>(P.perm[t + 2]) : 0;
    }
    double zc[E], ac[E];
    double part = 0.0;
#pragma unroll
    for (int k = 0; k < E; ++k) {
      zc[k] = ac[k] = 0.0;
      if (tid + k * nt < width) {
        const int j = cj[k];
        const double drift = P.vr ? -P.eta * cg[k] : 0.0;
        zc[k] = lazy_apply(P.z[j], t - P.last[j], drift, P.c);
        ac[k] = P.acc[j];
        part = part + cw[k] * zc[k];
      }
    }
    const double margin = block_allreduce(part, red, nw);
    const double s = residual(margin, cb, P.loss, P.delta);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      if (tid + k * nt < width) {
        const int j = cj[k];
        const double v = P.vr ? (s - cs) * cw[k] + cg[k] : s * cw[k];
        P.z[j] = soft_threshold(zc[k] - P.eta * v, P.c);
        P.last[j] = t + 1;
        P.acc[j] = ac[k] + s * cw[k] / P.n_f;
      }
    }
    if (tid == 0) P.table[ci] = s;
    if (more) fetch_gbar(nj, ng);
    __syncthreads();
    if (more) {
      cs = ni == ci ? s : ns;        // a repeated row reads this step's s
      ci = ni;
      cb = nb;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        cj[k] = nj[k];
        cw[k] = nwv[k];
        cg[k] = ng[k];
      }
    }
  }

  // materialize: every coordinate catches up to step T
  for (int j = tid; j < P.d; j += nt) {
    const double drift = P.vr ? -P.eta * P.gbar[j] : 0.0;
    P.z[j] = lazy_apply(P.z[j], P.T - P.last[j], drift, P.c);
  }
}

template <int E>
int launch(const Params& p, int threads, cudaStream_t stream) {
  lazy_epoch_kernel<E><<<1, threads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes: returns the cudaError_t of the
// launch (0 on success), or kErrPlan for a plan the kernel cannot run.
extern "C" {

int lazy_epoch_f64(const void* idx, const void* val, const void* b,
                   const void* perm, const void* z_in, const void* table_in,
                   const void* gbar, void* z, void* table, void* acc,
                   void* last, int64_t n, int64_t width, int64_t d,
                   int64_t T, double eta, double c, int vr, int loss,
                   double delta, int threads, int entries, void* stream) {
  if (n <= 0 || width <= 0 || d <= 0 || T < 0) return kErrPlan;
  if (n >= INT32_MAX || d >= INT32_MAX || T >= INT32_MAX) return kErrPlan;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return kErrPlan;
  if (int64_t(threads) * entries < width) return kErrPlan;
  Params p{static_cast<const int32_t*>(idx), static_cast<const double*>(val),
           static_cast<const double*>(b), static_cast<const int64_t*>(perm),
           static_cast<const double*>(z_in),
           static_cast<const double*>(table_in),
           static_cast<const double*>(gbar), static_cast<double*>(z),
           static_cast<double*>(table), static_cast<double*>(acc),
           static_cast<int32_t*>(last), static_cast<int>(n),
           static_cast<int>(width), static_cast<int>(d), static_cast<int>(T),
           eta, c, static_cast<double>(n), delta, vr, loss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (entries) {
    case 1: return launch<1>(p, threads, st);
    case 2: return launch<2>(p, threads, st);
    case 4: return launch<4>(p, threads, st);
    case 8: return launch<8>(p, threads, st);
    default: return kErrPlan;
  }
}

const char* lazy_epoch_error_string(int code) {
  if (code == kErrPlan) return "launch plan out of range";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
