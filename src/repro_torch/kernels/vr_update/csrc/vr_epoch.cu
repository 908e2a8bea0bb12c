// A whole fused VR epoch of p workers in one launch, for Hopper (sm_90a).
//
// K1's second route, for the convex paths. It replaces the per-step loop
// of launches around the Pallas TPU kernel _vr_update_kernel
// (src/repro/kernels/vr_update/kernel.py, launched by vr_update_flat's
// pallas_call), which the reference runs as one jitted lax.scan per epoch
// (src/repro/core/fused.py centralvr_epoch, saga_steps, svrg_steps). Per
// worker w, for t = 0..T-1 in order:
//
//   i     = order[w, t]            a = A[w, i, :]   (read by index)
//   z     = a . x                  s = l'(z; b[w, i])
//   s_old = table[w, i]            (lanes centralvr, saga; svrg: sbar[w, i])
//   g     = s*a    go = s_old*a    (each product rounded)
//   v     = g - go + gbar
//   x     = prox(x*scale - eta*v)
//   acc  += g*inv_m                (centralvr)
//   gbar += (g - go)*inv_m         (saga)
//   table[w, i] = s                (centralvr, saga)
//
// From g onward this is K1's element arithmetic op for op (vr_update.cu);
// -fmad=false keeps every product and sum rounded on its own.
//
// What bounds it. Bytes: each visited row once (T*d*8 a worker; 320 MB
// an epoch at p 8, n = T = 5000, d 1000, 95.5 us at 3.35 TB/s) and a few
// scalars a step. But a worker's steps form a serial chain: step t+1's
// dot needs step t's x. Each step pays at least one block barrier, a
// 5-level shuffle tree and one float64 exp (the logistic residual), so at
// d 20 or 90 the chain, not the bytes, sets the pace. The design keeps
// that chain short:
//
// * One block per worker (the p workers are independent), its threads
//   from launch_plan in epoch.py: one coordinate a thread up to d 256
//   (one warp up to d 32: no block barrier at all), then 256 or 512
//   threads of 2, 4 or 8 coordinates.
// * Each thread owns the coordinates j = tid + k*threads, k < K, for the
//   whole epoch, and keeps their x, gbar and acc in registers (K, a
//   template parameter, is 1, 2, 4 or 8), so a step's loads and products
//   over them are independent of each other. Above the on-chip capacity
//   (d > 512*8) the same kernel (K = 0) keeps the state in the output
//   buffers in global memory, where L2 holds it, and reads rows there.
// * Rows arrive ahead of use in a ring of 4 slots in shared memory: while
//   step t computes, every thread copies its own coordinates of row t+3
//   with cp.async (8 bytes each, so any d and any 8-byte-aligned A), one
//   commit group a step. The visit order is known in advance, so no
//   gathered copy of the epoch's rows is made (convex.gather_epoch is not
//   used on the card). One thread's 1-D TMA bulk copy a row, with an
//   mbarrier a slot, took 3-7% longer a step than this on an H100 at d
//   1000 and 25-34% longer at d 90 and 20 (PERF.md §6).
// * The dot: each thread sums its own coordinates in a fixed order, an
//   xor-shuffle tree all-reduces each warp (every lane ends with the same
//   bits: a + b == b + a), warp partials go to a double-buffered shared
//   slot, and after one __syncthreads every thread sums them in the same
//   order. So z, and s, which every thread computes for itself, are
//   bit-identical across threads and runs, at one barrier a step. The
//   same barrier frees the ring slot of step t-1 for the next copy.
// * Scalars come a window of 32 steps at a time, one step a lane of every
//   warp (index, label, table entry), read a window ahead and passed to
//   the step by __shfl_sync, so no step waits on a global load. The table
//   is read-write: SAGA's draws and uniform sampling repeat indices. A
//   window's entries are read right after a step's barrier, which orders
//   every earlier table write before them; from then on, after each step
//   every lane whose index is the step's takes its s (the lanes snoop
//   the writes), so a lane's entry is always the latest. Thread 0 writes
//   the table itself.
// * The lane is a template parameter: saga and svrg keep no acc.
// * TRACK (a template parameter, centralvr lane only) also stores the
//   iterate before each step into traj (p, T, d), the trajectory the
//   reference's centralvr_epoch(track=True) returns; the untracked
//   instantiation compiles without the store.
//
// vr_epoch_floor is a probe, not on any path: the serial chain alone (the
// shuffle tree, the barrier and the partial sums, one exp) for T steps,
// which chip_smoke.py times as the floor per step.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum Lane { kCentralVR = 0, kSaga = 1, kSvrg = 2 };
enum ProxKind {
  kProxNone = 0, kProxL1 = 1, kProxElasticNet = 2, kProxBox = 3
};
enum LossKind { kLogistic = 0, kRidge = 1, kHuber = 2, kPseudoHuber = 3 };

constexpr int kMaxSmem = 232448;      // a block's shared memory on an H100
constexpr int kFixedSmem = 512;       // 2 x 32 warp partials
constexpr int kStages = 4;           // ring slots of rows
constexpr int kMaxRegThreads = 512;  // a block's threads, state in registers

enum Error { kErrPlan = 1000, kErrSmem = 1001, kErrLane = 1002 };

struct Params {
  const double* A;          // (p, n, d)
  const double* b;          // (p, n)
  const int64_t* order;     // (p, T)
  double* x;                // (p, d) in and out
  double* table;            // (p, n) in and out; sbar with svrg (read)
  double* gbar;             // (p, d) in; out with saga
  double* acc;              // (p, d) out (centralvr)
  double* traj;             // (p, T, d) out: x before each step (TRACK)
  int64_t n, d, T;
  double eta, inv_m, scale, c1, c2, delta;
  int prox, loss;
};

__device__ __forceinline__ double sign_of(double v) {
  return v > 0.0 ? 1.0 : (v < 0.0 ? -1.0 : 0.0);
}

__device__ __forceinline__ double soft_threshold(double v, double t) {
  const double mag = (v < 0.0 ? -v : v) - t;
  return sign_of(v) * (mag > 0.0 ? mag : 0.0);
}

__device__ __forceinline__ double prox_epilogue(double xn, int prox, double c1,
                                                double c2) {
  if (prox == kProxL1) return soft_threshold(xn, c1);
  if (prox == kProxElasticNet) return soft_threshold(xn, c1) * c2;
  if (prox == kProxBox) {
    xn = xn < c1 ? c1 : xn;
    return xn > c2 ? c2 : xn;
  }
  return xn;
}

// s = l'(z; b), as convex._pointwise_residual computes it
__device__ __forceinline__ double residual(double z, double bb, int loss,
                                           double delta) {
  if (loss == kLogistic) {
    const double u = -bb * z;
    // the reciprocal correctly rounded: the same bits as 1.0 / (...)
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

__device__ __forceinline__ double warp_allreduce(double v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    v = v + __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// z of the block: every warp's all-reduced partial, then the partials in
// warp order; one barrier (a warp barrier when the block is one warp)
__device__ __forceinline__ double block_allreduce(double part, double* red,
                                                  int nw) {
  part = warp_allreduce(part);
  if (nw == 1) {
    __syncwarp();
    return part;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
  __syncthreads();
  double z = red[0];
  for (int k = 1; k < nw; ++k) z = z + red[k];
  return z;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kStages-2 of this thread's copy groups are pending
__device__ __forceinline__ void cp_async_wait_row() {
  static_assert(kStages == 4, "wait_group counts kStages - 2 groups");
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
}

// The scalars of a window of 32 steps, one step a lane: lane k of every
// warp holds step 32*W + k's index, label and table entry (sbar with
// svrg); idx -1 past the end
struct Window {
  int idx;
  double b, tab;
};

constexpr unsigned kFull = 0xffffffffu;

// K > 0: x, gbar and acc in registers, K coordinates a thread (j = tid +
// k*threads), rows through the ring in shared memory. K = 0: the state in
// the output buffers in global memory, rows read there (d above the
// on-chip capacity).
template <int LANE, int K, bool TRACK>
__global__ void __launch_bounds__(K == 0 ? 1024 : kMaxRegThreads)
vr_epoch_kernel(const Params P) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int KR = K > 0 ? K : 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nt = blockDim.x;
  const int nw = nt >> 5;
  const int64_t w = blockIdx.x;
  const int n = static_cast<int>(P.n), d = static_cast<int>(P.d);
  const int64_t T = P.T;

  double* red = reinterpret_cast<double*>(smem);              // [2][32]
  double* ring = reinterpret_cast<double*>(smem + kFixedSmem);

  const double* Aw = P.A + w * n * d;
  const double* bw = P.b + w * n;
  const int64_t* ow = P.order + w * T;
  double* tw = P.table + w * n;
  double* xg = P.x + w * d;
  double* gg = P.gbar + w * d;
  double* ag = LANE == kCentralVR ? P.acc + w * d : nullptr;

  double xr[KR], gr[KR], ar[KR];
  if constexpr (K > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + k * nt;
      xr[k] = j < d ? xg[j] : 0.0;
      gr[k] = j < d ? gg[j] : 0.0;
      ar[k] = 0.0;
    }
  } else if (LANE == kCentralVR) {
    for (int j = tid; j < d; j += nt) ag[j] = 0.0;
  }

  // windows: cur (this one), nx (the next: index loaded a window ahead,
  // label and table entry loaded at this window's first step) and the
  // index of the one after
  auto order_at = [&](int64_t u) {
    return u < T ? static_cast<int>(ow[u]) : -1;
  };
  Window cur, nx;
  cur.idx = order_at(lane);
  cur.b = cur.idx >= 0 ? bw[cur.idx] : 0.0;
  cur.tab = cur.idx >= 0 ? tw[cur.idx] : 0.0;
  nx.idx = order_at(32 + lane);
  nx.b = nx.tab = 0.0;
  int nn_idx = order_at(64 + lane);
  __syncthreads();

  // index of step u, for u in this window or the next (all lanes call it)
  auto index_of = [&](int64_t t, int64_t u) {
    return __shfl_sync(kFull, (u >> 5) == (t >> 5) ? cur.idx : nx.idx,
                       static_cast<int>(u & 31));
  };
  // copy row `r` of the epoch (index i) into its ring slot: every thread
  // copies its own coordinates and commits one group per call, past the
  // end too, so the group count stays the step count
  auto issue = [&](int64_t r, int i) {
    if (r < T) {
      double* dst = ring + (r % kStages) * d;
      const double* src = Aw + int64_t(i) * d;
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        const int j = tid + k * nt;
        if (j < d) cp_async8(smem_u32(dst + j), src + j);
      }
    }
    cp_async_commit();
  };

  if constexpr (K > 0)
    for (int64_t r = 0; r < kStages - 1; ++r) issue(r, index_of(0, r));

  int slot = 0;
  for (int64_t t = 0; t < T; ++t) {
    const int k = static_cast<int>(t & 31);
    if (k == 0 && t > 0) {
      cur = nx;
      nx.idx = nn_idx;
      nn_idx = order_at(t + 64 + lane);
    }
    const int ic = __shfl_sync(kFull, cur.idx, k);
    const double bc = __shfl_sync(kFull, cur.b, k);
    const double so = __shfl_sync(kFull, cur.tab, k);
    // the row of the next copy (or, without a ring, of the next step)
    const int pi = index_of(t, K > 0 ? t + kStages - 1 : t + 1);

    double part = 0.0;
    double s;
    if constexpr (K > 0) {
      const double* row = ring + slot * d;
      cp_async_wait_row();
      double a[K];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int j = tid + q * nt;
        a[q] = j < d ? row[j] : 0.0;
      }
#pragma unroll
      for (int q = 0; q < K; ++q)
        if (tid + q * nt < d) part = part + a[q] * xr[q];
      const double z = block_allreduce(part, red + (t & 1) * 32, nw);
      // the barrier above freed the slot of step t-1: refill it
      issue(t + kStages - 1, pi);
      s = residual(z, bc, P.loss, P.delta);
      if constexpr (TRACK) {
        double* tr = P.traj + (w * T + t) * d;
#pragma unroll
        for (int q = 0; q < K; ++q)
          if (tid + q * nt < d) tr[tid + q * nt] = xr[q];
      }
#pragma unroll
      for (int q = 0; q < K; ++q) {
        if (tid + q * nt < d) {
          const double g = s * a[q];
          const double go = so * a[q];
          const double gb = gr[q];
          const double v = g - go + gb;
          xr[q] = prox_epilogue(xr[q] * P.scale - P.eta * v, P.prox, P.c1,
                                P.c2);
          if (LANE == kCentralVR) ar[q] = ar[q] + g * P.inv_m;
          if (LANE == kSaga) gr[q] = gb + (g - go) * P.inv_m;
        }
      }
    } else {
      const double* row = Aw + int64_t(ic) * d;
      if (pi >= 0)
        for (int j = tid; j < d; j += nt)
          asm volatile("prefetch.global.L2 [%0];\n"
                       :: "l"(Aw + int64_t(pi) * d + j));
      for (int j = tid; j < d; j += nt) part = part + row[j] * xg[j];
      const double z = block_allreduce(part, red + (t & 1) * 32, nw);
      s = residual(z, bc, P.loss, P.delta);
      for (int j = tid; j < d; j += nt) {
        const double a = row[j];
        const double g = s * a;
        const double go = so * a;
        const double gb = gg[j];
        const double v = g - go + gb;
        if constexpr (TRACK) P.traj[(w * T + t) * d + j] = xg[j];
        xg[j] = prox_epilogue(xg[j] * P.scale - P.eta * v, P.prox, P.c1,
                              P.c2);
        if (LANE == kCentralVR) ag[j] = ag[j] + g * P.inv_m;
        if (LANE == kSaga) gg[j] = gb + (g - go) * P.inv_m;
      }
    }
    // the barrier above ordered every table write before this step: the
    // next window's labels and table entries can be read now
    if (k == 0 && nx.idx >= 0) {
      nx.b = bw[nx.idx];
      nx.tab = tw[nx.idx];
    }
    if (LANE != kSvrg) {
      if (tid == 0) tw[ic] = s;
      // every lane holding a later step of this index takes the new value
      if (cur.idx == ic) cur.tab = s;
      if (nx.idx == ic) nx.tab = s;
    }
    if (++slot == kStages) slot = 0;
  }

  if constexpr (K > 0) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + k * nt;
      if (j < d) {
        xg[j] = xr[k];
        if (LANE == kSaga) gg[j] = gr[k];
        if (LANE == kCentralVR) ag[j] = ar[k];
      }
    }
  }
}

// the serial chain of a step alone, T times: shuffle tree, barrier,
// partial sums, one exp
__global__ void __launch_bounds__(1024) vr_epoch_floor_kernel(double* out,
                                                              int64_t T) {
  __shared__ double red[2][32];
  const int nw = blockDim.x >> 5;
  double v = 1.0 + 1e-3 * threadIdx.x;
  for (int64_t t = 0; t < T; ++t) {
    const double z = block_allreduce(v, red[t & 1], nw);
    v = exp(-1e-3 * z);
  }
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

template <int LANE, int K, bool TRACK>
int launch(const Params& p, int64_t workers, int threads, int smem,
           cudaStream_t stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      vr_epoch_kernel<LANE, K, TRACK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  vr_epoch_kernel<LANE, K, TRACK><<<static_cast<unsigned>(workers), threads,
                                    smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int LANE, bool TRACK = false>
int launch_lane(const Params& p, int64_t workers, int threads, int coords,
                int smem, cudaStream_t stream) {
  switch (coords) {
    case 0: return launch<LANE, 0, TRACK>(p, workers, threads, smem, stream);
    case 1: return launch<LANE, 1, TRACK>(p, workers, threads, smem, stream);
    case 2: return launch<LANE, 2, TRACK>(p, workers, threads, smem, stream);
    case 4: return launch<LANE, 4, TRACK>(p, workers, threads, smem, stream);
    case 8: return launch<LANE, 8, TRACK>(p, workers, threads, smem, stream);
    default: return kErrPlan;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes: returns the cudaError_t of the
// launch (0 on success), or one of Error for a plan the kernel cannot run.
// traj: null, or (workers, T, d) for the centralvr lane's tracked epoch.
extern "C" {

int vr_epoch_f64(int lane, const void* A, const void* b, const void* order,
                 void* x, void* table, void* gbar, void* acc, void* traj,
                 int64_t workers,
                 int64_t n, int64_t d, int64_t T, double eta, double inv_m,
                 double scale, int prox, double c1, double c2, int loss,
                 double delta, int threads, int coords, void* stream) {
  if (workers <= 0 || n <= 0 || d <= 0 || T < 0) return kErrPlan;
  if (n > INT32_MAX || d > INT32_MAX) return kErrPlan;
  if (threads < 32 || threads > 1024 || threads % 32) return kErrPlan;
  // registers: every coordinate owned, at most kMaxRegThreads threads;
  // global memory (coords 0): no ring
  if (coords > 0 && (threads > kMaxRegThreads
                     || int64_t(threads) * coords < d))
    return kErrPlan;
  const int64_t smem = kFixedSmem + (coords ? 8 * kStages * d : 0);
  if (smem > kMaxSmem) return kErrSmem;
  Params p{static_cast<const double*>(A), static_cast<const double*>(b),
           static_cast<const int64_t*>(order), static_cast<double*>(x),
           static_cast<double*>(table), static_cast<double*>(gbar),
           static_cast<double*>(acc), static_cast<double*>(traj), n, d, T,
           eta, inv_m, scale, c1, c2, delta, prox, loss};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bytes = static_cast<int>(smem);
  if (traj && lane != kCentralVR) return kErrLane;
  switch (lane) {
    case kCentralVR:
      return traj ? launch_lane<kCentralVR, true>(p, workers, threads,
                                                  coords, bytes, st)
                  : launch_lane<kCentralVR>(p, workers, threads, coords,
                                            bytes, st);
    case kSaga:
      return launch_lane<kSaga>(p, workers, threads, coords, bytes, st);
    case kSvrg:
      return launch_lane<kSvrg>(p, workers, threads, coords, bytes, st);
    default: return kErrLane;
  }
}

int vr_epoch_floor(void* out, int64_t workers, int threads, int64_t T,
                   void* stream) {
  if (workers <= 0 || threads < 32 || threads > 1024 || threads % 32)
    return kErrPlan;
  vr_epoch_floor_kernel<<<static_cast<unsigned>(workers), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(out), T);
  return static_cast<int>(cudaGetLastError());
}

const char* vr_epoch_error_string(int code) {
  switch (code) {
    case kErrPlan: return "launch plan out of range";
    case kErrSmem: return "shared memory above the block's 232448 bytes";
    case kErrLane: return "unknown lane, or a tracked lane other than centralvr";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
