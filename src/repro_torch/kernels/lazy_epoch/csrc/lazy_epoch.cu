// One lazy sparse CentralVR epoch in one launch, for Hopper (sm_90a).
//
// It replaces no Pallas kernel: the TPU reference runs the sparse driver
// (src/repro/prox/lazy.py, sampling="sparse") as one jitted lax.scan,
// _lazy_epoch (lazy.py:215), whose step is a gather, the closed-form
// catch-up of the row's coordinates, a dot, the residual, the corrected
// step, a soft-threshold and three scatters. Written eagerly in PyTorch
// that is some fifty small launches a step, so the epoch is a persistent
// kernel here, the sparse sibling of vr_epoch.cu. Step t visits row
// i = perm[t] of the fixed-width rows (idx, val); J are the row's entries
// whose value is not 0 (sparsify pads every row to the longest with
// value-0 entries; see below):
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
// What bounds it. Bytes: the visited rows' nonzero entries (12 bytes
// each), labels, orders and the table, z and gbar in and z and acc out
// (about 20.1 MB an epoch of 20,242 rows of 74 at d 47,236: 6.0 us at
// 3.35 TB/s). But the steps form a serial chain (step t+1 may read what
// step t wrote), so the chain sets the pace. Done in order, a step would
// wait on an L2 round trip for the row's z and last, the catch-up (up to
// four closed-form rounds, a float64 division each), the reduction, the
// residual, the stores and a barrier, and the catch-up alone is three
// quarters of that (PERF.md §6). This design takes the state load and
// the catch-up off the chain:
//
// * Two groups of warps in one block: the step group (a thread per row
//   entry, threads = the width rounded up to whole warps, at most 128;
//   wider rows give each thread E = 2, 4 or 8 entries: width <= 1024) and
//   a look-ahead group of as many threads, which owns the same entries
//   (entry e = tid + k * threads, k < E). One named barrier (bar.sync 2)
//   ends each step; the block's other warps join only the passes over d.
// * A coordinate of row t+1 that step t does not touch cannot change
//   during step t. So while the step group runs step t (reduction,
//   residual, update, stores), the look-ahead group catches row t+1 up to
//   step t+1. Its z, last and gbar were copied into shared memory one step
//   earlier still (cp.async, issued during step t-1), so no global load
//   is on either group's chain. The rows' coordinates and values arrive
//   by cp.async three steps ahead, into a ring of 4 slots (their state
//   into a ring of 3).
// * Those early copies are stale where step t-1 or t writes. Membership
//   of rows t and t-1 comes from a 16-bit stamp per coordinate in shared
//   memory: the last row that held the coordinate stamps it with its
//   step's 6 low bits and the entry's position, one load and one store a
//   lookup. A stamp that names row t or t-1 is checked against that row's
//   coordinates (an older row may share the low bits), so the answer is
//   exact. For each entry of row t+1: a coordinate of row t takes step t's
//   new value from shared memory after the barrier (its last is t+1: no
//   catch-up); a coordinate of row t-1 takes step t-1's new value and
//   catches up one step; any other takes its early copy. Where d does not
//   fit the stamps (above about 111,000 at width 74, 48,600 at width
//   1024), small hash tables of the last rows' coordinates take their
//   place (open addressing, 8 slots an entry where they fit, each cleared
//   two steps after use), with the same answers. A repeated row
//   (perm[t+1] == perm[t]) finds all its entries in row t, and its table
//   entry is this step's s.
// * The catch-up's rounds: the lanes of a warp take one division a round
//   together whatever the signs of their z, and none in a round where no
//   lane needs one.
// * acc is only added to: red.global.add.f64 (atomicAdd with no return)
//   instead of a load and a store. A barrier separates the steps and the
//   indices within a row are distinct, so each address takes its adds in
//   step order and acc is bit-equal to a load-add-store.
// * Entries whose value is exactly 0 (sparsify's padding) are skipped:
//   their state is not copied, caught up, updated or stamped (or entered
//   in a hash table). A value-0 entry
//   at coordinate j applies exactly psi to j, which the next touch or the
//   closing pass applies in closed form, so skipping it changes the
//   result by rounding only; a row's work follows its own length, not the
//   longest row's. ref.py's plain version skips them the same way.
// * The dot: each step thread sums its own entries in a fixed order, an
//   xor-shuffle tree all-reduces each warp, warp partials go to shared
//   memory and every step thread sums them in warp order after a barrier
//   of the step group alone (bar.sync 1): the margin, and s, are
//   bit-identical in every thread.
// * The catch-up clamps its step counts to [0, rem] in float64 before
//   any cast to int: a tiny drift (|gbar_j| ~ 1e-15, or 1e-300) makes
//   ceil(z / drift) exceed 2^31 or overflow, and a double-to-int cast out
//   of range is undefined in C++.
// * last is int32 scratch; the launch zeroes it and acc and copies z and
//   the table into the outputs first, so one launch is one epoch call.
//
// Timing probes, not on any path (chip_smoke.py's phase split): STOP <
// kFull instantiations end each step after a phase (the look-ahead's
// copies; its membership, the state load; its catch-up; the step
// group's reduction), kPasses runs only the passes over d at each end,
// and lazy_epoch_floor runs the step's serial chain alone (shuffle tree,
// barriers, the residual, a store) for T steps.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

enum LossKind { kLogistic = 0, kRidge = 1, kHuber = 2, kPseudoHuber = 3 };
enum Error { kErrPlan = 1000 };
// where a probe's step stops (kFull: the epoch itself; kPasses: the two
// passes over d alone, no step)
enum Stop {
  kPasses = 0, kCopy = 1, kLoad = 2, kCatchUp = 3, kReduce = 4, kFull = 5
};

constexpr int kMaxThreads = 128;      // a group's threads at most
constexpr int kBlock = 256;           // the block: the two groups, and
                                      // warps that run only the passes
constexpr int kSlots = 4;             // rows' coordinates and values, and
                                      // hash tables: rows t-1 .. t+2
constexpr int kStates = 3;            // rows' z, last and gbar: t .. t+2
constexpr int kMaxSmem = 232448;      // a block's shared memory on an H100
// a stamp: the 6 low bits of a row's step, then the entry's position
constexpr int kPosBits = 10;          // width <= 1024
constexpr int kTagMask = 63;

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
  int hbits;                        // hash tables of 2^hbits slots (0:
                                    // stamps instead)
  int nt;                           // threads of each group
};

// shared memory, for a width W: the rows' coordinates and values (kSlots
// slots) and their state (kStates slots: z, last or source, gbar), two
// rows of new values and their coordinates, the warp partials; then
// either a 16-bit stamp per coordinate, or kSlots hash tables and each
// entry's slot in its table
struct Smem {
  int2* hash;       // [kSlots][2^hbits] (coordinate or -1, position)
  double* rw;       // [kSlots][W] values
  double* rz;       // [kStates][W] early z, then the caught-up z
  double* rg;       // [kStates][W] gbar
  double* zn;       // [2][W] each step's new z, by position
  double* red;      // [kMaxThreads / 32] warp partials
  int32_t* rj;      // [kSlots][W] coordinates
  int32_t* rl;      // [kStates][W] early last, then the source: -1, or
                    //              the entry's position in the last row
  int32_t* znj;     // [2][W] each step's coordinates, by position (-1:
                    //        a skipped entry)
  int32_t* rh;      // [kSlots][W] the entry's slot in its row's hash
                    //             table, or -1: what to clear
  uint16_t* stamp;  // [d] the last row that holds the coordinate
};

__host__ __device__ inline int64_t smem_bytes(int width, int hbits, int d) {
  const int64_t w = width;
  int64_t bytes = kSlots * w * 12 + kStates * w * 20 + 2 * w * 12
                  + 8 * (kMaxThreads / 32);
  if (hbits) return bytes + kSlots * w * 4 + kSlots * 8 * (int64_t(1) << hbits);
  return bytes + 2 * int64_t(d);
}

__device__ inline Smem carve(unsigned char* base, int W, int hbits) {
  Smem s;
  s.hash = reinterpret_cast<int2*>(base);
  s.rw = reinterpret_cast<double*>(s.hash + (hbits ? kSlots << hbits : 0));
  s.rz = s.rw + kSlots * W;
  s.rg = s.rz + kStates * W;
  s.zn = s.rg + kStates * W;
  s.red = s.zn + 2 * W;
  s.rj = reinterpret_cast<int32_t*>(s.red + kMaxThreads / 32);
  s.rl = s.rj + kSlots * W;
  s.znj = s.rl + kStates * W;
  s.rh = s.znj + 2 * W;
  s.stamp = reinterpret_cast<uint16_t*>(s.rh + (hbits ? kSlots * W : 0));
  return s;
}

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
// The lanes of a warp whose z have different signs take one division
// together (the phase picks its operands), not one division per branch
// in turn, and a round where no lane needs one takes none.
__device__ __forceinline__ double lazy_apply(double z, int rem, double b,
                                             double c) {
  const double dp = b - c;
  const double dn = b + c;
  const bool absorbing = (b < 0.0 ? -b : b) <= c;
#pragma unroll 1
  for (int r = 0; r < 4 && rem > 0; ++r) {
    // z > 0 moves by dp a step until it would cross 0, z < 0 by dn, and
    // 0 stays where it is absorbing
    const bool pos = z > 0.0;
    const bool neg = z < 0.0;
    const bool whole = pos ? dp >= 0.0 : (neg ? dn <= 0.0 : absorbing);
    int t = whole ? rem : 0;
    if (!whole && (pos || neg))
      t = ceil_steps(pos ? z : -z, pos ? -dp : dn, rem);
    if (pos || neg) z = z + static_cast<double>(t) * (pos ? dp : dn);
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

// a barrier of the first nt threads alone (the step group)
__device__ __forceinline__ void group_sync(int nt) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
}

// the barrier that ends a step: both groups, not the pass-only warps
__device__ __forceinline__ void step_sync(int nt) {
  asm volatile("bar.sync 2, %0;\n" ::"r"(2 * nt) : "memory");
}

// the margin of the step group (the first nw warps): every warp's
// all-reduced partial, then the partials in warp order, after the
// group's barrier
__device__ __forceinline__ double block_allreduce(double part, double* red,
                                                  int nw) {
  part = warp_allreduce(part);
  if (nw == 1) return part;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
  group_sync(nw * 32);
  double z = red[0];
  for (int k = 1; k < nw; ++k) z = z + red[k];
  return z;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int hash_slot(int j, int hbits) {
  return static_cast<int>((static_cast<uint32_t>(j) * 0x9E3779B1u)
                          >> (32 - hbits));
}

// the position of coordinate j in the table's row, or -1
__device__ __forceinline__ int hash_find(const int2* h, int hbits, int j) {
  const int mask = (1 << hbits) - 1;
  for (int s = hash_slot(j, hbits);; s = (s + 1) & mask) {
    const int2 e = h[s];
    if (e.x == j) return e.y;
    if (e.x < 0) return -1;
  }
}

// returns the slot it took
__device__ __forceinline__ int hash_insert(int2* h, int hbits, int j,
                                           int pos) {
  const int mask = (1 << hbits) - 1;
  int s = hash_slot(j, hbits);
  while (atomicCAS(&h[s].x, -1, j) != -1) s = (s + 1) & mask;
  h[s].y = pos;
  return s;
}

// the look-ahead thread's copies: row i's coordinates and values into
// ring slot u; for a row already there, its entries' z, last and gbar
// into state slot v
template <int E>
__device__ __forceinline__ void copy_row(const Params& P, const Smem& S,
                                         int u, int i, int lt, int nt) {
  const int W = P.width;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int e = lt + k * nt;
    if (e < W) {
      cp_async4(S.rj + u * W + e, P.idx + int64_t(i) * W + e);
      cp_async8(S.rw + u * W + e, P.val + int64_t(i) * W + e);
    }
  }
}

template <int E>
__device__ __forceinline__ void copy_state(const Params& P, const Smem& S,
                                           int u, int v, int lt, int nt) {
  const int W = P.width;
#pragma unroll
  for (int k = 0; k < E; ++k) {
    const int e = lt + k * nt;
    if (e < W && S.rw[u * W + e] != 0.0) {
      const int j = S.rj[u * W + e];
      cp_async8(S.rz + v * W + e, P.z + j);
      cp_async4(S.rl + v * W + e, P.last + j);
      if (P.vr) cp_async8(S.rg + v * W + e, P.gbar + j);
    }
  }
}

// Where entry e (coordinate j) of row t+1 finds its value at step t:
// returns its position in row t (take step t's new value), or -1 with
// prev set to its position in row t-1 (step t-1's value, one step to
// catch up) or -1 (its early copy). Then enters j as row t+1's. Stamps:
// the last row holding j stamped it with its step's low bits and the
// position, so a stamp that names row t or t-1 is checked against that
// row's coordinates (an older row may carry the same low bits); hash
// tables: one a row, probed for rows t and t-1.
template <bool STAMPS>
__device__ __forceinline__ int find_prior(const Params& P, const Smem& S,
                                          int t, int j, int e, int& prev) {
  const int W = P.width;
  prev = -1;
  if (STAMPS) {
    const int v = S.stamp[j];
    const int tag = v >> kPosBits;
    const int p = v & ((1 << kPosBits) - 1);
    S.stamp[j] =
        static_cast<uint16_t>((((t + 1) & kTagMask) << kPosBits) | e);
    if (p < W) {
      const int u = (t & (kSlots - 1)) * W;
      if (tag == (t & kTagMask) && S.rj[u + p] == j && S.rw[u + p] != 0.0)
        return p;
      if (tag == ((t - 1) & kTagMask) && S.znj[((t + 1) & 1) * W + p] == j)
        prev = p;
    }
    return -1;
  }
  const int H = 1 << P.hbits;
  const int q = hash_find(S.hash + (t & (kSlots - 1)) * H, P.hbits, j);
  if (q < 0)
    prev = hash_find(S.hash + ((t + 3) & (kSlots - 1)) * H, P.hbits, j);
  const int n1 = (t + 1) & (kSlots - 1);
  S.rh[n1 * W + e] = hash_insert(S.hash + n1 * H, P.hbits, j, e);
  return q;
}

// E entries a thread: entry e = tid + k * threads of the row, k < E.
// STOP < kFull: a timing probe that ends each step after that phase.
// Threads [0, nt) are the step group, [nt, 2 nt) the look-ahead group;
// the rest of the kBlock threads join only the passes over d. STAMPS:
// membership by a stamp per coordinate (d fits in shared memory), else
// by hash tables.
template <int E, int STOP, bool STAMPS>
__global__ void __launch_bounds__(kBlock)
lazy_epoch_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem S = carve(smem, P.width, P.hbits);
  const int W = P.width;
  const int H = STAMPS ? 0 : 1 << P.hbits;
  const int nt = P.nt;
  const bool stepper = threadIdx.x < nt;
  const bool steps = threadIdx.x < 2 * nt;
  const int tid = stepper ? threadIdx.x : threadIdx.x - nt;
  const int nw = nt >> 5;

  for (int j = threadIdx.x; j < P.d; j += blockDim.x) {
    P.z[j] = P.z_in[j];
    P.last[j] = 0;
    P.acc[j] = 0.0;
    if (STAMPS) S.stamp[j] = 0xffff;
  }
  for (int i = threadIdx.x; i < P.n; i += blockDim.x)
    P.table[i] = P.table_in[i];
  for (int s = threadIdx.x; s < kSlots * H; s += blockDim.x)
    S.hash[s] = make_int2(-1, 0);
  for (int s = threadIdx.x; s < kSlots * W; s += blockDim.x) {
    S.rw[s] = 0.0;
    if (!STAMPS) S.rh[s] = -1;
  }
  for (int s = threadIdx.x; s < kStates * W; s += blockDim.x) S.rg[s] = 0.0;
  for (int s = threadIdx.x; s < 2 * W; s += blockDim.x) {
    S.zn[s] = 0.0;
    S.znj[s] = -1;
  }
  __syncthreads();

  const int T = STOP == kPasses || !steps ? 0 : P.T;
  // the step group's scalars: this row, its label and table entry, and
  // the next row's; the look-ahead group's next row to copy
  int ci = 0, ni = 0, nn = 0;
  double cb = 0.0, nb = 0.0, cs = 0.0, ns = 0.0;
  int64_t ahead = 0;
  if (T > 0) {
    if (stepper) {
      ci = static_cast<int>(P.perm[0]);
      cb = P.b[ci];
      cs = P.table_in[ci];
      nn = T > 1 ? static_cast<int>(P.perm[1]) : 0;
    } else {
      // rows 0..2 into slots 0..2, then rows 0 and 1's state; row 0 needs
      // no catch-up (every last is 0) and enters as the first row
      for (int r = 0; r < 3 && r < T; ++r)
        copy_row<E>(P, S, r, static_cast<int>(P.perm[r]), tid, nt);
      cp_async_commit();
      cp_async_wait_all();
      for (int r = 0; r < 2 && r < T; ++r)
        copy_state<E>(P, S, r, r, tid, nt);
      cp_async_commit();
      cp_async_wait_all();
      int prev;
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int e = tid + k * nt;
        if (e < W && S.rw[e] != 0.0) {
          S.rl[e] = -1;
          find_prior<STAMPS>(P, S, -1, S.rj[e], e, prev);
        }
      }
      ahead = T > 3 ? P.perm[3] : 0;
    }
  }
  __syncthreads();

  double sink = 0.0;
  int s3 = 0;                      // t % kStates
  for (int t = 0; t < T; ++t, s3 = s3 == kStates - 1 ? 0 : s3 + 1) {
    const int s3n = s3 == kStates - 1 ? 0 : s3 + 1;       // (t+1) % 3
    const int s3nn = s3n == kStates - 1 ? 0 : s3n + 1;    // (t+2) % 3
    if (stepper) {
      // ---- the step group: step t on row ci ----
      const bool more = t + 1 < T;
      if (more) {
        ni = nn;
        nb = P.b[ni];
        // the barrier that ended the last step ordered every earlier table
        // write before this read; this step's own write is taken below
        ns = P.table[ni];
        nn = t + 2 < T ? static_cast<int>(P.perm[t + 2]) : 0;
      }
      if (STOP >= kReduce) {
        const int u = (t & (kSlots - 1)) * W;
        const int v = s3 * W;
        const double* zprev = S.zn + ((t + 1) & 1) * W;   // step t-1's
        double zc[E], cw[E];
        double part = 0.0;
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const int e = tid + k * nt;
          cw[k] = e < W ? S.rw[u + e] : 0.0;
          zc[k] = 0.0;
          if (cw[k] != 0.0) {
            const int src = S.rl[v + e];
            zc[k] = src < 0 ? S.rz[v + e] : zprev[src];
            part = part + cw[k] * zc[k];
          }
        }
        const double margin = block_allreduce(part, S.red, nw);
        const double s = residual(margin, cb, P.loss, P.delta);
        if (STOP == kFull) {
          double* znew = S.zn + (t & 1) * W;
          int32_t* zj = S.znj + (t & 1) * W;
#pragma unroll
          for (int k = 0; k < E; ++k) {
            const int e = tid + k * nt;
            if (e >= W) continue;
            zj[e] = -1;
            if (cw[k] != 0.0) {
              const int j = S.rj[u + e];
              const double g = S.rg[v + e];
              const double dv = P.vr ? (s - cs) * cw[k] + g : s * cw[k];
              const double zz = soft_threshold(zc[k] - P.eta * dv, P.c);
              P.z[j] = zz;
              P.last[j] = t + 1;
              atomicAdd(P.acc + j, s * cw[k] / P.n_f);
              znew[e] = zz;
              zj[e] = j;
            }
          }
          if (tid == 0) P.table[ci] = s;
        } else {
          sink = sink + s;
        }
        step_sync(nt);
        cs = ni == ci ? s : ns;        // a repeated row reads this step's s
      } else {
        step_sync(nt);
        cs = ns;
      }
      ci = ni;
      cb = nb;
    } else {
      // ---- the look-ahead group: row t+1 caught up to step t+1 ----
      if (t + 1 < T) {
        // the copies issued during step t-1: row t+1's state, row t+2's
        // coordinates and values
        cp_async_wait_all();
        if (t + 2 < T)
          copy_state<E>(P, S, (t + 2) & (kSlots - 1), s3nn, tid, nt);
        if (t + 3 < T) {
          copy_row<E>(P, S, (t + 3) & (kSlots - 1), static_cast<int>(ahead),
                      tid, nt);
          ahead = t + 4 < T ? P.perm[t + 4] : 0;
        }
        cp_async_commit();
        if (STOP == kCopy) {
          step_sync(nt);
          continue;
        }
        const int u = ((t + 1) & (kSlots - 1)) * W;
        const int v = s3n * W;
        const double* zprev = S.zn + ((t + 1) & 1) * W;   // step t-1's
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const int e = tid + k * nt;
          if (e >= W) continue;
          if (!STAMPS) S.rh[u + e] = -1;
          if (S.rw[u + e] != 0.0) {
            int qp;
            const int q = find_prior<STAMPS>(P, S, t, S.rj[u + e], e, qp);
            if (q >= 0) {
              S.rl[v + e] = q;            // step t's new value, no catch-up
            } else {
              const double z0 = qp >= 0 ? zprev[qp] : S.rz[v + e];
              const int l0 = qp >= 0 ? t : S.rl[v + e];
              if (STOP == kLoad) {
                S.rz[v + e] = z0 + static_cast<double>(l0);
              } else {
                const double drift = P.vr ? -P.eta * S.rg[v + e] : 0.0;
                S.rz[v + e] = lazy_apply(z0, t + 1 - l0, drift, P.c);
              }
              S.rl[v + e] = -1;
            }
          }
        }
        if (!STAMPS) {
          // row t-2's table, free for row t+2 at the next step: the slots
          // its entries took
          const int uc = (t + 2) & (kSlots - 1);
          int2* h_c = S.hash + uc * H;
#pragma unroll
          for (int k = 0; k < E; ++k) {
            const int e = tid + k * nt;
            if (e < W && S.rh[uc * W + e] >= 0) h_c[S.rh[uc * W + e]].x = -1;
          }
        }
      }
      step_sync(nt);
    }
  }
  __syncthreads();

  // materialize: every coordinate catches up to step T, the block's
  // threads 4 coordinates at a time (their loads issued together)
  constexpr int kQ = 4;
  for (int j0 = threadIdx.x; j0 < P.d; j0 += kQ * blockDim.x) {
    double zq[kQ], gq[kQ];
    int lq[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int j = j0 + q * blockDim.x;
      zq[q] = gq[q] = 0.0;
      lq[q] = P.T;
      if (j < P.d) {
        zq[q] = P.z[j];
        lq[q] = P.last[j];
        if (P.vr) gq[q] = P.gbar[j];
      }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int j = j0 + q * blockDim.x;
      if (j < P.d)
        P.z[j] = lazy_apply(zq[q], P.T - lq[q], P.vr ? -P.eta * gq[q] : 0.0,
                            P.c);
    }
  }
  if (STOP < kFull && sink == 1.0) P.acc[0] = sink;   // keeps the work
}

// the serial chain of a step alone, T times: shuffle tree, block barrier,
// the logistic residual (one exp, one reciprocal), a store, the step's
// barrier
__global__ void __launch_bounds__(kMaxThreads)
lazy_epoch_floor_kernel(double* out, int64_t T) {
  __shared__ double red[kMaxThreads / 32];
  const int nw = blockDim.x >> 5;
  double v = 1.0 + 1e-3 * threadIdx.x;
  for (int64_t t = 0; t < T; ++t) {
    const double s = residual(block_allreduce(v, red, nw), 1.0, kLogistic,
                              1.0);
    out[(t & 1) * blockDim.x + threadIdx.x] = s;
    v = s + 1e-3 * threadIdx.x;
    __syncthreads();
  }
}

template <int E, int STOP, bool STAMPS>
int launch(const Params& p, int smem, cudaStream_t stream) {
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      lazy_epoch_kernel<E, STOP, STAMPS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  lazy_epoch_kernel<E, STOP, STAMPS><<<1, kBlock, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int STOP, bool STAMPS>
int launch_entries(const Params& p, int entries, int smem,
                   cudaStream_t stream) {
  switch (entries) {
    case 1: return launch<1, STOP, STAMPS>(p, smem, stream);
    case 2: return launch<2, STOP, STAMPS>(p, smem, stream);
    case 4: return launch<4, STOP, STAMPS>(p, smem, stream);
    case 8: return launch<8, STOP, STAMPS>(p, smem, stream);
    default: return kErrPlan;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes: returns the cudaError_t of the
// launch (0 on success), or kErrPlan for a plan the kernel cannot run.
// stop: kFull for the epoch; below it, a timing probe (see Stop), on the
// stamp path only. The block is kBlock threads: the step group and the
// look-ahead group of ``threads`` each, and the warps that join only the
// passes.
extern "C" {

int lazy_epoch_f64(int stop, const void* idx, const void* val,
                   const void* b, const void* perm, const void* z_in,
                   const void* table_in, const void* gbar, void* z,
                   void* table, void* acc, void* last, int64_t n,
                   int64_t width, int64_t d, int64_t T, double eta,
                   double c, int vr, int loss, double delta, int threads,
                   int entries, void* stream) {
  if (n <= 0 || width <= 0 || d <= 0 || T < 0) return kErrPlan;
  if (n >= INT32_MAX || d >= INT32_MAX || T >= INT32_MAX) return kErrPlan;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return kErrPlan;
  if (int64_t(threads) * entries < width) return kErrPlan;
  if (width > (1 << kPosBits)) return kErrPlan;
  const int w = static_cast<int>(width);
  // a stamp per coordinate where d fits; else hash tables of 8 slots an
  // entry where they fit, at least 2 (a load factor <= 1/2)
  int hbits = 0;
  if (smem_bytes(w, 0, static_cast<int>(d)) > kMaxSmem) {
    hbits = 6;
    while ((int64_t(1) << hbits) < 8 * width) ++hbits;
    while (smem_bytes(w, hbits, 0) > kMaxSmem
           && (int64_t(1) << (hbits - 1)) >= 2 * width)
      --hbits;
    if (stop != kFull) return kErrPlan;
  }
  const int64_t smem = smem_bytes(w, hbits, hbits ? 0 : static_cast<int>(d));
  if (smem > kMaxSmem) return kErrPlan;
  Params p{static_cast<const int32_t*>(idx), static_cast<const double*>(val),
           static_cast<const double*>(b), static_cast<const int64_t*>(perm),
           static_cast<const double*>(z_in),
           static_cast<const double*>(table_in),
           static_cast<const double*>(gbar), static_cast<double*>(z),
           static_cast<double*>(table), static_cast<double*>(acc),
           static_cast<int32_t*>(last), static_cast<int>(n), w,
           static_cast<int>(d), static_cast<int>(T), eta, c,
           static_cast<double>(n), delta, vr, loss, hbits, threads};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(smem);
  if (hbits) return launch_entries<kFull, false>(p, entries, sm, st);
  switch (stop) {
    case kPasses: return launch_entries<kPasses, true>(p, entries, sm, st);
    case kCopy: return launch_entries<kCopy, true>(p, entries, sm, st);
    case kLoad: return launch_entries<kLoad, true>(p, entries, sm, st);
    case kCatchUp: return launch_entries<kCatchUp, true>(p, entries, sm, st);
    case kReduce: return launch_entries<kReduce, true>(p, entries, sm, st);
    case kFull: return launch_entries<kFull, true>(p, entries, sm, st);
    default: return kErrPlan;
  }
}

// out: (2 * threads,) float64
int lazy_epoch_floor(void* out, int threads, int64_t T, void* stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 || T < 0)
    return kErrPlan;
  lazy_epoch_floor_kernel<<<1, threads, 0, static_cast<cudaStream_t>(
      stream)>>>(static_cast<double*>(out), T);
  return static_cast<int>(cudaGetLastError());
}

const char* lazy_epoch_error_string(int code) {
  if (code == kErrPlan) return "launch plan out of range";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
