// Mamba2 SSD chunk scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _ssd_kernel in
// src/repro/kernels/ssd_scan/kernel.py (launched by ssd_scan's
// pallas_call). For every row (batch row b, head h) and every column p of
// the head's P, over the sequence in chunks of Q steps, with the state h
// (P x N, float32) carried in order from zero:
//
//   L = cumsum(la)                                   la: log-decay (< 0)
//   y = tril((C B^T) * exp(min(L_i - L_j, 0))) x  +  exp(L) * (C h^T)
//   h = exp(L_Q) h + x^T (B * exp(L_Q - L))
//
// B and C (S x N) are shared by the H heads of a batch row. Everything is
// float32. la and x are read through strides, so the kernel takes them in
// the model's layout (la (B, S, H), x (B, S, H, P)) as well as in the flat
// one (la (B*H, S), x (B*H, S, P)); y is written in x's layout. Rows past S
// are zero-filled in shared memory (zero log-decay, zero input: the padded
// scan of the reference) and never stored, so nothing is padded in memory.
//
// What bounds it: per (b, chunk) the scores C B^T (Q*Q*N), and per (b,
// chunk, head) w x (Q*Q*P, causal half), C h^T (Q*N*P) and the state
// contribution x^T (B * d) (P*Q*N): 8.90 GFLOP at Mamba2-130M's training
// shape (B 4, S 2048, H 24, P 64, N 128, Q 64), 18.0 us at 495 TFLOP/s of
// TF32, against 32.8 us for its 109.8 MB (la, x, B, C read once, y written
// once) at 3.35 TB/s: bytes bound it. 3xTF32 issues every product three
// times, so its own floor is 3 * 18.0 = 53.9 us.
//
// The design, in three parts:
//
// 1. Chunks in parallel. A block's unit is (chunk c, batch row b, a group
//    of heads, 64 columns of P); the group shares the chunk's scores
//    C B^T, computed once per block into shared memory (once per (b, c)
//    when the group holds all heads; kernel.py's launch_plan splits H
//    into groups of at most 6, 512 blocks at Mamba2-130M's shape, so the
//    grid fills the card several times over). Per head, the block computes
//    L, the chunk's own state contribution cs = x^T (B * exp(L_Q - L)), the
//    dual form w x with w = the scores under the head's decay and causal
//    mask, and the inter-chunk term exp(L) (C h_in^T). One block of 8
//    warps fills an SM (228,608 bytes of shared memory at Q 64, N 128, and
//    237 registers a thread).
//
// 2. The state passed between chunks, in this one launch, by chunk-ordered
//    look-back: h_in(c+1) = exp(L_Q) h_in(c) + cs_c. A block takes an
//    atomic ticket when it starts, and tickets map to units chunk-major,
//    so the block that computes chunk c waits only on the block of chunk
//    c-1 (same b, head, columns), which took an earlier ticket and is
//    therefore running or done: no block waits on one that has not
//    started. Per head, the block computes cs, waits (one thread, an
//    acquire load of the predecessor's flag, then a barrier), reads h_in(c)
//    from L2, publishes h_in(c+1) and its flag (a barrier, then one
//    thread's release store, cumulative over the stores the barrier
//    ordered before it), and only then computes its y,
//    so the chain between chunks carries one state read and one write per
//    head, not the products. The wrapper zeroes the ticket and the flags
//    in every call (a memset that a CUDA graph captures and replays). The
//    states take turns in two slots of a scratch buffer the wrapper
//    allocates, 2 * B * H * P * N floats (6.3 MB at Mamba2-130M's shape,
//    so they stay in L2): chunk c writes slot c % 2 only after chunk c - 1
//    has published, which it does only after its own read of that slot
//    is consumed. A wait that lasts 10 s traps, so a lost flag ends the
//    launch with an error instead of hanging the card.
//
// 3. Products on the tensor cores in 3xTF32: mma.sync m16n8k8 .tf32 with
//    float32 accumulators. Each operand a is split into a_hi =
//    cvt.rna.tf32(a) and a_lo = cvt.rna.tf32(a - a_hi), and each product
//    accumulates a_hi b_lo + a_lo b_hi + a_hi b_hi, the small terms first.
//    One pass of TF32 keeps 10 bits of mantissa, about 5e-4 relative per
//    operand, which the 1e-4 tolerance against the float32 plain version
//    does not allow; three passes leave about 2^-21. mma.sync and not
//    wgmma: TF32 wgmma takes only K-major operands from shared memory (the
//    transpose bits exist for 16-bit types only), and three of the four
//    products contract an operand over its rows (w x over steps; x^T (B*d)
//    over steps on both sides; C h^T over N with h stored (P, N)).
//    mma.sync loads its fragments from shared memory element by element,
//    so a transposed read costs nothing, and the decay, the mask and B*d
//    are applied as the fragment is loaded: w is formed from the scores in
//    the A operand's own positions, and is split into hi and lo only after
//    the decay and the mask are applied. C, x and the state read from the
//    last chunk are split once, as they are staged, into separate hi and
//    lo arrays; B (scaled by the head's decay) and w are split where they
//    are loaded. A split is two integer operations (tf32_rna below); split
//    at every fragment load instead, a value is split again by every warp
//    that reads it, and the splits become most of the kernel's
//    instructions. Rows and the contraction are permuted inside each tile
//    (see "Fragment order" below) so that a fragment's two neighbouring
//    values come in one 8-byte load, straight into the registers mma.sync
//    wants: with hi and lo interleaved in pairs instead, ptxas spent about
//    six register moves on every mma to gather them. Row strides are
//    padded so that each fragment load is free of bank conflicts. Tiles
//    are zero-padded in shared memory to 16 steps and 8 state columns, so
//    chunks of 8 and states of 16 (the reduced config) run on the same
//    path. Each slice of 8 accumulates its three products in a fresh
//    accumulator that is added to the running sum in float32: a running
//    sum kept inside the tensor cores is truncated at every mma, which on
//    an H100 left up to 3.4e-4 of error on fast-decaying heads.
//
// Where the time goes (an instrumented copy with clock64 marks between the
// barriers, and copies with one part removed, on an H100): the
// tensor-core phases (cs, w x, C h^T) take under half of a head's time;
// the rest is the phases between barriers that one block of 8 warps per
// SM cannot overlap with them: staging, the scan, the wait for the last
// chunk, the state's round trip through L2 and the release of the flag.
// Shared memory allows no second block per SM.
//
// L is summed in double and rounded to float32 once, as the plain version
// does it, here as a warp scan. The decays exp(L_i - L_j) take differences
// of L, which for the fast-decaying heads reach magnitudes of ~1e3 within
// a chunk, where a float32 ulp is ~1e-4: a float32 running sum leaves L's
// rounding to the order of the additions, and that difference alone moved
// y by 1e-3 against the plain version's (parallel) cumsum. A double sum of
// at most 64 floats is exact far below a float32 ulp in any order, so both
// round to the same float32 L.
//
// -fmad=false (kernels/build.py) holds for this file too: every multiply
// and add rounds as the plain version's do.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;       // 8 warps
constexpr int kPT = 64;             // columns of P per block
constexpr int kMaxQ = 64;           // chunk lengths the warp tiles cover
constexpr int kMaxN = 128;          // state sizes the warp tiles cover
constexpr int kXLoads = kMaxQ * kPT / 4 / kThreads;  // float4s of x a thread
constexpr uint64_t kWaitLimitNs = 10000000000ull;

struct Strides {                    // element strides of la and x (and y)
  int64_t la_b, la_h, la_s, x_b, x_h, x_s;
};

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// the least row stride >= n that is r mod m
__host__ __device__ constexpr int stride_mod(int n, int r, int m) {
  return n + ((r - n % m) % m + m) % m;
}

// Row strides (floats), each chosen so that its fragment loads are free of
// bank conflicts: B and x rows are read by the lane's thread index t (8
// mod 32); the scores by twice its group index 2g (2 mod 16); C^T, read 8
// bytes a lane by rows 2t and columns 2g (4 mod 16); h, 8 bytes a lane by
// rows g and columns 2t (8 mod 32).
__host__ __device__ constexpr int ld_b(int Np) {
  return stride_mod(Np, 8, 32);
}
__host__ __device__ constexpr int ld_ct(int Qp) {
  return stride_mod(Qp, 4, 16);
}
__host__ __device__ constexpr int ld_s(int Qp) {
  return stride_mod(Qp, 2, 16);
}
__host__ __device__ constexpr int ld_x() { return stride_mod(kPT, 8, 32); }
__host__ __device__ constexpr int ld_h(int Np) {
  return stride_mod(Np, 8, 32);
}

// shared memory of a block, in floats, for Qp steps and Np state columns
// (both padded): B; C^T, x and the state read from the last chunk, each
// as hi and lo halves; the scores; L, exp(L), exp(L_Q - L)
__host__ __device__ constexpr int smem_floats(int Qp, int Np) {
  return Qp * ld_b(Np) + 2 * Np * ld_ct(Qp) + Qp * ld_s(Qp)
       + 2 * Qp * ld_x() + 2 * kPT * ld_h(Np) + 3 * Qp;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// wait until the flag is set; trap after kWaitLimitNs
__device__ __forceinline__ void wait_flag(const int* f) {
  if (load_acquire(f)) return;
  const uint64_t t0 = global_ns();
  while (!load_acquire(f)) {
    __nanosleep(64);
    if (global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

// cvt.rna.tf32.f32 for a finite a: the 19 high bits, rounded to nearest
// with ties away from zero (the bits are sign and magnitude, so adding half
// of the dropped unit rounds the magnitude). Two integer operations, where
// ptxas expands the PTX instruction with checks for infinities and NaN.
__device__ __forceinline__ uint32_t tf32_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, each rounded to TF32
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// two 32-bit values from one 8-byte shared-memory load
__device__ __forceinline__ void lds2(const float* p, uint32_t* r) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  r[0] = __float_as_uint(v.x);
  r[1] = __float_as_uint(v.y);
}

// hi and lo halves of four values, stored as float4s at hi and lo
__device__ __forceinline__ void store_split4(float* hi, float* lo, float4 v) {
  uint32_t h[4], l[4];
  split_tf32(v.x, h[0], l[0]);
  split_tf32(v.y, h[1], l[1]);
  split_tf32(v.z, h[2], l[2]);
  split_tf32(v.w, h[3], l[3]);
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's (16 MT) x (8 NT) tile of a product over ksteps slices of 8, in
// 3xTF32, KU slices unrolled. load_a(mi, k0, hi, lo) gives the A fragment
// of m-tile mi at depth k0, split (rows g, g+8 by columns t, t+4 of the
// slice; g = lane/4, t = lane%4); load_b(nj, k0, hi, lo) the B fragment
// (rows t, t+4 of the slice, column g of n-tile nj). acc is in the
// accumulator's layout: rows g (0, 1) and g+8 (2, 3), columns 2t and
// 2t+1. Each slice's three products go into a fresh accumulator that is
// then added to acc in float32 (round to nearest): the tensor cores align
// and truncate the addends of each mma to the largest, so a running sum
// kept in them loses about 2^-23 of its own size at every slice.
template <int KU = 2, int MT, int NT, class LoadA, class LoadB>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], int ksteps,
                                         LoadA load_a, LoadB load_b) {
#pragma unroll KU
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k0 = 8 * ks;
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) load_a(mi, k0, ah[mi], al[mi]);
#pragma unroll
    for (int nj = 0; nj < NT; ++nj) load_b(nj, k0, bh[nj], bl[nj]);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part, ah[mi], bl[nj]);
        mma_tf32(part, al[mi], bh[nj]);
        mma_tf32(part, ah[mi], bh[nj]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] += part[e];
      }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
}

// Fragment order. In every product the accumulator rows g (c0, c1) and
// g + 8 (c2, c3) of an m-tile stand for the tile's rows 2g and 2g + 1: the
// A fragment's a0 and a1 (rows g and g + 8) then lie side by side in
// memory wherever A is stored with its rows contiguous (x^T, C^T), and one
// 8-byte load gives both. Where B is stored
// with its contraction index contiguous (B rows for the scores, h for
// C h^T), the slice's index t (b0) stands for 2t and t + 4 (b1) for
// 2t + 1, so b0 and b1 come in one load too, and A follows the same
// order. Any order of rows, or of the contraction, leaves the product as
// it is.
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const float* __restrict__ la, const float* __restrict__ x,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ y, float* states, int* sync, int B,
                int S, int H, int P, int N, int Q, int hpb, Strides st) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int ticket;
  const int Qp = round_up(Q, 16), Np = round_up(N, 8);
  const int ldB = ld_b(Np), ldCT = ld_ct(Qp), ldS = ld_s(Qp);
  const int ldX = ld_x(), ldH = ld_h(Np);
  float* sB = smem;                 // Qp x ldB    B rows of the chunk
  float* sCh = sB + Qp * ldB;       // Np x ldCT   C^T, hi
  float* sCl = sCh + Np * ldCT;     // Np x ldCT   C^T, lo
  float* sS = sCl + Np * ldCT;      // Qp x ldS    scores C B^T
  float* sXh = sS + Qp * ldS;       // Qp x ldX    x of the head, hi
  float* sXl = sXh + Qp * ldX;      // Qp x ldX    x, lo
  float* sHh = sXl + Qp * ldX;      // kPT x ldH   the state read (P, N), hi
  float* sHl = sHh + kPT * ldH;     // kPT x ldH   the state, lo
  float* sL = sHl + kPT * ldH;      // Qp          L
  float* sE = sL + Qp;              // Qp          exp(L)
  float* sD = sE + Qp;              // Qp          exp(L_Q - L)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int nc = (S + Q - 1) / Q, G = (H + hpb - 1) / hpb;
  const int PT = (P + kPT - 1) / kPT;

  // the unit, by ticket, chunk-major
  if (tid == 0) ticket = atomicAdd(sync, 1);
  __syncthreads();
  int r = ticket;
  const int c = r / (B * G * PT);
  r %= B * G * PT;
  const int pt = r % PT;
  r /= PT;
  const int grp = r % G, b = r / G;
  const int c0 = c * Q, p0 = pt * kPT, Pc = min(kPT, P - p0);
  const int h_first = grp * hpb, h_last = min(H, h_first + hpb);
  int* flags = sync + 1;            // (nc - 1, B, H, PT)
  const int64_t state_size = static_cast<int64_t>(P) * N;
  const int64_t per_chunk = static_cast<int64_t>(B) * H;

  // x and la of a head into registers (16-byte loads, zero past S, past Q
  // and past the tile's columns), issued ahead of the work they wait for
  float4 rx[kXLoads];
  float rla0 = 0.f, rla1 = 0.f;     // la of steps lane, lane + 32 (warp 0)
  auto fetch = [&](int hh) {
    const float* xh = x + b * st.x_b + hh * st.x_h + p0;
#pragma unroll
    for (int k = 0; k < kXLoads; ++k) {
      const int i = tid + k * kThreads, s = i / (kPT / 4);
      const int p = 4 * (i % (kPT / 4));
      rx[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < Q && c0 + s < S && p < Pc)
        rx[k] = *reinterpret_cast<const float4*>(xh + (c0 + s) * st.x_s + p);
    }
    if (warp == 0) {
      const float* lah = la + b * st.la_b + hh * st.la_h;
      rla0 = lane < Q && c0 + lane < S ? lah[(c0 + lane) * st.la_s] : 0.f;
      rla1 = lane + 32 < Q && c0 + lane + 32 < S
                 ? lah[(c0 + lane + 32) * st.la_s] : 0.f;
    }
  };
  fetch(h_first);

  // stage B, and C^T split, zero past S, past Q and past N: every load is
  // issued before the first store; consecutive lanes take consecutive
  // steps, so the transposed stores do not collide
  {
    const float* Bb = Bm + (static_cast<int64_t>(b) * S + c0) * N;
    const float* Cb = Cm + (static_cast<int64_t>(b) * S + c0) * N;
    constexpr int kLoads = kMaxQ * kMaxN / 4 / kThreads;
    float4 vb[kLoads], vc[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = tid + k * kThreads, s = i % Qp, n = 4 * (i / Qp);
      vb[k] = vc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s < Q && c0 + s < S && n < N) {
        vb[k] = *reinterpret_cast<const float4*>(Bb + s * N + n);
        vc[k] = *reinterpret_cast<const float4*>(Cb + s * N + n);
      }
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = tid + k * kThreads, s = i % Qp, n = 4 * (i / Qp);
      if (n < Np) {
        *reinterpret_cast<float4*>(sB + s * ldB + n) = vb[k];
        const float cv[4] = {vc[k].x, vc[k].y, vc[k].z, vc[k].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t hi, lo;
          split_tf32(cv[e], hi, lo);
          sCh[(n + e) * ldCT + s] = __uint_as_float(hi);
          sCl[(n + e) * ldCT + s] = __uint_as_float(lo);
        }
      }
    }
    // the state's padding (rows past Pc, columns past N) stays zero
    for (int i = tid; i < 2 * kPT * ldH; i += kThreads) sHh[i] = 0.f;
  }
  __syncthreads();

  // A fragment of C from C^T: m-tile rows m0, the slice at n0 (rows 2t,
  // 2t + 1 of C^T), hi and lo
  auto load_c = [&](int m0, int n0, uint32_t* hi, uint32_t* lo) {
    const int o0 = (n0 + 2 * t) * ldCT + m0 + 2 * g, o1 = o0 + ldCT;
    lds2(sCh + o0, hi);
    lds2(sCh + o1, hi + 2);
    lds2(sCl + o0, lo);
    lds2(sCl + o1, lo + 2);
  };

  // scores C B^T once for the group: warp (mt, nh) holds rows 16 mt and
  // columns 32 nh of the (Qp x Qp) tile
  {
    const int mt = warp % 4, nh = warp / 4;
    if (16 * mt < Qp && 32 * nh < Qp) {
      float acc[1][4][4];
      zero(acc);
      warp_mma(acc, Np / 8,
               [&](int, int k0, uint32_t* hi, uint32_t* lo) {
                 load_c(16 * mt, k0, hi, lo);
               },
               [&](int nj, int k0, uint32_t* hi, uint32_t* lo) {
                 const float2 v = *reinterpret_cast<const float2*>(
                     sB + (32 * nh + 8 * nj + g) * ldB + k0 + 2 * t);
                 split_tf32(v.x, hi[0], lo[0]);
                 split_tf32(v.y, hi[1], lo[1]);
               });
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int j = 32 * nh + 8 * nj + 2 * t;
        if (j < Qp) {
          float* s0 = sS + (16 * mt + 2 * g) * ldS + j;
          *reinterpret_cast<float2*>(s0) =
              make_float2(acc[0][nj][0], acc[0][nj][1]);
          *reinterpret_cast<float2*>(s0 + ldS) =
              make_float2(acc[0][nj][2], acc[0][nj][3]);
        }
      }
    }
  }

  for (int hh = h_first; hh < h_last; ++hh) {
    // x of the head into shared memory split, and L beside it (the last
    // head is done with both)
#pragma unroll
    for (int k = 0; k < kXLoads; ++k) {
      const int i = tid + k * kThreads, s = i / (kPT / 4);
      const int p = 4 * (i % (kPT / 4));
      if (s < Qp) store_split4(sXh + s * ldX + p, sXl + s * ldX + p, rx[k]);
    }
    if (warp == 0) {
      // L = cumsum(la): a warp scan in double, rounded once; then exp(L)
      // and exp(L_Q - L)
      double v0 = rla0, v1 = rla1;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const double u0 = __shfl_up_sync(0xffffffffu, v0, off);
        const double u1 = __shfl_up_sync(0xffffffffu, v1, off);
        if (lane >= off) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      const float l0 = static_cast<float>(v0), l1 = static_cast<float>(v1);
      const float lq = __shfl_sync(0xffffffffu, Q - 1 < 32 ? l0 : l1,
                                   (Q - 1) % 32);
      if (lane < Qp) {
        sL[lane] = l0;
        sE[lane] = expf(l0);
        sD[lane] = lane < Q ? expf(lq - l0) : 0.f;
      }
      if (lane + 32 < Qp) {
        sL[lane + 32] = l1;
        sE[lane + 32] = expf(l1);
        sD[lane + 32] = lane + 32 < Q ? expf(lq - l1) : 0.f;
      }
    }
    __syncthreads();
    const int64_t row = (static_cast<int64_t>(b) * H + hh) * PT + pt;
    const int64_t slot = static_cast<int64_t>(b) * H + hh;
    // the states passed between chunks take turns in two slots: chunk c
    // writes slot c % 2 only after chunk c - 1 has published, which chunk
    // c - 1 does only after its loads of the slot (from chunk c - 2) are
    // consumed
    const float* prev = c > 0
        ? states + ((c - 1) % 2 * per_chunk + slot) * state_size : nullptr;
    float* next = c + 1 < nc
        ? states + (c % 2 * per_chunk + slot) * state_size : nullptr;
    const float e_tot = expf(sL[Q - 1]);

    // cs = x^T (B * exp(L_Q - L)), (P x N): warp (mp, nq) holds rows 32 mp
    // and columns 32 nq; then the state passed on, in cs's layout
    {
      const int mp = warp % 2, nq = warp / 2;
      const bool active = 32 * mp < Pc && 32 * nq < Np;
      float acc[2][4][4];
      zero(acc);
      // one slice at a time: unrolled by two, as the other products are,
      // this one took the kernel past 255 registers into spills
      if (active)
        warp_mma<1>(acc, Qp / 8,
                 [&](int mi, int k0, uint32_t* hi, uint32_t* lo) {
                   const int o0 = (k0 + t) * ldX + 32 * mp + 16 * mi + 2 * g;
                   lds2(sXh + o0, hi);
                   lds2(sXh + o0 + 4 * ldX, hi + 2);
                   lds2(sXl + o0, lo);
                   lds2(sXl + o0 + 4 * ldX, lo + 2);
                 },
                 [&](int nj, int k0, uint32_t* hi, uint32_t* lo) {
                   const float* br =
                       sB + (k0 + t) * ldB + 32 * nq + 8 * nj + g;
                   split_tf32(br[0] * sD[k0 + t], hi[0], lo[0]);
                   split_tf32(br[4 * ldB] * sD[k0 + t + 4], hi[1], lo[1]);
                 });
      if (prev) {                   // the state this chunk starts from
        if (tid == 0) wait_flag(flags + (c - 1) * per_chunk * PT + row);
        __syncthreads();
      }
      if (active) {
        // every load of the state before the first store; accumulator
        // rows g and g + 8 of m-tile mi are rows p and p + 1
        float2 hin[2][4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int p = 32 * mp + 16 * mi + 2 * g + half;
              const int n = 32 * nq + 8 * nj + 2 * t;
              hin[mi][nj][half] = make_float2(0.f, 0.f);
              if (prev && p < Pc && n < N)
                hin[mi][nj][half] = __ldcg(reinterpret_cast<const float2*>(
                    prev + static_cast<int64_t>(p0 + p) * N + n));
            }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int p = 32 * mp + 16 * mi + 2 * g + half;
              const int n = 32 * nq + 8 * nj + 2 * t;
              if (p < Pc && n < N) {
                const float2 h = hin[mi][nj][half];
                if (prev) {
                  uint32_t h0, l0, h1, l1;
                  split_tf32(h.x, h0, l0);
                  split_tf32(h.y, h1, l1);
                  *reinterpret_cast<uint2*>(sHh + p * ldH + n) =
                      make_uint2(h0, h1);
                  *reinterpret_cast<uint2*>(sHl + p * ldH + n) =
                      make_uint2(l0, l1);
                }
                if (next)
                  *reinterpret_cast<float2*>(
                      next + static_cast<int64_t>(p0 + p) * N + n) =
                      make_float2(h.x * e_tot + acc[mi][nj][2 * half],
                                  h.y * e_tot + acc[mi][nj][2 * half + 1]);
              }
            }
      }
      // the barrier orders every thread's stores before one thread's
      // release store of the flag, which makes them visible with it
      __syncthreads();              // (sH is written, too)
      if (next && tid == 0) store_release(flags + c * per_chunk * PT + row, 1);
    }
    if (hh + 1 < h_last) fetch(hh + 1);   // in flight while y is computed

    // y = w x + exp(L) (C h_in^T), (Q x P): warp (mt, nh) holds rows 16 mt
    // and columns 32 nh; accumulator rows g and g + 8 are rows i0 and i1
    {
      const int mt = warp % 4, nh = warp / 4;
      if (16 * mt < Qp && 32 * nh < Pc) {
        const int i0 = 16 * mt + 2 * g, i1 = i0 + 1;
        const float L0 = sL[i0], L1 = sL[i1];
        float acc[1][4][4];
        zero(acc);
        // causal: steps past the tile's last row carry zero weight
        warp_mma(acc, min(Qp / 8, 2 * mt + 2),
                 [&](int, int k0, uint32_t* hi, uint32_t* lo) {
                   const int j0 = k0 + t, j1 = j0 + 4;
                   const float Lj0 = sL[j0], Lj1 = sL[j1];
                   const float* s0 = sS + i0 * ldS;
                   const float* s1 = s0 + ldS;
                   split_tf32(
                       j0 <= i0 ? s0[j0] * expf(fminf(L0 - Lj0, 0.f)) : 0.f,
                       hi[0], lo[0]);
                   split_tf32(
                       j0 <= i1 ? s1[j0] * expf(fminf(L1 - Lj0, 0.f)) : 0.f,
                       hi[1], lo[1]);
                   split_tf32(
                       j1 <= i0 ? s0[j1] * expf(fminf(L0 - Lj1, 0.f)) : 0.f,
                       hi[2], lo[2]);
                   split_tf32(
                       j1 <= i1 ? s1[j1] * expf(fminf(L1 - Lj1, 0.f)) : 0.f,
                       hi[3], lo[3]);
                 },
                 [&](int nj, int k0, uint32_t* hi, uint32_t* lo) {
                   const int o = (k0 + t) * ldX + 32 * nh + 8 * nj + g;
                   hi[0] = __float_as_uint(sXh[o]);
                   hi[1] = __float_as_uint(sXh[o + 4 * ldX]);
                   lo[0] = __float_as_uint(sXl[o]);
                   lo[1] = __float_as_uint(sXl[o + 4 * ldX]);
                 });
        float inter[1][4][4];
        zero(inter);
        if (c > 0)
          warp_mma(inter, Np / 8,
                   [&](int, int k0, uint32_t* hi, uint32_t* lo) {
                     load_c(16 * mt, k0, hi, lo);
                   },
                   [&](int nj, int k0, uint32_t* hi, uint32_t* lo) {
                     const int o = (32 * nh + 8 * nj + g) * ldH + k0 + 2 * t;
                     lds2(sHh + o, hi);
                     lds2(sHl + o, lo);
                   });
        float* yh = y + b * st.x_b + hh * st.x_h + p0;
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = half ? i1 : i0;
            const int p = 32 * nh + 8 * nj + 2 * t;
            if (i < Q && c0 + i < S && p < Pc) {
              const float e = sE[i];
              *reinterpret_cast<float2*>(yh + (c0 + i) * st.x_s + p) =
                  make_float2(acc[0][nj][2 * half]
                                  + e * inter[0][nj][2 * half],
                              acc[0][nj][2 * half + 1]
                                  + e * inter[0][nj][2 * half + 1]);
            }
          }
      }
    }
    __syncthreads();                // the next head overwrites x, L, sH
  }
}

constexpr int kMaxSmemBytes =
    smem_floats(kMaxQ, kMaxN) * static_cast<int>(sizeof(float));

}  // namespace

// Plain C interface, loaded with ctypes: returns the cudaError_t of the
// launch (0 on success), or -1 for a chunk or state size the warp tiles do
// not cover (Q <= 64, N <= 128), rows that 16-byte loads do not cover (N
// and P multiples of 4; la, x, B and C 16-byte aligned), or a head group
// below 1. sync is (1 + (S/Q - 1) * B * H * ceil(P/64)) zeroed ints (the
// ticket, then the flags); states holds min(S/Q - 1, 2) * B * H * P * N
// floats.
extern "C" {

int ssd_scan_launch(const void* la, const void* x, const void* Bm,
                    const void* Cm, void* y, void* states, void* sync, int B,
                    int S, int H, int P, int N, int Q, int hpb, int64_t la_b,
                    int64_t la_h, int64_t la_s, int64_t x_b, int64_t x_h,
                    int64_t x_s, void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || N % 4 || P % 4 || hpb < 1)
    return -1;
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0) return 0;
  // above 48 KB of dynamic shared memory only after an opt-in, once
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const Strides st{la_b, la_h, la_s, x_b, x_h, x_s};
  const int64_t blocks = static_cast<int64_t>((S + Q - 1) / Q) * B
                       * ((H + hpb - 1) / hpb) * ((P + kPT - 1) / kPT);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      smem_floats(round_up(Q, 16), round_up(N, 8)) * sizeof(float);
  ssd_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(la), static_cast<const float*>(x),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float*>(y), static_cast<float*>(states),
      static_cast<int*>(sync), B, S, H, P, N, Q, hpb, st);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_scan_error_string(int code) {
  if (code == -1)
    return "chunk above 64, state size above 128, N or P not a multiple "
           "of 4, or a head group below 1";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
