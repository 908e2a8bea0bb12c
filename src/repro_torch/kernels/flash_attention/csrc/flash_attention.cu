// Causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_kernel in
// src/repro/kernels/flash_attention/kernel.py (launched by
// flash_attention's pallas_call). q: (B, S, H, hd), k and v: (B, S, KV, hd),
// bfloat16 or float32, in the model's own layout (no transposes); out like
// q; hd 32, 64, 128 or 256. Query head h reads kv head h / (H / KV). Per
// query row, over the visible keys (k_pos <= q_pos and, with a window
// w > 0, k_pos > q_pos - w):
//
//   s = (q . k) * scale            scale = 1/sqrt(hd), float32 accumulation
//   online softmax: m' = max(m, max s); p = exp(s - m'); c = exp(m - m')
//   l' = l*c + sum p;  acc' = acc*c + T(p) . v   (float32 accumulation)
//   out = acc / max(l, 1e-30)       cast to the input type T
//
// p is rounded to the input type before P.V (bf16, or float32 as it is),
// as the reference casts p to v's dtype; l sums the float32 p. Masked
// scores are -1e30 and the running max starts at -1e30, as in the TPU
// kernel; key blocks wholly in the future or wholly before the window are
// skipped, which changes no value. The blocks of query rows and keys are
// the table in launch_hd below; ref.py's plain version chunks by the same
// table.
//
// What bounds it: at the Qwen2-7B-width train shape (S = 1024, H = 28,
// KV = 4, hd = 128) the causal half of the score and value products is
// 2 * 2 * S^2/2 * hd * H = 7.5 GFLOP, 7.6 us at 989 TFLOP/s of dense bf16,
// against 5.0 us for its 16.8 MB: operations bound it, on the tensor cores,
// and beside them the 14.7 M exponentials (about 3.8 us on the SFUs).
//
// bfloat16, the design (flash_fwd_bf16): one block of three warpgroups per
// (b*h, BQ query rows), the q-tiles launched longest first (under
// causality the last rows see the most keys).
//  * Warpgroup 0 is the producer: setmaxnreg lowers it to 40 registers and
//    one thread issues TMA. It loads the Q tile once and streams K and V
//    in 64-key blocks through a 3-stage ring, a full and an empty mbarrier
//    per stage. The tensor maps are 4-D over (hd, heads, S, B), the
//    model's layout; rows past S come in as zeros, so no tile reads the
//    next batch row's keys. A box row is 128 bytes (64 bf16) under the
//    128-byte swizzle, so an hd-128 tile is two boxes; hd 32 takes the
//    64-byte swizzle.
//  * Warpgroups 1 and 2 consume, 64 query rows each. S = Q K^T is wgmma
//    m64n64k16 with both operands K-major in shared memory, into
//    registers. The online softmax runs on that fragment: a row lies in
//    one quad of threads, so a row max is two shuffles; the mask is
//    applied only to blocks on the diagonal or at the window's edge;
//    scale * log2(e) is folded into one fmaf before ex2. P is rounded to
//    bf16 in registers, where the S fragment already has the layout of
//    wgmma's register A operand, and O += P V is wgmma m64nNk16 with V
//    through the transposed (MN-major) descriptor. O stays in registers as
//    float32 and is rescaled there.
//  * The next block's S product is issued before this block's P V, and
//    its softmax runs while P V is in flight; a stage is released when
//    both consumers' P V of it is done. Consumer 0 stops at its own
//    diagonal, one key block before consumer 1.
//  * The epilogue divides by l, rounds to bf16 into the warpgroup's Q rows
//    (swizzled as TMA expects) and stores them with TMA, which writes no
//    row at or past S.
// Registers set the blocks. A consumer keeps O, the next block's S and
// this block's P live at once. With 128-key blocks at hd 128, or with O's
// 128 registers at hd 256, ptxas spilled and serialized the wgmmas
// ("insufficient register resources"), whether setmaxnreg raised the
// consumers to 232 registers or left them at the 168 of the 384-thread
// launch bound; they now stay at 168. So keys come in blocks of 64 (O 64,
// S 32, P 16 registers at hd 128). At hd 256, where O alone would be 128
// registers, a block is 64 query rows that both consumers share: each
// computes the block's S and softmax and holds half of O's columns.
// Shared memory: 33,872 (hd 32), 66,640 (hd 64), 132,176 (hd 128) and
// 230,480 bytes (hd 256). An mbarrier wait that lasts 10 s traps, so a
// lost transfer ends the launch with an error instead of hanging the card.
//
// float32 (flash_fwd_f32) keeps the simple loop of the first port: one
// block of 4 warps per (b*h, 64 query rows), a loop over 64-key blocks
// (32 at hd 256), both products as register tiles of explicit fmaf in full
// float32. It does not use the tensor cores: TF32 would round the
// operands to 10 bits where the plain version keeps 24, and at the Qwen2
// shape it ties SDPA's float32 time. The score strip, the statistics and
// the output accumulator live in shared memory; the key rows sit one
// float apart there, against bank conflicts.

#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked up
                    // through the runtime, so nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: scalar fmaf products
// ---------------------------------------------------------------------------

constexpr int kF32Rows = 64;          // query rows per block (16 per warp)
constexpr int kF32Threads = 128;

// Shared-memory plan of one block: Q (kF32Rows x HD), K (BK x KS), V
// (BK x HD), the score strip (kF32Rows x BK; P overwrites it), the output
// accumulator O (kF32Rows x HD) and the softmax statistics.
template <int HD, int BK>
struct F32Plan {
  static constexpr int KS = HD + 1;   // row stride of K
  static constexpr size_t bytes =
      sizeof(float) * (kF32Rows * HD + BK * KS + BK * HD + kF32Rows * BK +
                       kF32Rows * HD + 3 * kF32Rows);
};

// rows [0, rows) of a (S, ld) strided tile starting at row r0 into shared
// memory with row stride ss, zero past S, 16 bytes a thread
template <int HD>
__device__ __forceinline__ void load_rows_f32(float* dst, int ss,
                                              const float* src, int64_t ld,
                                              int r0, int rows, int S,
                                              int tid) {
  constexpr int kChunks = HD / 4;
  for (int c = tid; c < rows * kChunks; c += kF32Threads) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      val = *reinterpret_cast<const float4*>(src + (r0 + r) * ld + col);
    if (ss % 4 == 0) {
      *reinterpret_cast<float4*>(dst + r * ss + col) = val;
    } else {
      dst[r * ss + col] = val.x;
      dst[r * ss + col + 1] = val.y;
      dst[r * ss + col + 2] = val.z;
      dst[r * ss + col + 3] = val.w;
    }
  }
}

template <int HD, int BK>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int S,
              int H, int KV, float scale, int window) {
  constexpr int KS = F32Plan<HD, BK>::KS;
  constexpr int kKeysPerLane = BK / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);    // kF32Rows x HD
  float* sK = sQ + kF32Rows * HD;                // BK x KS
  float* sV = sK + BK * KS;                      // BK x HD
  float* sS = sV + BK * HD;                      // kF32Rows x BK: S, then P
  float* sO = sS + kF32Rows * BK;                // kF32Rows x HD
  float* sM = sO + kF32Rows * HD;                // running max
  float* sL = sM + kF32Rows;                     // running sum
  float* sC = sL + kF32Rows;                     // this block's correction

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * kF32Rows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t q_row = static_cast<int64_t>(H) * HD;    // stride of s in q
  const int64_t kv_row = static_cast<int64_t>(KV) * HD;  // stride of s in k
  const float* qb = q + static_cast<int64_t>(b) * S * q_row + h * HD;
  const float* kb = k + static_cast<int64_t>(b) * S * kv_row + kvh * HD;
  const float* vb = v + static_cast<int64_t>(b) * S * kv_row + kvh * HD;
  float* ob = out + static_cast<int64_t>(b) * S * q_row + h * HD;

  load_rows_f32<HD>(sQ, HD, qb, q_row, q0, kF32Rows, S, tid);
  for (int i = tid; i < kF32Rows * HD; i += kF32Threads) sO[i] = 0.f;
  for (int i = tid; i < kF32Rows; i += kF32Threads) {
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }

  // keys [kv_begin, kv_end): up to the last valid query row (causal), and
  // from the block holding the first key any row of this block can see
  const int kv_end = min(q0 + kF32Rows, S);
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0)
    kv_begin = ((q0 - window + 1) / BK) * BK;
  __syncthreads();

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    load_rows_f32<HD>(sK, KS, kb, kv_row, k0, BK, S, tid);
    load_rows_f32<HD>(sV, HD, vb, kv_row, k0, BK, S, tid);
    __syncthreads();

    // scores of the warp's 16 rows against the BK keys: Q K^T
#pragma unroll
    for (int r0 = 0; r0 < 16; r0 += 4) {
      float acc[4][kKeysPerLane] = {};
      const float* qr = sQ + (warp * 16 + r0) * HD;
      const float* kr = sK + lane * KS;
      for (int d = 0; d < HD; ++d) {
        float qv[4], kv[kKeysPerLane];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) qv[rr] = qr[rr * HD + d];
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) kv[j] = kr[32 * j * KS + d];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int j = 0; j < kKeysPerLane; ++j)
            acc[rr][j] = fmaf(qv[rr], kv[j], acc[rr][j]);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j)
          sS[(warp * 16 + r0 + rr) * BK + lane + 32 * j] = acc[rr][j];
    }
    __syncwarp();

    // online softmax, one row at a time, BK / 32 keys per lane
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const int qp = q0 + row;
      float* srow = sS + row * BK;
      float s[kKeysPerLane];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        const int kp = k0 + lane + 32 * j;
        const bool ok = kp <= qp && (window <= 0 || kp > qp - window);
        s[j] = ok ? srow[lane + 32 * j] * scale : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, mx);
      float p[kKeysPerLane];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        p[j] = expf(s[j] - m_new);
        sum += p[j];
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();         // P overwrites this row's scores
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) srow[lane + 32 * j] = p[j];
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sM[row] = m_new;
        sL[row] = sL[row] * corr + sum;
        sC[row] = corr;
      }
      __syncwarp();
    }

    // acc = acc * c + P V on the warp's rows
    for (int i = lane; i < 16 * HD; i += 32) {
      const int row = warp * 16 + i / HD;
      sO[row * HD + i % HD] *= sC[row];
    }
    __syncwarp();
    constexpr int kCols = HD / 32;
#pragma unroll
    for (int r0 = 0; r0 < 16; r0 += 4) {
      float acc[4][kCols];
      float* o_rows = sO + (warp * 16 + r0) * HD + lane;
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[rr][c] = o_rows[rr * HD + 32 * c];
      for (int kk = 0; kk < BK; ++kk) {
        float pv[4], vv[kCols];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
          pv[rr] = sS[(warp * 16 + r0 + rr) * BK + kk];
#pragma unroll
        for (int c = 0; c < kCols; ++c) vv[c] = sV[kk * HD + lane + 32 * c];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[rr][c] = fmaf(pv[rr], vv[c], acc[rr][c]);
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int c = 0; c < kCols; ++c) o_rows[rr * HD + 32 * c] = acc[rr][c];
    }
    __syncthreads();        // sK and sV are reloaded next
  }

  for (int i = lane; i < 16 * HD; i += 32) {
    const int row = warp * 16 + i / HD, col = i % HD;
    if (q0 + row < S)
      ob[(q0 + row) * q_row + col] =
          sO[row * HD + col] / fmaxf(sL[row], 1e-30f);
  }
}

template <int HD, int BQ, int BK>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int B, int S, int H, int KV, double scale, int window,
               void* stream) {
  static_assert(BQ == kF32Rows, "the float32 kernel's blocks are 64 rows");
  constexpr size_t smem = F32Plan<HD, BK>::bytes;
  static_assert(smem <= 232448, "tiles exceed a block's shared memory");
  // above 48 KB of dynamic shared memory only after an opt-in, once
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_fwd_f32<HD, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((S + kF32Rows - 1) / kF32Rows));
  flash_fwd_f32<HD, BK><<<grid, kF32Threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, KV,
      static_cast<float>(scale), window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Hopper building blocks: mbarrier, TMA, wgmma (PTX)
// ---------------------------------------------------------------------------

constexpr uint64_t kWaitLimitNs = 10000000000ull;   // 10 s, then trap

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait for the phase of the given parity to complete
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > kWaitLimitNs) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | mode << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// pin registers that an asynchronous wgmma reads or writes: the compiler
// neither moves their uses across this point nor reuses them before it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// D (64 x 64) (+)= A (64 x 16) . B (64 x 16)^T, both K-major in smem
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 32) += A (64 x 16, registers) . B (16 x 32, MN-major in smem)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64) += A (64 x 16, registers) . B (16 x 64, MN-major in smem)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128) += A (64 x 16, registers) . B (16 x 128, MN-major in smem)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  static_assert(N == 64, "no wgmma_ss for this N");
  wgmma_ss_n64(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128, "no wgmma_rs for this N");
  if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// ---------------------------------------------------------------------------
// bfloat16: TMA, wgmma, accumulators in registers
// ---------------------------------------------------------------------------

constexpr int kStages = 3;        // the K and V ring
constexpr int kThreads = 384;     // producer warpgroup + two consumers
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40;

// Shared-memory plan of a block of BQ query rows: the Q tile (later O),
// kStages stages of K and of V, the mbarriers. A tile is a sequence of TMA
// boxes of rows x kRowBytes, each row of a box one swizzle span; the base
// is aligned to 1024 bytes, the span of the 128-byte swizzle pattern.
// BQ 128: each consumer takes 64 of the rows and all HD columns of O. BQ
// 64 (kSplit, hd 256): both consumers take the same 64 rows, each computes
// their S and holds half of O's columns, so O is 64 registers a thread
// and not 128.
template <int HD, int BQ, int BK>
struct Tiles {
  static_assert(BQ == 128 || BQ == 64, "a consumer takes 64 rows");
  // consumer 0 of a 128-row block skips the diagonal's last 64 keys: the
  // producer's ring must not wait for their release
  static_assert(64 / BK <= kStages, "key block too small for the ring");
  static constexpr bool kSplit = BQ == 64;
  static constexpr int kOCols = kSplit ? HD / 2 : HD;   // a consumer's O
  static constexpr int kRowBytes = HD >= 64 ? 128 : 64;
  static constexpr int kBoxCols = kRowBytes / 2;      // bf16 columns
  static constexpr int kBoxes = HD / kBoxCols;        // boxes across a head
  static constexpr uint32_t kAtom = 8 * kRowBytes;    // 8 rows: wgmma's SBO
  static constexpr uint64_t kMode = kRowBytes == 128 ? 1 : 2;
  static constexpr int kQBytes = BQ * HD * 2;
  static constexpr int kKVBytes = BK * HD * 2;        // one stage of K or V
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  static constexpr size_t bytes = kBarOff + 8 * (1 + 3 * kStages) + 1024;
};

// Mask the scores of the thread's two rows (r_lo, r_lo + 8) in a block of
// keys from k0, then one step of the online softmax: the running max and
// sum of each row, the correction of what came before, and p in place of
// the scores. Fragment layout (wgmma's accumulator): element 4j + 2i + e
// is row r_lo + 8i, key k0 + 8j + 2(lane % 4) + e.
template <int BK>
__device__ __forceinline__ void softmax_step(float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], bool mask,
                                             int k0, int r_lo, int lane,
                                             int window, float scale_log2) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r_lo + 8 * (e >> 1);
        const int key = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
        if (key > row || (window > 0 && key <= row - window))
          sc[4 * j + e] = kNegInf;
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    // a row that has seen only masked keys keeps p = 0 (its terms are
    // wiped by a zero correction once a visible key comes)
    const float mc = m_new == kNegInf ? 0.f : m_new * scale_log2;
    corr[i] = ex2(fmaf(m[i], scale_log2, -mc));
    m[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& s = sc[4 * j + 2 * i + e];
        s = ex2(fmaf(s, scale_log2, -mc));
        sum += s;
      }
    l[i] = l[i] * corr[i] + sum;
  }
}

// P (the fragment, rounded to bf16) as wgmma's register A operand: the
// 16 keys of step t are n8-blocks 2t and 2t + 1 of the fragment
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4],
                                       const float (&sc)[BK / 2]) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[t][r] = pack_bf16(sc[8 * t + 2 * r], sc[8 * t + 2 * r + 1]);
}

// S = Q K^T of one key block into the fragment sc, issued and committed,
// not waited for: A is the warpgroup's 64 rows of Q, B the key block, both
// K-major in shared memory; a k16 step advances the start address by 32
// bytes within a swizzled row, or moves to the next box
template <class P, int BK>
__device__ __forceinline__ void issue_qk_block(float (&sc)[BK / 2],
                                               uint32_t q_base,
                                               uint32_t k_base) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < P::kBoxes * P::kBoxCols / 16; ++kk) {
    const int box = kk * 16 / P::kBoxCols;
    const int col = kk * 16 % P::kBoxCols;
    wgmma_ss<BK>(sc,
                 smem_desc(q_base + box * 64 * P::kRowBytes + col * 2, 16,
                           P::kAtom, P::kMode),
                 smem_desc(k_base + box * BK * P::kRowBytes + col * 2, 16,
                           P::kAtom, P::kMode),
                 kk > 0);
  }
  wgmma_commit();
}

// O += P V of one key block, issued and committed, not waited for: A is P
// in registers, B the value block's kOCols columns from v_base through the
// transposed (MN-major) descriptor: LBO steps across boxes, SBO across 8
// keys
template <class P, int BK>
__device__ __forceinline__ void issue_pv_block(
    float (&o)[P::kOCols / 2], const uint32_t (&pa)[BK / 16][4],
    uint32_t v_base) {
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < BK / 16; ++kt)
    wgmma_rs<P::kOCols>(o, pa[kt],
                        smem_desc(v_base + kt * 16 * P::kRowBytes,
                                  BK * P::kRowBytes, P::kAtom, P::kMode));
  wgmma_commit();
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_o, int S, int H,
               int KV, float scale_log2, int window) {
  using P = Tiles<HD, BQ, BK>;
  constexpr int kOCols = P::kOCols;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + P::kKOff, sV = sQ + P::kVOff;
  const uint32_t q_full = sQ + P::kBarOff;
  const uint32_t k_full = q_full + 8;                 // + 8 s: stage s
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t kv_empty = v_full + 8 * kStages;

  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest tiles first
  const int kv_end = min(q0 + BQ, S);
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0)
    kv_begin = ((q0 - window + 1) / BK) * BK;
  const int n_blocks = (kv_end - kv_begin + BK - 1) / BK;
  // the warpgroup, through a shuffle so the compiler knows that it is
  // uniform across each warp
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kProducerRegs));
    if (t == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      prefetch_map(&tm_o);
      mbar_expect_tx(q_full, P::kQBytes);
      for (int g = 0; g < BQ / 64; ++g)
        for (int c = 0; c < P::kBoxes; ++c)
          tma_load(sQ + (g * P::kBoxes + c) * 64 * P::kRowBytes, &tm_q,
                   q_full, c * P::kBoxCols, h, q0 + 64 * g, b);
      for (int i = 0; i < n_blocks; ++i) {
        const int s = i % kStages;
        const int k0 = kv_begin + i * BK;
        // a fresh barrier counts as released in the phase before the first
        mbar_wait(kv_empty + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * s, P::kKVBytes);
        for (int c = 0; c < P::kBoxes; ++c)
          tma_load(sK + s * P::kKVBytes + c * BK * P::kRowBytes, &tm_k,
                   k_full + 8 * s, c * P::kBoxCols, kvh, k0, b);
        mbar_expect_tx(v_full + 8 * s, P::kKVBytes);
        for (int c = 0; c < P::kBoxes; ++c)
          tma_load(sV + s * P::kKVBytes + c * BK * P::kRowBytes, &tm_v,
                   v_full + 8 * s, c * P::kBoxCols, kvh, k0, b);
      }
    }
  } else {
    // consumers: 64 query rows each
    const int cg = wg - 1, warp = t / 32, lane = t % 32;
    const int row0 = P::kSplit ? q0 : q0 + 64 * cg;   // the warpgroup's rows
    const int r_lo = row0 + 16 * warp + lane / 4;   // the thread's rows
    const uint32_t q_base = sQ + (row0 - q0) * HD * 2;
    // the first box of the consumer's columns of O (and of V)
    const int box0 = P::kSplit ? cg * kOCols / P::kBoxCols : 0;
    const uint32_t v_cols = box0 * BK * P::kRowBytes;
    // the key blocks up to the warpgroup's last row: consumer 0 of a
    // 128-row block stops 64 keys short of the diagonal, which lie in its
    // future
    const int n_mine =
        min(n_blocks, (min(row0 + 64, S) - 1 - kv_begin) / BK + 1);
    float o[kOCols / 2];
#pragma unroll
    for (int i = 0; i < kOCols / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
    float sc[BK / 2];
    uint32_t pa[BK / 16][4];

    // the warpgroup's rows need the mask in a block on the diagonal or at
    // the window's edge
    auto needs_mask = [&](int k0) {
      return k0 + BK - 1 > row0 ||
             (window > 0 && k0 <= row0 + 63 - window);
    };

    // block 0's S and softmax, then per block: the next block's S is
    // issued before this block's P V, and its softmax runs while P V is in
    // flight; a stage is released when this consumer's P V of it is done
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    issue_qk_block<P, BK>(sc, q_base, sK);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_step<BK>(sc, m, l, corr, needs_mask(kv_begin), kv_begin, r_lo,
                     lane, window, scale_log2);
    pack_p<BK>(pa, sc);
    for (int i = 0; i + 1 < n_mine; ++i) {
      const int s = i % kStages, s1 = (i + 1) % kStages;
      mbar_wait(k_full + 8 * s1, ((i + 1) / kStages) & 1);
      mbar_wait(v_full + 8 * s, (i / kStages) & 1);
      issue_qk_block<P, BK>(sc, q_base, sK + s1 * P::kKVBytes);
      issue_pv_block<P, BK>(o, pa, sV + s * P::kKVBytes + v_cols);
      wgmma_wait<1>();
      fence_regs(sc);
      const int k0 = kv_begin + (i + 1) * BK;
      softmax_step<BK>(sc, m, l, corr, needs_mask(k0), k0, r_lo, lane,
                       window, scale_log2);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty + 8 * s);
#pragma unroll
      for (int j = 0; j < kOCols / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
      pack_p<BK>(pa, sc);
    }
    const int s = (n_mine - 1) % kStages;
    mbar_wait(v_full + 8 * s, ((n_mine - 1) / kStages) & 1);
    issue_pv_block<P, BK>(o, pa, sV + s * P::kKVBytes + v_cols);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(kv_empty + 8 * s);

    // out = O / l in bf16, into the warpgroup's Q rows as TMA lays a box
    // out (16-byte chunk c of row r at chunk c ^ (r % 8), or c ^ (r / 2 % 4)
    // under the 64-byte swizzle), then one TMA store per box of its
    // columns. Consumers that share rows first wait until both are done
    // with Q.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      l[i] = fmaxf(l[i], 1e-30f);
    }
    if constexpr (P::kSplit) asm volatile("bar.sync 1, 256;\n" ::: "memory");
    unsigned char* out_tile = smem + (row0 - q0) * HD * 2;
#pragma unroll
    for (int j = 0; j < kOCols / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = 16 * warp + lane / 4 + 8 * i;
        const int box = box0 + 8 * j / P::kBoxCols;
        const int chunk = j % (P::kBoxCols / 8);
        const int swz = P::kRowBytes == 128 ? chunk ^ (row % 8)
                                            : chunk ^ (row / 2 % 4);
        *reinterpret_cast<uint32_t*>(
            out_tile + box * 64 * P::kRowBytes + row * P::kRowBytes +
            swz * 16 + 4 * (lane % 4)) =
            pack_bf16(o[4 * j + 2 * i] / l[i], o[4 * j + 2 * i + 1] / l[i]);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(2 + cg) : "memory");
    if (t == 0) {
      for (int c = box0; c < box0 + kOCols / P::kBoxCols; ++c)
        tma_store(&tm_o, q_base + c * 64 * P::kRowBytes, c * P::kBoxCols, h,
                  row0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// cuTensorMapEncodeTiled, looked up once through the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 (B, S, heads, hd) tensor as a 4-D map over (hd, heads, S, B),
// innermost first; a box is `rows` rows of one head, `cols` columns wide.
// Reads past S fill zeros; stores past S are dropped.
bool make_map(CUtensorMap* map, const void* base, int hd, int heads, int S,
              int B, int cols, int rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kErrHeadSize = -1;
constexpr int kErrTensorMap = -2;

template <int HD, int BQ, int BK>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int S, int H, int KV, double scale, int window,
                void* stream) {
  using P = Tiles<HD, BQ, BK>;
  static_assert(P::bytes <= 232448, "tiles exceed a block's shared memory");
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_fwd_bf16<HD, BQ, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(P::bytes));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const CUtensorMapSwizzle swizzle = P::kRowBytes == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!make_map(&tm_q, q, HD, H, S, B, P::kBoxCols, 64, swizzle) ||
      !make_map(&tm_k, k, HD, KV, S, B, P::kBoxCols, BK, swizzle) ||
      !make_map(&tm_v, v, HD, KV, S, B, P::kBoxCols, BK, swizzle) ||
      !make_map(&tm_o, out, HD, H, S, B, P::kBoxCols, 64, swizzle))
    return kErrTensorMap;
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((S + BQ - 1) / BQ));
  flash_fwd_bf16<HD, BQ, BK><<<grid, kThreads, P::bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, tm_o, S, H, KV,
      static_cast<float>(scale * 1.4426950408889634), window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int S, int H, int KV, int hd, double scale, int window,
              void* stream);

// The block table: per dtype and head size, the (query rows, key rows) of
// a block, the template's last two arguments. ref.py's BLOCKS repeats it,
// and a test holds the two together.
template <>
int launch_hd<bf16>(const void* q, const void* k, const void* v, void* out,
                    int B, int S, int H, int KV, int hd, double scale,
                    int window, void* stream) {
  switch (hd) {
    case 32: return launch_bf16<32, 128, 64>(q, k, v, out, B, S, H, KV,
                                             scale, window, stream);
    case 64: return launch_bf16<64, 128, 64>(q, k, v, out, B, S, H, KV,
                                             scale, window, stream);
    case 128: return launch_bf16<128, 128, 64>(q, k, v, out, B, S, H, KV,
                                               scale, window, stream);
    case 256: return launch_bf16<256, 64, 64>(q, k, v, out, B, S, H, KV,
                                              scale, window, stream);
    default: return kErrHeadSize;
  }
}

template <>
int launch_hd<float>(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int H, int KV, int hd, double scale,
                     int window, void* stream) {
  switch (hd) {
    case 32: return launch_f32<32, 64, 64>(q, k, v, out, B, S, H, KV, scale,
                                           window, stream);
    case 64: return launch_f32<64, 64, 64>(q, k, v, out, B, S, H, KV, scale,
                                           window, stream);
    case 128: return launch_f32<128, 64, 64>(q, k, v, out, B, S, H, KV,
                                             scale, window, stream);
    case 256: return launch_f32<256, 64, 32>(q, k, v, out, B, S, H, KV,
                                             scale, window, stream);
    default: return kErrHeadSize;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes: returns the cudaError_t of the
// launch (0 on success), or a negative code of this file's own.
// dtype: 0 bfloat16, 1 float32.
extern "C" {

int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int H, int KV, int hd,
                           double scale, int window, int dtype,
                           void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (dtype == 1)
    return launch_hd<float>(q, k, v, out, B, S, H, KV, hd, scale, window,
                            stream);
  return launch_hd<bf16>(q, k, v, out, B, S, H, KV, hd, scale, window,
                         stream);
}

const char* flash_attention_error_string(int code) {
  switch (code) {
    case kErrHeadSize: return "head size not compiled (32, 64, 128 or 256)";
    case kErrTensorMap: return "TMA tensor map encoding failed";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
