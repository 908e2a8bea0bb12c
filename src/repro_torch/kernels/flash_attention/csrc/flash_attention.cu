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
// as the reference casts p to v's dtype.
//
// Masked scores are -1e30 and the running max starts at -1e30, as in the
// TPU kernel, so the arithmetic is the same; blocks wholly in the future
// (or wholly before the window) are skipped, which changes no value.
//
// What bounds it: at the Qwen2-7B-width train shape (S = 1024, H = 28,
// KV = 4, hd = 128) the causal half of the score and value products is
// 2 * 2 * S^2/2 * hd * H = 7.5 GFLOP, 7.6 us at 989 TFLOP/s of dense bf16,
// against 5.0 us for its 16.8 MB; so operations bound it, on the tensor
// cores. The design is the simple FlashAttention-2 forward the port
// starts from, not a fast one: one block of 4 warps per (b*h, 64 query
// rows); a loop over 64-key blocks up to the causal limit (the TPU grid's
// sequential kv axis becomes this loop); both products on the tensor
// cores through WMMA 16x16x16 bf16 fragments with float32 accumulators;
// the score strip, the softmax statistics and the float32 output
// accumulator live in shared memory, where each warp rescales its own 16
// rows. wgmma, TMA and a register-resident accumulator are for a later
// PR. S needs no padding: rows and keys past S are zero-filled in shared
// memory, masked by causality, and never stored.
//
// float32 inputs take the same loop with both products as register tiles
// of explicit fmaf in full float32 (no tensor cores: TF32 would round the
// operands to 10 bits where the plain version keeps 24); the key rows sit
// one float apart in shared memory, against bank conflicts. At hd 256 the
// query rows no longer stay in registers (bf16) and the kv block shrinks
// to 32 keys (the template's BK), so the tiles fit in a block's 227 KB:
// 144,128 bytes in bf16, 205,696 in float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBQ = 64;           // query rows per block (16 per warp)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// Shared-memory plan of one block: T tiles Q (kBQ x HD), K (BK x KS), V
// (BK x HD) and, in bf16, P (kBQ x BK); float tiles S (kBQ x BK; in
// float32 P is S itself), the output accumulator O (kBQ x HD) and the
// softmax statistics.
template <typename T, int HD, int BK>
struct Plan {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int KS = kF32 ? HD + 1 : HD;   // row stride of K
  static constexpr size_t bytes =
      sizeof(T) * (kBQ * HD + BK * KS + BK * HD + (kF32 ? 0 : kBQ * BK))
      + sizeof(float) * (kBQ * BK + kBQ * HD + 3 * kBQ);
};

// rows [0, rows) of a (S, ld) strided tile starting at row r0 into shared
// memory with row stride ss, zero past S, 16 bytes a thread
template <typename T, int HD>
__device__ __forceinline__ void load_rows(T* dst, int ss, const T* src,
                                          int64_t ld, int r0, int rows,
                                          int S, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = tid; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * kVec;
    uint4 val = zero;
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ld + col);
    if (ss % kVec == 0) {
      *reinterpret_cast<uint4*>(dst + r * ss + col) = val;
    } else {
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int i = 0; i < kVec; ++i) dst[r * ss + col + i] = e[i];
    }
  }
}

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S,
                 int H, int KV, float scale, int window) {
  using P_ = Plan<T, HD, BK>;
  constexpr bool kF32 = P_::kF32;
  constexpr int KS = P_::KS;
  constexpr int kKeysPerLane = BK / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);            // kBQ x HD
  T* sK = sQ + kBQ * HD;                         // BK x KS
  T* sV = sK + BK * KS;                          // BK x HD
  T* sPt = sV + BK * HD;                         // kBQ x BK (bf16 only)
  float* sS = reinterpret_cast<float*>(sPt + (kF32 ? 0 : kBQ * BK));
  T* sP = kF32 ? reinterpret_cast<T*>(sS) : sPt;
  float* sO = sS + kBQ * BK;                     // kBQ x HD
  float* sM = sO + kBQ * HD;                     // running max
  float* sL = sM + kBQ;                          // running sum
  float* sC = sL + kBQ;                          // this block's correction

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t q_row = static_cast<int64_t>(H) * HD;    // stride of s in q
  const int64_t kv_row = static_cast<int64_t>(KV) * HD;  // stride of s in k
  const T* qb = q + static_cast<int64_t>(b) * S * q_row + h * HD;
  const T* kb = k + static_cast<int64_t>(b) * S * kv_row + kvh * HD;
  const T* vb = v + static_cast<int64_t>(b) * S * kv_row + kvh * HD;
  T* ob = out + static_cast<int64_t>(b) * S * q_row + h * HD;

  load_rows<T, HD>(sQ, HD, qb, q_row, q0, kBQ, S, tid);
  for (int i = tid; i < kBQ * HD; i += kThreads) sO[i] = 0.f;
  for (int i = tid; i < kBQ; i += kThreads) {
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }

  // keys [kv_begin, kv_end): up to the last valid query row (causal), and
  // from the block holding the first key any row of this block can see
  const int kv_end = min(q0 + kBQ, S);
  int kv_begin = 0;
  if (window > 0 && q0 - window + 1 > 0)
    kv_begin = ((q0 - window + 1) / BK) * BK;
  __syncthreads();

  // bf16: the warp's 16 query rows stay in registers as WMMA fragments,
  // up to hd 128; at hd 256 they are read from shared memory per use
  constexpr bool kQRegs = !kF32 && HD <= 128;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
      qf[kQRegs ? HD / 16 : 1];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wmma::load_matrix_sync(qf[kk],
                             reinterpret_cast<const bf16*>(sQ) +
                                 warp * 16 * HD + kk * 16, HD);
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    load_rows<T, HD>(sK, KS, kb, kv_row, k0, BK, S, tid);
    load_rows<T, HD>(sV, HD, vb, kv_row, k0, BK, S, tid);
    __syncthreads();

    // scores of the warp's 16 rows against the BK keys: Q K^T
    if constexpr (kF32) {
#pragma unroll
      for (int r0 = 0; r0 < 16; r0 += 4) {
        float acc[4][kKeysPerLane] = {};
        const float* qr = reinterpret_cast<const float*>(sQ) +
                          (warp * 16 + r0) * HD;
        const float* kr = reinterpret_cast<const float*>(sK) + lane * KS;
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
    } else {
      const bf16* sQb = reinterpret_cast<const bf16*>(sQ);
      const bf16* sKb = reinterpret_cast<const bf16*>(sK);
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
        wmma::fill_fragment(sf, 0.f);
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          // K^T as a column-major (HD x BK) matrix: element (d, key) sits
          // at sK[key * HD + d]
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              kf;
          wmma::load_matrix_sync(kf, sKb + n * 16 * HD + kk * 16, HD);
          if constexpr (kQRegs) {
            wmma::mma_sync(sf, qf[kk], kf, sf);
          } else {
            wmma::load_matrix_sync(qf[0], sQb + warp * 16 * HD + kk * 16, HD);
            wmma::mma_sync(sf, qf[0], kf, sf);
          }
        }
        wmma::store_matrix_sync(sS + warp * 16 * BK + n * 16, sf, BK,
                                wmma::mem_row_major);
      }
    }
    __syncwarp();

    // online softmax, one row at a time, BK / 32 keys per lane
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const int qp = q0 + row;
      const float* srow = sS + row * BK;
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
      __syncwarp();         // float32: P overwrites this row's scores
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j)
        sP[row * BK + lane + 32 * j] = from_f32<T>(p[j]);
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
    if constexpr (kF32) {
      constexpr int kCols = HD / 32;
      const float* pr = reinterpret_cast<const float*>(sP);
      const float* vr = reinterpret_cast<const float*>(sV);
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
            pv[rr] = pr[(warp * 16 + r0 + rr) * BK + kk];
#pragma unroll
          for (int c = 0; c < kCols; ++c) vv[c] = vr[kk * HD + lane + 32 * c];
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
    } else {
      const bf16* sPb = reinterpret_cast<const bf16*>(sP);
      const bf16* sVb = reinterpret_cast<const bf16*>(sV);
#pragma unroll
      for (int n = 0; n < HD / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
        float* o_tile = sO + warp * 16 * HD + n * 16;
        wmma::load_matrix_sync(of, o_tile, HD, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              pf;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              vf;
          wmma::load_matrix_sync(pf, sPb + warp * 16 * BK + kk * 16, BK);
          wmma::load_matrix_sync(vf, sVb + kk * 16 * HD + n * 16, HD);
          wmma::mma_sync(of, pf, vf, of);
        }
        wmma::store_matrix_sync(o_tile, of, HD, wmma::mem_row_major);
      }
    }
    __syncthreads();        // sK and sV are reloaded next
  }

  for (int i = lane; i < 16 * HD; i += 32) {
    const int row = warp * 16 + i / HD, col = i % HD;
    if (q0 + row < S)
      ob[(q0 + row) * q_row + col] =
          from_f32<T>(sO[row * HD + col] / fmaxf(sL[row], 1e-30f));
  }
}

template <typename T, int HD, int BK>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, double scale, int window, void* stream) {
  constexpr size_t smem = Plan<T, HD, BK>::bytes;
  static_assert(smem <= 232448, "tiles exceed a block's shared memory");
  // above 48 KB of dynamic shared memory only after an opt-in, once
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((S + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, HD, BK><<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, KV,
      static_cast<float>(scale), window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int S, int H, int KV, int hd, double scale, int window,
              void* stream) {
  switch (hd) {
    case 32: return launch<T, 32, 64>(q, k, v, out, B, S, H, KV, scale,
                                      window, stream);
    case 64: return launch<T, 64, 64>(q, k, v, out, B, S, H, KV, scale,
                                      window, stream);
    case 128: return launch<T, 128, 64>(q, k, v, out, B, S, H, KV, scale,
                                        window, stream);
    case 256: return launch<T, 256, 32>(q, k, v, out, B, S, H, KV, scale,
                                        window, stream);
    default: return -1;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes: returns the cudaError_t of the
// launch (0 on success), or -1 for a head size with no instantiation.
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
  if (code == -1) return "head size not compiled (32, 64, 128 or 256)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
