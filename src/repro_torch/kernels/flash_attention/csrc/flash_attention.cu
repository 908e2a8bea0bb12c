// Causal GQA flash attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_kernel in
// src/repro/kernels/flash_attention/kernel.py (launched by
// flash_attention's pallas_call). q: (B, S, H, hd), k and v: (B, S, KV, hd),
// bfloat16, in the model's own layout (no transposes); out like q. Query
// head h reads kv head h / (H / KV). Per query row, over the visible keys
// (k_pos <= q_pos and, with a window w > 0, k_pos > q_pos - w):
//
//   s = (q . k) * scale            scale = 1/sqrt(hd), float32 accumulation
//   online softmax: m' = max(m, max s); p = exp(s - m'); c = exp(m - m')
//   l' = l*c + sum p;  acc' = acc*c + bf16(p) . v   (float32 accumulation)
//   out = acc / max(l, 1e-30)       cast to bfloat16
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBQ = 64;           // query rows per block (16 per warp)
constexpr int kBK = 64;           // keys per kv block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (kBQ * HD + 2 * kBK * HD + kBQ * kBK)   // Q K V P
       + sizeof(float) * (kBQ * kBK + kBQ * HD + 3 * kBQ);      // S O m l c
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int S,
                 int H, int KV, float scale, int window) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);      // kBQ x HD
  bf16* sK = sQ + kBQ * HD;                      // kBK x HD
  bf16* sV = sK + kBK * HD;                      // kBK x HD
  bf16* sP = sV + kBK * HD;                      // kBQ x kBK
  float* sS = reinterpret_cast<float*>(sP + kBQ * kBK);  // kBQ x kBK
  float* sO = sS + kBQ * kBK;                    // kBQ x HD
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
  const bf16* qb = q + static_cast<int64_t>(b) * S * q_row + h * HD;
  const bf16* kb = k + static_cast<int64_t>(b) * S * kv_row + kvh * HD;
  const bf16* vb = v + static_cast<int64_t>(b) * S * kv_row + kvh * HD;
  bf16* ob = out + static_cast<int64_t>(b) * S * q_row + h * HD;

  constexpr int kChunks = HD / 8;                // 16-byte chunks per row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = tid; c < kBQ * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 val = zero;
    if (q0 + r < S)
      val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * q_row + col);
    *reinterpret_cast<uint4*>(sQ + r * HD + col) = val;
  }
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
    kv_begin = ((q0 - window + 1) / kBK) * kBK;
  __syncthreads();

  // the warp's 16 query rows stay in registers as WMMA fragments
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
      qf[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * HD + kk * 16, HD);

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      uint4 kval = zero, vval = zero;
      if (k0 + r < S) {
        kval = *reinterpret_cast<const uint4*>(kb + (k0 + r) * kv_row + col);
        vval = *reinterpret_cast<const uint4*>(vb + (k0 + r) * kv_row + col);
      }
      *reinterpret_cast<uint4*>(sK + r * HD + col) = kval;
      *reinterpret_cast<uint4*>(sV + r * HD + col) = vval;
    }
    __syncthreads();

    // scores of the warp's 16 rows against the 64 keys: Q K^T
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        // K^T as a column-major (HD x kBK) matrix: element (d, key) sits
        // at sK[key * HD + d]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + n * 16 * HD + kk * 16, HD);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(sS + warp * 16 * kBK + n * 16, sf, kBK,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time, two keys per lane
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const int qp = q0 + row;
      const float* srow = sS + row * kBK;
      float s[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + lane + 32 * j;
        const bool ok = kp <= qp && (window <= 0 || kp > qp - window);
        s[j] = ok ? srow[lane + 32 * j] * scale : kNegInf;
      }
      float mx = fmaxf(s[0], s[1]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[row];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      float sum = p0 + p1;
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sP[row * kBK + lane] = __float2bfloat16_rn(p0);
      sP[row * kBK + lane + 32] = __float2bfloat16_rn(p1);
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
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      float* o_tile = sO + warp * 16 * HD + n * 16;
      wmma::load_matrix_sync(of, o_tile, HD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, sP + warp * 16 * kBK + kk * 16, kBK);
        wmma::load_matrix_sync(vf, sV + kk * 16 * HD + n * 16, HD);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(o_tile, of, HD, wmma::mem_row_major);
    }
    __syncthreads();        // sK and sV are reloaded next
  }

  for (int i = lane; i < 16 * HD; i += 32) {
    const int row = warp * 16 + i / HD, col = i % HD;
    if (q0 + row < S)
      ob[(q0 + row) * q_row + col] =
          __float2bfloat16_rn(sO[row * HD + col] / fmaxf(sL[row], 1e-30f));
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int KV, double scale, int window, void* stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // above 48 KB of dynamic shared memory only after an opt-in, once
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((S + kBQ - 1) / kBQ));
  flash_fwd_kernel<HD><<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), S, H, KV,
      static_cast<float>(scale), window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes: returns the cudaError_t of the
// launch (0 on success), or -1 for a head size with no instantiation.
extern "C" {

int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int H, int KV, int hd,
                           double scale, int window, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  switch (hd) {
    case 32: return launch<32>(q, k, v, out, B, S, H, KV, scale, window,
                               stream);
    case 64: return launch<64>(q, k, v, out, B, S, H, KV, scale, window,
                               stream);
    case 128: return launch<128>(q, k, v, out, B, S, H, KV, scale, window,
                                 stream);
    default: return -1;
  }
}

const char* flash_attention_error_string(int code) {
  if (code == -1) return "head size not compiled (32, 64 or 128)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
