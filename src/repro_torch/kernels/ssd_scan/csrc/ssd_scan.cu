// Mamba2 SSD chunk scan, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _ssd_kernel in
// src/repro/kernels/ssd_scan/kernel.py (launched by ssd_scan's
// pallas_call). For every row bh = b*H + h (batch row b, head h) and every
// column p of the head's P, over the sequence in chunks of Q steps, with
// the state h (P x N, float32) carried in order from zero:
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
// What bounds it: per (row, chunk) the products C B^T (Q*Q*N), w x
// (Q*Q*P), C h^T (Q*N*P) and the state update (P*Q*N): 3.67 MFLOP at
// Q = 64, P = 64, N = 128, so 11.3 GFLOP at Mamba2-130M's training shape
// (B = 4, H = 24, S = 2048), 168 us at the 67 TFLOP/s of float32 outside
// the tensor cores, against 33 us for its ~110 MB; so operations bound it.
//
// The design is the simple one the port starts from: one block of 256
// threads per (row, 32 columns of P); the TPU grid's sequential chunk axis
// becomes a loop inside the block, the state tile (32 x N) stays in shared
// memory across it, and every block recomputes the chunk's (Q x Q) weights
// w, which the P tiles share (at P = 64 that doubles the C B^T work, but
// gives 192 blocks for 132 SMs instead of 96). Each product is a register
// tile of 8 to 32 outputs per thread with explicit fmaf over shared memory
// (rows padded by one float against bank conflicts). Each chunk's tiles
// are staged through registers with 16-byte loads, all issued before the
// first store to shared memory. TF32 / 3xTF32 tensor-core products, and
// chunks in parallel with a separate state pass, are for a later PR.
//
// L is summed in double and rounded to float32 once, as the plain version
// does it. The decays exp(L_i - L_j) take differences of L, which for the
// fast-decaying heads reach magnitudes of ~1e3 within a chunk, where a
// float32 ulp is ~1e-4: a float32 running sum leaves L's rounding to the
// order of the additions, and that difference alone moved y by 1e-3
// against the plain version's (parallel) cumsum. A double sum of at most
// 64 floats is exact far below a float32 ulp in any order, so both round
// to the same float32 L.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;       // 16 x 16 threads over each tile
constexpr int kPT = 32;             // columns of P per block
constexpr int kMaxQ = 64;           // chunk lengths the register tiles cover
constexpr int kMaxN = 128;          // state sizes the register tiles cover
constexpr int kQT = kMaxQ / 16;     // rows (or columns) of Q per thread
constexpr int kPTT = kPT / 16;      // columns of P per thread
constexpr int kNT = kMaxN / 16;     // columns of N per thread
// float4 loads per thread to stage a chunk's B and C (each), and x tile
constexpr int kBCLoads = kMaxQ * kMaxN / 4 / kThreads;
constexpr int kXLoads = kMaxQ * kPT / 4 / kThreads;

struct Strides {                    // element strides of la and x (and y)
  int64_t la_b, la_h, la_s, x_b, x_h, x_s;
};

__host__ __device__ constexpr int smem_floats(int Q, int N) {
  return Q * kPT                    // x tile
       + 2 * Q * (N + 1)            // B, C
       + Q * (Q + 1)                // w
       + kPT * (N + 1)              // state tile
       + 3 * Q;                     // L, exp(L), exp(L_Q - L)
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const float* __restrict__ la, const float* __restrict__ x,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                float* __restrict__ y, int S, int H, int P, int N, int Q,
                Strides st) {
  extern __shared__ __align__(16) float smem[];
  const int NP = N + 1, QP = Q + 1;
  float* sX = smem;                 // Q x kPT (first: 16-byte stores)
  float* sB = sX + Q * kPT;         // Q x NP
  float* sC = sB + Q * NP;          // Q x NP
  float* sW = sC + Q * NP;          // Q x QP
  float* sH = sW + Q * QP;          // kPT x NP
  float* sL = sH + kPT * NP;        // Q
  float* sE = sL + Q;               // Q
  float* sD = sE + Q;               // Q

  const int bh = blockIdx.x, b = bh / H, hh = bh % H;
  const int p0 = blockIdx.y * kPT;
  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const float* lab = la + b * st.la_b + hh * st.la_h;
  const float* xb = x + b * st.x_b + hh * st.x_h + p0;
  float* yb = y + b * st.x_b + hh * st.x_h + p0;
  const float* Bb = Bm + static_cast<int64_t>(b) * S * N;
  const float* Cb = Cm + static_cast<int64_t>(b) * S * N;

  for (int i = tid; i < kPT * NP; i += kThreads) sH[i] = 0.f;

  const int n4s = N / 4;             // float4s per row of B and C
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < S; c0 += Q) {
    // stage the chunk: every load (16 bytes a thread, la one float) is
    // issued before the first store, so their latencies overlap
    float4 rb[kBCLoads], rc[kBCLoads], rx[kXLoads];
#pragma unroll
    for (int k = 0; k < kBCLoads; ++k) {
      const int i = tid + k * kThreads, s = i / n4s, n4 = i % n4s;
      rb[k] = rc[k] = zero4;
      if (s < Q && c0 + s < S) {
        const int64_t off = static_cast<int64_t>(c0 + s) * N + 4 * n4;
        rb[k] = *reinterpret_cast<const float4*>(Bb + off);
        rc[k] = *reinterpret_cast<const float4*>(Cb + off);
      }
    }
#pragma unroll
    for (int k = 0; k < kXLoads; ++k) {
      const int i = tid + k * kThreads;
      const int s = i / (kPT / 4), p = 4 * (i % (kPT / 4));
      rx[k] = zero4;
      if (c0 + s < S && s < Q && p0 + p < P)
        rx[k] = *reinterpret_cast<const float4*>(xb + (c0 + s) * st.x_s + p);
    }
    const float rla =
        tid < Q && c0 + tid < S ? lab[(c0 + tid) * st.la_s] : 0.f;
    __syncthreads();                // the last chunk is done with every tile
#pragma unroll
    for (int k = 0; k < kBCLoads; ++k) {
      const int i = tid + k * kThreads, s = i / n4s, n = 4 * (i % n4s);
      if (s < Q) {
        float* b = sB + s * NP + n;
        float* c = sC + s * NP + n;
        b[0] = rb[k].x; b[1] = rb[k].y; b[2] = rb[k].z; b[3] = rb[k].w;
        c[0] = rc[k].x; c[1] = rc[k].y; c[2] = rc[k].z; c[3] = rc[k].w;
      }
    }
#pragma unroll
    for (int k = 0; k < kXLoads; ++k) {
      const int i = tid + k * kThreads;
      if (i < Q * (kPT / 4)) reinterpret_cast<float4*>(sX)[i] = rx[k];
    }
    if (tid < Q) sL[tid] = rla;
    __syncthreads();
    if (tid == 0) {                 // L = cumsum(la), in double, rounded
      double acc = 0.0;
      for (int s = 0; s < Q; ++s) {
        acc += sL[s];
        sL[s] = static_cast<float>(acc);
      }
    }
    __syncthreads();
    if (tid < Q) {
      sE[tid] = expf(sL[tid]);
      sD[tid] = expf(sL[Q - 1] - sL[tid]);
    }

    // w = tril((C B^T) * exp(min(L_i - L_j, 0))): rows ti + 16r, cols
    // tj + 16c
    {
      float acc[kQT][kQT] = {};
      for (int n = 0; n < N; ++n) {
        float cv[kQT], bv[kQT];
#pragma unroll
        for (int r = 0; r < kQT; ++r) {
          const int i = ti + 16 * r;
          cv[r] = i < Q ? sC[i * NP + n] : 0.f;
          bv[r] = tj + 16 * r < Q ? sB[(tj + 16 * r) * NP + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kQT; ++r)
#pragma unroll
          for (int c = 0; c < kQT; ++c)
            acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kQT; ++r)
#pragma unroll
        for (int c = 0; c < kQT; ++c) {
          const int i = ti + 16 * r, j = tj + 16 * c;
          if (i < Q && j < Q)
            sW[i * QP + j] =
                j <= i ? acc[r][c] * expf(fminf(sL[i] - sL[j], 0.f)) : 0.f;
        }
    }
    __syncthreads();

    // y = w x + exp(L) (C h^T): rows ti + 16r, cols tj + 16c of the tile
    {
      float a[kQT][kPTT] = {}, e[kQT][kPTT] = {};
      for (int j = 0; j < Q; ++j) {
        float wv[kQT], xv[kPTT];
#pragma unroll
        for (int r = 0; r < kQT; ++r) {
          const int i = ti + 16 * r;
          wv[r] = i < Q ? sW[i * QP + j] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < kPTT; ++c) xv[c] = sX[j * kPT + tj + 16 * c];
#pragma unroll
        for (int r = 0; r < kQT; ++r)
#pragma unroll
          for (int c = 0; c < kPTT; ++c) a[r][c] = fmaf(wv[r], xv[c], a[r][c]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[kQT], hv[kPTT];
#pragma unroll
        for (int r = 0; r < kQT; ++r) {
          const int i = ti + 16 * r;
          cv[r] = i < Q ? sC[i * NP + n] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < kPTT; ++c) hv[c] = sH[(tj + 16 * c) * NP + n];
#pragma unroll
        for (int r = 0; r < kQT; ++r)
#pragma unroll
          for (int c = 0; c < kPTT; ++c) e[r][c] = fmaf(cv[r], hv[c], e[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kQT; ++r)
#pragma unroll
        for (int c = 0; c < kPTT; ++c) {
          const int i = ti + 16 * r, p = tj + 16 * c;
          if (i < Q && c0 + i < S && p0 + p < P)
            yb[(c0 + i) * st.x_s + p] = a[r][c] + sE[i] * e[r][c];
        }
    }
    __syncthreads();                // y has read the state before it moves

    // h = exp(L_Q) h + x^T (B * exp(L_Q - L)): rows ti + 16r of the tile,
    // cols tj + 16c of N
    {
      float acc[kPTT][kNT] = {};
      for (int j = 0; j < Q; ++j) {
        const float d = sD[j];
        float xv[kPTT], bv[kNT];
#pragma unroll
        for (int r = 0; r < kPTT; ++r) xv[r] = sX[j * kPT + ti + 16 * r];
#pragma unroll
        for (int c = 0; c < kNT; ++c) {
          const int n = tj + 16 * c;
          bv[c] = n < N ? sB[j * NP + n] * d : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kPTT; ++r)
#pragma unroll
          for (int c = 0; c < kNT; ++c)
            acc[r][c] = fmaf(xv[r], bv[c], acc[r][c]);
      }
      const float eq = sE[Q - 1];
#pragma unroll
      for (int r = 0; r < kPTT; ++r)
#pragma unroll
        for (int c = 0; c < kNT; ++c) {
          const int p = ti + 16 * r, n = tj + 16 * c;
          if (n < N) sH[p * NP + n] = sH[p * NP + n] * eq + acc[r][c];
        }
    }
  }
}

constexpr int kMaxSmemBytes = smem_floats(kMaxQ, kMaxN) * sizeof(float);

}  // namespace

// Plain C interface, loaded with ctypes: returns the cudaError_t of the
// launch (0 on success), or -1 for a chunk or state size the register
// tiles do not cover (Q <= 64, N <= 128) or rows that 16-byte loads do
// not cover (N and P multiples of 4; la, x, B and C 16-byte aligned).
extern "C" {

int ssd_scan_launch(const void* la, const void* x, const void* Bm,
                    const void* Cm, void* y, int B, int S, int H, int P,
                    int N, int Q, int64_t la_b, int64_t la_h, int64_t la_s,
                    int64_t x_b, int64_t x_h, int64_t x_s, void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || N % 4 || P % 4) return -1;
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0) return 0;
  // above 48 KB of dynamic shared memory only after an opt-in, once
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const Strides st{la_b, la_h, la_s, x_b, x_h, x_s};
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((P + kPT - 1) / kPT));
  const size_t smem = smem_floats(Q, N) * sizeof(float);
  ssd_scan_kernel<<<grid, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(la), static_cast<const float*>(x),
      static_cast<const float*>(Bm), static_cast<const float*>(Cm),
      static_cast<float*>(y), S, H, P, N, Q, st);
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_scan_error_string(int code) {
  if (code == -1)
    return "chunk above 64, state size above 128, or N or P not a multiple "
           "of 4";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
