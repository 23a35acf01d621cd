// ssd_scan — Mamba-2 chunked SSD forward from a zero state, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py:_kernel
// (launched by ssd_scan_kernel's pl.pallas_call). Per (b, h) stream, chunk by
// chunk (Q = chunk length, cum = inclusive cumsum of a_h * dt over the chunk):
//
//   W      = (C Bᵀ) ⊙ tril(exp(cum_t - cum_s)) ⊙ dt_s        (Q, Q)
//   y      = W @ x + (C @ h_inᵀ) ⊙ exp(cum_t)                 (Q, P)
//   h_out  = exp(cum_Q) · h_in + (x ⊙ exp(cum_Q - cum) dt)ᵀ @ B   (P, N)
//
// x, B, C are fp32 or bf16 (one dtype); dt and a fp32; all math in fp32;
// y comes out in x's dtype, the final state h_final (B, H, P, N) in fp32.
// S must be a multiple of Q (the wrapper pads with dt = 0 no-op steps).
//
// What bounds it on this card: operations. At the serving shape (B = 4,
// S = 2048, H = 80, P = 64, N = 128, Q = 256, fp32) one launch must move
// about 357 MB (107 µs at 3.35 TB/s) but do about 32.5 GFLOP even with
// CBᵀ formed once per (b, chunk) and only the causal half of W @ x
// (≈ 485 µs on the fp32 CUDA cores). This kernel executes about 61.7
// GFLOP there: CBᵀ per head on causal 64x64 tiles (26.8), W @ x on the
// same tiles (13.4), C @ h_in (10.7) and the state update (10.7).
//
// Design (not a block-for-block copy of the TPU grid (B, H, S/Q), whose
// chunk axis runs in order with the state in VMEM scratch):
//   * one block per (h, b) loops over the chunks itself; the (P, N) state
//     lives in shared memory for the whole stream and h_final is written
//     once at the end — HBM traffic is x, dt, B, C in and y, h_final out;
//   * a (Q, Q) fp32 tile does not fit (256 KB at Q = 256), so the chunk is
//     cut into 64-row sub-tiles: for each row tile t, the inter-chunk term
//     from the entering state, then for each column tile s <= t one 64x64
//     tile of W computed once into shared memory and reused across all P
//     columns of y. The state update takes each column tile's x and B while
//     they are loaded for the diagonal tile, in registers, and is applied
//     after every row of y has read the entering state (block barrier);
//   * the causal mask is applied before exp (the upper triangle of
//     cum_t - cum_s is positive and would overflow); ragged tile edges
//     (Q not a multiple of 64) are zero-filled and masked;
//   * the cumsum is sequential by one thread and kept in fp64, and every
//     exponent (cum_t - cum_s, cum_Q - cum_s, cum_t) is formed in fp64 and
//     rounded once before an fp32 exp. Over a 256-step chunk cum reaches
//     -10^3 with unit-normal inputs, where an fp32 difference of two such
//     values is off by up to ~1e-4 (their ulp): the chunked form then loses
//     digits that the sequential recurrence keeps. One fp64 add per W
//     element is negligible beside the 128-deep CBᵀ dot;
//   * fp32 FMA on the CUDA cores, 4x4 (y, W) and 4x8 (state) register tiles
//     per thread, padded shared-memory rows to keep banks apart. CBᵀ is
//     shared by all H heads (one B/C group) but each (b, h) block recomputes
//     it: 80x the CBᵀ work at H = 80 — the first thing a redesign removes,
//     with tensor-core (wgmma) products;
//   * every global offset is 64-bit (x has 5.4e9 elements at B = 32,
//     S = 32768, H = 80, P = 64).
// Limits: P <= 64, N <= 128, Q <= 1024 (the launcher refuses others).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kTile = 64;       // rows (and columns) of one sub-tile of the chunk
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxQ = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

size_t smem_bytes(int P, int N, int Q) {
  return sizeof(double) * (size_t)Q +
         sizeof(float) * ((size_t)P * (N + 1) + 2 * (size_t)kTile * (N + 1) +
                          (size_t)kTile * (P + 1) + (size_t)kTile * (kTile + 1) + 3 * (size_t)Q);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y,
                float* __restrict__ h_final, int64_t S, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NP = N + 1, PP = P + 1, TP = kTile + 1;
  double* cum = reinterpret_cast<double*>(smem);   // [Q]  inclusive cumsum of a*dt
  float* hs = reinterpret_cast<float*>(cum + Q);   // [P][N+1]      carried state h[p][n]
  float* cs = hs + P * NP;           // [kTile][N+1]  C rows of the row tile
  float* bs = cs + kTile * NP;       // [kTile][N+1]  B rows of the column tile
  float* xs = bs + kTile * NP;       // [kTile][P+1]  x rows of the column tile
  float* ws = xs + kTile * PP;       // [kTile][kTile+1]  W tile
  float* dts = ws + kTile * TP;      // [Q]  dt
  float* ecum = dts + Q;             // [Q]  exp(cum_t)
  float* dout = ecum + Q;            // [Q]  exp(cum_last - cum_s) * dt_s

  const int h = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const double ah = a[h];

  const int64_t HP = (int64_t)H * P;
  const T* xb = x + b * S * HP + (int64_t)h * P;    // row s at xb + s * HP
  T* yb = y + b * S * HP + (int64_t)h * P;
  const float* dtb = dt + b * S * H + h;           // row s at dtb + s * H
  const T* bb = bm + b * S * N;                     // row s at bb + s * N
  const T* cb = cm + b * S * N;

  for (int e = tid; e < P * NP; e += kThreads) hs[e] = 0.f;

  const int64_t nchunks = S / Q;
  const int ntiles = (Q + kTile - 1) / kTile;
  for (int64_t c = 0; c < nchunks; ++c) {
    const int64_t s0 = c * Q;
    __syncthreads();   // the previous chunk is done with every shared array
    for (int t = tid; t < Q; t += kThreads) dts[t] = dtb[(s0 + t) * H];
    __syncthreads();
    if (tid == 0) {
      double run = 0.0;
      for (int t = 0; t < Q; ++t) {
        run += ah * dts[t];
        cum[t] = run;
      }
    }
    __syncthreads();
    const double cum_last = cum[Q - 1];
    for (int t = tid; t < Q; t += kThreads) {
      ecum[t] = expf((float)cum[t]);
      dout[t] = expf((float)(cum_last - cum[t])) * dts[t];
    }

    float upd[4][8];   // this chunk's state update, p = ty + 16i, n = tx + 16k
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) upd[i][k] = 0.f;

    for (int it = 0; it < ntiles; ++it) {
      const int t0 = it * kTile;
      const int rows_t = min(kTile, Q - t0);
      __syncthreads();   // cs is free; ecum and dout are visible
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int r = e / N, n = e - r * N;
        cs[r * NP + n] = r < rows_t ? to_f32(cb[(s0 + t0 + r) * N + n]) : 0.f;
      }
      __syncthreads();

      // Inter-chunk term: y[t][p] = exp(cum_t) * sum_n C[t][n] h_in[p][n],
      // t = t0 + ty + 16i, p = tx + 16j.
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = tx + 16 * j < P ? hs[(tx + 16 * j) * NP + n] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        const float e = t < Q ? ecum[min(t, Q - 1)] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }

      // Intra-chunk term, one 64-column tile of W at a time (causal: u <= t).
      for (int jt = 0; jt <= it; ++jt) {
        const int u0 = jt * kTile;
        const int rows_u = min(kTile, Q - u0);
        __syncthreads();   // bs, xs and ws are free
        for (int e = tid; e < kTile * N; e += kThreads) {
          const int r = e / N, n = e - r * N;
          bs[r * NP + n] = r < rows_u ? to_f32(bb[(s0 + u0 + r) * N + n]) : 0.f;
        }
        for (int e = tid; e < kTile * P; e += kThreads) {
          const int r = e / P, p = e - r * P;
          xs[r * PP + p] = r < rows_u ? to_f32(xb[(s0 + u0 + r) * HP + p]) : 0.f;
        }
        __syncthreads();

        // W[t][u] = (C_t · B_u) * exp(cum_t - cum_u) * dt_u, masked before exp.
        {
          float cbv[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) cbv[i][j] = 0.f;
          for (int n = 0; n < N; ++n) {
            float cv[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * NP + n];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * NP + n];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) cbv[i][j] = fmaf(cv[i], bv[j], cbv[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int tl = ty + 16 * i, t = t0 + tl;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int ul = tx + 16 * j, u = u0 + ul;
              const bool live = t < Q && u <= t;
              // Clamped indices: no shared-memory read past the Q-long arrays.
              const int tc = min(t, Q - 1), uc = min(u, Q - 1);
              ws[tl * TP + ul] =
                  live ? cbv[i][j] * expf((float)(cum[tc] - cum[uc])) * dts[uc] : 0.f;
            }
          }
        }

        // These columns' share of the state update, once (on the diagonal):
        // upd[p][n] += sum_u x[u][p] * exp(cum_last - cum_u) dt_u * B[u][n].
        if (jt == it) {
          for (int ul = 0; ul < rows_u; ++ul) {
            const float d = dout[u0 + ul];
            float xv[4], bv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) xv[i] = ty + 16 * i < P ? xs[ul * PP + ty + 16 * i] * d : 0.f;
#pragma unroll
            for (int k = 0; k < 8; ++k) bv[k] = tx + 16 * k < N ? bs[ul * NP + tx + 16 * k] : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int k = 0; k < 8; ++k) upd[i][k] = fmaf(xv[i], bv[k], upd[i][k]);
          }
        }
        __syncthreads();   // ws is complete

        // y[t][p] += sum_u W[t][u] x[u][p]
        for (int ul = 0; ul < rows_u; ++ul) {
          float wv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = ws[(ty + 16 * i) * TP + ul];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = tx + 16 * j < P ? xs[ul * PP + tx + 16 * j] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t < Q) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int p = tx + 16 * j;
            if (p < P) put(yb + (s0 + t) * HP + p, acc[i][j]);
          }
        }
      }
    }

    // Every row of y has read the entering state: apply the update.
    __syncthreads();
    const float decay = expf((float)cum_last);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = ty + 16 * i;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int n = tx + 16 * k;
        if (p < P && n < N) hs[p * NP + n] = fmaf(decay, hs[p * NP + n], upd[i][k]);
      }
    }
  }
  __syncthreads();
  float* hf = h_final + ((int64_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    hf[e] = hs[p * NP + n];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* b, const void* c,
           void* y, float* h_final, int64_t B, int64_t S, int64_t H, int64_t P, int64_t N,
           int64_t Q, cudaStream_t stream) {
  const size_t smem = smem_bytes((int)P, (int)N, (int)Q);
  // Opt in above 48 KB once per device and size, so that a launch inside
  // CUDA-graph capture makes no attribute call.
  constexpr int kMaxDevices = 64;
  static size_t opted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024 && (dev >= kMaxDevices || smem > opted[dev])) {
    err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < kMaxDevices) opted[dev] = smem;
  }
  const dim3 grid((unsigned)H, (unsigned)B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)x, dt, a, (const T*)b, (const T*)c, (T*)y, h_final, S, (int)H, (int)P,
      (int)N, (int)Q);
  return (int)cudaGetLastError();
}

}  // namespace

// x, b, c, y: fp32 (bf16 == 0) or bf16 (bf16 == 1), contiguous (B,S,H,P) /
// (B,S,N); dt (B,S,H) and a (H,) fp32; h_final (B,H,P,N) fp32. Returns a
// cudaError_t code, 0 on success; cudaErrorInvalidValue for shapes outside
// the kernel's limits.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* a,
                               const void* b, const void* c, void* y, float* h_final,
                               int64_t B, int64_t S, int64_t H, int64_t P, int64_t N,
                               int64_t Q, int bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || P < 1 || P > kMaxP || N < 1 ||
      N > kMaxN || Q < 1 || Q > kMaxQ || S < Q || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, dt, a, b, c, y, h_final, B, S, H, P, N, Q, st)
              : launch<float>(x, dt, a, b, c, y, h_final, B, S, H, P, N, Q, st);
}
