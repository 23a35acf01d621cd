// gmsa_score — fused GMSA dispatch score + argmin for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gmsa_score/kernel.py:_kernel
// (launched by gmsa_score_kernel's pl.pallas_call). Per job type k and run b:
//
//   cost[k, i]      = sum_j r[k, i, j] * wpue[j]
//   score[b, k, i]  = a[b, k] * (q[b, k, i] - mu[b, k, i] + vp[b, k] * cost[k, i])
//   best[b, k]      = argmin_i score[b, k, i]     (lowest index on ties)
//
// What bounds it on this card: bytes. At the fleet shape (R = 100 runs,
// K = 8, N = 256) one launch must move about 4.6 MB (r once, q and mu once,
// scores out) for about 1.9 MFLOP — far below the fp32 ridge point.
//
// Design (not a block-for-block copy of the TPU grid, whose sequential
// i-loop carries a running (min, argmin) in VMEM scratch):
//   * one block per (k, chunk of runs); blocks carry nothing between them;
//   * the block computes the cost row for all N managers ONCE into shared
//     memory — warp per row, lanes strided along j (coalesced), ROWS rows
//     in flight per warp for memory-level parallelism, warp-shuffle sums —
//     so one read of r[k] serves every run of the chunk (under the JAX vmap
//     the fused kernel redid this matvec per run);
//   * it then loops over its runs: each thread scores managers i = tid,
//     tid + blockDim, ...; the (value, index) pairs reduce across the block
//     with ties to the lower index, which matches torch.argmin and the
//     strict `<` merge of the TPU kernel; NaN counts as the minimum, as in
//     torch.argmin;
//   * the ragged N edge is masked by the loop bounds — nothing is padded
//     with +3e38, so no out-of-range index can ever win. A row with a = 0
//     scores all (+/-)0 and picks index 0.
// q, mu, a and vp are read through element strides (runs, k[, n]), so the
// caller's (R, N, K) backlog layout is read in place with no transpose copy;
// r (K, N, N) and wpue (N,) must be contiguous; scores (R, K, N) and
// best (R, K) are written contiguous.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;   // cost rows in flight per warp

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v < bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
gmsa_score_kernel(const float* __restrict__ q, const float* __restrict__ mu,
                  const float* __restrict__ a, const float* __restrict__ vp,
                  const float* __restrict__ r, const float* __restrict__ wpue,
                  float* __restrict__ scores, int32_t* __restrict__ best,
                  int R, int K, int N, int runs_per_block,
                  int64_t sq_b, int64_t sq_k, int64_t sq_n,
                  int64_t smu_b, int64_t smu_k, int64_t smu_n,
                  int64_t sa_b, int64_t sa_k, int64_t svp_b, int64_t svp_k) {
  extern __shared__ float cost[];            // (N,)
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];

  const int k = blockIdx.x;
  const int b0 = blockIdx.y * runs_per_block;
  const int b1 = min(R, b0 + runs_per_block);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // 1. cost[i] = sum_j r[k, i, j] * wpue[j], once for the whole chunk.
  const float* rk = r + (int64_t)k * N * N;
  for (int i0 = warp * kRows; i0 < N; i0 += kWarps * kRows) {
    float acc[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) acc[u] = 0.f;
#pragma unroll 4
    for (int j = lane; j < N; j += 32) {
      const float w = wpue[j];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (i0 + u < N) acc[u] = fmaf(rk[(int64_t)(i0 + u) * N + j], w, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      float s = acc[u];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0 && i0 + u < N) cost[i0 + u] = s;
    }
  }
  __syncthreads();

  // 2. Per run: score, write, block-wide (min, argmin).
  for (int b = b0; b < b1; ++b) {
    const float ab = a[b * sa_b + k * sa_k];
    const float vb = vp[b * svp_b + k * svp_k];
    const float* qb = q + b * sq_b + k * sq_k;
    const float* mb = mu + b * smu_b + k * smu_k;
    float* sb = scores + ((int64_t)b * K + k) * N;
    float bv = INFINITY;
    int bi = N;                               // sentinel: any real index beats it
    for (int i = tid; i < N; i += kThreads) {
      const float s = ab * (qb[i * sq_n] - mb[i * smu_n] + vb * cost[i]);
      sb[i] = s;
      if (better(s, i, bv, bi)) { bv = s; bi = i; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? red_v[lane] : INFINITY;
      bi = lane < kWarps ? red_i[lane] : N;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      if (lane == 0) best[(int64_t)b * K + k] = bi;
    }
    __syncthreads();                          // red_* reused by the next run
  }
}

}  // namespace

extern "C" int gmsa_score_launch(
    const float* q, const float* mu, const float* a, const float* vp,
    const float* r, const float* wpue, float* scores, int32_t* best,
    int R, int K, int N, int runs_per_block,
    int64_t sq_b, int64_t sq_k, int64_t sq_n,
    int64_t smu_b, int64_t smu_k, int64_t smu_n,
    int64_t sa_b, int64_t sa_k, int64_t svp_b, int64_t svp_k,
    void* stream) {
  const size_t smem = (size_t)N * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gmsa_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(K, (R + runs_per_block - 1) / runs_per_block);
  gmsa_score_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q, mu, a, vp, r, wpue, scores, best, R, K, N, runs_per_block,
      sq_b, sq_k, sq_n, smu_b, smu_k, smu_n, sa_b, sa_k, svp_b, svp_k);
  return (int)cudaGetLastError();
}
