// gmsa_score — GMSA dispatch score + argmin for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gmsa_score/kernel.py:_kernel
// (launched by gmsa_score_kernel's pl.pallas_call). Per job type k and run b:
//
//   cost[k, i]      = sum_j r[k, i, j] * wpue[j]
//   score[b, k, i]  = a[b, k] * (q[b, k, i] - mu[b, k, i] + vp[b, k] * cost[k, i])
//   best[b, k]      = argmin_i score[b, k, i]     (lowest index on ties)
//
// r is shared by every run or, for the placement controller whose runs
// each carry their own layout, one (K, N, N) tensor per run: then cost is
// (R, K, N) and run b's scores read cost[b].
//
// What bounds it on this card: bytes. At the fleet shape (R = 100 runs,
// K = 8, N = 256) one call must move about 4.6 MB (r once, q and mu once,
// scores out) for about 1.9 MFLOP, ~0.4 FLOP/B: far below the fp32 ridge
// point, so tensor cores are no help. At (R = 1, K = 128, N = 1024) the
// 537 MB of r is the whole cost, as is the 209.7 MB of a per-run r at
// (R = 100, K = 8, N = 256).
//
// Design: two card-wide phases behind one C entry point (the TPU grid's
// sequential i-loop with a running (min, argmin) in VMEM has no use here).
//   1. gmsa_cost_kernel: cost = r·wpue as one (R_r·K·N, N) matvec over
//      every SM (R_r = 1 for a shared r, R for a per-run r), so each byte
//      of r is read once per call (not once per chunk of runs). One warp
//      per row, kRows rows in flight per warp, 16-byte
//      __ldg loads of r when its rows are 16-byte aligned (N % 4 == 0),
//      else a scalar path; wpue staged once per block in shared memory; a
//      grid-stride loop over rows with kCostBlocksPerSM blocks per SM.
//      Products accumulate in fp64 and the row's sum is rounded to fp32
//      once, so the (K, N) workspace is the correctly rounded matvec up to
//      a few ulp whatever the summation order (the phase moves bytes; fp64
//      FMA at half the fp32 rate costs nothing visible).
//   2. gmsa_pick_kernel: one block per (run, tile of kTile job types);
//      threads walk managers i = tid, tid + blockDim, .... q and mu are
//      read in their caller's layout: with stride_k == 1 (the simulator's
//      (R, N, K) buffers seen through .mT) a thread takes q[b, i, k0:k0+8]
//      as two 16-byte loads (coalesced across the warp); with stride_n == 1
//      loads go along i per k; any other strides take a scalar path. a and
//      vp are read once per (b, k) into shared memory. Scores are written
//      along i per k; each k's running (min, argmin) stays in registers,
//      then goes to shared memory, where warp t merges job type t's 256
//      pairs (eight in a row per lane, then five shuffles) with better():
//      ties to the lower index (as torch.argmin and the TPU kernel's strict
//      `<` merge), NaN counts as the minimum (as torch.argmin). Merging the
//      eight job types in parallel, one warp each, beat eight shuffle
//      chains per warp on the card. The ragged N edge is masked by the
//      loop bounds — nothing is padded, so no out-of-range index can win;
//      a row with a = 0 scores all (+/-)0 and picks index 0.
//   Launch: the pick kernel is a programmatic dependent launch
//   (cudaLaunchAttributeProgrammaticStreamSerialization). It loads its
//   first managers' q, mu, a and vp, then waits for the cost kernel
//   (griddepcontrol.wait, i.e. cudaGridDependencySynchronize) before it
//   reads cost. The wait covers the whole cost grid's completion and its
//   memory wherever the cost kernel signals, so it signals
//   (griddepcontrol.launch_dependents, i.e.
//   cudaTriggerProgrammaticLaunchCompletion) as it starts, not after its
//   stores: the pick blocks launch while the matvec runs and read q and mu
//   under it, which measured faster on the card than signalling after the
//   stores. The pick grid can launch only once every cost block has
//   started, so its waiting blocks never hold back a cost block. Stream
//   capture keeps the programmatic edge (chip_smoke.py prints the edges).
//
// r (R_r, K, N, N) and wpue (N,) must be contiguous; cost (R_r, K, N),
// scores (R, K, N) and best (R, K) are written contiguous.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;              // cost rows in flight per warp
constexpr int kCostBlocksPerSM = 4;   // resident cost blocks per SM
constexpr int kTile = 8;              // job types per pick block
static_assert(kTile == kWarps, "warp t reduces job type t of the tile");

__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v < bv || (v == bv && i < bi);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kCostBlocksPerSM)
gmsa_cost_kernel(const float* __restrict__ r, const float* __restrict__ wpue,
                 float* __restrict__ cost, int64_t rows, int N) {
  extern __shared__ double w[];              // (N,) wpue in fp64
  release_dependents();                      // see "Launch" above
  for (int j = threadIdx.x; j < N; j += kThreads) w[j] = (double)wpue[j];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t stride = (int64_t)gridDim.x * kWarps * kRows;
  for (int64_t i0 = warp * kRows; i0 < rows; i0 += stride) {
    double acc[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) acc[u] = 0.0;
    if (kVec) {
      const int nv = N >> 2;
#pragma unroll 4
      for (int v = lane; v < nv; v += 32) {
        float4 x[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          x[u] = i0 + u < rows
              ? __ldg(reinterpret_cast<const float4*>(r + (i0 + u) * N) + v)
              : make_float4(0.f, 0.f, 0.f, 0.f);
        const double2 w01 = reinterpret_cast<const double2*>(w)[2 * v];
        const double2 w23 = reinterpret_cast<const double2*>(w)[2 * v + 1];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          acc[u] = fma((double)x[u].x, w01.x, acc[u]);
          acc[u] = fma((double)x[u].y, w01.y, acc[u]);
          acc[u] = fma((double)x[u].z, w23.x, acc[u]);
          acc[u] = fma((double)x[u].w, w23.y, acc[u]);
        }
      }
    } else {
#pragma unroll 4
      for (int j = lane; j < N; j += 32) {
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          if (i0 + u < rows) acc[u] = fma((double)__ldg(r + (i0 + u) * N + j), w[j], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      double s = acc[u];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0 && i0 + u < rows) cost[i0 + u] = (float)s;
    }
  }
}

enum Layout { kKContig = 0, kNContig = 1, kStrided = 2 };

// x[b, k0 + t, i] - y[b, k0 + t, i] for t < kn, in the layout kL.
template <int kL>
__device__ __forceinline__ void load_diff(
    float d[kTile], const float* __restrict__ x, const float* __restrict__ y,
    int64_t b, int k0, int kn, int64_t i,
    int64_t sx_b, int64_t sx_k, int64_t sx_n,
    int64_t sy_b, int64_t sy_k, int64_t sy_n) {
  const float* xp = x + b * sx_b + (int64_t)k0 * sx_k;
  const float* yp = y + b * sy_b + (int64_t)k0 * sy_k;
  if (kL == kKContig) {
    xp += i * sx_n;
    yp += i * sy_n;
    if (kn == kTile && ((reinterpret_cast<uintptr_t>(xp) | reinterpret_cast<uintptr_t>(yp)) & 15) == 0) {
      const float4 x0 = __ldg(reinterpret_cast<const float4*>(xp));
      const float4 x1 = __ldg(reinterpret_cast<const float4*>(xp) + 1);
      const float4 y0 = __ldg(reinterpret_cast<const float4*>(yp));
      const float4 y1 = __ldg(reinterpret_cast<const float4*>(yp) + 1);
      d[0] = x0.x - y0.x; d[1] = x0.y - y0.y; d[2] = x0.z - y0.z; d[3] = x0.w - y0.w;
      d[4] = x1.x - y1.x; d[5] = x1.y - y1.y; d[6] = x1.z - y1.z; d[7] = x1.w - y1.w;
      return;
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t)
      if (t < kn) d[t] = __ldg(xp + t) - __ldg(yp + t);
  } else if (kL == kNContig) {
#pragma unroll
    for (int t = 0; t < kTile; ++t)
      if (t < kn) d[t] = __ldg(xp + t * sx_k + i) - __ldg(yp + t * sy_k + i);
  } else {
#pragma unroll
    for (int t = 0; t < kTile; ++t)
      if (t < kn) d[t] = __ldg(xp + t * sx_k + i * sx_n) - __ldg(yp + t * sy_k + i * sy_n);
  }
}

template <int kL>
__global__ void __launch_bounds__(kThreads)
gmsa_pick_kernel(const float* __restrict__ q, const float* __restrict__ mu,
                 const float* __restrict__ a, const float* __restrict__ vp,
                 const float* cost,           // written by the cost kernel: no .nc loads
                 float* __restrict__ scores, int32_t* __restrict__ best,
                 int K, int N, int64_t scost_b,
                 int64_t sq_b, int64_t sq_k, int64_t sq_n,
                 int64_t smu_b, int64_t smu_k, int64_t smu_n,
                 int64_t sa_b, int64_t sa_k, int64_t svp_b, int64_t svp_k) {
  __shared__ float ab_s[kTile], vb_s[kTile];
  __shared__ float red_v[kTile][kThreads];
  __shared__ int red_i[kTile][kThreads];

  const int64_t b = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int kn = min(kTile, K - k0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  cost += b * scost_b;                        // run b's workspace (0: shared r)
  // Everything that does not depend on cost, before the wait.
  if (tid < kn) {
    ab_s[tid] = a[b * sa_b + (int64_t)(k0 + tid) * sa_k];
    vb_s[tid] = vp[b * svp_b + (int64_t)(k0 + tid) * svp_k];
  }
  float d[kTile];
  if (tid < N)
    load_diff<kL>(d, q, mu, b, k0, kn, tid, sq_b, sq_k, sq_n, smu_b, smu_k, smu_n);
  __syncthreads();
  float ab[kTile], vb[kTile], bv[kTile];
  int bi[kTile];
#pragma unroll
  for (int t = 0; t < kTile; ++t) {
    ab[t] = t < kn ? ab_s[t] : 0.f;
    vb[t] = t < kn ? vb_s[t] : 0.f;
    bv[t] = INFINITY;
    bi[t] = N;                                // sentinel: any real index beats it
  }
  wait_for_primary();

  for (int i = tid; i < N; i += kThreads) {
    if (i != tid)
      load_diff<kL>(d, q, mu, b, k0, kn, i, sq_b, sq_k, sq_n, smu_b, smu_k, smu_n);
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      if (t < kn) {
        const int64_t row = (int64_t)(k0 + t) * N;
        const float s = ab[t] * fmaf(vb[t], __ldcg(cost + row + i), d[t]);
        scores[b * K * N + row + i] = s;
        if (better(s, i, bv[t], bi[t])) { bv[t] = s; bi[t] = i; }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kTile; ++t) { red_v[t][tid] = bv[t]; red_i[t][tid] = bi[t]; }
  __syncthreads();
  if (warp < kn) {                             // warp t finishes job type k0 + t
    float v = red_v[warp][lane];
    int i = red_i[warp][lane];
#pragma unroll
    for (int j = lane + 32; j < kThreads; j += 32)
      if (better(red_v[warp][j], red_i[warp][j], v, i)) { v = red_v[warp][j]; i = red_i[warp][j]; }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) best[b * K + k0 + warp] = i;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int kL>
cudaError_t launch_pick(const float* q, const float* mu, const float* a, const float* vp,
                        const float* cost, float* scores, int32_t* best, int R, int K, int N,
                        int64_t scost_b, int64_t sq_b, int64_t sq_k, int64_t sq_n,
                        int64_t smu_b, int64_t smu_k, int64_t smu_n,
                        int64_t sa_b, int64_t sa_k, int64_t svp_b, int64_t svp_k,
                        cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R, (K + kTile - 1) / kTile);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gmsa_pick_kernel<kL>, q, mu, a, vp, cost, scores, best,
                            K, N, scost_b, sq_b, sq_k, sq_n, smu_b, smu_k, smu_n,
                            sa_b, sa_k, svp_b, svp_k);
}

}  // namespace

// One call = the cost kernel, then the pick kernel, on `stream`. `r_runs`
// is 1 for a shared r or R for one r per run; `cost` is an (r_runs, K, N)
// fp32 workspace the caller allocates; `sms` is the card's SM count (sizes
// the cost kernel's grid). Returns a cudaError_t as int.
extern "C" int gmsa_score_launch(
    const float* q, const float* mu, const float* a, const float* vp,
    const float* r, const float* wpue, float* cost, float* scores, int32_t* best,
    int R, int r_runs, int K, int N, int sms,
    int64_t sq_b, int64_t sq_k, int64_t sq_n,
    int64_t smu_b, int64_t smu_k, int64_t smu_n,
    int64_t sa_b, int64_t sa_k, int64_t svp_b, int64_t svp_k,
    void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (r_runs != 1 && r_runs != R) return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)r_runs * K * N;
  const int64_t scost_b = r_runs == 1 ? 0 : (int64_t)K * N;
  const size_t smem = (size_t)N * sizeof(double);
  const int64_t per_block = (int64_t)kWarps * kRows;
  const int blocks = (int)std::min<int64_t>((rows + per_block - 1) / per_block,
                                            (int64_t)sms * kCostBlocksPerSM);
  const bool vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(r) & 15) == 0;
  cudaError_t err = vec ? allow_smem(gmsa_cost_kernel<true>, smem)
                        : allow_smem(gmsa_cost_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  if (vec)
    gmsa_cost_kernel<true><<<blocks, kThreads, smem, s>>>(r, wpue, cost, rows, N);
  else
    gmsa_cost_kernel<false><<<blocks, kThreads, smem, s>>>(r, wpue, cost, rows, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (sq_k == 1 && smu_k == 1)
    err = launch_pick<kKContig>(q, mu, a, vp, cost, scores, best, R, K, N, scost_b, sq_b, sq_k, sq_n,
                                smu_b, smu_k, smu_n, sa_b, sa_k, svp_b, svp_k, s);
  else if (sq_n == 1 && smu_n == 1)
    err = launch_pick<kNContig>(q, mu, a, vp, cost, scores, best, R, K, N, scost_b, sq_b, sq_k, sq_n,
                                smu_b, smu_k, smu_n, sa_b, sa_k, svp_b, svp_k, s);
  else
    err = launch_pick<kStrided>(q, mu, a, vp, cost, scores, best, R, K, N, scost_b, sq_b, sq_k, sq_n,
                                smu_b, smu_k, smu_n, sa_b, sa_k, svp_b, svp_k, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
