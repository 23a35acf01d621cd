// ssd_scan — Mamba-2 chunked SSD forward from a zero state, for NVIDIA
// Hopper (sm_90a), as a chain of five chunk-parallel kernels.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py:_kernel
// (launched by ssd_scan_kernel's pl.pallas_call), whose grid (B, H, S/Q)
// walks the chunks of one (b, h) stream in order with the state in VMEM.
// With Q the chunk length, nc = S / Q and, per (b, h, chunk), cum the
// inclusive cumsum of a_h * dt over the chunk:
//
//   y_t    = exp(cum_t) C_t · h_in + Σ_{u<=t} (C_t · B_u) exp(cum_t - cum_u) dt_u x_u
//   h_out  = exp(cum_Q) h_in + Σ_u x_u exp(cum_Q - cum_u) dt_u ⊗ B_u
//
// x, B, C are fp32 or bf16 (one dtype); dt and a fp32; all math in fp32 FMA
// on the CUDA cores (no tensor-core instruction, no library call); y comes
// out in x's dtype, the final state h_final (B, H, P, N) in fp32. S must be
// a multiple of Q (the wrapper pads with dt = 0 no-op steps).
//
// The chain, launched in order on the caller's stream by ssd_scan_launch;
// the caller allocates the three workspaces:
//   0. cumsum      per (b, chunk, h), one warp: cum (B, H, S) fp64, a
//                  shuffle scan over runs of ceil(Q/32) steps per lane.
//   1. chunk_cb    per (b, chunk, causal 64x64 tile pair): G = C_c B_cᵀ
//                  (B, nc, Q, Q) fp32, formed once for all H heads, which
//                  share one B/C group; the heads then read it from L2.
//   2. chunk_state per (b, chunk, h): the chunk's own state contribution
//                  s_c = Σ_u (x_u exp(cum_Q - cum_u) dt_u) ⊗ B_u into
//                  states (B, nc, H, P, N) fp32; a (P, N) product of depth Q.
//   3. state_pass  per (b, h, slice of P·N): walks the chunks in order and
//                  turns states[c] in place into the state entering chunk c,
//                  h_in[c] = exp(cum_Q[c-1]) h_in[c-1] + s_{c-1}, h_in[0] = 0;
//                  writes h_final. Elementwise, memory-bound.
//   4. chunk_scan  per (b, chunk, h, 64-row tile): y from C h_in[c]ᵀ and
//                  causal 64-column tiles of W = G ⊙ exp(cum_t - cum_u) dt_u.
//
// What bounds it on this card: operations. At the serving shape (B = 4,
// S = 2048, H = 80, P = 64, N = 128, Q = 256, fp32) the function needs about
// 32.5 GFLOP (≈ 485 µs on the fp32 CUDA cores) against 357 MB of HBM
// traffic (107 µs). The chain executes about 35.2 GFLOP there: CBᵀ once
// per (b, chunk) on causal tiles (0.34), the state contributions (10.7),
// C @ h_in (10.7) and causal 64x64 tiles of W @ x (13.4), plus ≈ 0.1 GB of
// workspace traffic (states is 84 MB, written twice and read twice).
//
// Design points:
//   * every block of the three products owns a 64-row output tile with an
//     8x4 register tile per thread; operands sit in shared memory k-major
//     (row k holds column k of the left operand and row k of the right one),
//     so each k step is three 16-byte shared loads for 32 FMAs. A warp
//     covers 4 x 8 threads: one wavefront per load. The k loop is unrolled
//     16 deep: a full unroll hoists more shared loads than the registers
//     hold and ran slower on the card;
//   * global reads take four consecutive elements of a row at once (one
//     16-byte fp32 or 8-byte bf16 load where the rows are aligned, scalar
//     loads otherwise). Operands whose source rows run along k (C, B, h_in,
//     G) are stored transposed with rows of 68 floats: a warp's lanes take
//     8 consecutive k of 16 rows, so the global reads are 32-byte runs and
//     the shared stores hit 32 distinct banks;
//   * chunk_cb and chunk_state fetch the next slab into registers before the
//     current slab's FMAs, hiding the loads' latency; chunk_scan fetches its
//     slab after the barrier, since holding a second slab costs the
//     registers its three blocks per SM need (measured slower);
//   * every phase's shared memory is static and under 48 KB (chunk_scan
//     47 KB at most, since it stages the chunk's cum and dt for Q <= 1024):
//     no opt-in attribute, so a launch inside CUDA-graph capture makes no
//     attribute call; chunk_cb and chunk_scan run three 128-thread blocks
//     per SM, chunk_state two 256-thread blocks;
//   * the cumsum stays in fp64, and every exponent (cum_t - cum_u,
//     cum_Q - cum_u, cum_t, cum_Q) is formed in fp64 and rounded once
//     before an fp32 exp: over a 256-step chunk cum reaches -10^3 with
//     unit-normal inputs, where an fp32 difference would lose the digits
//     the sequential recurrence keeps;
//   * the causal mask is applied before exp (above the diagonal cum_t -
//     cum_u is positive and may overflow); ragged tile edges (Q not a
//     multiple of 64) are zero-filled and masked;
//   * no atomics and no split of a sum across blocks: every output is
//     written by one thread in a fixed order, so launches repeat bitwise;
//   * every global offset is 64-bit (x has 5.4e9 elements at B = 32,
//     S = 32768, H = 80, P = 64).
// Limits: P <= 64 and N <= 128 (one register tile covers the (P, N) state),
// Q <= 1024 (chunk_scan's staged cum and dt), every grid under 2^31 blocks;
// the launcher refuses others.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;            // rows (and k depth) of one shared tile
constexpr int kLd = kT + 4;       // row stride of a 64-wide shared tile (16-byte rows, 4 mod 32 banks)
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kLdN = kMaxN + 4;   // row stride of a (., N) shared tile
constexpr int kMaxQ = 1024;

constexpr int kScanWarps = 8;         // cumsum: one warp per (b, chunk, h) stream
constexpr int kTileThreads = 128;     // chunk_cb, chunk_scan: 8 x 16 threads, a 64 x 64 tile
constexpr int kStateThreads = 256;    // chunk_state: 8 x 32 threads, the 64 x 128 (P, N) state
constexpr int kStateRows = 32;        // chunk_state: steps per shared tile
constexpr int kPassThreads = 256;     // state_pass
constexpr int kPassPer = 4;           // state_pass: state elements carried per thread
constexpr int kTileBlocks = 3;        // chunk_cb, chunk_scan: blocks per SM (registers: 170 a thread)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// out[0 .. valid) = v[0 .. valid), valid <= 4: one 16-byte store for a whole,
// aligned fp32 run.
template <typename T>
__device__ __forceinline__ void store4(T* out, const float (&v)[4], int valid) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < valid) put(out + j, v[j]);
}
__device__ __forceinline__ void store4(float* out, const float (&v)[4], int valid) {
  if (valid >= 4 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < valid) out[j] = v[j];
}

// This thread's 8x4 register tile: rows 8*ty .. 8*ty+7 and columns 4*tx ..
// 4*tx+3 of the block's output, kColGroups groups of 4 columns wide. A warp
// covers 4 ty x 8 tx, so that one k step's loads touch 4 distinct left and 8
// distinct right addresses (one shared-memory wavefront each).
template <int kColGroups>
__device__ __forceinline__ void tile_coords(int& ty, int& tx) {
  constexpr int kWarpsAcross = kColGroups / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  tx = (warp % kWarpsAcross) * 8 + (lane & 7);
  ty = (warp / kWarpsAcross) * 4 + (lane >> 3);
}

// acc[i][j] += Σ_k a[k][m0 + i] · b[k][n0 + j] over k < kDepth, both shared
// tiles k-major: three 16-byte loads per 32 FMAs.
template <int kDepth, int kLdA, int kLdB>
__device__ __forceinline__ void fma_tile(float (&acc)[8][4], const float* __restrict__ as,
                                         const float* __restrict__ bs, int m0, int n0) {
#pragma unroll 16
  for (int k = 0; k < kDepth; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(as + k * kLdA + m0);
    const float4 a1 = *reinterpret_cast<const float4*>(as + k * kLdA + m0 + 4);
    const float4 b = *reinterpret_cast<const float4*>(bs + k * kLdB + n0);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Elements k .. k+3 of a row of `count` elements, 0 past its end, in fp32:
// one 16-byte (fp32) or 8-byte (bf16) load when `vec` says the row starts on
// a 4-element boundary of aligned memory (k is a multiple of 4) and all four
// exist.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);   // bf16 -> fp32 is a 16-bit shift
  return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
}
template <typename T>
__device__ __forceinline__ float4 row4(const T* row, int k, int count, bool vec) {
  if (vec && k + 4 <= count) return load4(row + k);
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = k + j < count ? to_f32(row[k + j]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}
// Whether every row of `stride` elements starting at p starts on a 4-element
// boundary of 4-element-aligned memory, so that row4 may load whole vectors.
template <typename T>
__device__ __forceinline__ bool vec_rows(const T* p, int64_t stride) {
  return stride % 4 == 0 && (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0;
}

// A slab is the pair of shared tiles one k loop of fma_tile reads. Its values
// travel from global memory through registers, four consecutive elements of
// a row at a time: fetch_* reads f(r, k) = elements k .. k+3 of source row r,
// stash_* stores g(r, k, v) for each fetched value v.
struct Keep {
  template <typename V>
  __device__ __forceinline__ V operator()(int, int, V v) const { return v; }
};

// A 64 x 64 tile whose source rows run along k, stored transposed:
// dst[k * kLd + r]. Each warp step takes 8 consecutive k of 16 rows (two
// lanes a row): 32-byte source runs, and for each of the four scalar stores
// banks 16 (lane & 1) + (lane >> 1) + const, all distinct.
template <int kNT>
constexpr int kPer4 = kT * kT / (4 * kNT);

template <int kNT, typename F>
__device__ __forceinline__ void fetch_transposed(float4 (&v)[kPer4<kNT>], F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kPer4<kNT>; ++i) {
    const int e = warp + i * (kNT / 32);
    v[i] = f((e >> 3) * 16 + (lane >> 1), (e & 7) * 8 + (lane & 1) * 4);
  }
}

template <int kNT, typename G>
__device__ __forceinline__ void stash_transposed(float* dst, const float4 (&v)[kPer4<kNT>],
                                                 G g) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kPer4<kNT>; ++i) {
    const int e = warp + i * (kNT / 32);
    const int r = (e >> 3) * 16 + (lane >> 1), k = (e & 7) * 8 + (lane & 1) * 4;
    dst[(k + 0) * kLd + r] = g(r, k + 0, v[i].x);
    dst[(k + 1) * kLd + r] = g(r, k + 1, v[i].y);
    dst[(k + 2) * kLd + r] = g(r, k + 2, v[i].z);
    dst[(k + 3) * kLd + r] = g(r, k + 3, v[i].w);
  }
}

// A tile of kCols columns stored in source order: dst[r * kLdDst + k], one
// 16-byte store per four elements.
template <int kNT, int kCols, int kPer, typename F>
__device__ __forceinline__ void fetch_rows(float4 (&v)[kPer], F f) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kNT;
    v[i] = f(e / (kCols / 4), (e % (kCols / 4)) * 4);
  }
}

template <int kNT, int kCols, int kLdDst, int kPer, typename G>
__device__ __forceinline__ void stash_rows(float* dst, const float4 (&v)[kPer], G g) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kNT, r = e / (kCols / 4), k = (e % (kCols / 4)) * 4;
    *reinterpret_cast<float4*>(dst + r * kLdDst + k) = g(r, k, v[i]);
  }
}

// Phase 0. Stream (b * nc + c) * H + h, so that a block's warps are
// neighbouring heads sharing dt's sectors. Each lane sums a run of
// ceil(Q/32) steps, the warp scans the runs' totals, each lane writes its run.
__global__ void __launch_bounds__(kScanWarps * 32)
ssd_scan_cumsum_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                       double* __restrict__ cum, int64_t streams, int64_t S, int H, int Q) {
  const int lane = threadIdx.x & 31;
  const int64_t stream = (int64_t)blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  if (stream >= streams) return;   // whole warps
  const int h = (int)(stream % H);
  const int64_t bc = stream / H, nc = S / Q, b = bc / nc;
  const double ah = a[h];
  const float* d = dt + bc * Q * H + h;                  // step t at d[t * H]
  double* out = cum + (b * H + h) * S + (bc - b * nc) * Q;
  const int run = (Q + 31) / 32, t0 = lane * run, t1 = min(Q, t0 + run);
  double total = 0.0;
  for (int t = t0; t < t1; ++t) total += ah * (double)d[(int64_t)t * H];
  double incl = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  double acc = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) acc = 0.0;
  for (int t = t0; t < t1; ++t) {
    acc += ah * (double)d[(int64_t)t * H];
    out[t] = acc;
  }
}

// Phase 1. Block (b * nc + c) * npairs + pair, pair = it (it + 1) / 2 + jt
// with jt <= it: G[t][u] for the 64x64 tile (it, jt), depth N.
template <typename T>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
ssd_scan_chunk_cb_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
                         float* __restrict__ g, int N, int Q) {
  __shared__ __align__(16) float ct[kT * kLd];   // [n][t]  C rows of the row tile
  __shared__ __align__(16) float bt[kT * kLd];   // [n][u]  B rows of the column tile
  const int ntiles = (Q + kT - 1) / kT, npairs = ntiles * (ntiles + 1) / 2;
  const int64_t bc = blockIdx.x / npairs;        // b * nc + c
  int jt = (int)(blockIdx.x % npairs), it = 0;
  while (jt > it) jt -= ++it;
  const int t0 = it * kT, u0 = jt * kT;
  const T* crow = cm + bc * Q * N;               // step t at crow + t * N
  const T* brow = bm + bc * Q * N;
  int ty, tx;
  tile_coords<kT / 4>(ty, tx);

  const bool vec = vec_rows(crow, N) && vec_rows(brow, N);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 cv[kPer4<kTileThreads>], bv[kPer4<kTileThreads>];
  const auto fetch = [&](int n0) {
    fetch_transposed<kTileThreads>(cv, [&](int r, int k) {
      const int t = t0 + r;
      return t < Q ? row4(crow + (int64_t)t * N, n0 + k, N, vec) : zero;
    });
    fetch_transposed<kTileThreads>(bv, [&](int r, int k) {
      const int u = u0 + r;
      return u < Q ? row4(brow + (int64_t)u * N, n0 + k, N, vec) : zero;
    });
  };
  float acc[8][4] = {};
  fetch(0);
  for (int n0 = 0; n0 < N; n0 += kT) {
    __syncthreads();   // the previous slab is consumed
    stash_transposed<kTileThreads>(ct, cv, Keep());
    stash_transposed<kTileThreads>(bt, bv, Keep());
    __syncthreads();
    if (n0 + kT < N) fetch(n0 + kT);
    fma_tile<kT, kLd, kLd>(acc, ct, bt, 8 * ty, 4 * tx);
  }
  float* gb = g + bc * Q * Q;
  const int u = u0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + 8 * ty + i;
    if (t < Q && u < Q) store4(gb + (int64_t)t * Q + u, acc[i], Q - u);
  }
}

// Phase 2. Block (b * nc + c) * H + h: s_c[p][n] = Σ_u x[u][p] w_u B[u][n],
// w_u = exp(cum_Q - cum_u) dt_u, over slabs of kStateRows steps.
template <typename T>
__global__ void __launch_bounds__(kStateThreads, 2)
ssd_scan_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                            const T* __restrict__ bm, const double* __restrict__ cum,
                            float* __restrict__ states, int64_t S, int H, int P, int N,
                            int Q) {
  constexpr int kPerX = kStateRows * kMaxP / (4 * kStateThreads);
  constexpr int kPerB = kStateRows * kMaxN / (4 * kStateThreads);
  __shared__ __align__(16) float xs[kStateRows * kLd];    // [u][p]  x_u w_u
  __shared__ __align__(16) float bs[kStateRows * kLdN];   // [u][n]  B_u
  __shared__ float w[kMaxQ];
  const int h = (int)(blockIdx.x % H);
  const int64_t bc = blockIdx.x / H, nc = S / Q, b = bc / nc;
  const int64_t row0 = bc * Q, HP = (int64_t)H * P;
  const double* cu = cum + (b * H + h) * S + (bc - b * nc) * Q;
  const double last = cu[Q - 1];
  for (int u = threadIdx.x; u < Q; u += kStateThreads)
    w[u] = expf((float)(last - cu[u])) * dt[(row0 + u) * H + h];
  const T* xb = x + row0 * HP + (int64_t)h * P;   // step u at xb + u * HP
  const T* bb = bm + row0 * N;                    // step u at bb + u * N
  int ty, tx;
  tile_coords<kMaxN / 4>(ty, tx);

  const bool vec_x = vec_rows(xb, HP), vec_b = vec_rows(bb, N);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 xv[kPerX], bv[kPerB];
  const auto fetch = [&](int u0) {
    fetch_rows<kStateThreads, kMaxP>(xv, [&](int r, int p) {
      const int u = u0 + r;
      return u < Q ? row4(xb + (int64_t)u * HP, p, P, vec_x) : zero;
    });
    fetch_rows<kStateThreads, kMaxN>(bv, [&](int r, int n) {
      const int u = u0 + r;
      return u < Q ? row4(bb + (int64_t)u * N, n, N, vec_b) : zero;
    });
  };
  float acc[8][4] = {};
  fetch(0);
  for (int u0 = 0; u0 < Q; u0 += kStateRows) {
    __syncthreads();   // w is complete; the previous slab is consumed
    stash_rows<kStateThreads, kMaxP, kLd>(xs, xv, [&](int r, int, float4 v) {
      const float s = u0 + r < Q ? w[u0 + r] : 0.f;
      return make_float4(v.x * s, v.y * s, v.z * s, v.w * s);
    });
    stash_rows<kStateThreads, kMaxN, kLdN>(bs, bv, Keep());
    __syncthreads();
    if (u0 + kStateRows < Q) fetch(u0 + kStateRows);
    fma_tile<kStateRows, kLd, kLdN>(acc, xs, bs, 8 * ty, 4 * tx);
  }
  float* st = states + (bc * H + h) * (int64_t)P * N;
  const int n = 4 * tx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = 8 * ty + i;
    if (p < P && n < N) store4(st + (int64_t)p * N + n, acc[i], N - n);
  }
}

// Phase 3. Block (b * H + h) * slices + slice: each thread carries kPassPer
// elements of the (P, N) state through the chunks, the next chunk's
// contribution loaded before the current one is used.
__global__ void __launch_bounds__(kPassThreads)
ssd_scan_state_pass_kernel(float* __restrict__ states, const double* __restrict__ cum,
                           float* __restrict__ h_final, int64_t S, int H, int PN, int Q) {
  constexpr int kSpan = kPassThreads * kPassPer;
  const int slices = (PN + kSpan - 1) / kSpan;
  const int64_t bh = blockIdx.x / slices, nc = S / Q, b = bh / H, h = bh - b * H;
  const int e0 = (int)(blockIdx.x % slices) * kSpan + threadIdx.x;
  const int64_t step = (int64_t)H * PN;             // chunk c to chunk c + 1
  float* base = states + (b * nc * H + h) * PN;     // chunk c at base + c * step
  const double* last = cum + bh * S + (Q - 1);      // cum_Q of chunk c at last[c * Q]
  float hcur[kPassPer], next[kPassPer];
#pragma unroll
  for (int k = 0; k < kPassPer; ++k) {
    const int e = e0 + k * kPassThreads;
    hcur[k] = 0.f;
    next[k] = e < PN ? base[e] : 0.f;
  }
  for (int64_t c = 0; c < nc; ++c) {
    float cur[kPassPer];
#pragma unroll
    for (int k = 0; k < kPassPer; ++k) cur[k] = next[k];
    if (c + 1 < nc) {
#pragma unroll
      for (int k = 0; k < kPassPer; ++k) {
        const int e = e0 + k * kPassThreads;
        if (e < PN) next[k] = base[(c + 1) * step + e];
      }
    }
    const float decay = expf((float)last[c * Q]);
#pragma unroll
    for (int k = 0; k < kPassPer; ++k) {
      const int e = e0 + k * kPassThreads;
      if (e < PN) base[c * step + e] = hcur[k];
      hcur[k] = fmaf(decay, hcur[k], cur[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kPassPer; ++k) {
    const int e = e0 + k * kPassThreads;
    if (e < PN) h_final[bh * PN + e] = hcur[k];
  }
}

// Phase 4. Block ((b * nc + c) * ntiles + it) * H + h: neighbouring blocks are
// the heads of one row tile and read the same C rows and G tiles from L2.
// Slabs 0 .. nn-1 are the inter-chunk term (k = n), slabs nn .. nn+it the
// causal column tiles of the intra-chunk term (k = u).
template <typename T>
__global__ void __launch_bounds__(kTileThreads, kTileBlocks)
ssd_scan_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                           const T* __restrict__ cm, const double* __restrict__ cum,
                           const float* __restrict__ g, const float* __restrict__ h_in,
                           T* __restrict__ y, int64_t S, int H, int P, int N, int Q) {
  constexpr int kPer = kPer4<kTileThreads>;
  __shared__ __align__(16) float as[kT * kLd];   // [k][t]  C_t (k = n) or W[t][u] (k = u)
  __shared__ __align__(16) float bs[kT * kLd];   // [k][p]  h_in[p][n] (k = n) or x_u (k = u)
  __shared__ double cums[kMaxQ];                 // the chunk's cum, steps < t0 + 64
  __shared__ float dts[kMaxQ];
  const int ntiles = (Q + kT - 1) / kT;
  const int h = (int)(blockIdx.x % H);
  const int64_t rest = blockIdx.x / H, bc = rest / ntiles, nc = S / Q, b = bc / nc;
  const int it = (int)(rest % ntiles), t0 = it * kT, tend = min(Q, t0 + kT);
  const int64_t row0 = bc * Q, HP = (int64_t)H * P;
  const double* cu = cum + (b * H + h) * S + (bc - b * nc) * Q;
  for (int u = threadIdx.x; u < tend; u += kTileThreads) {
    cums[u] = cu[u];
    dts[u] = dt[(row0 + u) * H + h];
  }
  const T* crow = cm + row0 * N;                          // step t at crow + t * N
  const float* hb = h_in + (bc * H + h) * (int64_t)P * N; // h_in[p][n] at hb + p * N + n
  const T* xb = x + row0 * HP + (int64_t)h * P;           // step u at xb + u * HP
  const float* gb = g + bc * Q * Q;                       // G[t][u] at gb + t * Q + u
  int ty, tx;
  tile_coords<kT / 4>(ty, tx);

  const int nn = (N + kT - 1) / kT, slabs = nn + it + 1;
  const bool vec_c = vec_rows(crow, N), vec_h = vec_rows(hb, N), vec_g = vec_rows(gb, Q);
  const bool vec_x = vec_rows(xb, HP);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[8][4] = {};
  for (int slab = 0; slab < slabs; ++slab) {
    __syncthreads();   // cums, dts written; the previous slab is consumed
    float4 v[kPer];
    if (slab < nn) {
      const int n0 = slab * kT;
      fetch_transposed<kTileThreads>(v, [&](int r, int k) {
        const int t = t0 + r;
        return t < Q ? row4(crow + (int64_t)t * N, n0 + k, N, vec_c) : zero;
      });
      stash_transposed<kTileThreads>(as, v, Keep());
      fetch_transposed<kTileThreads>(v, [&](int r, int k) {
        return r < P ? row4(hb + (int64_t)r * N, n0 + k, N, vec_h) : zero;
      });
      stash_transposed<kTileThreads>(bs, v, Keep());
    } else {
      // Causal columns only: u0 + k <= t. A vector's last columns may pass
      // the diagonal; they lie in the diagonal tile, which chunk_cb writes
      // whole, and the stash masks them.
      const int u0 = (slab - nn) * kT;
      fetch_transposed<kTileThreads>(v, [&](int r, int k) {
        const int t = t0 + r;
        return t < Q && u0 + k <= t ? row4(gb + (int64_t)t * Q, u0 + k, Q, vec_g) : zero;
      });
      // W[t][u] = G[t][u] exp(cum_t - cum_u) dt_u, masked before exp: above
      // the diagonal cum_t - cum_u > 0 may overflow.
      stash_transposed<kTileThreads>(as, v, [&](int r, int k, float g) {
        const int t = t0 + r, u = u0 + k;
        return t < Q && u <= t ? g * expf((float)(cums[t] - cums[u])) * dts[u] : 0.f;
      });
      fetch_rows<kTileThreads, kT>(v, [&](int r, int p) {
        const int u = u0 + r;
        return u < Q ? row4(xb + (int64_t)u * HP, p, P, vec_x) : zero;
      });
      stash_rows<kTileThreads, kT, kLd>(bs, v, Keep());
    }
    __syncthreads();
    if (slab == nn) {
      // The inter-chunk term is complete: y_t = exp(cum_t) C_t h_inᵀ so far.
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = t0 + 8 * ty + i;
        const float e = t < Q ? expf((float)cums[t]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
    }
    fma_tile<kT, kLd, kLd>(acc, as, bs, 8 * ty, 4 * tx);
  }

  const int p = 4 * tx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + 8 * ty + i;
    if (t < Q && p < P) store4(y + (row0 + t) * HP + (int64_t)h * P + p, acc[i], P - p);
  }
}

int blocks_for(int64_t n, int64_t per, unsigned* out) {
  const int64_t blocks = (n + per - 1) / per;
  if (blocks < 1 || blocks > INT_MAX) return 1;
  *out = (unsigned)blocks;
  return 0;
}

template <typename T>
int launch(const T* x, const float* dt, const float* a, const T* bm, const T* cm, T* y,
           float* h_final, double* cum, float* g, float* states, int64_t B, int64_t S,
           int H, int P, int N, int Q, cudaStream_t stream) {
  const int64_t nc = S / Q, ntiles = (Q + kT - 1) / kT, PN = (int64_t)P * N;
  const int64_t slices = (PN + kPassThreads * kPassPer - 1) / (kPassThreads * kPassPer);
  unsigned g0, g1, g2, g3, g4;
  if (blocks_for(B * nc * H, kScanWarps, &g0) ||
      blocks_for(B * nc * (ntiles * (ntiles + 1) / 2), 1, &g1) ||
      blocks_for(B * nc * H, 1, &g2) || blocks_for(B * H * slices, 1, &g3) ||
      blocks_for(B * nc * ntiles * H, 1, &g4))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  ssd_scan_cumsum_kernel<<<g0, kScanWarps * 32, 0, stream>>>(dt, a, cum, B * nc * H, S, H, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_scan_chunk_cb_kernel<T><<<g1, kTileThreads, 0, stream>>>(bm, cm, g, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_scan_chunk_state_kernel<T><<<g2, kStateThreads, 0, stream>>>(x, dt, bm, cum, states, S,
                                                                    H, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_scan_state_pass_kernel<<<g3, kPassThreads, 0, stream>>>(states, cum, h_final, S, H,
                                                              (int)PN, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_scan_chunk_scan_kernel<T><<<g4, kTileThreads, 0, stream>>>(x, dt, cm, cum, g, states, y,
                                                                  S, H, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// x, b, c, y: fp32 (bf16 == 0) or bf16 (bf16 == 1), contiguous (B,S,H,P) /
// (B,S,N); dt (B,S,H) and a (H,) fp32; h_final (B,H,P,N) fp32. Workspaces,
// allocated by the caller and overwritten: cum (B,H,S) fp64, g (B,S/Q,Q,Q)
// fp32, states (B,S/Q,H,P,N) fp32 (left holding the state entering each
// chunk). Launches the five phases in order on `stream`. Returns a
// cudaError_t code, 0 on success; cudaErrorInvalidValue for shapes outside
// the kernels' limits.
extern "C" int ssd_scan_launch(const void* x, const float* dt, const float* a,
                               const void* b, const void* c, void* y, float* h_final,
                               double* cum, float* g, float* states, int64_t B, int64_t S,
                               int64_t H, int64_t P, int64_t N, int64_t Q, int bf16,
                               void* stream) {
  if (B < 1 || H < 1 || H > INT_MAX || P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 ||
      Q > kMaxQ || S < Q || S % Q != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch((const __nv_bfloat16*)x, dt, a, (const __nv_bfloat16*)b,
                  (const __nv_bfloat16*)c, (__nv_bfloat16*)y, h_final, cum, g, states, B, S,
                  (int)H, (int)P, (int)N, (int)Q, st);
  return launch((const float*)x, dt, a, (const float*)b, (const float*)c, (float*)y, h_final,
                cum, g, states, B, S, (int)H, (int)P, (int)N, (int)Q, st);
}
