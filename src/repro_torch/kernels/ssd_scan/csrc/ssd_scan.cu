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
// x, B, C are fp32 or bf16 (one dtype); dt and a fp32. chunk_state and
// chunk_scan run their products on the tensor cores (mma.sync TF32 as
// 3xTF32, ssd_scan_mma.cuh; 2xTF32 where an operand is bf16, which is exact
// in TF32); cumsum, chunk_cb and state_pass run in fp32 on the CUDA cores.
// No library call. y comes out in x's dtype, the final state h_final
// (B, H, P, N) in fp32. S must be a multiple of Q (the wrapper pads with
// dt = 0 no-op steps).
//
// The chain, launched in order on the caller's stream by ssd_scan_launch;
// the caller allocates the three workspaces:
//   0. cumsum      per (b, chunk, h), one warp: cum (B, H, S) fp64, a
//                  shuffle scan over runs of ceil(Q/32) steps per lane.
//   1. chunk_cb    per (b, chunk, causal 64x64 tile pair): G = C_c B_cᵀ
//                  (B, nc, Q, Q) fp32, formed once for all H heads, which
//                  share one B/C group; the heads then read it from L2.
//   2. chunk_state per (b, chunk, h, column tile of 16, 32 or 64 as N
//                  needs): the chunk's own state contribution s_c = (x ⊙
//                  w)ᵀ B, w_u = exp(cum_Q - cum_u) dt_u, into states
//                  (B, nc, H, P, N) fp32; a (P, N) product of depth Q.
//   3. state_pass  per (b, h, slice of P·N): walks the chunks in order and
//                  turns states[c] in place into the state entering chunk c,
//                  h_in[c] = exp(cum_Q[c-1]) h_in[c-1] + s_{c-1}, h_in[0] = 0;
//                  writes h_final. Elementwise, memory-bound.
//   4. chunk_scan  per (b, chunk, 64-row tile, h): y from C_t h_in[c]ᵀ and
//                  the causal 64-column tiles of W = G ⊙ exp(cum_t - cum_u) dt_u
//                  times x.
//
// What bounds it on this card: operations. At mamba2-2.7b's training
// microbatch (B = 2, S = 2048, H = 80, P = 64, N = 128, Q = 256, fp32) the
// function needs ≈ 16.3 GFLOP (≈ 0.24 ms on the fp32 CUDA cores, ≈ 0.10 ms
// as 3xTF32 on the tensor cores; chip_smoke.py's ssd_fwd_work) against
// 0.18 GB of HBM traffic (0.05 ms); chunk_scan executes ≈ 12.1 GFLOP of it
// (C h_inᵀ 5.4, the causal 64x64 tiles of W x 6.7) and chunk_state 5.4.
// With bf16 x, B, C every product but CBᵀ has one fp32 operand (W, h_in, x
// scaled by w) and takes two TF32 products.
//
// What held chunk_state and chunk_scan back, and what they do about it:
//   * both ran every product on the fp32 CUDA cores (8x4 register tiles,
//     three 16-byte shared loads per 32 FMAs; chunk_scan at 36% of the fp32
//     rate): they run on mma.sync m16n8k8 TF32 through ssd_scan_mma.cuh,
//     the backward chain's routine. chunk_state is mma_tile's product, as
//     the backward's chunk_dstate forms D: w a per-k scale of x (KScale),
//     its column tile 16, 32 or 64 wide as N is (hymba's N = 16), operands
//     by cp.async into a four-stage ring. chunk_scan's inter-chunk term is
//     one mma_tile product with the block's C rows resident and h_in
//     streamed; its exp(cum_t) is a row scale of the accumulator;
//   * chunk_scan spilled 132 bytes (124 in bf16) and formed W through
//     registers with an exp per element of every causal tile: W is formed
//     once per column tile from G in registers, masked before the exp, and
//     stored to shared memory already split into TF32 big and small planes
//     (Tf32Split), so that no fragment load splits it again (the split
//     costs three instructions per element, beside each HMMA); x arrives by
//     cp.async into the ring. Off the diagonal tile the exp per element
//     goes: anchored on the step before the row tile, r = t0 - 1,
//     exp(cum_t - cum_u) = exp(cum_t - cum_r) exp(cum_r - cum_u), so W's
//     column scale exp(cum_r - cum_u) dt_u (one exp per column) multiplies G
//     and the row scale exp(cum_t - cum_r) the accumulator once, after the
//     off-diagonal tiles (the inter-chunk term, added before them, carries
//     exp(cum_r) for the same reason). Both factors are <= 1 where cum does
//     not rise; a block with an exponent of that form > 0 (a·dt > 0, which
//     no model has) takes the per-element form, as the diagonal tile does.
//
// Design points:
//   * chunk_cb keeps the CUDA cores (0.34 of 16.3 GFLOP): 64x64 output
//     tiles, an 8x4 register tile per thread, operands k-major in shared
//     memory; global reads take four consecutive elements of a row at once
//     (one 16-byte fp32 or 8-byte bf16 load where the rows are aligned);
//   * cp.async moves 16-byte chunks where P and N are multiples of a
//     chunk's elements (4 fp32, 8 bf16) and every base is 16-byte aligned,
//     else one element (4 bytes, or a load and a store for bf16);
//   * chunk_scan's shared memory is dynamic (56 KB: three blocks an SM), its
//     limit set once per device by ssd_scan_init, which the wrapper calls
//     before the first launch there; the attribute belongs to the function,
//     so a launch is captured in a CUDA graph as any other. The rest is
//     static and under 48 KB;
//   * the cumsum stays in fp64, and every exponent (cum_t - cum_u,
//     cum_Q - cum_u, cum_t, cum_Q and the anchored ones) is formed in fp64
//     and rounded once before an fp32 exp: over a 256-step chunk cum
//     reaches -10^3 with unit-normal inputs, where an fp32 difference would
//     lose the digits the sequential recurrence keeps;
//   * the causal mask is applied before exp (above the diagonal cum_t -
//     cum_u is positive and may overflow); ragged tile edges (Q, P or N not
//     a multiple of the tile) are zero-filled and masked;
//   * no atomics and no split of a sum across blocks: every output is
//     written by one thread in a fixed order, so launches repeat bitwise;
//   * every global offset is 64-bit (x has 5.4e9 elements at B = 32,
//     S = 32768, H = 80, P = 64).
// Limits: P <= 64 (one 64-row or 64-column tile), N <= 128 (chunk_scan's
// resident C rows), Q <= 1024, every grid under 2^31 blocks; the launcher
// refuses others.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "ssd_scan_mma.cuh"

namespace {

constexpr int kLd = kT + 4;           // row stride of chunk_cb's 64-wide shared tiles (16-byte rows, 4 mod 32 banks)
constexpr int kScanWarps = 8;         // cumsum: one warp per (b, chunk, h) stream
constexpr int kTileThreads = 128;     // chunk_cb: 8 x 16 threads, a 64 x 64 tile
constexpr int kPassThreads = 256;     // state_pass
constexpr int kPassPer = 4;           // state_pass: state elements carried per thread
constexpr int kTileBlocks = 3;        // chunk_cb: blocks per SM (registers: 170 a thread)

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

// Phase 2. Block ((b * nc + c) * H + h) * ncols + col: s_c[p][n] for the
// column tile col of 16·NI, s_c = (x ⊙ w)ᵀ B with w_u = exp(cum_Q - cum_u)
// dt_u a per-k scale of x (KScale), as the backward's chunk_dstate forms D.
// Operands copied in chunks of 16 bytes (kV) or one element; x and B are T.
template <int NI, bool kV, typename T>
__global__ void __launch_bounds__(kThreads, 3)
ssd_scan_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                            const T* __restrict__ bm, const double* __restrict__ cum,
                            float* __restrict__ states, int64_t S, int H, int P, int N, int Q) {
  constexpr int kTN = 16 * NI;
  __shared__ __align__(16) float ring[2 * kRingStages * kPlane];
  __shared__ float w[kMaxQ];   // zero past Q to the last slab's end
  const int ncols = (N + kTN - 1) / kTN;
  const int64_t bch = blockIdx.x / ncols, bc = bch / H, nc = S / Q, b = bc / nc;
  const int h = (int)(bch % H), n0 = (int)(blockIdx.x % ncols) * kTN;
  const int64_t row0 = bc * Q, HP = (int64_t)H * P;
  const double* cu = cum + (b * H + h) * S + (bc - b * nc) * Q;
  const double last = cu[Q - 1];
  for (int u = threadIdx.x; u < (Q + kMK - 1) / kMK * kMK; u += kThreads)
    w[u] = u < Q ? expf((float)(last - cu[u])) * dt[(row0 + u) * H + h] : 0.f;
  const T* xb = x + row0 * HP + (int64_t)h * P;   // step u at xb + u * HP
  const T* bb = bm + row0 * N;                    // step u at bb + u * N
  float acc[2][NI][4];
  zero(acc);
  mma_tile<kRingStages, kV, false, false, false, NI, T, T>(acc, ring, ring + kRingStages * kPlane, Q,
      [&](int p, int u) { return p < P ? xb + (int64_t)u * HP + p : nullptr; },
      [&](int u, int n) { return n0 + n < N ? bb + (int64_t)u * N + n0 + n : nullptr; },
      KScale{w});
  float* out = states + bch * (int64_t)P * N;
  each_frag<NI>([&](int mi, int ni, int e, int r, int c) {
    if (r < P && n0 + c < N) out[(int64_t)r * N + n0 + c] = acc[mi][ni][e];
  });
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

// Phase 4's dynamic shared memory: the resident tile (the block's C rows,
// then W's split planes), mma_tile's ring, cum_t and cum_u (fp64), then
// dt_u, W's column scale, the inter-chunk term's row scale and the factored
// form's row scale, 64 each.
constexpr int kScanTileWords = 2 * kSplitWords;
constexpr int kLdCf = 2 * kT + 4;   // row stride of the fp32 C rows (N <= 128)
constexpr int kLdCh = 2 * kT + 8;   // of the bf16 ones (16-byte chunks stay aligned)
static_assert(kT * kLdCf <= kScanTileWords && kT * kLdCh / 2 <= kScanTileWords,
              "the C rows fit the split planes' words");
constexpr size_t scan_smem_bytes() {
  return sizeof(float) * (kScanTileWords + kRingStages * kPlane + 4 * kT) +
         sizeof(double) * 2 * kT;
}

// Phase 4. Block ((b * nc + c) * ntiles + it) * H + h: neighbouring blocks are
// the heads of one row tile and read the same C rows and G tiles from L2.
// y[t][p] for the 64 rows t of tile it: the inter-chunk term C_t h_inᵀ over
// N (C rows resident, h_in through the ring), then per causal column tile
// u0 = 64 j, j <= it, W's tile formed from G into split planes and W x over
// the tile (x through the ring). Operands copied in chunks of 16 bytes (kV)
// or one element (two blocks an SM: the one-element copy loops take the
// registers that three would leave); x, C and y are T.
template <bool kV, typename T>
__global__ void __launch_bounds__(kThreads, kV ? 3 : 2)
ssd_scan_chunk_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                           const T* __restrict__ cm, const double* __restrict__ cum,
                           const float* __restrict__ g, const float* __restrict__ h_in,
                           T* __restrict__ y, int64_t S, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kLdC = IsBf16<T> ? kLdCh : kLdCf;
  float* tiles = reinterpret_cast<float*>(smem);
  float* ring = tiles + kScanTileWords;
  double* cum_t = reinterpret_cast<double*>(ring + kRingStages * kPlane);
  double* cum_u = cum_t + kT;
  float* dt_u = reinterpret_cast<float*>(cum_u + kT);
  float* col = dt_u + kT;     // the factored form's exp(cum_r - cum_u) dt_u
  float* row = col + kT;      // the inter-chunk term's exp(cum_t), or exp(cum_r)
  float* rfac = row + kT;     // the factored form's exp(cum_t - cum_r)
  const int tid = threadIdx.x;
  const int ntiles = (Q + kT - 1) / kT;
  const int h = (int)(blockIdx.x % H);
  const int64_t rest = blockIdx.x / H, bc = rest / ntiles, nc = S / Q, b = bc / nc;
  const int it = (int)(rest % ntiles), t0 = it * kT;
  const int64_t row0 = bc * Q, HP = (int64_t)H * P;
  const double* cu = cum + (b * H + h) * S + (bc - b * nc) * Q;
  const T* crow = cm + row0 * N;                          // step t at crow + t * N
  const float* hb = h_in + (bc * H + h) * (int64_t)P * N; // h_in[p][n] at hb + p * N + n
  const T* xb = x + row0 * HP + (int64_t)h * P;           // step u at xb + u * HP
  const float* gb = g + bc * (int64_t)Q * Q;              // G[t][u] at gb + t * Q + u

  // The block's C rows (columns past N zero, up to the last slab), resident
  // for the inter-chunk product; its first barrier waits for them.
  T* ct = reinterpret_cast<T*>(tiles);
  load_tile<kChunk<T, kV>>(ct, kLdC, kT, (N + kMK - 1) / kMK * kMK, [&](int r, int c) {
    return t0 + r < Q && c < N ? crow + (int64_t)(t0 + r) * N + c : nullptr;
  });
  cp_async_commit();
  // The anchor r = t0 - 1 (cum_r = 0 before the chunk). Whether any exponent
  // of the factored form is > 0: cum_r, cum_t - cum_r, cum_r - cum_u (u < t0).
  const double anchor = t0 > 0 ? cu[t0 - 1] : 0.0;
  bool rises = tid == 0 && anchor > 0.0;
  if (tid < kT) {
    const double c = t0 + tid < Q ? cu[t0 + tid] : anchor;   // rows past Q: scale 1 on a zero row
    cum_t[tid] = c;
    rises |= c > anchor;
  }
  for (int u = tid; u < t0; u += kThreads) rises |= anchor > cu[u];
  const bool per_element = __syncthreads_or(rises);   // cum_t is written
  if (tid < kT) {
    row[tid] = expf((float)(per_element ? cum_t[tid] : anchor));
    rfac[tid] = expf((float)(cum_t[tid] - anchor));
  }

  // The inter-chunk term: acc[t][p] = Σ_n C_t[n] h_in[p][n], then scaled by
  // exp(cum_t), or by exp(cum_r) ahead of the factored form's row scale.
  float acc[2][4][4];
  zero(acc);
  mma_tile<kRingStages, kV, true, true, true, 4, T, float>(acc, nullptr, ring, N, NoSource(),
      [&](int n, int p) { return p < P ? hb + (int64_t)p * N + n : nullptr; }, NoScale(), ct,
      kLdC);
  each_frag<4>([&](int mi, int ni, int e, int r, int) { acc[mi][ni][e] *= row[r]; });

  // The intra-chunk term, one causal column tile at a time. mma_tile's last
  // barrier frees the planes, the ring and the column arrays.
  constexpr int kPerG = kT * kT / (4 * kThreads);
  const bool vec_g = vec_rows(gb, Q);
  uint32_t* planes = reinterpret_cast<uint32_t*>(tiles);
  for (int j = 0; j <= it; ++j) {
    const int u0 = j * kT;
    const bool diag = j == it, factored = !diag && !per_element;
    if (tid < kT) {
      const int u = u0 + tid;
      const double c = u < Q ? cu[u] : 0.0;
      const float d = u < Q ? dt[(row0 + u) * H + h] : 0.f;
      cum_u[tid] = c;
      dt_u[tid] = d;
      col[tid] = factored ? expf((float)(anchor - c)) * d : 0.f;
    }
    // G's tile into registers: rows e / 16, four columns at (e % 16) * 4;
    // on the diagonal tile only vectors that reach the causal part.
    float4 gv[kPerG];
#pragma unroll
    for (int i = 0; i < kPerG; ++i) {
      const int e = tid + i * kThreads, r = e / (kT / 4), c = e % (kT / 4) * 4, t = t0 + r;
      gv[i] = t < Q && (!diag || u0 + c <= t) ? row4(gb + (int64_t)t * Q, u0 + c, Q, vec_g)
                                                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if (diag && !per_element)   // every off-diagonal tile is in: their row scale
      each_frag<4>([&](int mi, int ni, int e, int r, int) { acc[mi][ni][e] *= rfac[r]; });
    __syncthreads();   // cum_u, dt_u, col are written
    // W[t][u] = G[t][u] exp(cum_t - cum_u) dt_u (masked before exp: above the
    // diagonal cum_t - cum_u > 0 may overflow), or G[t][u] col[u], split.
#pragma unroll
    for (int i = 0; i < kPerG; ++i) {
      const int e = tid + i * kThreads, r = e / (kT / 4), c = e % (kT / 4) * 4, t = t0 + r;
      const float gg[4] = {gv[i].x, gv[i].y, gv[i].z, gv[i].w};
      uint32_t big[4], small[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int u = u0 + c + k;
        const float wv = factored ? gg[k] * col[c + k]
                         : t < Q && u <= t
                             ? gg[k] * expf((float)(cum_t[r] - cum_u[c + k])) * dt_u[c + k]
                             : 0.f;
        split_tf32(wv, big[k], small[k]);
      }
      *reinterpret_cast<uint4*>(planes + r * kLdW + c) = make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(planes + kSplitWords + r * kLdW + c) =
          make_uint4(small[0], small[1], small[2], small[3]);
    }
    mma_tile<kRingStages, kV, true, false, true, 4, Tf32Split, T>(acc, nullptr, ring,
        min(kT, Q - u0), NoSource(),
        [&](int k, int p) { return p < P ? xb + (int64_t)(u0 + k) * HP + p : nullptr; },
        NoScale(), reinterpret_cast<const Tf32Split*>(planes), kLdW);
  }

  each_frag<4>([&](int mi, int ni, int e, int r, int p) {
    const int t = t0 + r;
    if (t < Q && p < P) put(y + (row0 + t) * HP + (int64_t)h * P + p, acc[mi][ni][e]);
  });
}

int blocks_for(int64_t n, int64_t per, unsigned* out) {
  const int64_t blocks = (n + per - 1) / per;
  if (blocks < 1 || blocks > INT_MAX) return 1;
  *out = (unsigned)blocks;
  return 0;
}

// The chain's operands; x, B, C and y of element type T.
template <typename T>
struct Chain {
  const T *x, *b, *c;
  const float *dt, *a;
  T* y;
  float* h_final;
  double* cum;
  float *g, *states;
  int64_t B, S, H, P, N, Q;
};

// Whether chunk_state's and chunk_scan's operands move in 16-byte chunks: P
// and N multiples of a chunk's elements of T (4 fp32, 8 bf16) and every
// copied base 16-byte aligned.
template <typename T>
bool chunks_of_16(const Chain<T>& k) {
  const void* const bases[] = {k.x, k.b, k.c, k.states};
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  constexpr int kE = kChunk<T, true>;
  return k.P % kE == 0 && k.N % kE == 0;
}

template <int NI, bool kV, typename T>
void launch_state(const Chain<T>& k, unsigned grid, cudaStream_t st) {
  ssd_scan_chunk_state_kernel<NI, kV, T><<<grid, kThreads, 0, st>>>(
      k.x, k.dt, k.b, k.cum, k.states, k.S, (int)k.H, (int)k.P, (int)k.N, (int)k.Q);
}

template <bool kV, typename T>
void launch_state(const Chain<T>& k, int ni, unsigned grid, cudaStream_t st) {
  if (ni == 1) launch_state<1, kV>(k, grid, st);
  else if (ni == 2) launch_state<2, kV>(k, grid, st);
  else launch_state<4, kV>(k, grid, st);
}

template <bool kV, typename T>
void launch_scan(const Chain<T>& k, unsigned grid, cudaStream_t st) {
  ssd_scan_chunk_scan_kernel<kV, T><<<grid, kThreads, scan_smem_bytes(), st>>>(
      k.x, k.dt, k.c, k.cum, k.g, k.states, k.y, k.S, (int)k.H, (int)k.P, (int)k.N, (int)k.Q);
}

// Launches phases [first, last] of the chain (numbered as above, 0..4).
template <typename T>
int launch_phases(const Chain<T>& k, int first, int last, cudaStream_t stream) {
  const int64_t B = k.B, S = k.S, H = k.H, P = k.P, N = k.N, Q = k.Q;
  if (B < 1 || H < 1 || H > INT_MAX || P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 ||
      Q > kMaxQ || S < Q || S % Q != 0 || first < 0 || last > 4)
    return (int)cudaErrorInvalidValue;
  const int64_t nc = S / Q, ntiles = (Q + kT - 1) / kT, PN = P * N;
  const int64_t slices = (PN + kPassThreads * kPassPer - 1) / (kPassThreads * kPassPer);
  const int ni = N <= 16 ? 1 : N <= 32 ? 2 : 4;
  const int64_t ncols = (N + 16 * ni - 1) / (16 * ni);
  const bool vec = chunks_of_16(k);
  unsigned g0, g1, g2, g3, g4;
  if (blocks_for(B * nc * H, kScanWarps, &g0) ||
      blocks_for(B * nc * (ntiles * (ntiles + 1) / 2), 1, &g1) ||
      blocks_for(B * nc * H * ncols, 1, &g2) || blocks_for(B * H * slices, 1, &g3) ||
      blocks_for(B * nc * ntiles * H, 1, &g4))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  for (int phase = first; phase <= last; ++phase) {
    switch (phase) {
      case 0:
        ssd_scan_cumsum_kernel<<<g0, kScanWarps * 32, 0, stream>>>(k.dt, k.a, k.cum, B * nc * H,
                                                                   S, (int)H, (int)Q);
        break;
      case 1:
        ssd_scan_chunk_cb_kernel<T><<<g1, kTileThreads, 0, stream>>>(k.b, k.c, k.g, (int)N,
                                                                     (int)Q);
        break;
      case 2:
        if (vec) launch_state<true>(k, ni, g2, stream);
        else launch_state<false>(k, ni, g2, stream);
        break;
      case 3:
        ssd_scan_state_pass_kernel<<<g3, kPassThreads, 0, stream>>>(k.states, k.cum, k.h_final,
                                                                    S, (int)H, (int)PN, (int)Q);
        break;
      default:
        if (vec) launch_scan<true>(k, g4, stream);
        else launch_scan<false>(k, g4, stream);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

int launch_dtype(int first, int last, const void* x, const float* dt, const float* a,
                 const void* b, const void* c, void* y, float* h_final, double* cum, float* g,
                 float* states, int64_t B, int64_t S, int64_t H, int64_t P, int64_t N, int64_t Q,
                 int bf16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16 == 1) {
    using T = __nv_bfloat16;
    const Chain<T> k{static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(c),
                     dt, a, static_cast<T*>(y), h_final, cum, g, states, B, S, H, P, N, Q};
    return launch_phases(k, first, last, st);
  }
  if (bf16 != 0) return (int)cudaErrorInvalidValue;
  const Chain<float> k{static_cast<const float*>(x), static_cast<const float*>(b),
                       static_cast<const float*>(c), dt, a, static_cast<float*>(y), h_final, cum,
                       g, states, B, S, H, P, N, Q};
  return launch_phases(k, first, last, st);
}

template <bool kV, typename T>
cudaError_t set_smem_limit() {
  return cudaFuncSetAttribute(ssd_scan_chunk_scan_kernel<kV, T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)scan_smem_bytes());
}

}  // namespace

// Sets chunk_scan's dynamic shared memory limit on the current device, for
// both element types. Call once per device before the first launch there,
// outside any stream capture. Returns a cudaError_t code, 0 on success.
extern "C" int ssd_scan_init() {
  cudaError_t err = set_smem_limit<false, float>();
  if (err == cudaSuccess) err = set_smem_limit<true, float>();
  if (err == cudaSuccess) err = set_smem_limit<false, __nv_bfloat16>();
  if (err == cudaSuccess) err = set_smem_limit<true, __nv_bfloat16>();
  return (int)err;
}

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
  return launch_dtype(0, 4, x, dt, a, b, c, y, h_final, cum, g, states, B, S, H, P, N, Q, bf16,
                      stream);
}

// ssd_scan_launch's phase `phase` (0..4) alone, on workspaces that an earlier
// full launch filled: for timing each kernel. chunk_state overwrites the
// states workspace with the chunks' own contributions and state_pass turns
// it over again on every call.
extern "C" int ssd_scan_phase_launch(int phase, const void* x, const float* dt, const float* a,
                                     const void* b, const void* c, void* y, float* h_final,
                                     double* cum, float* g, float* states, int64_t B, int64_t S,
                                     int64_t H, int64_t P, int64_t N, int64_t Q, int bf16,
                                     void* stream) {
  if (phase < 0 || phase > 4) return (int)cudaErrorInvalidValue;
  return launch_dtype(phase, phase, x, dt, a, b, c, y, h_final, cum, g, states, B, S, H, P, N, Q,
                      bf16, stream);
}
