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
// x, B, C are fp32 or bf16 (one dtype); dt and a fp32. chunk_cb,
// chunk_state and chunk_scan run their products on the tensor cores
// (mma.sync TF32 as 3xTF32, ssd_scan_mma.cuh; 2xTF32 where an operand is
// bf16, which is exact in TF32, and one TF32 product where both are);
// cumsum runs in fp64 and state_pass in fp32 on the CUDA cores.
// No library call. y comes out in x's dtype, the final state h_final
// (B, H, P, N) in fp32. S must be a multiple of Q (the wrapper pads with
// dt = 0 no-op steps).
//
// The chain, launched in order on the caller's stream by ssd_scan_launch;
// the caller allocates the three workspaces:
//   0. cumsum      per (b, chunk, group of 8 heads), one warp a head: cum
//                  (B, H, S) fp64, a shuffle scan over runs of ceil(Q/32)
//                  steps per lane; dt read and cum written coalesced,
//                  through shared memory (directly where Q <= 32).
//   1. chunk_cb    per (b, chunk, 64 x 32 output tile of the causal 64x64
//                  tile pairs; 64 x 16 where the grid would not fill the
//                  card): G = C_c B_cᵀ (B, nc, Q, Q) fp32, a product of
//                  depth N formed once for all H heads, which share one B/C
//                  group; the heads then read it from L2.
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
// What held cumsum and chunk_cb back (their earlier CUDA-core forms), and
// what they do about it:
//   * cumsum gave each (b, chunk, h) stream one warp whose lanes read dt at
//     a stride of H (one load instruction touching 32 rows), read it twice
//     and wrote cum at a stride of ceil(Q/32) steps: a block now reads the
//     chunk's rows for 8 heads once, neighbouring threads on neighbouring
//     heads, into shared memory, scans there and writes each head's row of
//     cum with neighbouring lanes on neighbouring steps (where Q <= 32, one
//     step a lane, the earlier reads shared their sectors and its writes
//     were coalesced: it keeps them, without shared memory or a barrier,
//     which cost 0.4 µs on an H100 at the serving engine's 32-step
//     chunks). Its fp64
//     additions are the earlier kernel's, in the same order: cum is bitwise
//     the same;
//   * chunk_cb ran its 0.17 GFLOP as fp32 FMAs (8x4 register tiles, 8-byte
//     bf16 loads) in 1.2 waves of 64x64 tiles at mamba2-2.7b's training
//     microbatch and in 4 blocks at the serving engine's 32-token prompts:
//     it is mma_tile's product (C rows m-major, B rows n-major, depth N, by
//     cp.async into the four-stage ring), 64 x 32 output tiles (64 x 16
//     where a grid of those would not fill the card's 132 SMs).
//
// Design points:
//   * cp.async moves 16-byte chunks where P and N are multiples of a
//     chunk's elements (4 fp32, 8 bf16) and every base is 16-byte aligned,
//     else one element (4 bytes, or a load and a store for bf16);
//   * chunk_scan's shared memory is dynamic (56 KB: three blocks an SM), and
//     so is cumsum's (96·Q bytes and pads: 101 KB at Q = 1024); their
//     limits are set once per device by ssd_scan_init, which the wrapper
//     calls before the first launch there; the attribute belongs to the
//     function, so a launch is captured in a CUDA graph as any other. The
//     rest is static and under 48 KB;
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

constexpr int kScanHeads = 8;         // cumsum: heads per block, one warp each
constexpr int kPassThreads = 256;     // state_pass
constexpr int kPassPer = 4;           // state_pass: state elements carried per thread
constexpr int kCbBlocks = 4;          // chunk_cb: blocks per SM (40 KB of ring each)
constexpr int kCardSms = 132;         // the H100 SXM's SMs: chunk_cb's narrower tile below a wave

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

// cumsum's shared memory for chunk length Q: per head of the block, the
// chunk's cum (fp64, rows cumsum_row(Q) apart) and dt (fp32, rows
// cumsum_ld(Q) apart), step t of each at skew(t), one pad word after every
// 32 steps, so that the lanes' runs of steps fall in distinct banks;
// cumsum_ld is 4 mod 32, so that the copy's stores (4 steps x 8 heads a
// warp) do too.
__host__ __device__ constexpr int cumsum_row(int Q) { return Q + (Q - 1) / 32 + 1; }
__host__ __device__ constexpr int cumsum_ld(int Q) { return (cumsum_row(Q) + 27) / 32 * 32 + 4; }
__host__ __device__ constexpr size_t cumsum_smem_bytes(int Q) {
  return kScanHeads * (sizeof(double) * cumsum_row(Q) + sizeof(float) * cumsum_ld(Q));
}
__device__ __forceinline__ int skew(int t) { return t + (t >> 5); }

// The warp's fp64 inclusive scan of v(t) = a_h dt_t over the chunk's Q
// steps, in the earlier kernel's order: lane l sums its run of ceil(Q/32)
// steps, the warp scans the runs' totals, each lane accumulates its run,
// put(t, cum_t).
template <typename V, typename Put>
__device__ __forceinline__ void scan_runs(int Q, V v, Put put) {
  const int lane = threadIdx.x & 31;
  const int run = (Q + 31) / 32, t0 = lane * run, t1 = min(Q, t0 + run);
  double total = 0.0;
  for (int t = t0; t < t1; ++t) total += v(t);
  double incl = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  double acc = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) acc = 0.0;
  for (int t = t0; t < t1; ++t) put(t, acc += v(t));
}

// Phase 0. Block (b * nc + c) * ngroups + group: heads h0 .. h0 + 7, h0 =
// 8 · group, warp w head h0 + w. The chunk's dt rows for those heads are read
// once, neighbouring threads on neighbouring heads, into shared memory; each
// warp scans its head there (scan_runs) into shared memory and writes the
// head's row of cum, neighbouring lanes on neighbouring steps. Where Q <= 32
// a lane holds one step, so the warp reads its head's steps itself (the
// block's warps share each row's sector) and writes cum coalesced as it
// scans: no shared memory and no barrier.
__global__ void __launch_bounds__(kScanHeads * 32)
ssd_scan_cumsum_kernel(const float* __restrict__ dt, const float* __restrict__ a,
                       double* __restrict__ cum, int64_t S, int H, int Q) {
  constexpr int kN = kScanHeads * 32, kBatch = 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ngroups = (H + kScanHeads - 1) / kScanHeads;
  const int64_t bc = blockIdx.x / ngroups, nc = S / Q, b = bc / nc;
  const int h0 = (int)(blockIdx.x % ngroups) * kScanHeads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, h = h0 + warp;
  const float* d = dt + bc * Q * H + h0;   // step t, head h0 + j at d[t * H + j]
  double* out = cum + (b * H + h) * S + (bc - b * nc) * Q;
  if (Q <= 32) {
    if (h >= H) return;
    const double ah = a[h];
    const float x = lane < Q ? d[(int64_t)lane * H + warp] : 0.f;
    scan_runs(Q, [&](int) { return ah * (double)x; }, [&](int t, double c) { out[t] = c; });
    return;
  }
  const int row = cumsum_row(Q), ld = cumsum_ld(Q);
  double* cs = reinterpret_cast<double*>(smem);   // head j's step t at cs[j * row + skew(t)]
  float* ds = reinterpret_cast<float*>(cs + kScanHeads * row);   // ds[j * ld + skew(t)]
  const int total = Q * kScanHeads;
  for (int e0 = tid; e0 < total; e0 += kBatch * kN) {   // kBatch loads in flight a thread
    float v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = e0 + i * kN, j = e % kScanHeads;
      v[i] = e < total && h0 + j < H ? d[(int64_t)(e / kScanHeads) * H + j] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = e0 + i * kN;
      if (e < total) ds[e % kScanHeads * ld + skew(e / kScanHeads)] = v[i];
    }
  }
  __syncthreads();
  if (h >= H) return;   // whole warps, past the block's one barrier
  const double ah = a[h];
  const float* dw = ds + warp * ld;
  double* cw = cs + warp * row;
  scan_runs(Q, [&](int t) { return ah * (double)dw[skew(t)]; },
            [&](int t, double c) { cw[skew(t)] = c; });
  __syncwarp();
  for (int t = lane; t < Q; t += 32) out[t] = cw[skew(t)];
}

// chunk_cb's column tiles of 16·NI in row tile it: they cover steps u <
// min(Q, 64 (it + 1)), the causal 64x64 tile pairs (it, jt <= it).
__host__ __device__ constexpr int cb_cols(int Q, int it, int tn) {
  return ((Q < kT * (it + 1) ? Q : kT * (it + 1)) + tn - 1) / tn;
}
__host__ __device__ constexpr int cb_tiles(int Q, int tn) {
  int n = 0;
  for (int it = 0; it * kT < Q; ++it) n += cb_cols(Q, it, tn);
  return n;
}

// Phase 1. Block (b * nc + c) * per_chunk + tile, the tiles of a chunk row
// tile by row tile: G[t][u] for the 64 rows t of row tile it and the 16·NI
// columns u of its column tile, = Σ_n C_t[n] B_u[n] over depth N, C's rows
// and B's by cp.async (chunks of 16 bytes where kV, else one element) into
// mma_tile's ring; B and C are T. Rows and columns past Q and the depth
// past N are zero-filled; every element of the tile below Q is written.
template <int NI, bool kV, typename T>
__global__ void __launch_bounds__(kThreads, kCbBlocks)
ssd_scan_chunk_cb_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
                         float* __restrict__ g, int N, int Q, int per_chunk) {
  constexpr int kTN = 16 * NI;
  __shared__ __align__(16) float ring[2 * kRingStages * kPlane];
  const int64_t bc = blockIdx.x / per_chunk;     // b * nc + c
  int j = (int)(blockIdx.x % per_chunk), it = 0;
  while (j >= cb_cols(Q, it, kTN)) j -= cb_cols(Q, it++, kTN);
  const int t0 = it * kT, u0 = j * kTN;
  const T* crow = cm + bc * Q * N;               // step t at crow + t * N
  const T* brow = bm + bc * Q * N;
  float acc[2][NI][4];
  zero(acc);
  mma_tile<kRingStages, kV, true, true, false, NI, T, T>(acc, ring, ring + kRingStages * kPlane, N,
      [&](int m, int k) { return t0 + m < Q ? crow + (int64_t)(t0 + m) * N + k : nullptr; },
      [&](int k, int n) { return u0 + n < Q ? brow + (int64_t)(u0 + n) * N + k : nullptr; },
      NoScale());
  // Each thread's elements come in pairs of neighbouring columns: one 8-byte
  // store where Q is even (so every row and pair starts 8-byte aligned).
  float* gb = g + bc * (int64_t)Q * Q;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        int r, c;
        frag_rc<NI>(mi, ni, e, r, c);
        const int t = t0 + r, u = u0 + c;
        if (t >= Q || u >= Q) continue;
        float* out = gb + (int64_t)t * Q + u;
        if (Q % 2 == 0) {
          *reinterpret_cast<float2*>(out) = make_float2(acc[mi][ni][e], acc[mi][ni][e + 1]);
        } else {
          out[0] = acc[mi][ni][e];
          if (u + 1 < Q) out[1] = acc[mi][ni][e + 1];
        }
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

// Whether chunk_cb's, chunk_state's and chunk_scan's operands move in
// 16-byte chunks: P and N multiples of a chunk's elements of T (4 fp32, 8
// bf16) and every copied base 16-byte aligned.
template <typename T>
bool chunks_of_16(const Chain<T>& k) {
  const void* const bases[] = {k.x, k.b, k.c, k.states};
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  constexpr int kE = kChunk<T, true>;
  return k.P % kE == 0 && k.N % kE == 0;
}

template <int NI, bool kV, typename T>
void launch_cb(const Chain<T>& k, int per_chunk, unsigned grid, cudaStream_t st) {
  ssd_scan_chunk_cb_kernel<NI, kV, T><<<grid, kThreads, 0, st>>>(k.b, k.c, k.g, (int)k.N,
                                                                 (int)k.Q, per_chunk);
}

template <int NI, typename T>
void launch_cb(const Chain<T>& k, bool vec, int per_chunk, unsigned grid, cudaStream_t st) {
  if (vec) launch_cb<NI, true>(k, per_chunk, grid, st);
  else launch_cb<NI, false>(k, per_chunk, grid, st);
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
  // chunk_cb: 64 x 32 tiles, or 64 x 16 where those would not fill a wave.
  const bool narrow = B * nc * cb_tiles((int)Q, 32) < kCardSms;
  const int cb_per_chunk = cb_tiles((int)Q, narrow ? 16 : 32);
  unsigned g0, g1, g2, g3, g4;
  if (blocks_for(B * nc * ((H + kScanHeads - 1) / kScanHeads), 1, &g0) ||
      blocks_for(B * nc * cb_per_chunk, 1, &g1) ||
      blocks_for(B * nc * H * ncols, 1, &g2) || blocks_for(B * H * slices, 1, &g3) ||
      blocks_for(B * nc * ntiles * H, 1, &g4))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  for (int phase = first; phase <= last; ++phase) {
    switch (phase) {
      case 0:
        ssd_scan_cumsum_kernel<<<g0, kScanHeads * 32, cumsum_smem_bytes((int)Q), stream>>>(
            k.dt, k.a, k.cum, S, (int)H, (int)Q);
        break;
      case 1:
        if (narrow) launch_cb<1>(k, vec, cb_per_chunk, g1, stream);
        else launch_cb<2>(k, vec, cb_per_chunk, g1, stream);
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
// both element types, and cumsum's (at Q = kMaxQ). Call once per device
// before the first launch there, outside any stream capture. Returns a
// cudaError_t code, 0 on success.
extern "C" int ssd_scan_init() {
  cudaError_t err = set_smem_limit<false, float>();
  if (err == cudaSuccess) err = set_smem_limit<true, float>();
  if (err == cudaSuccess) err = set_smem_limit<false, __nv_bfloat16>();
  if (err == cudaSuccess) err = set_smem_limit<true, __nv_bfloat16>();
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_scan_cumsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cumsum_smem_bytes(kMaxQ));
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
