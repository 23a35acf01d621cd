// ssd_scan_bwd — the gradient of the Mamba-2 chunked SSD forward
// (ssd_scan.cu) for NVIDIA Hopper (sm_90a), as a chain of four kernels.
//
// The Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py:_kernel has no
// backward: the JAX package trains through ssd_chunked
// (src/repro/models/lm.py:266) with autodiff. The port trains through the
// forward chain, so its gradient is this chain, behind
// repro_torch.kernels.ssd_scan.ops.SsdScanFn.
//
// Per (b, h) and chunk c of length Q, with cum the forward's inclusive
// cumsum of a_h * dt local to the chunk, A_c = cum_Q, L_ts = exp(cum_t -
// cum_s) for t >= s, CB_ts = C_t·B_s (the forward's G workspace), M_ts =
// dy_t·x_s, h_in the state entering the chunk (the forward's workspace) and
// G_c the gradient of the state leaving it:
//
//   D_c     = Σ_t exp(cum_t) dy_t ⊗ C_t
//   G_{c-1} = exp(A_c) G_c + D_c,                  G_{nc-1} = dh_final
//   dx_s    = dt_s [Σ_{t>=s} L_ts CB_ts dy_t + exp(A_c - cum_s) G_c B_s]
//   R_ts    = Σ_h dt_s L_ts M_ts                   (t >= s; B, C shared by heads)
//   dB_s    = Σ_t R_ts C_t + Σ_h dt_s exp(A_c - cum_s) G_cᵀ x_s
//   dC_t    = Σ_s R_ts B_s + Σ_h exp(cum_t) h_inᵀ dy_t
//   ddt_s   = Σ_{t>=s} L_ts CB_ts M_ts + exp(A_c - cum_s) x_s·(G_c B_s) + a_h rev_s
//   da_h    = Σ_{b,c,s} dt_s rev_s,                rev_s = Σ_{t>=s} ∂cum_t
//
// where ∂cum collects W_ts = L_ts CB_ts dt_s M_ts (+ on t, − on s), the
// inter-chunk term exp(cum_t) dy_t·(h_in C_t) on t, V_s = exp(A_c - cum_s)
// dt_s x_s·(G_c B_s) (− on s, + on Q) and exp(A_c) <G_c, h_in> on Q.
//
// The chain, launched in order on the caller's stream by
// ssd_scan_bwd_launch; the caller allocates the workspaces:
//   1. chunk_dstate per (b, chunk, h, 64-column slice of N): D_c into the
//                   gstates workspace (B, nc, H, P, N), a (P, N) product of
//                   depth Q; then, as further blocks of the same launch, per
//                   (b, chunk, causal 64x64 tile pair): R = Σ_h dt_s L_ts M_ts
//                   into r (B, nc, Q, Q), the heads summed in order.
//   2. dstate_pass  per (b, h, slice of P·N): walks the chunks backwards and
//                   turns gstates[c] in place from D_c into G_c.
//   3. chunk_bwd    per (b, chunk, h), one block for the whole chunk: dx,
//                   ddt, and the chunk's da partial into da_part (B, nc, H).
//                   ∂cum and the direct ddt build up in shared memory in a
//                   fixed order; one thread takes the reverse cumsum.
//   4. chunk_dbc    per (b, chunk, 64-row tile, 64-column slice of N, dB or
//                   dC): the R term (depth <= Q) and the heads' state terms
//                   as one product of depth H·P; one more block sums da_part
//                   over (b, chunk) per head, in order.
//
// What bounds it on this card: operations. At mamba2-2.7b's training
// microbatch (B = 2, S = 2048, H = 80, P = 64, N = 128, Q = 256, fp32) the
// gradient needs ≈ 32.6 GFLOP (≈ 0.49 ms on the fp32 CUDA cores; the count
// is chip_smoke.py's ssd_bwd_bound_ms) against 0.32 GB of HBM traffic
// (0.09 ms). The chain executes ≈ 47.3 GFLOP: chunk_dstate 5.4 (D) + 6.7
// (R: M formed again per head, summed over heads), chunk_bwd 24.2 (M, the
// (L ⊙ CB)ᵀ dy tiles, G_c B_s and h_in C_t per head), chunk_dbc 11.1 (the
// heads' state terms at depth H·P and the R terms). All of it on the fp32
// CUDA cores, as the forward; tensor cores, TMA and wgmma are later work.

// Design points:
//   * every product is one 64x64 output tile per 128-thread block with an
//     8x4 register tile per thread (the forward's layout); both operands
//     pass through shared memory k-major in slabs of 32, each element
//     produced by a functor that applies the masks and the exponents on
//     the way in, so that one routine serves every product;
//   * chunk_bwd owns a whole (b, chunk, h): the row and column sums of its
//     64x64 tiles (∂cum on t and on s, the direct ddt) go through a shared
//     staging tile and are summed by one thread per row or column in index
//     order, so no two blocks write one value and no atomics are needed:
//     launches repeat bitwise;
//   * the causal mask is applied before exp, every exponent is an fp64
//     difference of cum values rounded once to fp32, as in the forward;
//   * shared memory is static and under 48 KB (chunk_bwd: 41.5 KB at Q =
//     1024), so no opt-in attribute is set and a launch may be captured in
//     a CUDA graph;
//   * every global offset is 64-bit.
// Limits: as the forward's: P <= 64, N <= 128, Q <= 1024, every grid under
// 2^31 blocks; the launcher refuses others.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // output tile rows and columns
constexpr int kK = 32;          // depth of one shared slab
constexpr int kLd = kT + 4;     // row stride of a k-major slab (16-byte rows)
constexpr int kSt = kT + 1;     // row stride of the staging tile
constexpr int kThreads = 128;   // 8 x 16 threads, 8x4 outputs each
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxQ = 1024;
constexpr int kPassThreads = 256;
constexpr int kPassPer = 4;

// This thread's 8x4 register tile: rows 8*ty .. 8*ty+7, columns 4*tx ..
// 4*tx+3. A warp covers 4 ty x 8 tx.
__device__ __forceinline__ void tile_coords(int& ty, int& tx) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  tx = (warp & 1) * 8 + (lane & 7);
  ty = (warp >> 1) * 4 + (lane >> 3);
}

// acc[i][j] += Σ_{k < depth} fa(8ty + i, k) · fb(k, 4tx + j). fa(m, k) and
// fb(k, n) give the operands' elements (0 outside their range); each
// slab of kK steps is stored k-major in as / bs. kAk (kBk) says that the
// left (right) operand's source runs along k in memory: consecutive threads
// then take consecutive k, otherwise consecutive m (n), so global reads
// are coalesced either way. A slab's elements are all read into registers
// before any is stored: the shared stores go through generic pointers,
// which the compiler cannot tell from the global reads, so interleaved
// stores would serialise the reads (one memory round trip each). The
// first slab's elements are read before the first barrier: fa and fb may
// read shared memory only where a barrier has passed since it was written.
// A barrier precedes every store into as / bs, so the caller may read the
// slabs (or what aliases them) right before the call; it ends without one.
template <bool kAk, bool kBk, typename FA, typename FB>
__device__ __forceinline__ void mm_tile(float (&acc)[8][4], float* __restrict__ as,
                                        float* __restrict__ bs, int depth, FA fa, FB fb) {
  constexpr int kPer = kK * kT / kThreads;
  int ty, tx;
  tile_coords(ty, tx);
  for (int k0 = 0; k0 < depth; k0 += kK) {
    float va[kPer], vb[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int k = kAk ? e % kK : e / kT, m = kAk ? e / kK : e % kT;
      va[i] = k0 + k < depth ? fa(m, k0 + k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int k = kBk ? e % kK : e / kT, n = kBk ? e / kK : e % kT;
      vb[i] = k0 + k < depth ? fb(k0 + k, n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int k = kAk ? e % kK : e / kT, m = kAk ? e / kK : e % kT;
      as[k * kLd + m] = va[i];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int k = kBk ? e % kK : e / kT, n = kBk ? e / kK : e % kT;
      bs[k * kLd + n] = vb[i];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * kLd + 8 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * kLd + 8 * ty + 4);
      const float4 b = *reinterpret_cast<const float4*>(bs + k * kLd + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// out[r][c] = acc for rows r0 + r < rows and columns c0 + c < cols, with
// out's rows `ld` apart.
__device__ __forceinline__ void store_tile(float* out, int64_t ld, const float (&acc)[8][4],
                                           int r0, int rows, int c0, int cols) {
  int ty, tx;
  tile_coords(ty, tx);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + 8 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * tx + j;
      if (c < cols) out[(int64_t)r * ld + c] = acc[i][j];
    }
  }
}

// Phase 1. Blocks [0, nd): (((b * nc + c) * H + h) * nslices + slice) with
// D_c[p][n] for n in the slice; blocks [nd, nd + nr): (b * nc + c) * npairs
// + pair, pair = it (it + 1) / 2 + js with js <= it: R[t][s] for the tile
// (it, js).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_dstate_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                            const float* __restrict__ cm, const float* __restrict__ dy,
                            const double* __restrict__ cum, float* __restrict__ gstates,
                            float* __restrict__ r, int64_t S, int H, int P, int N, int Q,
                            int64_t nd) {
  __shared__ __align__(16) float as[kK * kLd];
  __shared__ __align__(16) float bs[kK * kLd];
  __shared__ float w[kMaxQ];
  const int64_t nc = S / Q, HP = (int64_t)H * P;
  float acc[8][4];
  zero(acc);
  if (blockIdx.x < nd) {
    const int nslices = (N + kT - 1) / kT;
    const int slice = (int)(blockIdx.x % nslices);
    const int64_t bch = blockIdx.x / nslices, bc = bch / H, b = bc / nc;
    const int h = (int)(bch % H), n0 = slice * kT;
    const double* cu = cum + (b * H + h) * S + (bc - b * nc) * Q;
    for (int t = threadIdx.x; t < Q; t += kThreads) w[t] = expf((float)cu[t]);
    __syncthreads();
    const float* dyb = dy + bc * Q * HP + (int64_t)h * P;   // step t at dyb + t * HP
    const float* crow = cm + bc * Q * N;
    // D[p][n] = Σ_t (exp(cum_t) dy_t[p]) C_t[n].
    mm_tile<false, false>(acc, as, bs, Q,
        [&](int p, int t) { return p < P ? w[t] * dyb[(int64_t)t * HP + p] : 0.f; },
        [&](int t, int n) { return n0 + n < N ? crow[(int64_t)t * N + n0 + n] : 0.f; });
    store_tile(gstates + bch * (int64_t)P * N + n0, N, acc, 0, P, 0, N - n0);
    return;
  }
  const int ntiles = (Q + kT - 1) / kT, npairs = ntiles * (ntiles + 1) / 2;
  const int64_t rest = blockIdx.x - nd, bc = rest / npairs, b = bc / nc;
  int js = (int)(rest % npairs), it = 0;
  while (js > it) js -= ++it;
  const int t0 = it * kT, s0 = js * kT;
  const int64_t row0 = bc * Q;
  int ty, tx;
  tile_coords(ty, tx);
  for (int h = 0; h < H; ++h) {
    float m[8][4];
    zero(m);
    const float* dyb = dy + row0 * HP + (int64_t)h * P;
    const float* xb = x + row0 * HP + (int64_t)h * P;
    // M[t][s] = dy_t · x_s over P.
    mm_tile<true, true>(m, as, bs, P,
        [&](int i, int p) { return t0 + i < Q ? dyb[(int64_t)(t0 + i) * HP + p] : 0.f; },
        [&](int p, int j) { return s0 + j < Q ? xb[(int64_t)(s0 + j) * HP + p] : 0.f; });
    const double* cu = cum + (b * H + h) * S + (bc - b * nc) * Q;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = s0 + 4 * tx + j;
      if (s >= Q) continue;
      const double cs = cu[s];
      const float ds = dt[(row0 + s) * H + h];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = t0 + 8 * ty + i;
        if (t < Q && s <= t) acc[i][j] = fmaf(ds * expf((float)(cu[t] - cs)), m[i][j], acc[i][j]);
      }
    }
  }
  store_tile(r + bc * (int64_t)Q * Q, Q, acc, t0, Q, s0, Q);
}

// Phase 2. Block (b * H + h) * slices + slice: each thread carries kPassPer
// elements of the (P, N) gradient backwards through the chunks, reading
// D_c before writing G_c over it.
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_dstate_pass_kernel(float* __restrict__ gstates, const float* __restrict__ dh_final,
                           const double* __restrict__ cum, int64_t S, int H, int PN, int Q) {
  constexpr int kSpan = kPassThreads * kPassPer;
  const int slices = (PN + kSpan - 1) / kSpan;
  const int64_t bh = blockIdx.x / slices, nc = S / Q, b = bh / H, h = bh - b * H;
  const int e0 = (int)(blockIdx.x % slices) * kSpan + threadIdx.x;
  const int64_t step = (int64_t)H * PN;             // chunk c to chunk c + 1
  float* base = gstates + (b * nc * H + h) * PN;    // chunk c at base + c * step
  const double* last = cum + bh * S + (Q - 1);      // cum_Q of chunk c at last[c * Q]
  float g[kPassPer];
#pragma unroll
  for (int k = 0; k < kPassPer; ++k) {
    const int e = e0 + k * kPassThreads;
    g[k] = e < PN ? dh_final[bh * PN + e] : 0.f;
  }
  for (int64_t c = nc - 1; c >= 0; --c) {
    const float decay = expf((float)last[c * Q]);
#pragma unroll
    for (int k = 0; k < kPassPer; ++k) {
      const int e = e0 + k * kPassThreads;
      if (e < PN) {
        const float d = base[c * step + e];
        base[c * step + e] = g[k];
        g[k] = fmaf(decay, g[k], d);
      }
    }
  }
}

// Phase 3. Block (b * nc + c) * H + h.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ a, const float* __restrict__ bm,
                         const float* __restrict__ cm, const float* __restrict__ dy,
                         const double* __restrict__ cum, const float* __restrict__ g,
                         const float* __restrict__ h_in, const float* __restrict__ gstates,
                         float* __restrict__ dx, float* __restrict__ ddt,
                         float* __restrict__ da_part, int64_t S, int H, int P, int N, int Q) {
  __shared__ __align__(16) float slab[2 * kK * kLd];   // as | bs, or the staging tile
  __shared__ double cums[kMaxQ];
  __shared__ float dts[kMaxQ];
  __shared__ float dcum[kMaxQ];   // ∂cum, then its reverse cumsum
  __shared__ float ddir[kMaxQ];   // the direct ddt
  __shared__ float vs[kMaxQ];     // V_s, summed onto ∂cum_Q at the end
  __shared__ float red[kThreads];
  float* as = slab;
  float* bs = slab + kK * kLd;
  float* stage = slab;            // 64 x kSt <= 2 * kK * kLd floats
  const int h = (int)(blockIdx.x % H);
  const int64_t bc = blockIdx.x / H, nc = S / Q, b = bc / nc;
  const int64_t row0 = bc * Q, HP = (int64_t)H * P, PN = (int64_t)P * N;
  const double* cu = cum + (b * H + h) * S + (bc - b * nc) * Q;
  for (int u = threadIdx.x; u < Q; u += kThreads) {
    cums[u] = cu[u];
    dts[u] = dt[(row0 + u) * H + h];
    dcum[u] = 0.f;
    ddir[u] = 0.f;
    vs[u] = 0.f;
  }
  const double last = cu[Q - 1];
  const float* xb = x + row0 * HP + (int64_t)h * P;       // step s at xb + s * HP
  const float* dyb = dy + row0 * HP + (int64_t)h * P;
  const float* brow = bm + row0 * N;                      // step s at brow + s * N
  const float* crow = cm + row0 * N;
  const float* gb = g + bc * (int64_t)Q * Q;              // CB[t][s] at gb + t * Q + s
  const float* gc = gstates + (bc * H + h) * PN;          // G_c[p][n] at gc + p * N + n
  const float* hb = h_in + (bc * H + h) * PN;
  const int ntiles = (Q + kT - 1) / kT;
  int ty, tx;
  tile_coords(ty, tx);
  const int tid = threadIdx.x;

  for (int js = 0; js < ntiles; ++js) {
    const int s0 = js * kT;
    float dxa[8][4];
    zero(dxa);
    for (int it = js; it < ntiles; ++it) {
      const int t0 = it * kT;
      float m[8][4];
      zero(m);
      // M[t][s] = dy_t · x_s over P (rows t, columns s).
      mm_tile<true, true>(m, as, bs, P,
          [&](int i, int p) { return t0 + i < Q ? dyb[(int64_t)(t0 + i) * HP + p] : 0.f; },
          [&](int p, int j) { return s0 + j < Q ? xb[(int64_t)(s0 + j) * HP + p] : 0.f; });
      __syncthreads();   // the slabs are consumed: stage (L ⊙ CB ⊙ M)[t][s]
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = t0 + 8 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + 4 * tx + j;
          float v = 0.f;
          if (t < Q && s <= t) v = gb[(int64_t)t * Q + s] * expf((float)(cums[t] - cums[s])) * m[i][j];
          stage[(8 * ty + i) * kSt + 4 * tx + j] = v;
        }
      }
      __syncthreads();
      // ∂cum_t += Σ_s dt_s P1[t][s]: one thread per row, columns in order.
      if (tid < kT && t0 + tid < Q) {
        float sum = 0.f;
        for (int j = 0; j < kT && s0 + j < Q; ++j) sum = fmaf(dts[s0 + j], stage[tid * kSt + j], sum);
        dcum[t0 + tid] += sum;
      }
      __syncthreads();   // the diagonal tile's rows and columns share dcum entries
      // ddt_s += Σ_t P1[t][s]; ∂cum_s -= dt_s Σ_t P1[t][s]: one thread per column.
      if (tid >= kT && s0 + tid - kT < Q) {
        const int j = tid - kT;
        float sum = 0.f;
        for (int i = 0; i < kT; ++i) sum += stage[i * kSt + j];
        ddir[s0 + j] += sum;
        dcum[s0 + j] -= dts[s0 + j] * sum;
      }
      // dx[s][p] += Σ_t (L ⊙ CB)[t][s] dy_t[p] over this t tile (mm_tile's
      // barrier orders the staging reads before its slab writes).
      mm_tile<false, false>(dxa, as, bs, kT,
          [&](int j, int i) {
            const int t = t0 + i, s = s0 + j;
            return t < Q && s <= t ? gb[(int64_t)t * Q + s] * expf((float)(cums[t] - cums[s])) : 0.f;
          },
          [&](int i, int p) { return t0 + i < Q && p < P ? dyb[(int64_t)(t0 + i) * HP + p] : 0.f; });
    }
    // The state term: inter[s][p] = (G_c B_s)[p] over N.
    float in[8][4];
    zero(in);
    mm_tile<true, true>(in, as, bs, N,
        [&](int j, int n) { return s0 + j < Q ? brow[(int64_t)(s0 + j) * N + n] : 0.f; },
        [&](int n, int p) { return p < P ? gc[(int64_t)p * N + n] : 0.f; });
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = s0 + 8 * ty + i;
      const float e = s < Q ? expf((float)(last - cums[s])) : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 4 * tx + j;
        const bool ok = s < Q && p < P;
        stage[(8 * ty + i) * kSt + p] = ok ? xb[(int64_t)s * HP + p] * in[i][j] : 0.f;
        if (ok) dx[(row0 + s) * HP + (int64_t)h * P + p] = dts[s] * fmaf(e, in[i][j], dxa[i][j]);
      }
    }
    __syncthreads();
    // xi_s = x_s · (G_c B_s): the direct ddt gets exp(A - cum_s) xi_s, ∂cum_s
    // loses V_s = exp(A - cum_s) dt_s xi_s, which ∂cum_Q gets back below.
    if (tid < kT && s0 + tid < Q) {
      const int s = s0 + tid;
      float xi = 0.f;
      for (int p = 0; p < P; ++p) xi += stage[tid * kSt + p];
      const float e = expf((float)(last - cums[s]));
      const float v = e * dts[s] * xi;
      ddir[s] = fmaf(e, xi, ddir[s]);
      dcum[s] -= v;
      vs[s] = v;
    }
  }
  // The inter-chunk ∂cum term: exp(cum_t) dy_t · (h_in C_t), per t tile.
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * kT;
    float yi[8][4];
    zero(yi);
    mm_tile<true, true>(yi, as, bs, N,
        [&](int i, int n) { return t0 + i < Q ? crow[(int64_t)(t0 + i) * N + n] : 0.f; },
        [&](int n, int p) { return p < P ? hb[(int64_t)p * N + n] : 0.f; });
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = t0 + 8 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = 4 * tx + j;
        stage[(8 * ty + i) * kSt + p] =
            t < Q && p < P ? dyb[(int64_t)t * HP + p] * yi[i][j] : 0.f;
      }
    }
    __syncthreads();
    if (tid < kT && t0 + tid < Q) {
      float sum = 0.f;
      for (int p = 0; p < P; ++p) sum += stage[tid * kSt + p];
      dcum[t0 + tid] = fmaf(expf((float)cums[t0 + tid]), sum, dcum[t0 + tid]);
    }
  }
  // ∂cum_Q += exp(A) <G_c, h_in> + Σ_s V_s. The dot: strided partial sums,
  // then a fixed tree; Σ_s V_s in index order.
  float part = 0.f;
  for (int64_t e = tid; e < PN; e += kThreads) part = fmaf(gc[e], hb[e], part);
  red[tid] = part;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (tid < off) red[tid] += red[tid + off];
    __syncthreads();
  }
  if (tid == 0) {
    float vsum = 0.f;
    for (int u = 0; u < Q; ++u) vsum += vs[u];
    dcum[Q - 1] += fmaf(expf((float)last), red[0], vsum);
  }
  __syncthreads();
  // The reverse cumsum, in index order from the end, by one thread.
  if (tid == 0) {
    float rev = 0.f, dap = 0.f;
    for (int u = Q - 1; u >= 0; --u) {
      rev += dcum[u];
      dcum[u] = rev;
      dap = fmaf(dts[u], rev, dap);
    }
    da_part[bc * H + h] = dap;
  }
  __syncthreads();
  const float ah = a[h];
  for (int u = tid; u < Q; u += kThreads) ddt[(row0 + u) * H + h] = fmaf(ah, dcum[u], ddir[u]);
}

// Phase 4. Blocks [0, B * nc * ntiles * nslices * 2): ((((b * nc + c) *
// ntiles + tile) * nslices + slice) * 2 + kind), kind 0 dB for the s tile,
// kind 1 dC for the t tile; one last block sums da.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk_dbc_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ bm, const float* __restrict__ cm,
                         const float* __restrict__ dy, const double* __restrict__ cum,
                         const float* __restrict__ h_in, const float* __restrict__ gstates,
                         const float* __restrict__ r, const float* __restrict__ da_part,
                         float* __restrict__ db, float* __restrict__ dc, float* __restrict__ da,
                         int64_t B, int64_t S, int H, int P, int N, int Q, int64_t nblocks) {
  __shared__ __align__(16) float as[kK * kLd];
  __shared__ __align__(16) float bs[kK * kLd];
  const int64_t nc = S / Q, HP = (int64_t)H * P, PN = (int64_t)P * N;
  if (blockIdx.x >= nblocks) {
    // da_h = Σ_{b, c} da_part[b, c, h], in order.
    for (int h = threadIdx.x; h < H; h += kThreads) {
      float sum = 0.f;
      for (int64_t bc = 0; bc < B * nc; ++bc) sum += da_part[bc * H + h];
      da[h] = sum;
    }
    return;
  }
  const int nslices = (N + kT - 1) / kT, ntiles = (Q + kT - 1) / kT;
  const int kind = (int)(blockIdx.x & 1);
  int64_t rest = blockIdx.x >> 1;
  const int slice = (int)(rest % nslices);
  rest /= nslices;
  const int tile = (int)(rest % ntiles);
  const int64_t bc = rest / ntiles, b = bc / nc, row0 = bc * Q;
  const int r0 = tile * kT, n0 = slice * kT;
  const float* rb = r + bc * (int64_t)Q * Q;              // R[t][s] at rb + t * Q + s
  const float* brow = bm + row0 * N;
  const float* crow = cm + row0 * N;
  const double* cub = cum + b * H * S + (bc - b * nc) * Q;   // head h at cub + h * S
  float acc[8][4];
  zero(acc);
  if (kind == 0) {
    // dB[s][n] = Σ_{t >= s} R[t][s] C_t[n] ...
    for (int it = tile; it < ntiles; ++it) {
      const int t0 = it * kT;
      mm_tile<false, false>(acc, as, bs, kT,
          [&](int j, int i) {
            const int t = t0 + i, s = r0 + j;
            return t < Q && s < Q ? rb[(int64_t)t * Q + s] : 0.f;
          },
          [&](int i, int n) {
            return t0 + i < Q && n0 + n < N ? crow[(int64_t)(t0 + i) * N + n0 + n] : 0.f;
          });
    }
    // ... + Σ_{h, p} dt_s exp(A_h - cum_s) x_s[h][p] G_c[h][p][n].
    mm_tile<true, false>(acc, as, bs, (int)HP,
        [&](int j, int k) {
          const int s = r0 + j, h = k / P;
          if (s >= Q) return 0.f;
          const double* cu = cub + (int64_t)h * S;
          return dt[(row0 + s) * H + h] * expf((float)(cu[Q - 1] - cu[s])) *
                 x[(row0 + s) * HP + k];
        },
        [&](int k, int n) {
          const int h = k / P, p = k - h * P;
          return n0 + n < N ? gstates[(bc * H + h) * PN + (int64_t)p * N + n0 + n] : 0.f;
        });
    store_tile(db + row0 * N + n0, N, acc, r0, Q, 0, N - n0);
  } else {
    // dC[t][n] = Σ_{s <= t} R[t][s] B_s[n] ...
    for (int js = 0; js <= tile; ++js) {
      const int s0 = js * kT;
      mm_tile<true, false>(acc, as, bs, kT,
          [&](int i, int j) {
            const int t = r0 + i, s = s0 + j;
            return t < Q && s < Q ? rb[(int64_t)t * Q + s] : 0.f;
          },
          [&](int j, int n) {
            return s0 + j < Q && n0 + n < N ? brow[(int64_t)(s0 + j) * N + n0 + n] : 0.f;
          });
    }
    // ... + Σ_{h, p} exp(cum_t) dy_t[h][p] h_in[h][p][n].
    mm_tile<true, false>(acc, as, bs, (int)HP,
        [&](int i, int k) {
          const int t = r0 + i, h = k / P;
          if (t >= Q) return 0.f;
          return expf((float)cub[(int64_t)h * S + t]) * dy[(row0 + t) * HP + k];
        },
        [&](int k, int n) {
          const int h = k / P, p = k - h * P;
          return n0 + n < N ? h_in[(bc * H + h) * PN + (int64_t)p * N + n0 + n] : 0.f;
        });
    store_tile(dc + row0 * N + n0, N, acc, r0, Q, 0, N - n0);
  }
}

int blocks_for(int64_t n, int64_t per, unsigned* out) {
  const int64_t blocks = (n + per - 1) / per;
  if (blocks < 1 || blocks > INT_MAX) return 1;
  *out = (unsigned)blocks;
  return 0;
}

}  // namespace

// Every tensor fp32 and contiguous but cum (fp64): x, dy, dx (B,S,H,P); dt,
// ddt (B,S,H); a, da (H,); b, c, db, dc (B,S,N); dh_final (B,H,P,N); the
// forward's workspaces cum (B,H,S), g (B,S/Q,Q,Q), h_in (B,S/Q,H,P,N).
// Workspaces allocated by the caller and overwritten: gstates
// (B,S/Q,H,P,N), r (B,S/Q,Q,Q), da_part (B,S/Q,H). Launches the four phases
// in order on `stream`. Returns a cudaError_t code, 0 on success;
// cudaErrorInvalidValue for shapes outside the kernels' limits.
extern "C" int ssd_scan_bwd_launch(const float* x, const float* dt, const float* a,
                                   const float* b, const float* c, const float* dy,
                                   const float* dh_final, const double* cum, const float* g,
                                   const float* h_in, float* dx, float* ddt, float* da,
                                   float* db, float* dc, float* gstates, float* r,
                                   float* da_part, int64_t B, int64_t S, int64_t H, int64_t P,
                                   int64_t N, int64_t Q, void* stream) {
  if (B < 1 || H < 1 || H > INT_MAX || P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 ||
      Q > kMaxQ || S < Q || S % Q != 0 || H * P > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t nc = S / Q, ntiles = (Q + kT - 1) / kT, nslices = (N + kT - 1) / kT;
  const int64_t npairs = ntiles * (ntiles + 1) / 2, PN = P * N;
  const int64_t nd = B * nc * H * nslices, nr = B * nc * npairs;
  const int64_t ndbc = B * nc * ntiles * nslices * 2;
  const int64_t pass_slices = (PN + kPassThreads * kPassPer - 1) / (kPassThreads * kPassPer);
  unsigned g1, g2, g3, g4;
  if (blocks_for(nd + nr, 1, &g1) || blocks_for(B * H * pass_slices, 1, &g2) ||
      blocks_for(B * nc * H, 1, &g3) || blocks_for(ndbc + 1, 1, &g4))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  ssd_bwd_chunk_dstate_kernel<<<g1, kThreads, 0, st>>>(x, dt, c, dy, cum, gstates, r, S, (int)H,
                                                       (int)P, (int)N, (int)Q, nd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_dstate_pass_kernel<<<g2, kPassThreads, 0, st>>>(gstates, dh_final, cum, S, (int)H,
                                                          (int)PN, (int)Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_chunk_bwd_kernel<<<g3, kThreads, 0, st>>>(x, dt, a, b, c, dy, cum, g, h_in, gstates,
                                                    dx, ddt, da_part, S, (int)H, (int)P, (int)N,
                                                    (int)Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_bwd_chunk_dbc_kernel<<<g4, kThreads, 0, st>>>(x, dt, b, c, dy, cum, h_in, gstates, r,
                                                    da_part, db, dc, da, B, S, (int)H, (int)P,
                                                    (int)N, (int)Q, ndbc);
  return (int)cudaGetLastError();
}
