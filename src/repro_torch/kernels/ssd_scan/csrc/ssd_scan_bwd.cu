// ssd_scan_bwd — the gradient of the Mamba-2 chunked SSD forward
// (ssd_scan.cu) for NVIDIA Hopper (sm_90a), as a chain of five kernels.
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
//   1. chunk_dstate per (b, chunk, head group of 16, causal 64x64 tile
//                   pair): the group's partial of R = Σ_h dt_s L_ts M_ts into
//                   r_part (B, nc, ceil(H / 16), Q, Q); then, as further
//                   blocks of the same launch, per (b, chunk, h, column tile
//                   of 16, 32 or 64 as N needs): D_c into the gstates
//                   workspace (B, nc, H, P, N), a (P, N) product of depth Q.
//   2. dstate_pass  per (b, h, slice of P·N): walks the chunks backwards and
//                   turns gstates[c] in place from D_c into G_c; then, as
//                   further blocks, per (b, chunk, causal tile pair): R into
//                   r (B, nc, Q, Q), the groups' partials summed in order.
//   3. chunk_bwd    per (b, chunk, h), one block for the whole chunk: dx,
//                   ddt, the chunk's da partial into da_part (B, nc, H), and
//                   the per-(b, step, head) scales scale_out = dt_s exp(A_c -
//                   cum_s) and scale_in = exp(cum_t) (B, S, H) that chunk_dbc
//                   reads.
//   4. chunk_dbc    per (b, chunk, dB or dC, 64-row tile, slot, column tile
//                   of 16, 32 or 64 as N needs): slot 0 the R term (depth <=
//                   Q), slot 1 + g the state terms of the heads [16g, 16g +
//                   16) (depth 16·P), each into its own partial of part (B,
//                   nc, 2, 1 + ceil(H / 16), Q, N).
//   5. dbc_sum      per output element: dB, dC = the partials summed over
//                   the slots in order; one more block sums da_part over
//                   (b, chunk) per head, in order.
//
// What bounds it on this card: operations. At mamba2-2.7b's training
// microbatch (B = 2, S = 2048, H = 80, P = 64, N = 128, Q = 256, fp32) the
// gradient needs ≈ 32.6 GFLOP (≈ 0.49 ms on the fp32 CUDA cores, ≈ 0.20 ms as
// 3xTF32 on the tensor cores; chip_smoke.py's ssd_bwd_work under
// ssd_bwd_bound_ms) against 0.32 GB of HBM traffic (0.09 ms); with bf16 x,
// B, C and dy, ≈ 0.115 ms at fp32 accuracy (27.1 GFLOP of bf16 x fp32
// products as two TF32 products each, the 5.4 GFLOP dy xᵀ at the bf16 rate)
// against 0.19 GB (0.06 ms). The chain
// executes ≈ 47.3 GFLOP of fp32 products, all on the tensor cores as three
// TF32 products each (≈ 142 TF32 GFLOP): chunk_dstate 5.4 (D) + 6.7 (R: M
// per head and causal tile pair), chunk_bwd 24.2 (M, the (L ⊙ CB)ᵀ dy tiles,
// G_c B_s and h_in C_t per head) and chunk_dbc 11.1 (the heads' state terms
// at depth H·P and the R terms); and 21M exps of R's diagonal tiles (52M in
// the per-element form).
//
// What held the chain's kernels back, and what they do about it:
//   * every product ran on the fp32 CUDA cores: they run on mma.sync
//     m16n8k8 TF32 as 3xTF32 (mma_step). Each fp32 operand v is split into
//     big, v rounded to TF32 to nearest (ties away, as cvt.rna.tf32), and
//     small = v - big, and a tile takes big·small + small·big + big·big: the
//     dropped small·small and small's truncation to TF32 by the tensor core
//     leave ≈ 2^-21 of each product, fp32's order. The split happens as a
//     fragment is loaded, three instructions (an integer add of half a TF32
//     ulp, a mask, a subtraction): operands arrive by cp.async, which copies
//     bytes, so no register pass stores them split;
//   * their global reads were latency-bound, a few 4-byte loads in flight
//     per thread behind two barriers a slab, each costing some twenty
//     integer instructions: operands now move by cp.async in 16-byte chunks
//     (4-byte ones where P, N or Q is no multiple of 4 or a base is not
//     16-byte aligned) into rings of stages ahead of the products
//     (mma_tile), or as whole tiles that stay in shared memory
//     (load_tile, mma_resident), and no register holds a load in flight;
//   * chunk_dbc ran 129 blocks of depth H·P and redid dt·exp(A - cum) per
//     element in two N slices: the depth is split over groups of 16 heads
//     (1536 blocks at mamba2's shape, 1280 at hymba's), summed in a fixed
//     order by dbc_sum (no atomics); the scales come from chunk_bwd's
//     workspaces through a per-block table, one multiply per element as a
//     row scale of each 8-deep step (each head padded to 16 steps of k); its
//     column tile is 16 or 32 wide where N is (hymba's N = 16);
//   * chunk_bwd formed L ⊙ CB twice per tile pair, re-read dy_t for the dx
//     product and summed rows and columns one thread each: per tile pair
//     one batch of copies brings dy_t and CB (and, first in its column,
//     x_s); L ⊙ CB is formed once in place of CB, and M = dy_t x_sᵀ and the
//     dx product read all three in shared memory; the row and column sums
//     run in every thread's registers, then across lanes by butterfly
//     shuffles and across warps through shared memory, in a fixed order.
//     The state term's rings take dy_t's and W's place so that x_s stays
//     for x_s·(G_c B_s); the inter-chunk term is yiᵀ = h_in C_tᵀ with h_in
//     resident, dy_t read at the accumulator's positions before the
//     product. The Q-long arrays are sized by the launch's Q in dynamic
//     shared memory (61 KB at Q = 256: three blocks an SM);
//   * chunk_dstate's R ran 160 blocks that each walked all 80 heads, M
//     formed on the fp32 CUDA cores with two barriers a 32-deep slab, then
//     an fp64 subtraction and an exp per element and head: the walk is
//     split over groups of 16 heads (800 blocks at mamba2's shape, 1280 at
//     hymba's), each block's partial summed in order by dstate_pass; per
//     head one batch of copies brings the dy_t and x_s tiles (and cum, dt)
//     into one of two stages while the other head's product runs. Off the
//     diagonal the per-element exp goes: L_ts = exp(cum_t - cum_r) exp(cum_r
//     - cum_s) with r the s tile's last step, so a head's term is one
//     product with dy_t's rows and x_s's columns scaled, accumulating in R's
//     registers; where an exponent of that form is > 0 (cum rising: a·dt >
//     0, which no model has) the head takes the per-element form;
//   * chunk_dstate's D ran on the fp32 CUDA cores in 64-column slices: it is
//     mma_tile's product, exp(cum_t) a per-k scale of A (KScale), its column
//     tile 16 or 32 wide where N is;
//   * dstate_pass kept one chunk's load in flight (it stores G_c over D_c
//     before the next load): each thread loads a window of 8 chunks' D_c
//     and decays before its first store, in 16-byte vectors where P·N is a
//     multiple of 4.

// Design points:
//   * no two blocks write one value and no atomics are used: chunk_bwd owns
//     a whole (b, chunk, h), chunk_dstate's and chunk_dbc's partials have one
//     writer each, and dstate_pass and dbc_sum add them in order, so launches
//     repeat bitwise;
//   * the causal mask is applied before exp, every exponent is an fp64
//     difference of cum values rounded once to fp32, as in the forward;
//   * chunk_dstate, chunk_bwd (Q up to 1024) and chunk_dbc opt in to their
//     dynamic shared memory once per device, in ssd_scan_bwd_init, which
//     the wrapper calls before the first launch on a device. The attribute
//     belongs to the function, not to a launch, so a launch is captured in a
//     CUDA graph as any other;
//   * every global offset is 64-bit.
// Limits: as the forward's: P <= 64, N <= 128, Q <= 1024, every grid under
// 2^31 blocks; the launcher refuses others.
//
// Element types: x, B, C, dy and the gradients dx, dB, dC share one type T,
// fp32 or bf16 (the forward's y is in x's dtype, so dy is too); dt, a, ddt,
// da, dh_final and every workspace are fp32 (cum fp64) in both. A bf16
// operand is staged in shared memory as it is in global memory (cp.async
// copies bytes: 8 bf16 a 16-byte chunk, where fp32 takes 4) and widened to
// fp32 as a fragment element is loaded; dx, dB and dC are rounded to bf16
// once, from the fp32 value the fp32 chain would store. A bf16 value is
// exact in TF32, so its small part in the 3xTF32 split is zero: a product
// whose operand is an unscaled bf16 tile skips the tensor-core product
// that would read that small part, with the same sum: two TF32 products
// where fp32 takes three, and one for M = dy_t x_sᵀ, whose two operands
// are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "ssd_scan_mma.cuh"

namespace {

constexpr int kPassThreads = 256;
constexpr int kPassWin = 8;     // dstate_pass: chunks whose loads are in flight before a store
constexpr int kWLd = kT + 8;    // row stride of chunk_bwd's (L ⊙ CB) tile
constexpr int kLdH = 2 * kT + 4;   // row stride of chunk_bwd's h_in tile (N <= 128)
constexpr int kTilesWords = 2 * kT * kLdT;   // the dy_t and x_s tiles (chunk_dstate, chunk_bwd)
constexpr int kBwdStages = 2;   // chunk_bwd: mma_tile's ring stages
constexpr int kHeadGroup = 16;  // chunk_dbc: heads per state-term partial
constexpr int kRHeadGroup = 16; // chunk_dstate: heads per partial of R
// chunk_dstate's R: words per stage of its two-stage ring over heads: the
// dy_t and x_s tiles, cum_t and cum_s (fp64), dt_s, then the factored
// form's row and column scales.
constexpr int kRStageWords = kTilesWords + 7 * kT;
constexpr int kSumThreads = 256;
static_assert(kBwdStages * kPlane <= kT * kLdT && kBwdStages * kPlane <= kT * kWLd &&
              kT * kLdH <= kTilesWords, "chunk_bwd's rings and h_in fit its tiles");
static_assert(kThreads == 2 * kT, "chunk_dstate's R: one thread per cum_t, cum_s copy");

// Per row of the block tile, the sum of f(mi, ni, e) over this warp's 8·NI
// columns, into red[(warp & 1) * kT + row]: each thread's own columns in
// order, then the row's four lanes by butterfly. Per column, col_partials
// sums this warp's 32 rows into red[(warp >> 1) * 16·NI + column]. The
// order is fixed, so launches repeat bitwise. Every thread of the block
// calls them.
template <int NI, typename F>
__device__ __forceinline__ void row_partials(F f, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float s = 0.f;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        s += f(mi, ni, 2 * hf);
        s += f(mi, ni, 2 * hf + 1);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if ((lane & 3) == 0) red[(warp & 1) * kT + (warp >> 1) * 32 + mi * 16 + 8 * hf + (lane >> 2)] = s;
    }
}

template <int NI, typename F>
__device__ __forceinline__ void col_partials(F f, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float s = f(0, ni, b);
      s += f(0, ni, 2 + b);
      s += f(1, ni, b);
      s += f(1, ni, 2 + b);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if ((lane >> 2) == 0) red[(warp >> 1) * 16 * NI + (warp & 1) * 8 * NI + ni * 8 + 2 * lane + b] = s;
    }
}

// Phase 1's dynamic shared memory: R's two stages, or D's ring and its
// exp(cum_t) (Q at most kMaxQ).
constexpr size_t dstate_smem_bytes() {
  constexpr int r_words = 2 * kRStageWords, d_words = 2 * kRingStages * kPlane + kMaxQ;
  return sizeof(float) * (r_words > d_words ? r_words : d_words);
}

// Phase 1. Blocks [0, nr): ((b * nc + c) * ngroups + group) * npairs + pair,
// pair = it (it + 1) / 2 + js with js <= it: the partial of R[t][s] over
// the heads [16·group, 16·group + 16) for the tile (it, js) into r_part[b,
// c, group]; blocks [nr, nr + nd): ((b * nc + c) * H + h) * ncols + col:
// D_c[p][n] for the column tile col of 16·NI. Operands copied in chunks of
// 16 bytes (kV) or one element; x, C and dy are T.
template <int NI, bool kV, typename T>
__global__ void __launch_bounds__(kThreads, 3)
ssd_bwd_chunk_dstate_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                            const T* __restrict__ cm, const T* __restrict__ dy,
                            const double* __restrict__ cum, float* __restrict__ gstates,
                            float* __restrict__ r_part, int64_t S, int H, int P, int N, int Q,
                            int64_t nr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t nc = S / Q, HP = (int64_t)H * P;
  if (blockIdx.x >= nr) {
    // D[p][n] = Σ_t (exp(cum_t) dy_t[p]) C_t[n], the scale a KScale of A's
    // columns.
    constexpr int kTN = 16 * NI;
    float* ring_a = reinterpret_cast<float*>(smem);
    float* ring_b = ring_a + kRingStages * kPlane;
    float* w = ring_b + kRingStages * kPlane;   // exp(cum_t), zero past Q to the last slab
    const int ncols = (N + kTN - 1) / kTN;
    const int64_t rest = blockIdx.x - nr, bch = rest / ncols, bc = bch / H, b = bc / nc;
    const int h = (int)(bch % H), n0 = (int)(rest % ncols) * kTN;
    const double* cu = cum + (b * H + h) * S + (bc - b * nc) * Q;
    for (int t = threadIdx.x; t < (Q + kMK - 1) / kMK * kMK; t += kThreads)
      w[t] = t < Q ? expf((float)cu[t]) : 0.f;
    const T* dyb = dy + bc * Q * HP + (int64_t)h * P;   // step t at dyb + t * HP
    const T* crow = cm + bc * Q * N;
    float acc[2][NI][4];
    zero(acc);
    mma_tile<kRingStages, kV, false, false, false, NI, T, T>(acc, ring_a, ring_b, Q,
        [&](int p, int t) { return p < P ? dyb + (int64_t)t * HP + p : nullptr; },
        [&](int t, int n) { return n0 + n < N ? crow + (int64_t)t * N + n0 + n : nullptr; },
        KScale{w});
    float* out = gstates + bch * (int64_t)P * N;
    each_frag<NI>([&](int mi, int ni, int e, int r, int c) {
      if (r < P && n0 + c < N) out[(int64_t)r * N + n0 + c] = acc[mi][ni][e];
    });
    return;
  }
  const int ntiles = (Q + kT - 1) / kT, npairs = ntiles * (ntiles + 1) / 2;
  const int ngroups = (H + kRHeadGroup - 1) / kRHeadGroup;
  int js = (int)(blockIdx.x % npairs), it = 0;
  while (js > it) js -= ++it;
  const int64_t bg = blockIdx.x / npairs, bc = bg / ngroups, b = bc / nc, row0 = bc * Q;
  const int h0 = (int)(bg % ngroups) * kRHeadGroup, nh = min(kRHeadGroup, H - h0);
  const int t0 = it * kT, s0 = js * kT, P8 = (P + 7) / 8 * 8, tid = threadIdx.x;
  const double* cub = cum + b * H * S + (bc - b * nc) * Q;   // head h's at cub + h * S
  float* const stages = reinterpret_cast<float*>(smem);
  constexpr int kLd = kLdTOf<T>;
  // Head h0 + hh's operands into stage hh % 2, one group: the dy_t and x_s
  // tiles of T (columns past P zero; each in an fp32 tile's words), cum_t
  // and cum_s (thread i < 64 copies cum_{t0+i}, thread 64 + i cum_{s0+i} and
  // dt_{s0+i}).
  auto issue = [&](int hh) {
    float* const st = stages + (hh & 1) * kRStageWords;
    T* const dyt = reinterpret_cast<T*>(st);
    T* const xs = reinterpret_cast<T*>(st + kT * kLdT);
    double* const cts = reinterpret_cast<double*>(st + kTilesWords);
    const int h = h0 + hh;
    const T* dyb = dy + row0 * HP + (int64_t)h * P;
    const T* xb = x + row0 * HP + (int64_t)h * P;
    load_tile<kChunk<T, kV>>(dyt, kLd, kT, P8, [&](int r, int c) {
      return t0 + r < Q && c < P ? dyb + (int64_t)(t0 + r) * HP + c : nullptr;
    });
    load_tile<kChunk<T, kV>>(xs, kLd, kT, P8, [&](int r, int c) {
      return s0 + r < Q && c < P ? xb + (int64_t)(s0 + r) * HP + c : nullptr;
    });
    const int i = tid % kT, u = (tid < kT ? t0 : s0) + i;
    if (u < Q) {
      cp_async<8>(cts + tid, cub + (int64_t)h * S + u);
      if (tid >= kT) cp_async<4>(reinterpret_cast<float*>(cts + 2 * kT) + i, dt + (row0 + u) * H + h);
    }
    cp_async_commit();
  };
  // Off the diagonal (t0 > s0 + 63 = r, the s tile's last step), L_ts =
  // exp(cum_t - cum_r) exp(cum_r - cum_s): a head's R term is then one
  // product of dy_t's rows scaled by sa_t = exp(cum_t - cum_r) and x_s's by
  // sb_s = dt_s exp(cum_r - cum_s), each exponent an fp64 difference rounded
  // once to fp32, with no exp per element. Both factors are <= 1 where cum
  // does not rise within the chunk (a·dt <= 0, as in every model); a head
  // with an exponent > 0 takes the per-element form, as does the diagonal
  // tile. Thread i < 64 forms sa_{t0+i}, thread 64 + i sb_{s0+i}: fetch
  // reads its operands a head ahead, settle writes the scale into the
  // head's stage and says whether its exponent is > 0.
  const bool off = it > js;
  double cu_u = 0.0, cu_r = 0.0;
  float dt_s = 0.f;
  auto fetch = [&](int hh) {
    if (!off) return;
    const double* cu = cub + (int64_t)(h0 + hh) * S;
    const int u = (tid < kT ? t0 : s0) + tid % kT;
    cu_r = cu[s0 + kT - 1];
    cu_u = u < Q ? cu[u] : cu_r;   // rows past Q: scale 1 on a zero row
    if (tid >= kT) dt_s = dt[(row0 + u) * H + h0 + hh];
  };
  auto settle = [&](int hh) {
    if (!off) return true;
    const double d = tid < kT ? cu_u - cu_r : cu_r - cu_u;
    const float e = expf((float)d);
    stages[(hh & 1) * kRStageWords + kTilesWords + 5 * kT + tid] = tid < kT ? e : dt_s * e;
    return d > 0.0;
  };
  float acc[2][4][4];
  zero(acc);
  issue(0);
  fetch(0);
  bool rises = settle(0);
  for (int hh = 0; hh < nh; ++hh) {
    if (hh + 1 < nh) {
      issue(hh + 1);
      fetch(hh + 1);
      cp_async_wait<1>();   // this thread's copies of head hh have landed
    } else {
      cp_async_wait<0>();
    }
    // Everyone's have; whether any exponent of the factored form is > 0.
    const bool per_element = __syncthreads_or(rises);
    const float* st = stages + (hh & 1) * kRStageWords;
    const T* dyt = reinterpret_cast<const T*>(st);
    const T* xs = reinterpret_cast<const T*>(st + kT * kLdT);
    const double* ct = reinterpret_cast<const double*>(st + kTilesWords);
    const double* cs = ct + kT;
    const float* ds = reinterpret_cast<const float*>(cs + kT);
    const float* sa = ds + kT;
    const float* sb = sa + kT;
    if (!per_element) {
      mma_resident<true, true, 4>(acc, dyt, kLd, xs, kLd, P8,
                                  [&](int m, int) { return sa[m]; },
                                  [&](int n, int) { return sb[n]; });
    } else {
      // M[t][s] = dy_t · x_s over P, then R += dt_s exp(cum_t - cum_s) M on
      // and below the diagonal (the mask before exp: cum_t, cum_s past Q
      // unset).
      float m[2][4][4];
      zero(m);
      mma_resident<true, true, 4>(m, dyt, kLd, xs, kLd, P8);
      each_frag<4>([&](int mi, int ni, int e, int r, int c) {
        if (t0 + r < Q && s0 + c <= t0 + r)
          acc[mi][ni][e] = fmaf(ds[c] * expf((float)(ct[r] - cs[c])), m[mi][ni][e], acc[mi][ni][e]);
      });
    }
    if (hh + 1 < nh) rises = settle(hh + 1);   // stage (hh + 1) % 2 is not read until then
    __syncthreads();        // stage hh % 2 is free for head hh + 2's copies
  }
  float* out = r_part + (bg * Q + t0) * (int64_t)Q + s0;
  each_frag<4>([&](int mi, int ni, int e, int r, int c) {
    if (t0 + r < Q && s0 + c < Q) out[(int64_t)r * Q + c] = acc[mi][ni][e];
  });
}

// kV consecutive floats at p (16-byte aligned where kV is 4) into v, and back.
template <int kV>
__device__ __forceinline__ void load_vec(float (&v)[kV], const float* p) {
  if constexpr (kV == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    v[0] = *p;
  }
}

template <int kV>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[kV]) {
  if constexpr (kV == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else *p = v[0];
}

// Phase 2. Blocks [0, npass): (b * H + h) * slices + slice: each thread
// carries kV consecutive elements of the (P, N) gradient backwards through
// the chunks, kPassWin chunks at a time: the window's D_c and decays are all
// loaded before G_c is stored over the first of them. Blocks [npass, npass
// + B·nc·npairs): (b * nc + c) * npairs + pair: R over the causal tile pair,
// the head groups' partials summed in order.
template <int kV>
__global__ void __launch_bounds__(kPassThreads)
ssd_bwd_dstate_pass_kernel(float* __restrict__ gstates, const float* __restrict__ dh_final,
                           const double* __restrict__ cum, const float* __restrict__ r_part,
                           float* __restrict__ r, int64_t S, int H, int PN, int Q, int ngroups,
                           int64_t npass) {
  const int64_t nc = S / Q;
  if (blockIdx.x >= npass) {
    const int ntiles = (Q + kT - 1) / kT, npairs = ntiles * (ntiles + 1) / 2;
    const int64_t rest = blockIdx.x - npass, bc = rest / npairs, QQ = (int64_t)Q * Q;
    int js = (int)(rest % npairs), it = 0;
    while (js > it) js -= ++it;
    const float* src = r_part + bc * ngroups * QQ;
    float* dst = r + bc * QQ;
    for (int e = threadIdx.x * kV; e < kT * kT; e += kPassThreads * kV) {
      const int t = it * kT + e / kT, s = js * kT + e % kT;
      if (t >= Q || s >= Q) continue;
      const int64_t o = (int64_t)t * Q + s;
      float sum[kV], v[kV];
      load_vec<kV>(sum, src + o);
      for (int g = 1; g < ngroups; ++g) {
        load_vec<kV>(v, src + g * QQ + o);
#pragma unroll
        for (int k = 0; k < kV; ++k) sum[k] += v[k];
      }
      store_vec<kV>(dst + o, sum);
    }
    return;
  }
  constexpr int kSpan = kPassThreads * kV;
  const int slices = (PN + kSpan - 1) / kSpan;
  const int64_t bh = blockIdx.x / slices, b = bh / H, h = bh - b * H;
  const int e = (int)(blockIdx.x % slices) * kSpan + threadIdx.x * kV;
  if (e >= PN) return;
  const int64_t step = (int64_t)H * PN;                 // chunk c to chunk c + 1
  float* base = gstates + (b * nc * H + h) * PN + e;    // chunk c at base + c * step
  const double* last = cum + bh * S + (Q - 1);          // cum_Q of chunk c at last[c * Q]
  float g[kV];
  load_vec<kV>(g, dh_final + bh * PN + e);
  for (int64_t top = nc - 1; top >= 0; top -= kPassWin) {   // chunks top, top - 1, ...
    const int wn = top + 1 < kPassWin ? (int)(top + 1) : kPassWin;
    float d[kPassWin][kV], decay[kPassWin];
#pragma unroll
    for (int i = 0; i < kPassWin; ++i)
      if (i < wn) {
        load_vec<kV>(d[i], base + (top - i) * step);
        decay[i] = expf((float)last[(top - i) * Q]);
      }
#pragma unroll
    for (int i = 0; i < kPassWin; ++i)
      if (i < wn) {
        store_vec<kV>(base + (top - i) * step, g);
#pragma unroll
        for (int k = 0; k < kV; ++k) g[k] = fmaf(decay[i], g[k], d[i][k]);
      }
  }
}

// Phase 3's dynamic shared memory: the dy_t and x_s tiles (or mma_tile's
// rings, or the h_in tile), the (L ⊙ CB) tile (or a ring), the row and
// column partials, then cum (fp64) and six fp32 arrays of length Q.
constexpr size_t bwd_smem_bytes(int Q) {
  return sizeof(float) * (kTilesWords + kT * kWLd + 4 * kT) +
         (size_t)Q * (sizeof(double) + 6 * sizeof(float));
}

// Phase 4's dynamic shared memory: mma_tile's ring, then the block's scales.
constexpr size_t dbc_smem_bytes() {
  return sizeof(float) * (2 * kRingStages * kPlane + kT * kHeadGroup);
}

// Phase 3. Block (b * nc + c) * H + h; operands copied in chunks of 16
// bytes (kV) or one element; x, B, C, dy and dx are T. Per tile pair (s tile
// js, t tile it >= js) the dy_t tile, the CB tile and (first pair of js) the
// x_s tile arrive in one batch of copies and stay in shared memory; (L ⊙ CB)
// is formed in place of CB, and M = dy_t x_sᵀ and dx += (L ⊙ CB)ᵀ dy_t read
// them there.
template <bool kV, typename T>
__global__ void __launch_bounds__(kThreads, 3)
ssd_bwd_chunk_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ a, const T* __restrict__ bm,
                         const T* __restrict__ cm, const T* __restrict__ dy,
                         const double* __restrict__ cum, const float* __restrict__ g,
                         const float* __restrict__ h_in, const float* __restrict__ gstates,
                         T* __restrict__ dx, float* __restrict__ ddt,
                         float* __restrict__ da_part, float* __restrict__ scale_out,
                         float* __restrict__ scale_in, int64_t S, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) unsigned char smem[];
  // tiles: dy_t and x_s of T (rows kLd apart, each in an fp32 tile's words);
  // the state-term product's rings take dy_t's and (L ⊙ CB)'s place, and
  // h_in (rows kLdH apart) the tiles' in the inter-chunk products.
  constexpr int kLd = kLdTOf<T>, kE = kChunk<T, kV>, kEF = kChunk<float, kV>;
  float* tiles = reinterpret_cast<float*>(smem);
  T* dyt = reinterpret_cast<T*>(tiles);
  T* xs = reinterpret_cast<T*>(tiles + kT * kLdT);
  float* wt = tiles + kTilesWords;   // CB, then (L ⊙ CB)[t][s], rows kWLd apart
  float* red = wt + kT * kWLd;       // row, then column partials
  double* cums = reinterpret_cast<double*>(red + 4 * kT);
  float* dts = reinterpret_cast<float*>(cums + Q);
  float* eo = dts + Q;            // exp(A - cum_s)
  float* ei = eo + Q;             // exp(cum_t)
  float* dcum = ei + Q;           // ∂cum, then its reverse cumsum
  float* ddir = dcum + Q;         // the direct ddt
  float* vs = ddir + Q;           // V_s, summed onto ∂cum_Q at the end
  const int h = (int)(blockIdx.x % H);
  const int64_t bc = blockIdx.x / H, nc = S / Q, b = bc / nc;
  const int64_t row0 = bc * Q, HP = (int64_t)H * P, PN = (int64_t)P * N;
  const double* cu = cum + (b * H + h) * S + (bc - b * nc) * Q;
  const double last = cu[Q - 1];
  for (int u = threadIdx.x; u < Q; u += kThreads) {
    const double c = cu[u];
    const float d = dt[(row0 + u) * H + h];
    const float e_out = expf((float)(last - c)), e_in = expf((float)c);
    cums[u] = c;
    dts[u] = d;
    eo[u] = e_out;
    ei[u] = e_in;
    scale_out[(row0 + u) * H + h] = d * e_out;
    scale_in[(row0 + u) * H + h] = e_in;
    dcum[u] = 0.f;
    ddir[u] = 0.f;
    vs[u] = 0.f;
  }
  const T* xb = x + row0 * HP + (int64_t)h * P;           // step s at xb + s * HP
  const T* dyb = dy + row0 * HP + (int64_t)h * P;
  const T* brow = bm + row0 * N;                          // step s at brow + s * N
  const T* crow = cm + row0 * N;
  const float* gb = g + bc * (int64_t)Q * Q;              // CB[t][s] at gb + t * Q + s
  const float* gc = gstates + (bc * H + h) * PN;          // G_c[p][n] at gc + p * N + n
  const float* hb = h_in + (bc * H + h) * PN;
  const int ntiles = (Q + kT - 1) / kT;
  const int tid = threadIdx.x;
  const int P8 = (P + 7) / 8 * 8, N16 = (N + kMK - 1) / kMK * kMK;

  for (int js = 0; js < ntiles; ++js) {
    const int s0 = js * kT;
    float dxa[2][4][4];
    zero(dxa);
    for (int it = js; it < ntiles; ++it) {
      const int t0 = it * kT;
      // The pair's tiles, columns past P (past Q for CB) zero. The barrier
      // at the end of the last pair (or mma_tile's) freed the buffers.
      if (it == js)
        load_tile<kE>(xs, kLd, kT, kT, [&](int r, int c) {
          return s0 + r < Q && c < P ? xb + (int64_t)(s0 + r) * HP + c : nullptr;
        });
      load_tile<kE>(dyt, kLd, kT, kT, [&](int r, int c) {
        return t0 + r < Q && c < P ? dyb + (int64_t)(t0 + r) * HP + c : nullptr;
      });
      load_tile<kEF>(wt, kWLd, kT, kT, [&](int r, int c) {
        return t0 + r < Q && s0 + c < Q ? gb + (int64_t)(t0 + r) * Q + s0 + c : nullptr;
      });
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      // (L ⊙ CB)[t][s] in place, once for the pair; above the diagonal and
      // past Q zero (selected: CB is unspecified there).
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int i = e / kT, j = e % kT, t = t0 + i, s = s0 + j;
        float* w = wt + i * kWLd + j;
        *w = t < Q && s <= t ? *w * expf((float)(cums[t] - cums[s])) : 0.f;
      }
      __syncthreads();
      // M[t][s] = dy_t · x_s over P (rows t, columns s).
      float m[2][4][4];
      zero(m);
      mma_resident<true, true, 4>(m, dyt, kLd, xs, kLd, P8);
      // P1 = (L ⊙ CB) ⊙ M: ∂cum_t += Σ_s dt_s P1[t][s]; ddt_s += Σ_t P1[t][s],
      // ∂cum_s -= dt_s Σ_t P1[t][s].
      auto p1 = [&](int mi, int ni, int e) {
        int r, c;
        frag_rc<4>(mi, ni, e, r, c);
        return wt[r * kWLd + c] * m[mi][ni][e];
      };
      row_partials<4>([&](int mi, int ni, int e) {
        int r, c;
        frag_rc<4>(mi, ni, e, r, c);
        return (s0 + c < Q ? dts[s0 + c] : 0.f) * p1(mi, ni, e);
      }, red);
      col_partials<4>(p1, red + 2 * kT);
      __syncthreads();
      if (tid < kT) {   // the diagonal tile's row tid and column tid: one thread
        const int t = t0 + tid, s = s0 + tid;
        if (t < Q) dcum[t] += red[tid] + red[kT + tid];
        if (s < Q) {
          const float col = red[2 * kT + tid] + red[3 * kT + tid];
          ddir[s] += col;
          dcum[s] -= dts[s] * col;
        }
      }
      // dx[s][p] += Σ_t (L ⊙ CB)[t][s] dy_t[p] over this t tile (rows past Q
      // zero in both).
      mma_resident<false, false, 4>(dxa, wt, kWLd, dyt, kLd, kT);
      __syncthreads();   // the tiles and the partials are consumed
    }
    // The state term: inter[s][p] = (G_c B_s)[p] over N, its rings in place of
    // dy_t and (L ⊙ CB), so that x_s stays.
    float in[2][4][4];
    zero(in);
    mma_tile<kBwdStages, kV, true, true, false, 4, T, float>(in, tiles, wt, N,
        [&](int j, int n) { return s0 + j < Q ? brow + (int64_t)(s0 + j) * N + n : nullptr; },
        [&](int n, int p) { return p < P ? gc + (int64_t)p * N + n : nullptr; }, NoScale());
    each_frag<4>([&](int mi, int ni, int e, int r, int p) {
      const int s = s0 + r;
      if (s < Q && p < P)
        put(dx + (row0 + s) * HP + (int64_t)h * P + p,
            dts[s] * fmaf(eo[s], in[mi][ni][e], dxa[mi][ni][e]));
    });
    // xi_s = x_s · (G_c B_s): the direct ddt gets exp(A - cum_s) xi_s, ∂cum_s
    // loses V_s = exp(A - cum_s) dt_s xi_s, which ∂cum_Q gets back below.
    row_partials<4>([&](int mi, int ni, int e) {
      int r, p;
      frag_rc<4>(mi, ni, e, r, p);
      return to_f32(xs[r * kLd + p]) * in[mi][ni][e];
    }, red);
    __syncthreads();
    if (tid < kT && s0 + tid < Q) {
      const int s = s0 + tid;
      const float xi = red[tid] + red[kT + tid], e = eo[s], v = e * dts[s] * xi;
      ddir[s] = fmaf(e, xi, ddir[s]);
      dcum[s] -= v;
      vs[s] = v;
    }
  }
  // The inter-chunk ∂cum term: exp(cum_t) dy_t · (h_in C_t), per t tile, as
  // yiᵀ[p][t] = Σ_n h_in[p][n] C_t[n] with h_in resident in the tiles (zero
  // up to mma_tile's last slab).
  load_tile<kEF>(tiles, kLdH, kT, N16, [&](int r, int c) {
    return r < P && c < N ? hb + (int64_t)r * N + c : nullptr;
  });
  cp_async_commit();
  cp_async_wait<0>();
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * kT;
    float dyv[2][4][4];   // dy_t at this thread's accumulator positions, read first
    each_frag<4>([&](int mi, int ni, int e, int p, int c) {
      dyv[mi][ni][e] = t0 + c < Q && p < P ? to_f32(dyb[(int64_t)(t0 + c) * HP + p]) : 0.f;
    });
    float yi[2][4][4];
    zero(yi);
    mma_tile<kBwdStages, kV, true, true, true, 4, float, T>(yi, nullptr, wt, N, NoSource(),
        [&](int n, int j) { return t0 + j < Q ? crow + (int64_t)(t0 + j) * N + n : nullptr; },
        NoScale(), tiles, kLdH);
    col_partials<4>([&](int mi, int ni, int e) { return dyv[mi][ni][e] * yi[mi][ni][e]; }, red);
    __syncthreads();
    if (tid < kT && t0 + tid < Q) {
      const int t = t0 + tid;
      dcum[t] = fmaf(ei[t], red[tid] + red[kT + tid], dcum[t]);
    }
  }
  // ∂cum_Q += exp(A) <G_c, h_in> + Σ_s V_s. The dot: strided partial sums,
  // then a fixed tree; Σ_s V_s in index order.
  float part = 0.f;
  for (int64_t e = tid; e < PN; e += kThreads) part = fmaf(gc[e], hb[e], part);
  __syncthreads();   // the last row partials are read
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

// Phase 4. Block (((((b * nc + c) * 2 + kind) * nrows + tile) * nslots +
// slot) * ncols + col), kind 0 dB for the s tile, kind 1 dC for the t tile,
// columns in tiles of 16·NI: the slot's partial of the (tile, col) output
// tile into part[b, c, kind, slot]; operands copied in chunks of 16 bytes
// (kV) or one element; x, B, C and dy are T.
template <int NI, bool kV, typename T>
__global__ void __launch_bounds__(kThreads, kV ? 4 : 2)
ssd_bwd_chunk_dbc_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                         const T* __restrict__ cm, const T* __restrict__ dy,
                         const float* __restrict__ h_in, const float* __restrict__ gstates,
                         const float* __restrict__ r, const float* __restrict__ scale_out,
                         const float* __restrict__ scale_in, float* __restrict__ part,
                         int64_t S, int H, int P, int N, int Q) {
  constexpr int kTN = 16 * NI;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring_a = reinterpret_cast<float*>(smem);
  float* ring_b = ring_a + kRingStages * kPlane;
  float* scs = ring_b + kRingStages * kPlane;   // [row][head - h0]
  const int64_t nc = S / Q, HP = (int64_t)H * P, PN = (int64_t)P * N;
  const int nslots = 1 + (H + kHeadGroup - 1) / kHeadGroup;
  const int ncols = (N + kTN - 1) / kTN, nrows = (Q + kT - 1) / kT;
  int64_t rest = blockIdx.x;
  const int col = (int)(rest % ncols);
  rest /= ncols;
  const int slot = (int)(rest % nslots);
  rest /= nslots;
  const int tile = (int)(rest % nrows);
  rest /= nrows;
  const int kind = (int)(rest & 1);
  const int64_t bc = rest >> 1, row0 = bc * Q;
  const int r0 = tile * kT, n0 = col * kTN;
  const float* rb = r + bc * (int64_t)Q * Q;              // R[t][s] at rb + t * Q + s
  const T* brow = bm + row0 * N;
  const T* crow = cm + row0 * N;
  float acc[2][NI][4];
  zero(acc);
  if (slot == 0 && kind == 0) {
    // dB[s][n] = Σ_{t >= s} R[t][s] C_t[n]: t from the s tile's first row.
    mma_tile<kRingStages, kV, false, false, false, NI, float, T>(acc, ring_a, ring_b, Q - r0,
        [&](int j, int k) { return r0 + j < Q ? rb + (int64_t)(r0 + k) * Q + r0 + j : nullptr; },
        [&](int k, int n) { return n0 + n < N ? crow + (int64_t)(r0 + k) * N + n0 + n : nullptr; },
        NoScale());
  } else if (slot == 0) {
    // dC[t][n] = Σ_{s <= t} R[t][s] B_s[n]: s up to the t tile's last row.
    mma_tile<kRingStages, kV, true, false, false, NI, float, T>(acc, ring_a, ring_b,
                                                               min(Q, r0 + kT),
        [&](int i, int k) { return r0 + i < Q ? rb + (int64_t)(r0 + i) * Q + k : nullptr; },
        [&](int k, int n) { return n0 + n < N ? brow + (int64_t)k * N + n0 + n : nullptr; },
        NoScale());
  } else {
    // The heads [h0, h0 + nh): dB: Σ_{h, p} scale_out[s][h] x_s[h][p] G_c[h][p][n];
    // dC: Σ_{h, p} scale_in[t][h] dy_t[h][p] h_in[h][p][n]. Each head takes Pp
    // steps of k, P rounded up to the slab depth (the rest zero), so that
    // every 8-deep step lies in one head and the scale is a row scale.
    const int h0 = (slot - 1) * kHeadGroup, nh = min(kHeadGroup, H - h0);
    const int Pp = (P + kMK - 1) / kMK * kMK;
    const float* sc = kind == 0 ? scale_out : scale_in;
    const T* src = (kind == 0 ? x : dy) + (row0 + r0) * HP + (int64_t)h0 * P;
    const float* st = (kind == 0 ? gstates : h_in) + (bc * H + h0) * PN;   // [k][n], k = (h - h0) P + p
    for (int e = threadIdx.x; e < kT * kHeadGroup; e += kThreads) {
      const int i = e / kHeadGroup, hh = e % kHeadGroup;
      scs[e] = r0 + i < Q && hh < nh ? sc[(row0 + r0 + i) * H + h0 + hh] : 0.f;
    }
    mma_tile<kRingStages, kV, true, false, false, NI, T, float>(acc, ring_a, ring_b, nh * Pp,
        [&](int i, int k) {
          const int hh = k / Pp, p = k - hh * Pp;
          return r0 + i < Q && p < P ? src + (int64_t)i * HP + hh * P + p : nullptr;
        },
        [&](int k, int n) {
          const int hh = k / Pp, p = k - hh * Pp;
          return n0 + n < N && p < P ? st + hh * PN + (int64_t)p * N + n0 + n : nullptr;
        },
        [&](int i, int k) { return scs[i * kHeadGroup + k / Pp]; });
  }
  float* out = part + ((bc * 2 + kind) * nslots + slot) * (int64_t)Q * N;
  each_frag<NI>([&](int mi, int ni, int e, int r, int c) {
    if (r0 + r < Q && n0 + c < N) out[(int64_t)(r0 + r) * N + n0 + c] = acc[mi][ni][e];
  });
}

// Phase 5. Blocks [0, nsum): one output element of dB or dC per thread, the
// slots' partials summed in slot order, rounded once to T; one last block
// sums da.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
ssd_bwd_dbc_sum_kernel(const float* __restrict__ part, const float* __restrict__ da_part,
                       T* __restrict__ db, T* __restrict__ dc, float* __restrict__ da,
                       int64_t BC, int H, int N, int Q, int nslots, int64_t nsum) {
  if (blockIdx.x >= nsum) {
    // da_h = Σ_{b, c} da_part[b, c, h], in order.
    for (int h = threadIdx.x; h < H; h += kSumThreads) {
      float sum = 0.f;
      for (int64_t bc = 0; bc < BC; ++bc) sum += da_part[bc * H + h];
      da[h] = sum;
    }
    return;
  }
  const int64_t QN = (int64_t)Q * N, i = (int64_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= 2 * BC * QN) return;
  const int64_t e = i % QN, bk = i / QN, bc = bk >> 1;   // bk = bc * 2 + kind
  const float* p = part + bk * nslots * QN + e;
  float sum = p[0];
  for (int k = 1; k < nslots; ++k) sum += p[k * QN];
  put(((bk & 1) ? dc : db) + bc * QN + e, sum);
}

int blocks_for(int64_t n, int64_t per, unsigned* out) {
  const int64_t blocks = (n + per - 1) / per;
  if (blocks < 1 || blocks > INT_MAX) return 1;
  *out = (unsigned)blocks;
  return 0;
}

// The chain's operands; x, B, C, dy and dx, dB, dC of element type T.
template <typename T>
struct Chain {
  const T *x, *b, *c, *dy;
  const float *dt, *a, *dh_final;
  const double* cum;
  const float *g, *h_in;
  T *dx, *db, *dc;
  float *ddt, *da, *gstates, *r, *da_part, *scale_out, *scale_in, *part, *r_part;
  int64_t B, S, H, P, N, Q;
};

// Whether every copied operand of chunk_dstate, chunk_bwd and chunk_dbc moves
// in 16-byte chunks and dstate_pass in 16-byte vectors: P and N multiples of
// a chunk's elements of T (4 fp32, 8 bf16), Q a multiple of 4 and every base
// 16-byte aligned.
template <typename T>
bool chunks_of_16(const Chain<T>& k) {
  const void* const bases[] = {k.x, k.dy, k.b, k.c, k.h_in, k.gstates, k.r, k.dh_final,
                               k.r_part};
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  constexpr int kE = kChunk<T, true>;
  return k.P % kE == 0 && k.N % kE == 0 && k.Q % 4 == 0;
}

template <int NI, bool kV, typename T>
void launch_dstate(const Chain<T>& k, unsigned grid, int64_t nr, cudaStream_t st) {
  ssd_bwd_chunk_dstate_kernel<NI, kV, T><<<grid, kThreads, dstate_smem_bytes(), st>>>(
      k.x, k.dt, k.c, k.dy, k.cum, k.gstates, k.r_part, k.S, (int)k.H, (int)k.P, (int)k.N,
      (int)k.Q, nr);
}

template <bool kV, typename T>
void launch_dstate(const Chain<T>& k, int ni, unsigned grid, int64_t nr, cudaStream_t st) {
  if (ni == 1) launch_dstate<1, kV>(k, grid, nr, st);
  else if (ni == 2) launch_dstate<2, kV>(k, grid, nr, st);
  else launch_dstate<4, kV>(k, grid, nr, st);
}

template <int kV, typename T>
void launch_pass(const Chain<T>& k, unsigned grid, int64_t npass, int ngroups, cudaStream_t st) {
  ssd_bwd_dstate_pass_kernel<kV><<<grid, kPassThreads, 0, st>>>(
      k.gstates, k.dh_final, k.cum, k.r_part, k.r, k.S, (int)k.H, (int)(k.P * k.N), (int)k.Q,
      ngroups, npass);
}

template <bool kV, typename T>
void launch_bwd(const Chain<T>& k, unsigned grid, cudaStream_t st) {
  ssd_bwd_chunk_bwd_kernel<kV, T><<<grid, kThreads, bwd_smem_bytes((int)k.Q), st>>>(
      k.x, k.dt, k.a, k.b, k.c, k.dy, k.cum, k.g, k.h_in, k.gstates, k.dx, k.ddt, k.da_part,
      k.scale_out, k.scale_in, k.S, (int)k.H, (int)k.P, (int)k.N, (int)k.Q);
}

template <int NI, bool kV, typename T>
void launch_dbc(const Chain<T>& k, unsigned grid, cudaStream_t st) {
  ssd_bwd_chunk_dbc_kernel<NI, kV, T><<<grid, kThreads, dbc_smem_bytes(), st>>>(
      k.x, k.b, k.c, k.dy, k.h_in, k.gstates, k.r, k.scale_out, k.scale_in, k.part, k.S,
      (int)k.H, (int)k.P, (int)k.N, (int)k.Q);
}

template <bool kV, typename T>
void launch_dbc(const Chain<T>& k, int ni, unsigned grid, cudaStream_t st) {
  if (ni == 1) launch_dbc<1, kV>(k, grid, st);
  else if (ni == 2) launch_dbc<2, kV>(k, grid, st);
  else launch_dbc<4, kV>(k, grid, st);
}

template <bool kV, typename T>
cudaError_t set_smem_limits(cudaFuncAttribute max_smem) {
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_chunk_bwd_kernel<kV, T>, max_smem,
                                         (int)bwd_smem_bytes(kMaxQ));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk_dstate_kernel<1, kV, T>, max_smem,
                               (int)dstate_smem_bytes());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk_dstate_kernel<2, kV, T>, max_smem,
                               (int)dstate_smem_bytes());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk_dstate_kernel<4, kV, T>, max_smem,
                               (int)dstate_smem_bytes());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk_dbc_kernel<1, kV, T>, max_smem,
                               (int)dbc_smem_bytes());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk_dbc_kernel<2, kV, T>, max_smem,
                               (int)dbc_smem_bytes());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_chunk_dbc_kernel<4, kV, T>, max_smem,
                               (int)dbc_smem_bytes());
  return err;
}

// Launches phases [first, last] of the chain (1-based, as numbered above).
template <typename T>
int launch_phases(const Chain<T>& k, int first, int last, cudaStream_t st) {
  const int64_t B = k.B, S = k.S, H = k.H, P = k.P, N = k.N, Q = k.Q;
  if (B < 1 || H < 1 || H > INT_MAX || P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 ||
      Q > kMaxQ || S < Q || S % Q != 0 || H * P > INT_MAX || first < 1 || last > 5)
    return (int)cudaErrorInvalidValue;
  const int64_t nc = S / Q, ntiles = (Q + kT - 1) / kT, npairs = ntiles * (ntiles + 1) / 2;
  const int ni = N <= 16 ? 1 : N <= 32 ? 2 : 4;
  const int64_t ncols = (N + 16 * ni - 1) / (16 * ni);
  const int64_t ngroups = (H + kRHeadGroup - 1) / kRHeadGroup;
  const int64_t nr = B * nc * ngroups * npairs, nd = B * nc * H * ncols;
  const bool vec = chunks_of_16(k);
  const int64_t span = kPassThreads * (vec ? 4 : 1);
  const int64_t npass = B * H * ((P * N + span - 1) / span);
  const int64_t nslots = 1 + (H + kHeadGroup - 1) / kHeadGroup;
  const int64_t ndbc = B * nc * 2 * ntiles * nslots * ncols;
  const int64_t nsum = (2 * B * S * N + kSumThreads - 1) / kSumThreads;
  unsigned g1, g2, g3, g4, g5;
  if (blocks_for(nr + nd, 1, &g1) || blocks_for(npass + B * nc * npairs, 1, &g2) ||
      blocks_for(B * nc * H, 1, &g3) || blocks_for(ndbc, 1, &g4) || blocks_for(nsum + 1, 1, &g5))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  for (int phase = first; phase <= last; ++phase) {
    switch (phase) {
      case 1:
        if (vec) launch_dstate<true>(k, ni, g1, nr, st);
        else launch_dstate<false>(k, ni, g1, nr, st);
        break;
      case 2:
        if (vec) launch_pass<4>(k, g2, npass, (int)ngroups, st);
        else launch_pass<1>(k, g2, npass, (int)ngroups, st);
        break;
      case 3:
        if (vec) launch_bwd<true>(k, g3, st);
        else launch_bwd<false>(k, g3, st);
        break;
      case 4:
        if (vec) launch_dbc<true>(k, ni, g4, st);
        else launch_dbc<false>(k, ni, g4, st);
        break;
      default:
        ssd_bwd_dbc_sum_kernel<T><<<g5, kSumThreads, 0, st>>>(k.part, k.da_part, k.db, k.dc,
                                                              k.da, B * nc, (int)H, (int)N,
                                                              (int)Q, (int)nslots, nsum);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// The chain on the caller's pointers, x, b, c, dy, dx, db, dc of element type
// T.
template <typename T>
int launch_typed(int first, int last, const void* x, const float* dt, const float* a,
                 const void* b, const void* c, const void* dy, const float* dh_final,
                 const double* cum, const float* g, const float* h_in, void* dx, float* ddt,
                 float* da, void* db, void* dc, float* gstates, float* r, float* da_part,
                 float* scale_out, float* scale_in, float* part, float* r_part, int64_t B,
                 int64_t S, int64_t H, int64_t P, int64_t N, int64_t Q, cudaStream_t st) {
  const Chain<T> k{static_cast<const T*>(x), static_cast<const T*>(b), static_cast<const T*>(c),
                   static_cast<const T*>(dy), dt, a, dh_final, cum, g, h_in,
                   static_cast<T*>(dx), static_cast<T*>(db), static_cast<T*>(dc), ddt, da,
                   gstates, r, da_part, scale_out, scale_in, part, r_part, B, S, H, P, N, Q};
  return launch_phases(k, first, last, st);
}

int launch_dtype(int first, int last, int bf16, const void* x, const float* dt, const float* a,
                 const void* b, const void* c, const void* dy, const float* dh_final,
                 const double* cum, const float* g, const float* h_in, void* dx, float* ddt,
                 float* da, void* db, void* dc, float* gstates, float* r, float* da_part,
                 float* scale_out, float* scale_in, float* part, float* r_part, int64_t B,
                 int64_t S, int64_t H, int64_t P, int64_t N, int64_t Q, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16 != 0 && bf16 != 1) return (int)cudaErrorInvalidValue;
  auto run = bf16 ? launch_typed<__nv_bfloat16> : launch_typed<float>;
  return run(first, last, x, dt, a, b, c, dy, dh_final, cum, g, h_in, dx, ddt, da, db, dc,
             gstates, r, da_part, scale_out, scale_in, part, r_part, B, S, H, P, N, Q, st);
}

}  // namespace

// Sets chunk_dstate's, chunk_bwd's (for Q up to 1024) and chunk_dbc's
// dynamic shared memory limits on the current device, for both element
// types. Call once per device before the first launch there, outside any
// stream capture. Returns a cudaError_t code, 0 on success.
extern "C" int ssd_scan_bwd_init() {
  const cudaFuncAttribute max_smem = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err = set_smem_limits<false, float>(max_smem);
  if (err == cudaSuccess) err = set_smem_limits<true, float>(max_smem);
  if (err == cudaSuccess) err = set_smem_limits<false, __nv_bfloat16>(max_smem);
  if (err == cudaSuccess) err = set_smem_limits<true, __nv_bfloat16>(max_smem);
  return (int)err;
}

// x, b, c, dy and dx, db, dc: fp32 (bf16 == 0) or bf16 (bf16 == 1), one
// type; every other tensor fp32 but cum (fp64); all contiguous: x, dy, dx
// (B,S,H,P); dt, ddt (B,S,H); a, da (H,); b, c, db, dc (B,S,N); dh_final
// (B,H,P,N); the forward's workspaces cum (B,H,S), g (B,S/Q,Q,Q), h_in
// (B,S/Q,H,P,N). Workspaces allocated by the caller and overwritten: gstates
// (B,S/Q,H,P,N), r (B,S/Q,Q,Q), da_part (B,S/Q,H), scale_out and scale_in
// (B,S,H), part (B,S/Q,2,1+ceil(H/16),Q,N), r_part (B,S/Q,ceil(H/16),Q,Q).
// Launches the five phases in order on `stream`. Returns a cudaError_t code, 0 on success;
// cudaErrorInvalidValue for shapes outside the kernels' limits.
extern "C" int ssd_scan_bwd_launch(const void* x, const float* dt, const float* a,
                                   const void* b, const void* c, const void* dy,
                                   const float* dh_final, const double* cum, const float* g,
                                   const float* h_in, void* dx, float* ddt, float* da,
                                   void* db, void* dc, float* gstates, float* r,
                                   float* da_part, float* scale_out, float* scale_in,
                                   float* part, float* r_part, int64_t B, int64_t S, int64_t H,
                                   int64_t P, int64_t N, int64_t Q, int bf16, void* stream) {
  return launch_dtype(1, 5, bf16, x, dt, a, b, c, dy, dh_final, cum, g, h_in, dx, ddt, da, db,
                      dc, gstates, r, da_part, scale_out, scale_in, part, r_part, B, S, H, P,
                      N, Q, stream);
}

// ssd_scan_bwd_launch's phase `phase` (1..5) alone, on workspaces that an
// earlier full launch filled: for timing each kernel. dstate_pass turns
// gstates over again on every call (and sums R again).
extern "C" int ssd_scan_bwd_phase_launch(int phase, const void* x, const float* dt,
                                         const float* a, const void* b, const void* c,
                                         const void* dy, const float* dh_final,
                                         const double* cum, const float* g, const float* h_in,
                                         void* dx, float* ddt, float* da, void* db, void* dc,
                                         float* gstates, float* r, float* da_part,
                                         float* scale_out, float* scale_in, float* part,
                                         float* r_part, int64_t B, int64_t S, int64_t H,
                                         int64_t P, int64_t N, int64_t Q, int bf16,
                                         void* stream) {
  if (phase < 1 || phase > 5) return (int)cudaErrorInvalidValue;
  return launch_dtype(phase, phase, bf16, x, dt, a, b, c, dy, dh_final, cum, g, h_in, dx, ddt,
                      da, db, dc, gstates, r, da_part, scale_out, scale_in, part, r_part, B, S,
                      H, P, N, Q, stream);
}
