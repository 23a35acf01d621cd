// ssd_scan_mma.cuh — the tensor-core routine shared by the ssd_scan chains
// (ssd_scan.cu, the forward; ssd_scan_bwd.cu, its gradient), for NVIDIA
// Hopper (sm_90a).
//
// Products of fp32 operands run on mma.sync m16n8k8 TF32 as 3xTF32
// (mma_step): each operand v is split into big, v rounded to TF32, and
// small = v - big, and a tile takes big·small + small·big + big·big, which
// leaves ≈ 2^-21 of each product, fp32's order. A bf16 operand is exact in
// TF32, so its small part is zero and the product that reads it is dropped
// at compile time (2xTF32). Operands move from global to shared memory by
// cp.async into rings of stages ahead of the products (mma_tile), or as
// whole tiles that stay (load_tile, mma_resident); a resident operand may
// also be stored already split (Tf32Split), so that no fragment load splits
// it again.
//
// Included by both sources inside no namespace of theirs: everything here
// lives in an unnamed namespace, one copy per library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kT = 64;          // output tile rows
constexpr int kThreads = 128;   // 2 x 2 warps
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxQ = 1024;
constexpr int kMK = 16;         // the tensor-core routine: depth of one shared slab
constexpr int kLdM = kMK + 4;   // row stride of an m-major plane: fragment loads hit 32 banks
constexpr int kPlane = kT * kLdM;   // words per plane, >= kMK * (kT + 8) for a k-major one
constexpr int kLdT = kT + 4;    // row stride of a resident 64-wide fp32 tile
constexpr int kRingStages = 4;  // mma_tile's ring stages where shared memory allows
static_assert(kPlane >= kMK * (kT + 8), "a k-major plane fits");

// The element types of x, B, C, dy and dx, dB, dC.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
template <typename T>
constexpr bool IsBf16 = false;
template <>
constexpr bool IsBf16<__nv_bfloat16> = true;

// A resident operand stored already split for 3xTF32 (split_tf32's big and
// small, as bit patterns): big at A[m * lda + k], m-major, small
// kSplitWords further on. mma_step loads its fragments without a split.
struct Tf32Split {
  uint32_t bits;
};
template <typename T>
constexpr bool IsSplit = false;
template <>
constexpr bool IsSplit<Tf32Split> = true;
constexpr int kLdW = kT + 4;               // row stride of a split plane (64 k wide)
constexpr int kSplitWords = kT * kLdW;     // words from the big plane to the small one
__device__ __forceinline__ float to_f32(Tf32Split v) { return __uint_as_float(v.bits); }

// Elements of T per copied chunk: 16 bytes (kV), else one element.
template <typename T, bool kV>
constexpr int kChunk = kV ? 16 / (int)sizeof(T) : 1;
// Row strides, in elements of T, of an m-major plane and of the dy_t and x_s
// tiles: a 16-byte chunk of bf16 needs rows a multiple of 8 elements apart.
template <typename T>
constexpr int kLdMOf = IsBf16<T> ? kMK + 8 : kLdM;
template <typename T>
constexpr int kLdTOf = IsBf16<T> ? kT + 8 : kLdT;
static_assert(kT * kLdMOf<__nv_bfloat16> / 2 <= kPlane && kT * kLdTOf<__nv_bfloat16> / 2 <= kT * kLdT,
              "a bf16 plane or tile fits an fp32 one's words");

// ---- The tensor-core routine (chunk_dstate, chunk_bwd, chunk_dbc) ---------
//
// A block's output tile is 64 rows x 16·NI columns; its four warps are 2 x 2,
// each owning 32 rows x 8·NI columns as 2 x NI mma tiles of 16 x 8. A
// thread's accumulator acc[mi][ni][e] is element e of the m16n8 tile (mi,
// ni): frag_rc gives its row and column.

// d += a · b on one m16n8k8 tile, TF32 operands, fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block-tile row r and column c of accumulator element e of mma tile
// (mi, ni): the one map every epilogue uses.
template <int NI>
__device__ __forceinline__ void frag_rc(int mi, int ni, int e, int& r, int& c) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  r = (warp >> 1) * 32 + mi * 16 + (lane >> 2) + 8 * (e >> 1);
  c = (warp & 1) * 8 * NI + ni * 8 + 2 * (lane & 3) + (e & 1);
}

// f(mi, ni, e, r, c) for every accumulator element of this thread, (r, c)
// its row and column (frag_rc).
template <int NI, typename F>
__device__ __forceinline__ void each_frag(F f) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, c;
        frag_rc<NI>(mi, ni, e, r, c);
        f(mi, ni, e, r, c);
      }
}

template <int NI>
__device__ __forceinline__ void zero(float (&acc)[2][NI][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// Where element (m, k) of a slab of `rows` rows of T lies in its plane:
// m-major (rows kLdMOf<T> apart) when the source runs along k, else k-major
// (rows of rows + 8). Either way a fp32 fragment load's 32 lanes hit 32
// banks, and the stores, consecutive along the source, at most two to a
// bank.
template <bool kAlongK, int kRows, typename T>
__device__ __forceinline__ int plane_at(int m, int k) {
  return kAlongK ? m * kLdMOf<T> + k : k * (kRows + 8) + m;
}

// Copy of kBytes (16, 8 or 4 bytes, as aligned) from global to shared
// memory by cp.async, and its group bookkeeping. cp.async has no 2-byte
// form: a lone bf16 element is copied by a load and a store, landed before
// the barrier that follows the group's wait.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
  else if constexpr (kBytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(d), "l"(src) : "memory");
  else if constexpr (kBytes == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(d), "l"(src) : "memory");
  else
    *static_cast<unsigned short*>(dst) = *static_cast<const unsigned short*>(src);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// v = big + small as the tensor core reads TF32 operands, dropping the low 13
// bits of each: big is v rounded to TF32 to nearest, ties away from zero
// (half a TF32 ulp added to the magnitude bits, as cvt.rna.tf32 rounds),
// small = v - big, which the tensor core truncates to TF32. Three
// instructions where two cvt.rna.tf32 took about nine; no inf or NaN reaches
// a product here.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(v) + 0x1000u;
  small = __float_as_uint(v - __uint_as_float(big & 0xffffe000u));
}

// mma_tile's operand maps: no row scale; a scale w[k] of A's column k in
// place of a row scale (PerK); no source (a resident A).
struct NoScale {
  __device__ float operator()(int, int) const { return 1.f; }
};
struct KScale {
  const float* w;
  __device__ float operator()(int, int k) const { return w[k]; }
};
template <typename XA>
constexpr bool PerK = false;
template <>
constexpr bool PerK<KScale> = true;
struct NoSource {
  __device__ std::nullptr_t operator()(int, int) const { return nullptr; }
};

// Zero-fills kBytes of shared memory (where a copy has no source).
template <int kBytes>
__device__ __forceinline__ void zero_chunk(void* dst) {
  static_assert(kBytes == 16 || kBytes == 8 || kBytes == 4 || kBytes == 2,
                "zero_chunk: a chunk is 16, 8, 4 or 2 bytes");
  if constexpr (kBytes == 16) *static_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  else if constexpr (kBytes == 8) *static_cast<float2*>(dst) = make_float2(0.f, 0.f);
  else if constexpr (kBytes == 4) *static_cast<float*>(dst) = 0.f;
  else *static_cast<unsigned short*>(dst) = 0;
}

// One 8-deep step of k of the block's 64 x 16·NI product, both operands in
// shared memory, the step at A's depth ka and B's kb: A(m, k) at A[m * lda +
// k] (kAk) or A[k * lda + m], B(k, n) at B[n * ldb + k] (kBk) or B[k * ldb +
// n], each widened to fp32 as it is read. Each fragment element is split
// into big = rna_tf32(v) and small = rna_tf32(v - big) as it is loaded, A's
// rows scaled by xa(m, kabs) first (kabs the step's depth in the whole
// product; with a PerK xa, element k of A's rows by xa(m, kabs + k)), B's
// columns by xb(n, kabs), and a tile takes big·small + small·big + big·big;
// an unscaled bf16 operand's small part is zero, and the product that reads
// it is skipped. A Tf32Split A (m-major, unscaled) is loaded already split.
// With the fp32 row strides used here (20, 68, 72, 132, 16·NI
// + 8) no two lanes of a fragment load hit one bank, but for a k-major B at
// stride 68 (two).
template <bool kAk, bool kBk, int NI, typename TA, typename TB, typename XA,
          typename XB = NoScale>
__device__ __forceinline__ void mma_step(float (&acc)[2][NI][4], const TA* __restrict__ A,
                                         int lda, int ka, const TB* __restrict__ B, int ldb,
                                         int kb, XA xa, int kabs, XB xb = XB()) {
  constexpr bool kAExact = IsBf16<TA> && std::is_same_v<XA, NoScale>;
  constexpr bool kBExact = IsBf16<TB> && std::is_same_v<XB, NoScale>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wr = (warp >> 1) * 32, wc = (warp & 1) * 8 * NI;
  auto a_at = [&](int m, int kk) { return to_f32(kAk ? A[m * lda + kk] : A[kk * lda + m]); };
  auto b_at = [&](int kk, int n) { return to_f32(kBk ? B[n * ldb + kk] : B[kk * ldb + n]); };
  uint32_t bb[NI][2], bs[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
    const int n = wc + ni * 8 + g;
    const float sn = xb(n, kabs);
    split_tf32(sn * b_at(kb + q, n), bb[ni][0], bs[ni][0]);
    split_tf32(sn * b_at(kb + q + 4, n), bb[ni][1], bs[ni][1]);
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int m = wr + mi * 16 + g;
    uint32_t ab[4], as[4];
    if constexpr (IsSplit<TA>) {
      static_assert(kAk && std::is_same_v<XA, NoScale>, "a split A is m-major and unscaled");
      const uint32_t* big = reinterpret_cast<const uint32_t*>(A);
      const int i0 = m * lda + ka + q, i1 = i0 + 8 * lda;
      ab[0] = big[i0], ab[1] = big[i1], ab[2] = big[i0 + 4], ab[3] = big[i1 + 4];
      as[0] = big[kSplitWords + i0], as[1] = big[kSplitWords + i1];
      as[2] = big[kSplitWords + i0 + 4], as[3] = big[kSplitWords + i1 + 4];
    } else {
      float sc[4];   // the scales of A's fragment elements (m, q), (m + 8, q), (m, q + 4), (m + 8, q + 4)
      if constexpr (PerK<XA>) {
        sc[0] = sc[1] = xa(m, kabs + q);
        sc[2] = sc[3] = xa(m, kabs + q + 4);
      } else {
        sc[0] = sc[2] = xa(m, kabs);
        sc[1] = sc[3] = xa(m + 8, kabs);
      }
      split_tf32(sc[0] * a_at(m, ka + q), ab[0], as[0]);
      split_tf32(sc[1] * a_at(m + 8, ka + q), ab[1], as[1]);
      split_tf32(sc[2] * a_at(m, ka + q + 4), ab[2], as[2]);
      split_tf32(sc[3] * a_at(m + 8, ka + q + 4), ab[3], as[3]);
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      if constexpr (!kBExact) mma_tf32(acc[mi][ni], ab, bs[ni][0], bs[ni][1]);
      if constexpr (!kAExact) mma_tf32(acc[mi][ni], as, bb[ni][0], bb[ni][1]);
      mma_tf32(acc[mi][ni], ab, bb[ni][0], bb[ni][1]);
    }
  }
}

// acc += A · B over a depth (a multiple of 8) of operands already in shared
// memory (layouts as mma_step's), A's rows scaled by xa(m, k) and B's
// columns by xb(n, k), each uniform over an 8-deep step. No barrier: the
// caller makes them ready.
template <bool kAk, bool kBk, int NI, typename XA = NoScale, typename XB = NoScale, typename TA,
          typename TB>
__device__ __forceinline__ void mma_resident(float (&acc)[2][NI][4], const TA* A, int lda,
                                             const TB* B, int ldb, int depth, XA xa = XA(),
                                             XB xb = XB()) {
  for (int k = 0; k < depth; k += 8)
    mma_step<kAk, kBk, NI>(acc, A, lda, k, B, ldb, k, xa, k, xb);
}

// This thread's share of a rows x cols tile of T copied by cp.async into
// dst (rows ld elements apart) in chunks of kE elements along the columns
// (cols a multiple of kE); src(r, c) gives the chunk's address, nullptr for
// zeros. The caller commits and waits.
template <int kE, typename T, typename F>
__device__ __forceinline__ void load_tile(T* dst, int ld, int rows, int cols, F src) {
  constexpr int kBytes = kE * (int)sizeof(T);
  const int per_row = cols / kE, dr = kThreads / per_row, dc = kThreads % per_row;
  int r = threadIdx.x / per_row, cc = threadIdx.x % per_row;
  while (r < rows) {
    const int col = cc * kE;
    const T* from = src(r, col);
    if (from) cp_async<kBytes>(dst + r * ld + col, from);
    else zero_chunk<kBytes>(dst + r * ld + col);
    r += dr;
    cc += dc;
    if (cc >= per_row) cc -= per_row, ++r;
  }
}

// acc += Σ_{k < depth} A(m, k) · B(k, n) over the block's 64 x 16·NI tile
// in 3xTF32, A's rows scaled by xa(m, k), uniform over each 8-deep step of
// k (NoScale() where there is none), or A's columns by a KScale's w[k] (w
// read up to the last slab's end).
//
// Operands come from global memory in chunks of 16 bytes (kV; else one
// element) along the dimension their source runs along (kAk / kBk: along k;
// else along m / n): sa(m, k) (sb(k, n)) gives the address of the chunk
// that starts at the element, nullptr where the chunk is zero; consecutive
// threads take consecutive chunks, so the copies are coalesced. A's elements
// are TA, B's TB (fp32 or bf16; a resident A may be Tf32Split, stored split
// by the caller). With kARes, A is no copy but resident in
// shared memory at a_res over the whole depth (rows lda apart, layout as
// mma_step's). depth is a multiple of a chunk's elements.
//
// The copies run by cp.async into rings of kS planes for A (ring_a) and for
// B (ring_b), kS - 1 slabs ahead of the products, so no register holds a
// load in flight. A plane holds its slab as it is in memory: m-major (rows
// kLdMOf apart) when the source runs along k, else k-major (rows of
// 64 + 8 or 16·NI + 8), so neither the chunk stores nor the fp32 fragment
// loads hit a bank twice. A barrier precedes the first read of the planes
// and of a_res, so the caller may write a_res right before the call; the
// call ends with a barrier, so the caller may write it right after.
template <int kS, bool kV, bool kAk, bool kBk, bool kARes, int NI, typename TA, typename TB,
          typename SA, typename SB, typename XA>
__device__ __forceinline__ void mma_tile(float (&acc)[2][NI][4], float* __restrict__ ring_a,
                                         float* __restrict__ ring_b, int depth, SA sa, SB sb,
                                         XA xa, const TA* __restrict__ a_res = nullptr,
                                         int lda = 0) {
  constexpr int kTN = 16 * NI;
  constexpr int kEA = kChunk<TA, kV>, kEB = kChunk<TB, kV>;
  constexpr int kChunksA = kARes ? 0 : kT * kMK / kEA;
  constexpr int kChunksB = kTN * kMK / kEB;
  constexpr int kLdA = kAk ? kLdMOf<TA> : kT + 8, kLdB = kBk ? kLdMOf<TB> : kTN + 8;
  const int nslabs = (depth + kMK - 1) / kMK;
  // This thread's chunks of slab t into stage t % kS, one group.
  auto issue = [&](int t) {
    if (t < nslabs) {
      TA* const a_st = reinterpret_cast<TA*>(ring_a + (t % kS) * kPlane);
      TB* const b_st = reinterpret_cast<TB*>(ring_b + (t % kS) * kPlane);
      const int k0 = t * kMK;
#pragma unroll
      for (int i = 0; i < (kChunksA + kThreads - 1) / kThreads; ++i) {
        const int c = threadIdx.x + i * kThreads;
        constexpr int kPerLine = kAk ? kMK / kEA : kT / kEA;
        const int k = kAk ? c % kPerLine * kEA : c / kPerLine;
        const int m = kAk ? c / kPerLine : c % kPerLine * kEA;
        if (c < kChunksA) {
          TA* dst = a_st + plane_at<kAk, kT, TA>(m, k);
          const TA* src = k0 + k < depth ? sa(m, k0 + k) : nullptr;
          if (src) cp_async<kEA * (int)sizeof(TA)>(dst, src);
          else zero_chunk<kEA * (int)sizeof(TA)>(dst);
        }
      }
#pragma unroll
      for (int i = 0; i < (kChunksB + kThreads - 1) / kThreads; ++i) {
        const int c = threadIdx.x + i * kThreads;
        constexpr int kPerLine = kBk ? kMK / kEB : kTN / kEB;
        const int k = kBk ? c % kPerLine * kEB : c / kPerLine;
        const int n = kBk ? c / kPerLine : c % kPerLine * kEB;
        if (c < kChunksB) {
          TB* dst = b_st + plane_at<kBk, kTN, TB>(n, k);
          const TB* src = k0 + k < depth ? sb(k0 + k, n) : nullptr;
          if (src) cp_async<kEB * (int)sizeof(TB)>(dst, src);
          else zero_chunk<kEB * (int)sizeof(TB)>(dst);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < kS - 1; ++t) issue(t);
  for (int t = 0; t < nslabs; ++t) {
    cp_async_wait<kS - 2>();   // this thread's chunks of slab t have landed
    __syncthreads();           // everyone's have, and slab t - 1's stage is free
    issue(t + kS - 1);
    const int k0 = t * kMK;
#pragma unroll
    for (int kk = 0; kk < kMK; kk += 8) {
      const TB* b_st = reinterpret_cast<const TB*>(ring_b + (t % kS) * kPlane);
      if constexpr (kARes)
        mma_step<kAk, kBk, NI>(acc, a_res, lda, k0 + kk, b_st, kLdB, kk, xa, k0 + kk);
      else
        mma_step<kAk, kBk, NI>(acc, reinterpret_cast<const TA*>(ring_a + (t % kS) * kPlane),
                               kLdA, kk, b_st, kLdB, kk, xa, k0 + kk);
    }
  }
  cp_async_wait<0>();          // only empty groups remain
  __syncthreads();
}

}  // namespace
