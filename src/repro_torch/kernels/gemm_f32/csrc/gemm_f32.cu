// gemm_f32.cu — y = x @ W for fp32 x (M, K) and W (K, N), both row-major,
// on Hopper's tensor cores at fp32 accuracy (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its weight products to
// XLA (jnp.matmul). It was added because fp32 prefill spent most of its
// time in cuBLAS's SGEMM, which runs on the CUDA cores at ≈ 50 of their
// 67 TFLOP/s. Here each product is 3xTF32 on the tensor cores: an operand
// v is split into big = v rounded to TF32 (cvt.rna) and small = v - big
// (exact in fp32, then rounded to TF32 too), and a tile takes
// small·big + big·small + big·big, which leaves ≈ 2^-22 of each product,
// fp32's order. The tensor cores add into their fp32 accumulator rounding
// toward zero, and over K = 2560 those roundings alone left 7x the error of
// cuBLAS's fp32 SGEMM (measured on an H100), so each stage's products go
// into a fresh wgmma accumulator that the thread then adds, rounding to
// nearest, into its own fp32 sum: the tensor cores round only within 32
// steps of k. The bound is the tensor cores' 495 / 3 = 165 TFLOP/s of such
// products (well above the 3.35 TB/s of the operands at the model's
// shapes).
//
// The tensor cores read a TF32 operand from shared memory K-major only,
// and W (K, N) row-major is N-major, so the kernel computes yᵀ = Wᵀ xᵀ:
// wgmma's A operand is W's tile, loaded from shared memory into registers
// (where the layout is free) and split there; its B operand is x's tile,
// which TMA lands K-major as it lies in memory. x's tile is split in shared
// memory once per stage: big overwrites the tile in place and small goes to
// a plane beside it with the same (swizzled) layout, so the split is
// elementwise and needs no transpose.
//
// Design: one persistent block per SM walks over 128 x 128 tiles of y.
// One thread of warp group 0 keeps a ring of kStages stages full with TMA
// loads (x's 128 x 32 box, W's 32 x 128 as four 32 x 32 boxes, all with
// the 128-byte swizzle). Warp groups 1 and 2 each own 64 columns of the
// tile: per stage each splits half of the next stage's x tile, then they
// load and split their W fragments, start twelve m64n128k8 wgmmas (four k8
// steps, three products each), release the stage and add its sum into
// their own. On an H100 at (8192, 2560, 5120) this took 2.23-2.41 ms; a
// separate warp group splitting x took 2.48 ms, splitting while the wgmmas
// run 2.37 ms, and no split at all (a wrong result) 1.93-2.05 ms: the
// split's shared-memory traffic, not its instructions, is what it costs.
// TMA zero-fills rows and columns outside x and W, so ragged M, N and K
// need no padding; the epilogue stores y from the accumulators with
// predicated stores.
//
// Plain C interface, loaded with ctypes: gemm_f32_init once per device,
// then gemm_f32_launch; each returns a cudaError_t (kEncodeFailed where
// cuTensorMapEncodeTiled refused a tensor map).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                 // rows of y a tile: wgmma's N
constexpr int kBN = 128;                 // columns of y a tile: 2 consumer warp groups x 64 (wgmma's M)
constexpr int kBK = 32;                  // depth of a stage: 128 bytes of an x row
constexpr int kSteps = kBK / 8;          // wgmma k8 steps a stage
constexpr int kStages = 4;
constexpr int kAcc = kBM / 2;            // accumulator registers a thread: 64 x kBM over 128
constexpr int kWBox = 32;                // columns of W a TMA box: 128 bytes
constexpr int kXBytes = kBM * kBK * 4;   // one x plane (big or small)
constexpr int kWBoxBytes = kBK * kWBox * 4;
constexpr int kWBytes = kBK * kBN * 4;
constexpr int kStageBytes = 2 * kXBytes + kWBytes;
constexpr int kThreads = 384;            // warp group 0 feeds, 1 and 2 compute
constexpr int kConsumers = 256;
constexpr int kSplitChunks = kXBytes / 16 / kConsumers;   // 16-byte chunks a consumer splits a stage
static_assert(kSplitChunks * 16 * kConsumers == kXBytes, "the consumers split a whole x tile");
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 3 * kStages * 8;
constexpr int kEncodeFailed = 10000;
static_assert(kStageBytes % 1024 == 0 && kXBytes % 1024 == 0 && kWBoxBytes % 1024 == 0,
              "swizzled tiles stay 1024-byte aligned");
static_assert(kSmemBytes <= 232448, "fits a block's shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small, each a TF32 value rounded to nearest; small carries
// what big leaves of v (v - big is exact in fp32).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// A K-major shared-memory operand of wgmma: rows of kBK fp32 (128 bytes)
// under the 128-byte swizzle, eight-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_x(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>((8 * kBK * 4) >> 4) << 32) | (1ull << 62);
}

#define GEMM_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define GEMM_D16(i) GEMM_D4(i), GEMM_D4(i + 4), GEMM_D4(i + 8), GEMM_D4(i + 12)

// d (64 x 128, fp32) = a (64 x 8, TF32 in registers) · b (8 x 128, TF32,
// K-major in shared memory), plus d where ``add``.
__device__ __forceinline__ void wgmma_tf32(float (&d)[kAcc], const uint32_t (&a)[4], uint64_t b,
                                           int add) {
  static_assert(kAcc == 64, "m64n128k8");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : GEMM_D16(0), GEMM_D16(16), GEMM_D16(32), GEMM_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(add));
}

// The tile column (0..127) of row g + 8h of consumer warp group cw's
// wgmma tile in warp ``warp``: W's column that the row's A fragment holds,
// and y's column that the accumulator row is stored to.
__device__ __forceinline__ int tile_col(int cw, int warp, int g, int h) {
  return 64 * cw + 16 * warp + g + 8 * h;
}

// Keeps the compiler from moving reads or writes of the accumulators
// across a wgmma fence or wait.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(kThreads, 1)
    gemm_f32_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w, float* __restrict__ y,
                    int64_t m_rows, int64_t n_cols, int64_t k_depth) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  const uint32_t full0 = smem_u32(bars);             // TMA landed (expect_tx)
  const uint32_t ready0 = full0 + 8 * kStages;       // x split (kConsumers arrivals)
  const uint32_t empty0 = ready0 + 8 * kStages;      // consumed (8 consumer warps)
  const uint32_t smem0 = smem_u32(smem);

  const int tiles_m = static_cast<int>((m_rows + kBM - 1) / kBM);
  const int tiles_n = static_cast<int>((n_cols + kBN - 1) / kBN);
  const int tiles = tiles_m * tiles_n;
  const int k_tiles = static_cast<int>((k_depth + kBK - 1) / kBK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(ready0 + 8 * s, kConsumers);
      mbar_init(empty0 + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int warp = threadIdx.x / 32;
    if (warp == 0) {
      // TMA producer: one lane keeps the ring full.
      if (threadIdx.x == 0) {
        int it = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
          const int m0 = (tile % tiles_m) * kBM, n0 = (tile / tiles_m) * kBN;
          for (int kt = 0; kt < k_tiles; ++kt, ++it) {
            const int s = it % kStages;
            const uint32_t round = it / kStages;
            mbar_wait(empty0 + 8 * s, (round & 1) ^ 1);
            const uint32_t full = full0 + 8 * s, base = smem0 + s * kStageBytes;
            mbar_expect_tx(full, kXBytes + kWBytes);
            tma_load(base, &map_x, full, kt * kBK, m0);
#pragma unroll
            for (int b = 0; b < kBN / kWBox; ++b)
              tma_load(base + 2 * kXBytes + b * kWBoxBytes, &map_w, full, n0 + b * kWBox,
                       kt * kBK);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int cw = wg - 1;                     // this warp group's 64 columns of the tile
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, q = lane % 4;
    const int ct = threadIdx.x - 128;          // 0..255 among the consumers
    // Splits this thread's chunks of stage ``it``'s x tile once TMA has
    // landed it: big in place, small beside it; then signals the split.
    auto split_x = [&](int it) {
      const int s = it % kStages;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      uint4* big = reinterpret_cast<uint4*>(smem + s * kStageBytes);
      uint4* small = reinterpret_cast<uint4*>(smem + s * kStageBytes + kXBytes);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint4 v[kSplitChunks / 2];
#pragma unroll
        for (int j = 0; j < kSplitChunks / 2; ++j) v[j] = big[ct + kConsumers * (half * kSplitChunks / 2 + j)];
#pragma unroll
        for (int j = 0; j < kSplitChunks / 2; ++j) {
          uint4 b, l;
          split_tf32(__uint_as_float(v[j].x), b.x, l.x);
          split_tf32(__uint_as_float(v[j].y), b.y, l.y);
          split_tf32(__uint_as_float(v[j].z), b.z, l.z);
          split_tf32(__uint_as_float(v[j].w), b.w, l.w);
          const int i = ct + kConsumers * (half * kSplitChunks / 2 + j);
          big[i] = b;
          small[i] = l;
        }
      }
      // The tensor cores read the planes through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(ready0 + 8 * s);
    };
    const int my_tiles = (tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
    const int total = my_tiles * k_tiles;
    split_x(0);
    // W fragment rows r0 and r0 + 8 of this thread (columns of the tile),
    // at k = q and q + 4 of the first k8 step: word offsets in a stage's W
    // part (four 32 x 32 boxes, rows of 128 bytes under the 128-byte
    // swizzle, which XORs the same k % 8 into each later k8 step's rows).
    int w_off[2][2];                           // [row r0 / r0 + 8][k q / q + 4]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = tile_col(cw, warp, g, h);
        const int k = q + 4 * e;
        w_off[h][e] = (n / kWBox) * (kWBoxBytes / 4) + k * kWBox +
                      ((((n % kWBox) / 4) ^ (k % 8)) * 4) + n % 4;
      }
    float d[kAcc], acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) d[i] = 0.f;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int64_t m0 = static_cast<int64_t>(tile % tiles_m) * kBM;
      const int64_t n0 = static_cast<int64_t>(tile / tiles_m) * kBN;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int s = it % kStages;
        // split_x(it) waited for this stage's TMA (W's tile too) in this thread.
        mbar_wait(ready0 + 8 * s, (it / kStages) & 1);
        if (it + 1 < total) split_x(it + 1);
        const float* w = reinterpret_cast<const float*>(smem + s * kStageBytes + 2 * kXBytes);
        uint32_t ab[kSteps][4], as[kSteps][4];
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          const float* wk = w + 8 * kk * kWBox;
          split_tf32(wk[w_off[0][0]], ab[kk][0], as[kk][0]);
          split_tf32(wk[w_off[1][0]], ab[kk][1], as[kk][1]);
          split_tf32(wk[w_off[0][1]], ab[kk][2], as[kk][2]);
          split_tf32(wk[w_off[1][1]], ab[kk][3], as[kk][3]);
        }
        const uint32_t xb = smem0 + s * kStageBytes, xs = xb + kXBytes;
        fence_acc(d);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          // A k8 step is 32 bytes further along the 128-byte rows.
          wgmma_tf32(d, as[kk], desc_x(xb + 32 * kk), kk > 0);
          wgmma_tf32(d, ab[kk], desc_x(xs + 32 * kk), 1);
          wgmma_tf32(d, ab[kk], desc_x(xb + 32 * kk), 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(d);
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] += d[i];
      }
      // Epilogue: acc[4j + 2h + e] is y[m0 + 8j + 2q + e][n0 + tile_col(cw, warp, g, h)].
      const int64_t n_lo = n0 + tile_col(cw, warp, g, 0), n_hi = n0 + tile_col(cw, warp, g, 1);
#pragma unroll
      for (int j = 0; j < kAcc / 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t m = m0 + 8 * j + 2 * q + e;
          if (m < m_rows) {
            float* row = y + m * n_cols;
            if (n_lo < n_cols) row[n_lo] = acc[4 * j + e];
            if (n_hi < n_cols) row[n_hi] = acc[4 * j + 2 + e];
          }
        }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                      cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                             &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major fp32 (rows, cols) matrix as TMA boxes of (box_rows, box_cols);
// elements outside it read as zeros.
bool encode(CUtensorMap* map, const float* base, int64_t rows, int64_t cols, int box_rows,
            int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" int gemm_f32_init() {
  return static_cast<int>(cudaFuncSetAttribute(
      gemm_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
}

// y (M, N) = x (M, K) @ w (K, N), all fp32, row-major and contiguous, base
// addresses 16-byte aligned and K, N multiples of 4 (TMA's row pitch);
// M, N, K >= 1. ``sms`` persistent blocks at most.
extern "C" int gemm_f32_launch(const float* x, const float* w, float* y, int64_t m, int64_t n,
                               int64_t k, int sms, cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  if (!encode(&map_x, x, m, k, kBM, kBK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&map_w, w, k, n, kBK, kWBox, CU_TENSOR_MAP_SWIZZLE_128B))
    return kEncodeFailed;
  const int64_t tiles = ((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  gemm_f32_kernel<<<grid, kThreads, kSmemBytes, stream>>>(map_x, map_w, y, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
