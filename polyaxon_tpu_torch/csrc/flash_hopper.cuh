// Hopper (sm_90a) pieces shared by the warp-specialised flash kernels
// (flash_fwd.cu, flash_bwd.cu): mbarriers, TMA loads, wgmma descriptors
// and products, the consumer warpgroups' ping-pong, the persistent tile
// order, and the host side of the tensor maps.  ops/_build.py hashes this
// header into every kernel library's name, so an edit here rebuilds both.
//
// Every kernel built on it has three warpgroups: two consumers of 64 rows
// each (a work tile of 128 rows) and one producer whose single thread
// issues every copy.  Tiles in shared memory are rows of 64 columns (128
// bytes) in the 128-byte swizzle TMA writes, in boxes of `rows` x 128
// bytes, one box per 64 columns.

#pragma once

#include <cuda.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {
namespace hopper {

constexpr int WG_ROWS = 64;      // rows of a consumer warpgroup
constexpr int BLK = 2 * WG_ROWS;  // rows of a work tile
constexpr int BOX_BYTES = BLK * 128;  // one 128-row x 64-column TMA box
constexpr int THREADS = 384;     // two consumer warpgroups, one producer
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---- key padding

// How the key-padding bytes of a batch (0 or 1 each, ops/flash.py's
// _mask_bytes) treat the N keys kv0 .. kv0 + N - 1: 1 when they admit
// every key, 0 when they refuse every key, -1 when they cut the tile.  One
// load a lane and a warp vote (every lane of the warp must call it), so a
// tile the padding leaves whole takes the unmasked path and only the
// tile a row's padding starts in takes the per-element rule.
template <int N>
__device__ __forceinline__ int padding_of(const uint8_t* kv_row, int kv0) {
  static_assert(N == 64 || N == 128, "key tiles of 64 or 128 keys");
  const int lane = threadIdx.x & 31;
  const uint32_t w =
      N == 128 ? *reinterpret_cast<const uint32_t*>(kv_row + kv0 + 4 * lane)
               : *reinterpret_cast<const uint16_t*>(kv_row + kv0 + 2 * lane);
  const uint32_t ones = N == 128 ? 0x01010101u : 0x0101u;
  if (__all_sync(0xffffffffu, w == ones)) return 1;
  if (__all_sync(0xffffffffu, w == 0u)) return 0;
  return -1;
}

// ---- mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the barrier's phase differs from `parity`.  A wait that never
// ends is a bug; trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (long long spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1ll << 26)) __trap();
  }
}

// One box of a 4-D tensor map at coordinates (c0, c1, c2, c3) into shared
// memory at `dst`; completion counts on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into shared memory at `dst`; completion counts on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- wgmma

// Shared-memory matrix descriptor of a 128-byte-swizzled tile (the layout
// TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): start address, leading and
// stride byte offsets (16-byte units), layout type 1 = 128B swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from touching a wgmma's registers (accumulators, or
// the A fragments it reads) while the wgmma owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[j][r])::"memory");
}

#define WGMMA_SS_N64(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),  \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),  \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),  \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),  \
      "+f"(d[31])  \
      : "l"(da), "l"(db), "r"(scale_d))

#define WGMMA_SS_N128(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "%64, %65, p, 1, 1, 0, 0;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),  \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),  \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),  \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),  \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),  \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),  \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),  \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),  \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
      : "l"(da), "l"(db), "r"(scale_d))

#define WGMMA_RS_N64(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),  \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),  \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),  \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),  \
      "+f"(d[31])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

#define WGMMA_RS_N128(TY)  \
  asm volatile(  \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"  \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "  \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),  \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),  \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),  \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),  \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),  \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),  \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),  \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),  \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),  \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),  \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),  \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))

// D[64 x N] (=|+=) A[64 x 16] B[N x 16]^T, both K-major in shared memory.
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>)
      WGMMA_SS_N64("bf16");
    else
      WGMMA_SS_N64("f16");
  } else {
    if constexpr (std::is_same_v<T, __nv_bfloat16>)
      WGMMA_SS_N128("bf16");
    else
      WGMMA_SS_N128("f16");
  }
}

// D[64 x N] += A[64 x 16] (registers) B[16 x N] (MN-major in shared
// memory, read with the transpose bit).
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "wgmma_rs: N is 64 or 128");
  constexpr int scale_d = 1;
  if constexpr (N == 64) {
    if constexpr (std::is_same_v<T, __nv_bfloat16>)
      WGMMA_RS_N64("bf16");
    else
      WGMMA_RS_N64("f16");
  } else {
    if constexpr (std::is_same_v<T, __nv_bfloat16>)
      WGMMA_RS_N128("bf16");
    else
      WGMMA_RS_N128("f16");
  }
}

// C[64 x N] = A[64 x DEPTH] B[N x DEPTH]^T, both K-major tiles in shared
// memory (a: the warpgroup's first A row; boxes a_box and b_box bytes
// apart): k-step kk covers columns 16 kk .. 16 kk + 15, 32 bytes into its
// 64-column box.
template <typename T, int N, int DEPTH>
__device__ __forceinline__ void issue_ss(float (&c)[N / 2], uint32_t a,
                                         int a_box, uint32_t b, int b_box) {
#pragma unroll
  for (int kk = 0; kk < DEPTH / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss<T, N>(c, sw128_desc(a + (kk / 4) * a_box + off, 16, 1024),
                   sw128_desc(b + (kk / 4) * b_box + off, 16, 1024), kk > 0);
  }
}

// C[64 x N] += A[64 x K] B[K x N]: A from registers (K / 16 fragments), B
// a tile whose rows are the depth, read MN-major with the transpose bit
// (k-step j at row 16 j of every 64-column box; boxes b_box bytes apart).
template <typename T, int N, int K>
__device__ __forceinline__ void issue_rs(float (&c)[N / 2],
                                         uint32_t (&a)[K / 16][4], uint32_t b,
                                         int b_box) {
#pragma unroll
  for (int j = 0; j < K / 16; ++j)
    wgmma_rs<T, N>(c, a[j], sw128_desc(b + j * 16 * 128, b_box, 1024));
}

// f32 accumulators of a [64 x K] product rounded to T as the A fragments
// of a product of depth K: accumulators 8j .. 8j+7 are exactly the
// fragment of k-step j.
template <typename T, int K>
__device__ __forceinline__ void pack_frags(uint32_t (&a)[K / 16][4],
                                           const float (&s)[K / 2]) {
#pragma unroll
  for (int j = 0; j < K / 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[j][r] = Mma<T>::pack(s[8 * j + 2 * r], s[8 * j + 2 * r + 1]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Ping-pong of the two consumer warpgroups on named barriers 3 and 4 (256
// threads each): a warpgroup issues its wgmmas in its turn and then hands
// the turn over, so one warpgroup's elementwise pass runs under the
// other's products.  Turns strictly alternate; warpgroup 1 opens by
// passing the first turn to warpgroup 0.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 + (wg ^ 1)) : "memory");
}

// The tiles of BN keys any row of a work tile of queries starting at
// position q_lo can admit, as [begin, end) (the reference's _block_needed
// and window remap).
template <int BN>
__device__ __forceinline__ void kv_tiles(int q_lo, int n_kv, int causal,
                                         int has_window, int window,
                                         int* begin, int* end) {
  const long long q_hi = static_cast<long long>(q_lo) + BLK - 1;
  long long b = 0, e = n_kv;
  if (causal) e = q_hi < 0 ? 0 : q_hi / BN + 1;
  const long long first = static_cast<long long>(q_lo) - window;
  if (has_window && first > 0) b = first / BN;
  if (e > n_kv) e = n_kv;
  *begin = static_cast<int>(b);
  *end = static_cast<int>(b < e ? e : b);
}

// The n-th work tile of block `blk` (zig-zag over the blocks, so each
// block's sum of causal loop lengths evens out); tiles are ordered longest
// loop first.
__device__ __forceinline__ int tile_of(int n, int blk, int blocks) {
  return n * blocks + ((n & 1) ? blocks - 1 - blk : blk);
}

// The warpgroup's 64 rows x D f32 accumulators (m64nD layout: thread row
// warp * 16 + g (+ 8), columns 8 nt + 2 tig (+ 1)) rounded to T and
// written to `rows` consecutive output rows `row_stride` elements apart:
// staged through the warpgroup's part of a 128-row staging tile (`stage`:
// its first row in box 0; 128-byte swizzle, so the writes spread over all
// banks) and leaving as 16-byte stores.  Named barrier `bar` orders the
// warpgroup's reuse of the stage.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           unsigned char* stage, T* out,
                                           long long row_stride, int bar) {
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32, g = tw % 32 / 4, tig = tw % 4;
  named_sync(bar);  // the stage's previous rows have left
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = warp * 16 + g + 8 * i;
      const int chunk = (nt % 8) ^ (r % 8);
      *reinterpret_cast<uint32_t*>(stage + (nt / 8) * BOX_BYTES + r * 128 +
                                   chunk * 16 + tig * 4) =
          Mma<T>::pack(acc[4 * nt + 2 * i], acc[4 * nt + 2 * i + 1]);
    }
  }
  named_sync(bar);
  constexpr int CHUNKS = D / 8;  // 16-byte chunks of a row
#pragma unroll
  for (int idx = tw; idx < WG_ROWS * CHUNKS; idx += 128) {
    const int r = idx / CHUNKS, ch = idx % CHUNKS;
    const uint4 val = *reinterpret_cast<const uint4*>(
        stage + (ch / 8) * BOX_BYTES + r * 128 + ((ch % 8) ^ (r % 8)) * 16);
    *reinterpret_cast<uint4*>(out + r * row_stride + ch * 8) = val;
  }
}

// ---- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, through the runtime's driver entry point (no
// link against libcuda); null when the driver does not have it.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The 4-D map (D, H, S, B) of a BSHD view with a contiguous [H, D] block
// and the given sequence and batch strides (elements), read in boxes of
// 64 columns x `rows` rows with the 128-byte swizzle.
inline bool make_map(CUtensorMap* map, EncodeTiled encode, int dtype,
                     const void* ptr, int D, int H, int S, int B,
                     long long ss, long long sb, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map,
                dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// q - k lies in (-Sk, Sq + Sk): a window past that range is the same rule,
// and the clamped one fits the kernels' 32-bit positions.
inline int clamp_window(long long window, int Sq, int Sk) {
  const long long reach = static_cast<long long>(Sq) + Sk + 1;
  return static_cast<int>(window > reach ? reach
                          : window < -reach ? -reach : window);
}

}  // namespace hopper
}  // namespace
