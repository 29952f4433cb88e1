// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface; built by polyaxon_tpu_torch/ops/_build.py with nvcc and
// loaded with ctypes by polyaxon_tpu_torch/ops/flash.py.
//
// Replaces the TPU kernel polyaxon_tpu/ops/flash.py::_fwd_kernel (launched
// by _flash_forward's pl.pallas_call).  It computes the same function:
//   S = (Q K^T) * scale in f32; masks in order causal (q_ids >= k_ids with
//   q_shift = Sk - Sq), window (q_ids - k_ids <= window, any int), key
//   padding; an online softmax with running max and sum in f32; P rounded
//   to V's type before the PV product; fully masked rows give O = 0 and
//   LSE = -1e30.  Out: O in the input type (BSHD) and LSE [B, H, Sq] f32.
//   The TPU layout artifacts (128-lane LSE, [B, Sk, 128] f32 mask) are gone:
//   the mask is [B, Sk] bytes and the LSE is one float a row.
//
// What bounds it on an H100 SXM: at GPT-2 medium's shapes (B=2, H=16,
// S=1024, D=64, bf16, causal) one launch must move Q, K, V and O, about
// 16 MiB, and do about 4.3 GFLOP (4*D per admitted (q, k) pair).  At
// 3.35 TB/s the bytes take about 5 us, at 989 TFLOP/s the operations
// about 4.4 us: the floor is about 5 us, memory-bound on paper.  In
// practice the work per 128 x 128 tile is two products on the tensor
// cores and 16384 exps on the MUFU (16 a clock an SM): at D = 64 the
// two take about the same number of clocks, so the kernel runs only as
// fast as it overlaps the softmax with the products and hides the loads
// and the ragged causal loops.
//
// What this design does about it (bf16 / fp16, D = 64 or 128):
// - Warp-specialised blocks of three warpgroups.  Warpgroup 2 is the
//   producer: one thread issues every copy as a TMA load (4-D tensor maps
//   over (D, H, S, B) built from the caller's strides, so q/k/v are read in
//   place as views of the fused QKV projection) into 128-byte-swizzled
//   tiles, and its warps give their registers away (setmaxnreg).
//   Warpgroups 0 and 1 are consumers of 64 query rows each: a block owns
//   128 query rows.
// - K/V tiles of 128 keys stream through a ring of mbarrier-guarded
//   stages (5 at D = 64, 2 at D = 128): the producer waits for a free
//   stage, the consumers for a full one, so loads of the next tiles run
//   under the math of this one.  Q has its own full/empty pair.
// - S = Q K^T is one chain of wgmma m64n128k16 per consumer, A and B read
//   from shared memory through descriptors matching the TMA swizzle.
//   O += P V takes P from registers: the f32 score accumulators are
//   rounded to the input type straight into wgmma A fragments (the
//   reference's rounding point), V is read from shared memory with the
//   transpose bit.  Nothing of S or P touches shared memory.
// - The softmax works in log2 units (scale * log2 e folded into one FMA,
//   exp2 on the MUFU) and keeps 32-bit positions.  Three kinds of tile:
//   one the warpgroup's rows admit whole takes no mask test; one that
//   only the causal diagonal cuts sets the refused scores to -inf with
//   one compare against a row bound and then takes the same path; any
//   other (window edge, key padding) runs the full per-element rule.
//   The two consumer warpgroups take turns on named barriers, so one
//   warpgroup's softmax runs under the other's wgmma, and each overlaps
//   its own softmax of tile t with its PV product of tile t - 1.
// - A persistent grid: one block per SM walks (q-tile, head, batch) tiles,
//   longest causal loop first and in a zig-zag over the blocks, so the
//   ragged causal loop lengths even out and a block's next Q and K/V loads
//   overlap its current epilogue.  O is staged through a shared-memory
//   tile (128-byte swizzle) and written with 16-byte stores; the LSE is
//   written once a row.
//
// float32: a simple shared-memory version with f32 FMAs (the tensor cores
// would round to TF32); each warp owns 16 rows, its scores, P and output
// accumulator live in shared memory.

#include <cuda.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

// ------------------------------------------------------- Hopper bf16/fp16

namespace hopper {

constexpr int BQ = 128;          // query rows of a block (two warpgroups)
constexpr int BKV = 128;         // key rows of a K/V tile
constexpr int WG_ROWS = 64;      // query rows of a consumer warpgroup
constexpr int THREADS = 384;     // two consumer warpgroups, one producer
constexpr int BOX_BYTES = 128 * 128;  // one 128-row x 64-column TMA box
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static constexpr int STAGES = D == 64 ? 5 : 2;
  static constexpr int HALVES = D / 64;  // 64-column (128-byte) boxes a row
  static constexpr int TILE = HALVES * BOX_BYTES;  // one Q, K or V tile
  static constexpr int Q = 0;
  static constexpr int O = Q + TILE;  // the output tile on its way out
  static constexpr int K = O + TILE;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BARS = V + STAGES * TILE;  // full[S], empty[S], q
  static constexpr int BYTES = BARS + (2 * STAGES + 2) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align to 1024
};

// The kv tiles any row of a 128-row q tile starting at position q_lo can
// admit, as [begin, end) (the reference's _block_needed and window remap).
__device__ __forceinline__ void kv_range(int q_lo, int n_kv, int causal,
                                         int has_window, int window,
                                         int* begin, int* end) {
  const long long q_hi = static_cast<long long>(q_lo) + BQ - 1;
  long long b = 0, e = n_kv;
  if (causal) e = q_hi < 0 ? 0 : q_hi / BKV + 1;
  const long long first = static_cast<long long>(q_lo) - window;
  if (has_window && first > 0) b = first / BKV;
  if (e > n_kv) e = n_kv;
  *begin = static_cast<int>(b);
  *end = static_cast<int>(b < e ? e : b);
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
__device__ __forceinline__ void fence_frags(uint32_t (&a)[BKV / 16][4]) {
#pragma unroll
  for (int j = 0; j < BKV / 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[j][r])::"memory");
}

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

// S[64 x 128] (=|+=) Q[64 x 16] K[128 x 16]^T, both K-major in shared memory.
template <typename T>
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    WGMMA_SS_N128("bf16");
  else
    WGMMA_SS_N128("f16");
}

// O[64 x D] += P[64 x 16] (registers) V[16 x D] (MN-major in shared memory).
template <typename T, int D>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         uint64_t db) {
  constexpr int scale_d = 1;
  if constexpr (D == 64) {
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
// the turn over, so one warpgroup's softmax runs under the other's
// products.  Turns strictly alternate; warpgroup 1 opens by passing the
// first turn to warpgroup 0.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 + (wg ^ 1)) : "memory");
}

struct Params {
  void* o;
  float* lse;
  const uint8_t* kv_mask;  // [B, Sk] bytes or null
  int B, H, Sq, Sk;
  int causal, has_window, window;  // window clamped into int range
  float scale_log2;                // scale * log2(e)
};

// The n-th tile of block `blk` (zig-zag over the blocks, so each block's
// sum of causal loop lengths evens out); tiles are ordered by q tile,
// longest causal loop first.
__device__ __forceinline__ int tile_of(int n, int blk, int blocks) {
  return n * blocks + ((n & 1) ? blocks - 1 - blk : blk);
}

// S = Q K^T for the warpgroup's 64 rows (q: its first Q row in shared
// memory; k: the K tile): k-step kk covers d = 16 kk .. 16 kk + 15, 32
// bytes into its 64-column box.
template <typename T, int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q,
                                         uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_qk<T>(s, sw128_desc(q + off, 16, 1024), sw128_desc(k + off, 16, 1024),
                kk > 0);
  }
}

// O += P V (v: the V tile): k-step j covers keys 16 j .. 16 j + 15, rows
// 16 j on in every 64-column box; the boxes lie BOX_BYTES apart.
template <typename T, int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&pa)[BKV / 16][4],
                                         uint32_t v) {
#pragma unroll
  for (int j = 0; j < BKV / 16; ++j)
    wgmma_pv<T, D>(acc, pa[j], sw128_desc(v + j * 16 * 128, BOX_BYTES, 1024));
}

// P rounded to V's type: accumulators 8j .. 8j+7 of S are exactly the
// wgmma A fragment of k-step j.
template <typename T>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BKV / 16][4],
                                       const float (&s)[64]) {
#pragma unroll
  for (int j = 0; j < BKV / 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[j][r] = Mma<T>::pack(s[8 * j + 2 * r], s[8 * j + 2 * r + 1]);
}

// This thread's place in a warpgroup's S tile: accumulator i holds row
// qpos[(i / 2) % 2] and key kv0 + 8 * (i / 4) + 2 * tig + i % 2.
struct RowCtx {
  int qpos[2];  // positions of the thread's two rows
  int qw_lo;    // the warpgroup's first position
  int tig;
  const uint8_t* kv_row;  // the batch's key-padding bytes, or null
};

// One online-softmax step on the S tile of keys kv0 .. kv0 + 127: masks
// (no test on a tile the rows admit whole, one compare a score where only
// the causal diagonal cuts it, the full rule where the window edge or
// padding does), the running max m and sum l in log2 units, the factor
// corr that rescales O, and P left in s.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int kv0, const RowCtx& rc,
                                             const Params& p) {
  const float c = p.scale_log2;
  const bool whole =
      (!p.causal || kv0 + BKV - 1 <= rc.qw_lo) &&
      (!p.has_window || rc.qw_lo + WG_ROWS - 1 - kv0 <= p.window) &&
      rc.kv_row == nullptr && c > 0.0f;
  // A tile only the causal diagonal cuts: refuse with -inf, then take the
  // whole tile's path (ex2(-inf) = 0; a row refused whole keeps m and
  // gets 0s).
  const bool diagonal = !whole && p.causal && !p.has_window &&
                        rc.kv_row == nullptr && c > 0.0f;
  if (diagonal) {
    const int last0 = rc.qpos[0] - kv0 - 2 * rc.tig;
    const int last1 = rc.qpos[1] - kv0 - 2 * rc.tig;
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (8 * (i >> 2) + (i & 1) > ((i & 2) ? last1 : last0))
        s[i] = __int_as_float(0xff800000u);
  }
  const bool fast = whole || diagonal;
  float mt[2];
  if (fast) {
    // Scores admitted or -inf, scale > 0: max(x) = max(S) * c.
    mt[0] = s[0];
    mt[1] = s[2];
#pragma unroll
    for (int i = 1; i < 64; ++i)
      mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s[i]);
    mt[0] *= c;
    mt[1] *= c;
  } else {
    // x = S * scale * log2 e, or NEG_INF where a mask refuses.
    mt[0] = mt[1] = NEG_INF;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int key = kv0 + 8 * j + 2 * rc.tig;
      uint32_t pad = 0x0101u;
      if (rc.kv_row)
        pad = *reinterpret_cast<const uint16_t*>(rc.kv_row + key);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k_pos = key + (e & 1);
        const int q_pos = rc.qpos[e >> 1];
        const bool ok = (!p.causal || q_pos >= k_pos) &&
                        (!p.has_window || q_pos - k_pos <= p.window) &&
                        ((pad >> (8 * (e & 1))) & 0xFF) != 0;
        const float x = ok ? s[4 * j + e] * c : NEG_INF;
        s[4 * j + e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
  }
  float m_new[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // a row's four threads share its max
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
    m_new[i] = fmaxf(m[i], mt[i]);
    corr[i] = m[i] > NEG_INF / 2 ? ex2(m[i] - m_new[i]) : 0.0f;
    m[i] = m_new[i];
    l[i] *= corr[i];
  }
  if (fast) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float pr = ex2(fmaf(s[i], c, -m_new[(i >> 1) & 1]));
      s[i] = pr;
      l[(i >> 1) & 1] += pr;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      // A fully masked row keeps m at NEG_INF, where
      // exp(NEG_INF - NEG_INF) = 1 would pollute l: zero those terms.
      const float pr =
          s[i] > NEG_INF / 2 ? ex2(s[i] - m_new[(i >> 1) & 1]) : 0.0f;
      s[i] = pr;
      l[(i >> 1) & 1] += pr;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Smem<D>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full_bar = base + L::BARS;
  const uint32_t empty_bar = full_bar + 8 * STAGES;
  const uint32_t q_full = empty_bar + 8 * STAGES;
  const uint32_t q_empty = q_full + 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 2 * 128);
    }
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_q = p.Sq / BQ, n_kv = p.Sk / BKV;
  const int n_tiles = n_q * p.H * p.B;
  const int q_shift = p.Sk - p.Sq;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int kv_it = 0;
      for (int n = 0;; ++n) {
        const int t = tile_of(n, blockIdx.x, gridDim.x);
        if (t >= n_tiles) break;
        const int iq = n_q - 1 - t / (p.H * p.B);
        const int h = t % p.H, b = t / p.H % p.B;
        int kb, ke;
        kv_range(iq * BQ + q_shift, n_kv, p.causal, p.has_window, p.window,
                 &kb, &ke);
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, L::TILE);
        for (int c = 0; c < L::HALVES; ++c)
          tma_load(base + L::Q + c * BOX_BYTES, &tm_q, q_full, c * 64, h,
                   iq * BQ, b);
        for (int kt = kb; kt < ke; ++kt, ++kv_it) {
          const int s = kv_it % STAGES;
          mbar_wait(empty_bar + 8 * s, ((kv_it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full_bar + 8 * s, 2 * L::TILE);
          for (int c = 0; c < L::HALVES; ++c) {
            tma_load(base + L::K + s * L::TILE + c * BOX_BYTES, &tm_k,
                     full_bar + 8 * s, c * 64, h, kt * BKV, b);
            tma_load(base + L::V + s * L::TILE + c * BOX_BYTES, &tm_v,
                     full_bar + 8 * s, c * 64, h, kt * BKV, b);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32, lane = tw % 32;
    const int g = lane / 4, tig = lane % 4;
    const int row0 = wg * WG_ROWS + warp * 16 + g;  // this thread's rows:
                                                    // row0, row0 + 8
    const uint32_t q_smem = base + L::Q + wg * WG_ROWS * 128;
    if (wg == 1) turn_pass(wg);
    int kv_it = 0;
    for (int n = 0;; ++n) {
      const int t = tile_of(n, blockIdx.x, gridDim.x);
      if (t >= n_tiles) break;
      const int iq = n_q - 1 - t / (p.H * p.B);
      const int h = t % p.H, b = t / p.H % p.B;
      const int q_lo = iq * BQ + q_shift;  // the block's first position
      const RowCtx rc{{q_lo + row0, q_lo + row0 + 8},
                      q_lo + wg * WG_ROWS,
                      tig,
                      p.kv_mask ? p.kv_mask + static_cast<long long>(b) * p.Sk
                                : nullptr};
      int kb, ke;
      kv_range(q_lo, n_kv, p.causal, p.has_window, p.window, &kb, &ke);

      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
      float m[2] = {NEG_INF, NEG_INF};
      float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums

      mbar_wait(q_full, n & 1);
      if (kb < ke) {
        // The loop runs one tile ahead: S of tile kt is issued with PV of
        // tile kt - 1, and tile kt's softmax runs while that PV does.
        int prev = kv_it % STAGES;
        mbar_wait(full_bar + 8 * prev, (kv_it / STAGES) & 1);
        float s[64], corr[2];
        uint32_t pa[BKV / 16][4];
        turn_wait(wg);
        wgmma_fence();
        issue_qk<T, D>(s, q_smem, base + L::K + prev * L::TILE);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<0>();
        fence_regs<64>(s);
        if (kb + 1 == ke) mbar_arrive(q_empty);  // Q is read for this tile
        softmax_tile(s, m, l, corr, kb * BKV, rc, p);  // acc is 0: no rescale
        pack_p<T>(pa, s);
        ++kv_it;
        for (int kt = kb + 1; kt < ke; ++kt, ++kv_it) {
          const int cur = kv_it % STAGES;
          mbar_wait(full_bar + 8 * cur, (kv_it / STAGES) & 1);
          fence_regs<D / 2>(acc);
          fence_frags(pa);
          turn_wait(wg);
          wgmma_fence();
          issue_qk<T, D>(s, q_smem, base + L::K + cur * L::TILE);
          wgmma_commit();
          issue_pv<T, D>(acc, pa, base + L::V + prev * L::TILE);
          wgmma_commit();
          turn_pass(wg);
          wgmma_wait<1>();  // S is ready; PV still runs
          fence_regs<64>(s);
          if (kt + 1 == ke) mbar_arrive(q_empty);
          softmax_tile(s, m, l, corr, kt * BKV, rc, p);
          wgmma_wait<0>();
          fence_regs<D / 2>(acc);
          fence_frags(pa);
          mbar_arrive(empty_bar + 8 * prev);  // that stage may be refilled
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
          pack_p<T>(pa, s);
          prev = cur;
        }
        fence_regs<D / 2>(acc);
        fence_frags(pa);
        turn_wait(wg);
        wgmma_fence();
        issue_pv<T, D>(acc, pa, base + L::V + prev * L::TILE);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<0>();
        fence_regs<D / 2>(acc);
        fence_frags(pa);
        mbar_arrive(empty_bar + 8 * prev);
      } else {
        mbar_arrive(q_empty);  // no key admitted: O = 0, LSE = NEG_INF
      }

      // Finalize: O = acc / l, LSE = (m + log2 l) ln 2; fully masked rows
      // give 0 and NEG_INF.  O is staged in the warpgroup's half of the O
      // buffer (128-byte swizzle, so the writes spread over all banks) and
      // leaves as 16-byte stores.
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        inv[i] = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
      }
      unsigned char* stage = smem + L::O + wg * WG_ROWS * 128;
      named_sync(1 + wg);  // the last tile's rows have left
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = warp * 16 + g + 8 * i;
          const int chunk = (nt % 8) ^ (r % 8);
          *reinterpret_cast<uint32_t*>(stage + (nt / 8) * BOX_BYTES +
                                       r * 128 + chunk * 16 + tig * 4) =
              Mma<T>::pack(acc[4 * nt + 2 * i] * inv[i],
                           acc[4 * nt + 2 * i + 1] * inv[i]);
        }
      }
      named_sync(1 + wg);
      T* o = static_cast<T*>(p.o);
      constexpr int CHUNKS = D / 8;  // 16-byte chunks of a row
#pragma unroll
      for (int idx = tw; idx < WG_ROWS * CHUNKS; idx += 128) {
        const int r = idx / CHUNKS, ch = idx % CHUNKS;
        const uint4 val = *reinterpret_cast<const uint4*>(
            stage + (ch / 8) * BOX_BYTES + r * 128 + ((ch % 8) ^ (r % 8)) * 16);
        const long long row = static_cast<long long>(iq) * BQ + wg * WG_ROWS + r;
        *reinterpret_cast<uint4*>(
            o + ((static_cast<long long>(b) * p.Sq + row) * p.H + h) * D +
            ch * 8) = val;
      }
      if (tig == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
          p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + iq * BQ +
                row0 + 8 * i] =
              l[i] == 0.0f ? NEG_INF : (m[i] + log2f(l[i])) * LN2;
      }
    }
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
EncodeTiled encode_tiled() {
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
// 64 columns x 128 rows with the 128-byte swizzle.
bool make_map(CUtensorMap* map, EncodeTiled encode, int dtype,
              const void* ptr, int D, int H, int S, int B, long long ss,
              long long sb) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, BKV, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map,
                dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                4, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <typename T, int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           const Masks& mk, void* o, float* lse, int B, int H, int Sq,
           int Sk, const long long* st, float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  const int sms = sm_count();
  if (encode == nullptr || sms == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, encode, dtype, q, D, H, Sq, B, st[1], st[0]) ||
      !make_map(&tm_k, encode, dtype, k, D, H, Sk, B, st[3], st[2]) ||
      !make_map(&tm_v, encode, dtype, v, D, H, Sk, B, st[5], st[4]))
    return static_cast<int>(cudaErrorInvalidValue);
  // q - k lies in (-Sk, Sq + Sk): a window past that range is the same
  // rule, and the clamped one fits the kernel's 32-bit positions.
  const long long reach = static_cast<long long>(Sq) + Sk + 1;
  const long long w = mk.window > reach ? reach
                      : mk.window < -reach ? -reach : mk.window;
  const Params p{o, lse, mk.kv_mask, B, H, Sq, Sk, mk.causal,
                 mk.has_window, static_cast<int>(w), scale * LOG2E};
  const int tiles = (Sq / BQ) * H * B;
  return launch_kernel_threads<flash_fwd_wgmma<T, D>>(
      Smem<D>::ALLOC, dim3(tiles < sms ? tiles : sms), THREADS, stream, tm_q,
      tm_k, tm_v, p);
}

}  // namespace hopper

// ------------------------------------------------------------------ float32

template <int D>
struct F32Smem {
  static constexpr int LD = D + 4;      // Q/K/V row stride (16-byte rows)
  static constexpr int LDP = BKV + 4;   // P row stride
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(float) * BQ * LD;
  static constexpr size_t v = k + sizeof(float) * BKV * LD;
  static constexpr size_t p = v + sizeof(float) * BKV * LD;
  static constexpr size_t o = p + sizeof(float) * BQ * LDP;
  static constexpr size_t m = o + sizeof(float) * BQ * D;
  static constexpr size_t l = m + sizeof(float) * BQ;
  static constexpr size_t bytes = l + sizeof(float) * BQ;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, Masks mk, float* __restrict__ o,
              float* __restrict__ lse, int H, int Sq, int Sk, long long q_sb,
              long long q_ss, long long k_sb, long long k_ss, long long v_sb,
              long long v_ss, float scale) {
  using L = F32Smem<D>;
  constexpr int LD = L::LD;
  constexpr int LDP = L::LDP;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q);
  float* Ks = reinterpret_cast<float*>(smem + L::k);
  float* Vs = reinterpret_cast<float*>(smem + L::v);
  float* Ps = reinterpret_cast<float*>(smem + L::p);
  float* Os = reinterpret_cast<float*>(smem + L::o);
  float* Ms = reinterpret_cast<float*>(smem + L::m);
  float* Ls = reinterpret_cast<float*>(smem + L::l);

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long q0 = static_cast<long long>(iq) * BQ;
  const long long q_lo = q0 + (Sk - Sq);
  const uint8_t* kv_row =
      mk.kv_mask ? mk.kv_mask + static_cast<long long>(b) * Sk : nullptr;
  long long kv_begin, kv_end;
  kv_range(q_lo, Sk / BKV, mk, &kv_begin, &kv_end);

  load_tile_f32<D, LD>(Qs, q + b * q_sb + q0 * q_ss + h * D, q_ss);
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) Os[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    Ms[i] = NEG_INF;
    Ls[i] = 0.0f;
  }
  __syncthreads();

  for (long long t = kv_begin; t < kv_end; ++t) {
    const long long kv0 = t * BKV;
    load_tile_f32<D, LD>(Ks, k + b * k_sb + kv0 * k_ss + h * D, k_ss);
    load_tile_f32<D, LD>(Vs, v + b * v_sb + kv0 * v_ss + h * D, v_ss);
    __syncthreads();
    for (int rr = 0; rr < ROWS; ++rr) {
      const int r = warp * ROWS + rr;
      float s[BKV / 32];
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < BKV / 32; ++j) {
        const int c = lane + 32 * j;
        float acc = 0.0f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) acc += Qs[r * LD + d] * Ks[c * LD + d];
        s[j] = mk.ok(q_lo + r, kv0 + c, kv_row) ? acc * scale : NEG_INF;
        mc = fmaxf(mc, s[j]);
      }
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, warp_max(mc));
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < BKV / 32; ++j) {
        const float p = s[j] > NEG_INF / 2 ? expf(s[j] - m_new) : 0.0f;
        psum += p;
        Ps[r * LDP + lane + 32 * j] = p;
      }
      psum = warp_sum(psum);
      const float corr = m_prev > NEG_INF / 2 ? expf(m_prev - m_new) : 0.0f;
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        float acc = 0.0f;
#pragma unroll 8
        for (int c = 0; c < BKV; ++c) acc += Ps[r * LDP + c] * Vs[c * LD + d];
        Os[r * D + d] = Os[r * D + d] * corr + acc;
      }
      __syncwarp();
      if (lane == 0) {
        Ms[r] = m_new;
        Ls[r] = Ls[r] * corr + psum;
      }
    }
    __syncthreads();  // K/V are overwritten by the next tile
  }

  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = warp * ROWS + rr;
    const float l = Ls[r];
    const float safe_l = l == 0.0f ? 1.0f : l;
    float* orow = o + ((static_cast<long long>(b) * Sq + q0 + r) * H + h) * D;
    for (int d = lane; d < D; d += 32) orow[d] = Os[r * D + d] / safe_l;
    if (lane == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + q0 + r] =
          l == 0.0f ? NEG_INF : Ms[r] + logf(safe_l);
  }
}

// ------------------------------------------------------------------ launch

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const Masks& mk,
               void* o, float* lse, int B, int H, int Sq, int Sk,
               const long long* st, float scale, cudaStream_t stream) {
  return launch_kernel<flash_fwd_f32<D>>(
      F32Smem<D>::bytes, dim3(Sq / BQ, H, B), stream,
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), mk, static_cast<float*>(o), lse, H, Sq,
      Sk, st[0], st[1], st[2], st[3], st[4], st[5], scale);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; D: 64 or 128.  q/k/v are
// BSHD with a contiguous [H, D] inner block, 16-byte aligned rows, and the
// given batch and sequence strides (in elements); o is contiguous BSHD,
// lse [B, H, Sq] f32; kv_mask is null or [B, Sk] bytes (nonzero = attend).
// Sq and Sk are multiples of 128 (bfloat16, float16) or 64 (float32).
// Launches on `stream`, allocates nothing, and returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for what it does not
// take).
extern "C" int flash_fwd(int dtype, int D, const void* q, const void* k,
                         const void* v, const void* kv_mask, void* o,
                         void* lse, int B, int H, int Sq, int Sk,
                         long long q_sb, long long q_ss, long long k_sb,
                         long long k_ss, long long v_sb, long long v_ss,
                         float scale, int causal, int has_window,
                         long long window, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || H < 1 || Sq < 1 || Sk < 1) return invalid;
  const Masks mk{static_cast<const uint8_t*>(kv_mask), causal, has_window,
                 window};
  const long long st[6] = {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (Sq % BQ != 0 || Sk % BKV != 0) return invalid;
    if (D == 64)
      return launch_f32<64>(q, k, v, mk, o, l, B, H, Sq, Sk, st, scale, s);
    if (D == 128)
      return launch_f32<128>(q, k, v, mk, o, l, B, H, Sq, Sk, st, scale, s);
    return invalid;
  }
  if (Sq % hopper::BQ != 0 || Sk % hopper::BKV != 0) return invalid;
  if (dtype == 1 && D == 64)
    return hopper::launch<__nv_bfloat16, 64>(dtype, q, k, v, mk, o, l, B, H,
                                             Sq, Sk, st, scale, s);
  if (dtype == 1 && D == 128)
    return hopper::launch<__nv_bfloat16, 128>(dtype, q, k, v, mk, o, l, B, H,
                                              Sq, Sk, st, scale, s);
  if (dtype == 2 && D == 64)
    return hopper::launch<__half, 64>(dtype, q, k, v, mk, o, l, B, H, Sq, Sk,
                                      st, scale, s);
  if (dtype == 2 && D == 128)
    return hopper::launch<__half, 128>(dtype, q, k, v, mk, o, l, B, H, Sq,
                                       Sk, st, scale, s);
  return invalid;
}
