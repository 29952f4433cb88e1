// Flash-attention backward for Hopper (sm_90a), CUDA C++ with a plain C
// interface; built by polyaxon_tpu_torch/ops/_build.py with nvcc and
// loaded with ctypes by polyaxon_tpu_torch/ops/flash.py.
//
// Replaces the two TPU kernels of polyaxon_tpu/ops/flash.py's
// _flash_backward: _bwd_dq_kernel (:347, entry flash_bwd_dq) and
// _bwd_dkv_kernel (:407, entry flash_bwd_dkv).  Both recompute
// P = exp(S * scale - LSE) from the forward's row logsumexp, with the
// forward's masks (causal with q_shift = Sk - Sq, raw window, key padding)
// applied as a select, never a multiply: a fully masked row has
// LSE = -1e30, where exp overflows to inf.  With
// delta = rowsum(dO * O) - dlse (computed by the caller):
//   dS = P * (dO V^T - delta) * scale                      (f32)
//   dQ = sum over kv tiles of  bf16(dS) K                  (flash_bwd_dq)
//   dV = sum over q tiles of   bf16(P)^T dO                (flash_bwd_dkv)
//   dK = sum over q tiles of   bf16(dS)^T Q                (flash_bwd_dkv)
// The rounding to the input type sits where the Pallas kernels put it
// (flash.py:398-400, :454-456, :462-464); all other arithmetic is f32.
// Two kernels and no atomics, as in the reference: every output element
// has one owner, so the result is deterministic.
//
// What bounds it on an H100 SXM: at GPT-2 medium's training shape
// (B=8, H=16, S=1024, D=64, bf16, causal) dq does 3 products of 2*D FLOP
// per admitted (q, k) pair (S, dP, dQ) and dkv 4 (S, dP, dV, dK): about
// 26 and 35 us at 989 TFLOP/s against about 20 us to move their bytes at
// 3.35 TB/s.  Both are bound by operations on paper; per 128 x 128 tile
// the elementwise pass (16384 exps on the MUFU, the masks, dS) takes about
// as many clocks as the products, so each kernel is as fast as it
// overlaps the two.
//
// What this design does about it (bf16 / fp16, D = 64 or 128), on the
// pieces of the forward (flash_hopper.cuh):
// - Warp-specialised persistent blocks of three warpgroups.  The producer
//   warpgroup gives its registers away (setmaxnreg) and one of its threads
//   issues every copy as TMA (4-D tensor maps over (D, H, S, B), so q/k/v
//   are read in place as views of the fused QKV projection) into
//   128-byte-swizzled tiles.  Two consumer warpgroups own 64 rows each of
//   a 128-row work tile and take turns on named barriers, so one's
//   elementwise pass runs under the other's products.  One block per SM
//   walks the work tiles, longest loop first, zig-zagged over the blocks.
// - dq is query-major: a work tile is 128 queries of one (head, batch);
//   Q and dO are loaded once, K/V tiles stream through a ring of
//   mbarrier-guarded stages over the range the masks admit (the forward's
//   loop ends).  S = Q K^T and dP = dO V^T are SS wgmmas (both K-major);
//   dS is formed in the accumulators and packed straight into A fragments
//   (rounded to K's type) for dQ += dS K, which reads K with the transpose
//   bit.  dQ += dS K of tile t is issued in the turn of tile t + 1, after
//   its S and dP, and runs under its elementwise pass.  Each thread keeps
//   LSE * log2 e and delta of its two rows.
// - dkv is key-major: a work tile is 128 keys; K and V are loaded once, Q,
//   dO and the per-query LSE and delta rows (1-D bulk copies) stream over
//   the q range the masks admit (q_tiles, the mirror of the reference's
//   _q_base).  S^T = K Q^T and dP^T = V dO^T are SS wgmmas; P^T and dS^T
//   are formed in place (LSE and delta read per column from shared memory)
//   and packed as A fragments for dV += P^T dO and dK += dS^T Q, which read
//   dO and Q with the transpose bit.  These run at once: S^T, dP^T, dK and
//   dV already hold 192 of a consumer's 240 registers at D = 64, so the
//   next tile's S^T and dP^T cannot be in flight beside their fragments.
// - The elementwise pass works in log2 units (P = exp2(S * scale log2 e -
//   LSE log2 e)) with 32-bit positions and three kinds of tile, as in the
//   forward: whole (no mask test), causal diagonal (-inf by one compare a
//   score, then the whole tile's path), and the full rule (window edge,
//   key padding).
// - Streamed tiles are 128 rows at D = 64 and 64 rows at D = 128, so each
//   consumer's S, dP and f32 accumulators fit its registers (no spills,
//   no serialised wgmma).  Outputs are staged through a swizzled
//   shared-memory tile and leave as 16-byte stores.
//
// float32: a shared-memory version with f32 FMAs (the tensor cores would
// round to TF32); each warp walks its 16 rows one at a time, the row's P
// and dS live in shared memory and the dQ (dK, dV) accumulators too.

#include "flash_hopper.cuh"

namespace {

struct Strides {  // batch and sequence strides, in elements
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss;
};

struct RawArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, Sq, Sk;
  Strides st;
  float scale;
};

// ------------------------------------------------------- Hopper bf16/fp16

namespace hopper {

struct Params {
  void* out0;          // dQ (dq), dK (dkv): contiguous BSHD
  void* out1;          // dV (dkv)
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  const uint8_t* kv_mask;  // [B, Sk] bytes or null
  int B, H, Sq, Sk;
  int causal, has_window, window;  // window clamped into int range
  float scale, scale_log2;         // scale, scale * log2(e)
};

// The q tiles of BM rows (positions t BM + q_shift ..) that can admit a
// key of the 128-key tile starting at kv0, as [begin, end): causality
// starts at the tile holding position kv0, the window ends at the tile
// holding position kv0 + 127 + window (the reference's _q_base).
template <int BM>
__device__ __forceinline__ void q_tiles(int kv0, int n_q, int q_shift,
                                        const Params& p, int* begin,
                                        int* end) {
  long long b = 0, e = n_q;
  const long long first = static_cast<long long>(kv0) - q_shift;
  if (p.causal && first > 0) b = first / BM;
  if (p.has_window) {
    const long long last =
        static_cast<long long>(kv0) + BLK - 1 + p.window - q_shift;
    e = last < 0 ? 0 : last / BM + 1;
    if (e > n_q) e = n_q;
  }
  *begin = static_cast<int>(b);
  *end = static_cast<int>(b < e ? e : b);
}

// One consumer warpgroup's walk over the streamed tiles [first, end) of a
// work tile, ring slots `it`, `it` + 1, ...  For each tile: `ss(stage)`
// issues the SS products in the warpgroup's turn; `elementwise(stage, t)`
// works on their accumulators; `pack()` rounds the results into A
// fragments; `rs(stage)` issues the RS products that read them.  With PIPE
// the RS products of tile t are issued in the turn of tile t + 1, after its
// SS products, and run under its elementwise pass (the forward's S / PV
// overlap); without, they run at once.  `fence()` pins the RS products'
// accumulators and fragments; `last()` runs once the resident tiles have
// been read for the last time.  A stage is released when the RS products
// that read it are done.  With PIPE the first tile is peeled, so which
// wgmmas are in flight is known at every point of the code (a
// data-dependent branch around them makes ptxas serialise them: C7518).
template <bool PIPE, int STAGES, typename Ss, typename Elem, typename Pack,
          typename Rs, typename Fence, typename Last>
__device__ __forceinline__ void stream_tiles(int first, int end, int& it,
                                             uint32_t full_bar,
                                             uint32_t empty_bar, int wg,
                                             Ss ss, Elem elementwise,
                                             Pack pack, Rs rs, Fence fence,
                                             Last last) {
  if (first >= end) return;
  int prev = 0;
  const auto step = [&](int t, auto pending) {  // pending: tile t - 1's RS
    constexpr bool PENDING = decltype(pending)::value;
    const int cur = it % STAGES;
    mbar_wait(full_bar + 8 * cur, (it / STAGES) & 1);
    fence();
    turn_wait(wg);
    wgmma_fence();
    ss(cur);
    wgmma_commit();
    if constexpr (PENDING) {
      rs(prev);
      wgmma_commit();
    }
    turn_pass(wg);
    if constexpr (PENDING)
      wgmma_wait<1>();  // the SS products are done; the RS ones still run
    else
      wgmma_wait<0>();
    if (t + 1 == end) last();
    elementwise(cur, t);
    if constexpr (PENDING) {
      wgmma_wait<0>();
      fence();
      mbar_arrive(empty_bar + 8 * prev);
    }
    pack();
    if constexpr (!PIPE) {
      fence();
      wgmma_fence();
      rs(cur);
      wgmma_commit();
      wgmma_wait<0>();
      fence();
      mbar_arrive(empty_bar + 8 * cur);
    }
    prev = cur;
    ++it;
  };
  if constexpr (!PIPE) {
    for (int t = first; t < end; ++t) step(t, std::false_type{});
  } else {
    step(first, std::false_type{});
    for (int t = first + 1; t < end; ++t) step(t, std::true_type{});
    fence();
    turn_wait(wg);
    wgmma_fence();
    rs(prev);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait<0>();
    fence();
    mbar_arrive(empty_bar + 8 * prev);
  }
}

// ---- dq

template <int D>
struct DqSmem {
  static constexpr int BN = D == 64 ? 128 : 64;  // keys of a K/V tile
  static constexpr bool PIPE = true;  // dQ += dS K runs under the next tile
  static constexpr int HALVES = D / 64;         // 64-column boxes a row
  static constexpr int QTILE = HALVES * BOX_BYTES;  // Q, dO, the dQ staging
  static constexpr int KBOX = BN * 128;
  static constexpr int KTILE = HALVES * KBOX;   // one K or V tile
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int Q = 0;
  static constexpr int DO = Q + QTILE;
  static constexpr int OUT = DO + QTILE;
  static constexpr int K = OUT + QTILE;
  static constexpr int V = K + STAGES * KTILE;
  static constexpr int BARS = V + STAGES * KTILE;  // full[S], empty[S], q
  static constexpr int BYTES = BARS + (2 * STAGES + 2) * 8;
  static constexpr int ALLOC = BYTES + 1024;  // room to align to 1024
};

// This thread's two rows of a dq work tile.
struct DqRows {
  int qpos[2];     // their positions
  int qw_lo;       // the warpgroup's first position
  float lse2[2];   // LSE * log2 e
  float delta[2];
  const uint8_t* kv_row;  // the batch's key-padding bytes, or null
};

template <bool FAST, int N>
__device__ __forceinline__ void ds_pass(float (&s)[N / 2],
                                        const float (&dp)[N / 2], int kv0,
                                        int tig, const DqRows& r,
                                        const Params& p) {
  const float c = p.scale_log2;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int key = kv0 + 8 * j + 2 * tig;
    uint32_t pad = 0x0101u;
    if (!FAST && r.kv_row)
      pad = *reinterpret_cast<const uint16_t*>(r.kv_row + key);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, h = e >> 1;
      bool ok = true;
      if (!FAST) {
        const int k_pos = key + (e & 1), q_pos = r.qpos[h];
        ok = (!p.causal || q_pos >= k_pos) &&
             (!p.has_window || q_pos - k_pos <= p.window) &&
             ((pad >> (8 * (e & 1))) & 0xFF) != 0;
      }
      const float pr = ok ? ex2(fmaf(s[i], c, -r.lse2[h])) : 0.0f;
      s[i] = pr * (dp[i] - r.delta[h]) * p.scale;
    }
  }
}

// dS = P * (dP - delta) * scale into s, for the S tile of keys kv0 ..
// kv0 + N - 1: accumulator i holds row qpos[(i / 2) % 2] and key
// kv0 + 8 (i / 4) + 2 tig + i % 2.  P is recomputed in log2 units and
// zeroed where a mask refuses: no test on a tile the warpgroup's rows
// admit whole, -inf by one compare where only the causal diagonal cuts
// (ex2(-inf) = 0), the full rule where the window edge or padding does.
template <int N>
__device__ __forceinline__ void ds_tile(float (&s)[N / 2],
                                        const float (&dp)[N / 2], int kv0,
                                        int tig, const DqRows& r,
                                        const Params& p) {
  const bool plain = r.kv_row == nullptr && p.scale_log2 > 0.0f;
  const bool whole = plain && (!p.causal || kv0 + N - 1 <= r.qw_lo) &&
                     (!p.has_window ||
                      r.qw_lo + WG_ROWS - 1 - kv0 <= p.window);
  const bool diagonal = !whole && plain && p.causal && !p.has_window;
  if (diagonal) {
    const int last0 = r.qpos[0] - kv0 - 2 * tig;
    const int last1 = r.qpos[1] - kv0 - 2 * tig;
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      if (8 * (i >> 2) + (i & 1) > ((i & 2) ? last1 : last0))
        s[i] = __int_as_float(0xff800000u);
  }
  if (whole || diagonal)
    ds_pass<true, N>(s, dp, kv0, tig, r, p);
  else
    ds_pass<false, N>(s, dp, kv0, tig, r, p);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = DqSmem<D>;
  constexpr int BN = L::BN;
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

  const int n_q = p.Sq / BLK, n_kv = p.Sk / BN;
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
        kv_tiles<BN>(iq * BLK + q_shift, n_kv, p.causal, p.has_window, p.window,
                     &kb, &ke);
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, 2 * L::QTILE);
        for (int c = 0; c < L::HALVES; ++c) {
          tma_load(base + L::Q + c * BOX_BYTES, &tm_q, q_full, c * 64, h,
                   iq * BLK, b);
          tma_load(base + L::DO + c * BOX_BYTES, &tm_do, q_full, c * 64, h,
                   iq * BLK, b);
        }
        for (int kt = kb; kt < ke; ++kt, ++kv_it) {
          const int s = kv_it % STAGES;
          mbar_wait(empty_bar + 8 * s, ((kv_it / STAGES) & 1) ^ 1);
          mbar_expect_tx(full_bar + 8 * s, 2 * L::KTILE);
          for (int c = 0; c < L::HALVES; ++c) {
            tma_load(base + L::K + s * L::KTILE + c * L::KBOX, &tm_k,
                     full_bar + 8 * s, c * 64, h, kt * BN, b);
            tma_load(base + L::V + s * L::KTILE + c * L::KBOX, &tm_v,
                     full_bar + 8 * s, c * 64, h, kt * BN, b);
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
    const uint32_t do_smem = base + L::DO + wg * WG_ROWS * 128;
    if (wg == 1) turn_pass(wg);
    int kv_it = 0;
    for (int n = 0;; ++n) {
      const int t = tile_of(n, blockIdx.x, gridDim.x);
      if (t >= n_tiles) break;
      const int iq = n_q - 1 - t / (p.H * p.B);
      const int h = t % p.H, b = t / p.H % p.B;
      const int q_lo = iq * BLK + q_shift;  // the block's first position
      const long long row =
          (static_cast<long long>(b) * p.H + h) * p.Sq + iq * BLK + row0;
      const DqRows r{{q_lo + row0, q_lo + row0 + 8},
                     q_lo + wg * WG_ROWS,
                     {p.lse[row] * LOG2E, p.lse[row + 8] * LOG2E},
                     {p.delta[row], p.delta[row + 8]},
                     p.kv_mask ? p.kv_mask + static_cast<long long>(b) * p.Sk
                               : nullptr};
      int kb, ke;
      kv_tiles<BN>(q_lo, n_kv, p.causal, p.has_window, p.window, &kb, &ke);

      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

      mbar_wait(q_full, n & 1);
      if (kb == ke) mbar_arrive(q_empty);  // no key admitted: dQ = 0
      float s[BN / 2], dp[BN / 2];
      uint32_t da[BN / 16][4];
      const auto k_tile = [&](int st) { return base + L::K + st * L::KTILE; };
      stream_tiles<L::PIPE, STAGES>(
          kb, ke, kv_it, full_bar, empty_bar, wg,
          [&](int st) {  // S = Q K^T, dP = dO V^T
            issue_ss<T, BN, D>(s, q_smem, BOX_BYTES, k_tile(st), L::KBOX);
            issue_ss<T, BN, D>(dp, do_smem, BOX_BYTES,
                               base + L::V + st * L::KTILE, L::KBOX);
          },
          [&](int, int kt) {
            fence_regs<BN / 2>(s);
            fence_regs<BN / 2>(dp);
            ds_tile<BN>(s, dp, kt * BN, tig, r, p);
          },
          [&] { pack_frags<T, BN>(da, s); },  // dS rounded to K's type
          [&](int st) { issue_rs<T, D, BN>(acc, da, k_tile(st), L::KBOX); },
          [&] {
            fence_regs<D / 2>(acc);
            fence_frags<BN / 16>(da);
          },
          [&] { mbar_arrive(q_empty); });  // Q and dO are read

      const long long out_row =
          static_cast<long long>(b) * p.Sq + iq * BLK + wg * WG_ROWS;
      store_rows<T, D>(acc, smem + L::OUT + wg * WG_ROWS * 128,
                       static_cast<T*>(p.out0) + (out_row * p.H + h) * D,
                       static_cast<long long>(p.H) * D, 1 + wg);
    }
  }
}

// ---- dkv

template <int D>
struct DkvSmem {
  static constexpr int BM = D == 64 ? 128 : 64;  // queries of a Q/dO tile
  // dV, dK += P^T dO, dS^T Q run at once: their fragments would not fit
  // beside dK, dV and the next tile's S^T and dP^T.
  static constexpr bool PIPE = false;
  static constexpr int HALVES = D / 64;
  static constexpr int KTILE = HALVES * BOX_BYTES;  // K, V, the dK/dV staging
  static constexpr int QBOX = BM * 128;
  static constexpr int QTILE = HALVES * QBOX;     // one Q or dO tile
  // A stage: Q, dO, then the tile's LSE and delta rows (BM floats each).
  static constexpr int LSE = 2 * QTILE;
  static constexpr int DELTA = LSE + BM * 4;
  static constexpr int STAGE = (DELTA + BM * 4 + 1023) / 1024 * 1024;
  static constexpr int STAGE_TX = 2 * QTILE + 2 * BM * 4;  // bytes a stage
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int K = 0;
  static constexpr int V = K + KTILE;
  static constexpr int OUT = V + KTILE;
  static constexpr int RING = OUT + KTILE;
  static constexpr int BARS = RING + STAGES * STAGE;  // full, empty, kv
  static constexpr int BYTES = BARS + (2 * STAGES + 2) * 8;
  static constexpr int ALLOC = BYTES + 1024;
};

// This thread's two key rows of a dkv work tile.
struct DkvRows {
  int kpos[2];    // their positions
  int kw_lo;      // the warpgroup's first key
  bool kv_ok[2];  // not padded
  bool padded;    // the batch has a key-padding mask
};

template <bool FAST, int N>
__device__ __forceinline__ void p_ds_pass(float (&s)[N / 2],
                                          float (&dp)[N / 2], int q0, int tig,
                                          const float* lse, const float* dl,
                                          const DkvRows& r, const Params& p) {
  const float c = p.scale_log2;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    const float2 l2 = *reinterpret_cast<const float2*>(lse + col);
    const float2 d2 = *reinterpret_cast<const float2*>(dl + col);
    const float lse2[2] = {l2.x * LOG2E, l2.y * LOG2E};
    const float dlt[2] = {d2.x, d2.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, h = e >> 1, x = e & 1;
      bool ok = true;
      if (!FAST) {
        const int q_pos = q0 + col + x, k_pos = r.kpos[h];
        ok = r.kv_ok[h] && (!p.causal || q_pos >= k_pos) &&
             (!p.has_window || q_pos - k_pos <= p.window);
      }
      const float pr = ok ? ex2(fmaf(s[i], c, -lse2[x])) : 0.0f;
      s[i] = pr;
      dp[i] = pr * (dp[i] - dlt[x]) * p.scale;
    }
  }
}

// P^T into s and dS^T into dp for the S^T tile of queries at positions
// q0 .. q0 + N - 1: accumulator i holds key kpos[(i / 2) % 2] and query
// column 8 (i / 4) + 2 tig + i % 2, whose LSE and delta come from shared
// memory.  The same three kinds of tile as in dq.
template <int N>
__device__ __forceinline__ void p_ds_tile(float (&s)[N / 2],
                                          float (&dp)[N / 2], int q0, int tig,
                                          const float* lse, const float* dl,
                                          const DkvRows& r, const Params& p) {
  const bool plain = !r.padded && p.scale_log2 > 0.0f;
  const bool whole = plain && (!p.causal || q0 >= r.kw_lo + WG_ROWS - 1) &&
                     (!p.has_window || q0 + N - 1 - r.kw_lo <= p.window);
  const bool diagonal = !whole && plain && p.causal && !p.has_window;
  if (diagonal) {
    const int first0 = r.kpos[0] - q0 - 2 * tig;
    const int first1 = r.kpos[1] - q0 - 2 * tig;
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      if (8 * (i >> 2) + (i & 1) < ((i & 2) ? first1 : first0))
        s[i] = __int_as_float(0xff800000u);
  }
  if (whole || diagonal)
    p_ds_pass<true, N>(s, dp, q0, tig, lse, dl, r, p);
  else
    p_ds_pass<false, N>(s, dp, q0, tig, lse, dl, r, p);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const Params p) {
  using L = DkvSmem<D>;
  constexpr int BM = L::BM;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full_bar = base + L::BARS;
  const uint32_t empty_bar = full_bar + 8 * STAGES;
  const uint32_t kv_full = empty_bar + 8 * STAGES;
  const uint32_t kv_empty = kv_full + 8;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 2 * 128);
    }
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 2 * 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_q = p.Sq / BM, n_kv = p.Sk / BLK;
  const int n_tiles = n_kv * p.H * p.B;
  const int q_shift = p.Sk - p.Sq;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int q_it = 0;
      for (int n = 0;; ++n) {
        const int t = tile_of(n, blockIdx.x, gridDim.x);
        if (t >= n_tiles) break;
        const int ikv = t / (p.H * p.B);  // low key tiles: longest loops
        const int h = t % p.H, b = t / p.H % p.B;
        int qb, qe;
        q_tiles<BM>(ikv * BLK, n_q, q_shift, p, &qb, &qe);
        mbar_wait(kv_empty, (n & 1) ^ 1);
        mbar_expect_tx(kv_full, 2 * L::KTILE);
        for (int c = 0; c < L::HALVES; ++c) {
          tma_load(base + L::K + c * BOX_BYTES, &tm_k, kv_full, c * 64, h,
                   ikv * BLK, b);
          tma_load(base + L::V + c * BOX_BYTES, &tm_v, kv_full, c * 64, h,
                   ikv * BLK, b);
        }
        const long long rows = (static_cast<long long>(b) * p.H + h) * p.Sq;
        for (int qt = qb; qt < qe; ++qt, ++q_it) {
          const int s = q_it % STAGES;
          const uint32_t stage = base + L::RING + s * L::STAGE;
          const uint32_t bar = full_bar + 8 * s;
          mbar_wait(empty_bar + 8 * s, ((q_it / STAGES) & 1) ^ 1);
          mbar_expect_tx(bar, L::STAGE_TX);
          for (int c = 0; c < L::HALVES; ++c) {
            tma_load(stage + c * L::QBOX, &tm_q, bar, c * 64, h, qt * BM, b);
            tma_load(stage + L::QTILE + c * L::QBOX, &tm_do, bar, c * 64, h,
                     qt * BM, b);
          }
          bulk_load(stage + L::LSE, p.lse + rows + qt * BM, BM * 4, bar);
          bulk_load(stage + L::DELTA, p.delta + rows + qt * BM, BM * 4, bar);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32, lane = tw % 32;
    const int g = lane / 4, tig = lane % 4;
    const int row0 = wg * WG_ROWS + warp * 16 + g;  // this thread's keys:
                                                    // row0, row0 + 8
    const uint32_t k_smem = base + L::K + wg * WG_ROWS * 128;
    const uint32_t v_smem = base + L::V + wg * WG_ROWS * 128;
    if (wg == 1) turn_pass(wg);
    int q_it = 0;
    for (int n = 0;; ++n) {
      const int t = tile_of(n, blockIdx.x, gridDim.x);
      if (t >= n_tiles) break;
      const int ikv = t / (p.H * p.B);
      const int h = t % p.H, b = t / p.H % p.B;
      const int kv0 = ikv * BLK;
      const uint8_t* kv_row =
          p.kv_mask ? p.kv_mask + static_cast<long long>(b) * p.Sk : nullptr;
      const DkvRows r{{kv0 + row0, kv0 + row0 + 8},
                      kv0 + wg * WG_ROWS,
                      {kv_row == nullptr || kv_row[kv0 + row0] != 0,
                       kv_row == nullptr || kv_row[kv0 + row0 + 8] != 0},
                      kv_row != nullptr};
      int qb, qe;
      q_tiles<BM>(kv0, n_q, q_shift, p, &qb, &qe);

      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;

      mbar_wait(kv_full, n & 1);
      if (qb == qe) mbar_arrive(kv_empty);  // no query admitted: 0s
      float s[BM / 2], dp[BM / 2];
      uint32_t pa[BM / 16][4], da[BM / 16][4];
      const auto q_tile = [&](int st) {  // a stage's Q tile; dO follows
        return base + L::RING + st * L::STAGE;
      };
      const auto rows = [&](int st, int off) {  // a stage's LSE or delta
        return reinterpret_cast<const float*>(smem + L::RING + st * L::STAGE +
                                              off);
      };
      stream_tiles<L::PIPE, STAGES>(
          qb, qe, q_it, full_bar, empty_bar, wg,
          [&](int st) {  // S^T = K Q^T, dP^T = V dO^T
            issue_ss<T, BM, D>(s, k_smem, BOX_BYTES, q_tile(st), L::QBOX);
            issue_ss<T, BM, D>(dp, v_smem, BOX_BYTES, q_tile(st) + L::QTILE,
                               L::QBOX);
          },
          [&](int st, int qt) {
            fence_regs<BM / 2>(s);
            fence_regs<BM / 2>(dp);
            p_ds_tile<BM>(s, dp, qt * BM + q_shift, tig, rows(st, L::LSE),
                          rows(st, L::DELTA), r, p);
          },
          [&] {
            pack_frags<T, BM>(pa, s);   // P rounded to dO's type
            pack_frags<T, BM>(da, dp);  // dS rounded to Q's type
          },
          [&](int st) {
            issue_rs<T, D, BM>(dv, pa, q_tile(st) + L::QTILE, L::QBOX);
            issue_rs<T, D, BM>(dk, da, q_tile(st), L::QBOX);
          },
          [&] {
            fence_regs<D / 2>(dk);
            fence_regs<D / 2>(dv);
            fence_frags<BM / 16>(pa);
            fence_frags<BM / 16>(da);
          },
          [&] { mbar_arrive(kv_empty); });  // K and V are read

      const long long off =
          ((static_cast<long long>(b) * p.Sk + kv0 + wg * WG_ROWS) * p.H + h) *
          D;
      unsigned char* stage = smem + L::OUT + wg * WG_ROWS * 128;
      const long long stride = static_cast<long long>(p.H) * D;
      store_rows<T, D>(dk, stage, static_cast<T*>(p.out0) + off, stride,
                       1 + wg);
      store_rows<T, D>(dv, stage, static_cast<T*>(p.out1) + off, stride,
                       1 + wg);
    }
  }
}

// ---- host side

// dkv = 0: flash_bwd_dq_wgmma over (128-row q tile, head, batch) work
// tiles; dkv = 1: flash_bwd_dkv_wgmma over (128-key tile, head, batch);
// one persistent block per SM at most.
template <typename T, int D>
int launch(int dkv, int dtype, const RawArgs& r, const Masks& mk,
           cudaStream_t stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled encode = encode_tiled();
  const int sms = sm_count();
  if (encode == nullptr || sms == 0 ||
      reinterpret_cast<uintptr_t>(r.lse) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(r.delta) % 16 != 0)
    return invalid;
  // Q and dO stream in dkv, K and V in dq; the others stay for a work tile.
  const int q_rows = dkv ? DkvSmem<D>::BM : BLK;
  const int k_rows = dkv ? BLK : DqSmem<D>::BN;
  const Strides& st = r.st;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!make_map(&tm_q, encode, dtype, r.q, D, r.H, r.Sq, r.B, st.q_ss,
                st.q_sb, q_rows) ||
      !make_map(&tm_do, encode, dtype, r.dout, D, r.H, r.Sq, r.B, st.do_ss,
                st.do_sb, q_rows) ||
      !make_map(&tm_k, encode, dtype, r.k, D, r.H, r.Sk, r.B, st.k_ss,
                st.k_sb, k_rows) ||
      !make_map(&tm_v, encode, dtype, r.v, D, r.H, r.Sk, r.B, st.v_ss,
                st.v_sb, k_rows))
    return invalid;
  const Params p{dkv ? r.dk : r.dq, r.dv,
                 static_cast<const float*>(r.lse),
                 static_cast<const float*>(r.delta), mk.kv_mask, r.B, r.H,
                 r.Sq, r.Sk, mk.causal, mk.has_window,
                 clamp_window(mk.window, r.Sq, r.Sk), r.scale,
                 r.scale * LOG2E};
  const int tiles = (dkv ? r.Sk : r.Sq) / BLK * r.H * r.B;
  const dim3 grid(tiles < sms ? tiles : sms);
  if (dkv)
    return launch_kernel_threads<flash_bwd_dkv_wgmma<T, D>>(
        DkvSmem<D>::ALLOC, grid, THREADS, stream, tm_k, tm_v, tm_q, tm_do, p);
  return launch_kernel_threads<flash_bwd_dq_wgmma<T, D>>(
      DqSmem<D>::ALLOC, grid, THREADS, stream, tm_q, tm_do, tm_k, tm_v, p);
}

}  // namespace hopper

// ------------------------------------------------------------------ float32

template <typename T>
struct BwdArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* dout;
  const float* lse;    // [B, H, Sq]
  const float* delta;  // [B, H, Sq]
  T* dq;               // contiguous [B, Sq, H, D]
  T* dk;               // contiguous [B, Sk, H, D]
  T* dv;
  int H, Sq, Sk;
  Strides st;
  float scale;
};

// The q tiles a kv tile starting at key kv0 can be admitted by, as
// [begin, end): causality starts at the tile holding query position kv0,
// the window ends at the tile holding position kv0 + BKV - 1 + window.
__device__ __forceinline__ void q_range(long long kv0, int n_q,
                                        long long q_shift, const Masks& mk,
                                        long long* begin, long long* end) {
  *begin = 0;
  *end = n_q;
  if (mk.causal && kv0 - q_shift > 0) *begin = (kv0 - q_shift) / BQ;
  if (mk.has_window) {
    const long long last = kv0 + BKV - 1 + mk.window - q_shift;
    *end = last < 0 ? 0 : last / BQ + 1;
    if (*end > n_q) *end = n_q;
  }
}

template <int D>
struct F32BwdSmem {
  static constexpr int LD = D + 4;  // row stride of the 64-row tiles
  static constexpr size_t tile = sizeof(float) * 64 * LD;
  static constexpr size_t acc = sizeof(float) * 64 * D;
  static constexpr size_t rows = sizeof(float) * WARPS * 64;  // a row each
  // dq: Q, dO, K, V tiles, the dQ accumulator, each warp's dS row.
  static constexpr size_t dq_bytes = 4 * tile + acc + rows;
  // dkv: K, V, Q, dO tiles, dK and dV, LSE and delta, each warp's P and
  // dS rows.
  static constexpr size_t dkv_bytes =
      4 * tile + 2 * acc + 2 * sizeof(float) * BQ + 2 * rows;
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_f32(const BwdArgs<float> a, const Masks mk) {
  constexpr int LD = F32BwdSmem<D>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + 64 * LD;
  float* Ks = dOs + 64 * LD;
  float* Vs = Ks + 64 * LD;
  float* dQs = Vs + 64 * LD;
  float* dSw = dQs + 64 * D;  // [WARPS][BKV]

  const int iq = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long q0 = static_cast<long long>(iq) * BQ;
  const long long q_lo = q0 + (a.Sk - a.Sq);
  const uint8_t* kv_row =
      mk.kv_mask ? mk.kv_mask + static_cast<long long>(b) * a.Sk : nullptr;
  long long kv_begin, kv_end;
  kv_range(q_lo, a.Sk / BKV, mk, &kv_begin, &kv_end);
  const Strides& st = a.st;
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq + q0;
  float* ds = dSw + warp * BKV;

  load_tile_f32<D, LD>(Qs, a.q + b * st.q_sb + q0 * st.q_ss + h * D, st.q_ss);
  load_tile_f32<D, LD>(dOs, a.dout + b * st.do_sb + q0 * st.do_ss + h * D,
                       st.do_ss);
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) dQs[i] = 0.0f;
  __syncthreads();

  for (long long t = kv_begin; t < kv_end; ++t) {
    const long long kv0 = t * BKV;
    load_tile_f32<D, LD>(Ks, a.k + b * st.k_sb + kv0 * st.k_ss + h * D,
                         st.k_ss);
    load_tile_f32<D, LD>(Vs, a.v + b * st.v_sb + kv0 * st.v_ss + h * D,
                         st.v_ss);
    __syncthreads();
    for (int rr = 0; rr < ROWS; ++rr) {
      const int r = warp * ROWS + rr;
      const float lse = a.lse[row_base + r];
      const float delta = a.delta[row_base + r];
#pragma unroll
      for (int j = 0; j < BKV / 32; ++j) {
        const int c = lane + 32 * j;
        float s = 0.0f, dp = 0.0f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          s += Qs[r * LD + d] * Ks[c * LD + d];
          dp += dOs[r * LD + d] * Vs[c * LD + d];
        }
        const float p = mk.ok(q_lo + r, kv0 + c, kv_row)
                            ? expf(s * a.scale - lse) : 0.0f;
        ds[c] = p * (dp - delta) * a.scale;
      }
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        float acc = 0.0f;
#pragma unroll 8
        for (int c = 0; c < BKV; ++c) acc += ds[c] * Ks[c * LD + d];
        dQs[r * D + d] += acc;
      }
      __syncwarp();
    }
    __syncthreads();  // K/V are overwritten by the next tile
  }

  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = warp * ROWS + rr;
    float* out =
        a.dq + ((static_cast<long long>(b) * a.Sq + q0 + r) * a.H + h) * D;
    for (int d = lane; d < D; d += 32) out[d] = dQs[r * D + d];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_f32(const BwdArgs<float> a, const Masks mk) {
  constexpr int LD = F32BwdSmem<D>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + 64 * LD;
  float* Qs = Vs + 64 * LD;
  float* dOs = Qs + 64 * LD;
  float* dKs = dOs + 64 * LD;
  float* dVs = dKs + 64 * D;
  float* Ls = dVs + 64 * D;
  float* Ds = Ls + BQ;
  float* Pw = Ds + BQ;              // [WARPS][BQ]
  float* dSw = Pw + WARPS * BQ;     // [WARPS][BQ]

  const int ikv = blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long kv0 = static_cast<long long>(ikv) * BKV;
  const long long q_shift = a.Sk - a.Sq;
  const uint8_t* kv_row =
      mk.kv_mask ? mk.kv_mask + static_cast<long long>(b) * a.Sk : nullptr;
  long long q_begin, q_end;
  q_range(kv0, a.Sq / BQ, q_shift, mk, &q_begin, &q_end);
  const Strides& st = a.st;
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
  float* p_row = Pw + warp * BQ;
  float* ds_row = dSw + warp * BQ;

  load_tile_f32<D, LD>(Ks, a.k + b * st.k_sb + kv0 * st.k_ss + h * D, st.k_ss);
  load_tile_f32<D, LD>(Vs, a.v + b * st.v_sb + kv0 * st.v_ss + h * D, st.v_ss);
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) dKs[i] = dVs[i] = 0.0f;

  for (long long t = q_begin; t < q_end; ++t) {
    const long long q0 = t * BQ;
    __syncthreads();  // the previous tile is no longer read
    load_tile_f32<D, LD>(Qs, a.q + b * st.q_sb + q0 * st.q_ss + h * D,
                         st.q_ss);
    load_tile_f32<D, LD>(dOs, a.dout + b * st.do_sb + q0 * st.do_ss + h * D,
                         st.do_ss);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      Ls[i] = a.lse[row_base + q0 + i];
      Ds[i] = a.delta[row_base + q0 + i];
    }
    __syncthreads();
    const long long q_lo = q0 + q_shift;
    for (int rr = 0; rr < ROWS; ++rr) {
      const int r = warp * ROWS + rr;
#pragma unroll
      for (int j = 0; j < BQ / 32; ++j) {
        const int c = lane + 32 * j;
        float s = 0.0f, dp = 0.0f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          s += Ks[r * LD + d] * Qs[c * LD + d];
          dp += Vs[r * LD + d] * dOs[c * LD + d];
        }
        const float p = mk.ok(q_lo + c, kv0 + r, kv_row)
                            ? expf(s * a.scale - Ls[c]) : 0.0f;
        p_row[c] = p;
        ds_row[c] = p * (dp - Ds[c]) * a.scale;
      }
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        float acc_v = 0.0f, acc_k = 0.0f;
#pragma unroll 8
        for (int c = 0; c < BQ; ++c) {
          acc_v += p_row[c] * dOs[c * LD + d];
          acc_k += ds_row[c] * Qs[c * LD + d];
        }
        dVs[r * D + d] += acc_v;
        dKs[r * D + d] += acc_k;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = warp * ROWS + rr;
    const long long off =
        ((static_cast<long long>(b) * a.Sk + kv0 + r) * a.H + h) * D;
    for (int d = lane; d < D; d += 32) {
      a.dk[off + d] = dKs[r * D + d];
      a.dv[off + d] = dVs[r * D + d];
    }
  }
}

// ------------------------------------------------------------------ launch

// dkv = 0: flash_bwd_dq_f32 over (Sq / 64, H, B); dkv = 1: flash_bwd_dkv_f32
// over (Sk / 64, H, B).
template <int D>
int launch_f32(int dkv, const RawArgs& r, const Masks& mk, cudaStream_t s) {
  const BwdArgs<float> a{static_cast<const float*>(r.q),
                         static_cast<const float*>(r.k),
                         static_cast<const float*>(r.v),
                         static_cast<const float*>(r.dout),
                         static_cast<const float*>(r.lse),
                         static_cast<const float*>(r.delta),
                         static_cast<float*>(r.dq), static_cast<float*>(r.dk),
                         static_cast<float*>(r.dv), r.H, r.Sq, r.Sk, r.st,
                         r.scale};
  const dim3 grid(dkv ? r.Sk / BKV : r.Sq / BQ, r.H, r.B);
  using L = F32BwdSmem<D>;
  return dkv ? launch_kernel<flash_bwd_dkv_f32<D>>(L::dkv_bytes, grid, s, a,
                                                   mk)
             : launch_kernel<flash_bwd_dq_f32<D>>(L::dq_bytes, grid, s, a, mk);
}

int dispatch(int dkv, int dtype, int D, const RawArgs& r, const Masks& mk,
             cudaStream_t s) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (r.B < 1 || r.H < 1 || r.Sq < 1 || r.Sk < 1) return invalid;
  if (dtype == 0) {
    if (r.Sq % BQ != 0 || r.Sk % BKV != 0) return invalid;
    if (D == 64) return launch_f32<64>(dkv, r, mk, s);
    if (D == 128) return launch_f32<128>(dkv, r, mk, s);
    return invalid;
  }
  if (r.Sq % hopper::BLK != 0 || r.Sk % hopper::BLK != 0) return invalid;
  if (dtype == 1 && D == 64)
    return hopper::launch<__nv_bfloat16, 64>(dkv, dtype, r, mk, s);
  if (dtype == 1 && D == 128)
    return hopper::launch<__nv_bfloat16, 128>(dkv, dtype, r, mk, s);
  if (dtype == 2 && D == 64)
    return hopper::launch<__half, 64>(dkv, dtype, r, mk, s);
  if (dtype == 2 && D == 128)
    return hopper::launch<__half, 128>(dkv, dtype, r, mk, s);
  return invalid;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; D: 64 or 128.  q/k/v/dout
// are BSHD with a contiguous [H, D] inner block, 16-byte aligned rows and
// the given batch and sequence strides (in elements); lse and delta are
// [B, H, Sq] f32, 16-byte aligned; dq, dk, dv are contiguous BSHD in the
// input type (the entry writes only its own: dq, or dk and dv); kv_mask is
// null or [B, Sk] bytes (nonzero = attend).  Sq and Sk are multiples of
// 128 (bfloat16, float16) or 64 (float32).  Each entry launches one kernel
// on `stream`, allocates nothing, and returns the launch's cudaError_t (0
// on success; cudaErrorInvalidValue for what it does not take).
#define FLASH_BWD_ENTRY(NAME, DKV)                                            \
  extern "C" int NAME(                                                        \
      int dtype, int D, const void* q, const void* k, const void* v,          \
      const void* dout, const void* lse, const void* delta,                   \
      const void* kv_mask, void* dq, void* dk, void* dv, int B, int H,        \
      int Sq, int Sk, long long q_sb, long long q_ss, long long k_sb,         \
      long long k_ss, long long v_sb, long long v_ss, long long do_sb,        \
      long long do_ss, float scale, int causal, int has_window,               \
      long long window, void* stream) {                                       \
    const RawArgs r{q,  k,  v, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk,    \
                    {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss},       \
                    scale};                                                   \
    const Masks mk{static_cast<const uint8_t*>(kv_mask), causal, has_window,  \
                   window};                                                   \
    return dispatch(DKV, dtype, D, r, mk, static_cast<cudaStream_t>(stream)); \
  }

FLASH_BWD_ENTRY(flash_bwd_dq, 0)
FLASH_BWD_ENTRY(flash_bwd_dkv, 1)
