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

#include "flash_hopper.cuh"

namespace {

// ------------------------------------------------------- Hopper bf16/fp16

namespace hopper {

constexpr int BQ = BLK;          // query rows of a block (two warpgroups)
constexpr int BKV = 128;         // key rows of a K/V tile

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

struct Params {
  void* o;
  float* lse;
  const uint8_t* kv_mask;  // [B, Sk] bytes or null
  int B, H, Sq, Sk;
  int causal, has_window, window;  // window clamped into int range
  float scale_log2;                // scale * log2(e)
};

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
        kv_tiles<BKV>(iq * BQ + q_shift, n_kv, p.causal, p.has_window,
                      p.window, &kb, &ke);
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
      kv_tiles<BKV>(q_lo, n_kv, p.causal, p.has_window, p.window, &kb, &ke);

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
        issue_ss<T, BKV, D>(s, q_smem, BOX_BYTES, base + L::K + prev * L::TILE,
                            BOX_BYTES);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<0>();
        fence_regs<64>(s);
        if (kb + 1 == ke) mbar_arrive(q_empty);  // Q is read for this tile
        softmax_tile(s, m, l, corr, kb * BKV, rc, p);  // acc is 0: no rescale
        pack_frags<T, BKV>(pa, s);
        ++kv_it;
        for (int kt = kb + 1; kt < ke; ++kt, ++kv_it) {
          const int cur = kv_it % STAGES;
          mbar_wait(full_bar + 8 * cur, (kv_it / STAGES) & 1);
          fence_regs<D / 2>(acc);
          fence_frags(pa);
          turn_wait(wg);
          wgmma_fence();
          issue_ss<T, BKV, D>(s, q_smem, BOX_BYTES, base + L::K + cur * L::TILE,
                              BOX_BYTES);
          wgmma_commit();
          issue_rs<T, D, BKV>(acc, pa, base + L::V + prev * L::TILE, BOX_BYTES);
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
          pack_frags<T, BKV>(pa, s);
          prev = cur;
        }
        fence_regs<D / 2>(acc);
        fence_frags(pa);
        turn_wait(wg);
        wgmma_fence();
        issue_rs<T, D, BKV>(acc, pa, base + L::V + prev * L::TILE, BOX_BYTES);
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
      // buffer and leaves as 16-byte stores.
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        inv[i] = 1.0f / (l[i] == 0.0f ? 1.0f : l[i]);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= inv[(i >> 1) & 1];
      const long long row0_out =
          static_cast<long long>(b) * p.Sq + iq * BQ + wg * WG_ROWS;
      store_rows<T, D>(acc, smem + L::O + wg * WG_ROWS * 128,
                       static_cast<T*>(p.o) + (row0_out * p.H + h) * D,
                       static_cast<long long>(p.H) * D, 1 + wg);
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

template <typename T, int D>
int launch(int dtype, const void* q, const void* k, const void* v,
           const Masks& mk, void* o, float* lse, int B, int H, int Sq,
           int Sk, const long long* st, float scale, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  const int sms = sm_count();
  if (encode == nullptr || sms == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, encode, dtype, q, D, H, Sq, B, st[1], st[0], BQ) ||
      !make_map(&tm_k, encode, dtype, k, D, H, Sk, B, st[3], st[2], BKV) ||
      !make_map(&tm_v, encode, dtype, v, D, H, Sk, B, st[5], st[4], BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{o, lse, mk.kv_mask, B, H, Sq, Sk, mk.causal,
                 mk.has_window, clamp_window(mk.window, Sq, Sk),
                 scale * LOG2E};
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
