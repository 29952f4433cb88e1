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
// about 4.4 us: the floor is about 5 us, memory-bound.
//
// What this design does about it: one block per (q-tile of 64 rows, head,
// batch) reads its Q tile once and streams K/V tiles of 64 rows through
// shared memory, so the [S, S] scores never reach device memory and each
// block reads K/V only over the tiles its masks can admit: the causal
// bound ends the loop at the tile holding the block's last query, the
// window starts it at the tile holding q_lo - window (the TPU's
// _block_needed / _kv_base remap become the loop's ends).  Blocks with the
// longest causal loops are scheduled first.
//
// bf16 / fp16 (the model's path): four warps own 16 query rows each and
// keep everything of a row in registers, as FlashAttention-2 does: Q as
// mma.sync A fragments, the 16 x 64 score tile and the 16 x D output
// accumulator as f32 C fragments.  The score fragments are rounded to the
// input type and reused directly as the A operand of the PV product (the
// C layout of two m16n8 tiles is the A layout of one m16k16 tile), so P
// never touches shared memory.  K and V reach the tensor cores through
// ldmatrix (V transposed by ldmatrix.trans) from rows padded by 16 bytes,
// which keeps the eight rows of each 8x8 matrix in distinct banks.  The
// next K/V tile is copied with cp.async while the current one is used
// (two stages).  No wgmma or TMA yet, so it stays well above the floor.
//
// float32: a simple shared-memory version with f32 FMAs (the tensor cores
// would round to TF32); each warp owns 16 rows, its scores, P and output
// accumulator live in shared memory.

#include "flash_common.cuh"

namespace {

template <typename T, int D>
struct MmaSmem {
  static constexpr int LD = D + 8;  // 16-byte row pad: ldmatrix bank spread
  static constexpr size_t tile = sizeof(T) * 64 * LD;
  static constexpr size_t bytes = tile * 5;  // Q, K x 2 stages, V x 2
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, Masks mk, T* __restrict__ o,
              float* __restrict__ lse, int H, int Sq, int Sk, long long q_sb,
              long long q_ss, long long k_sb, long long k_ss, long long v_sb,
              long long v_ss, float scale) {
  using L = MmaSmem<T, D>;
  constexpr int LD = L::LD;
  constexpr int NS = BKV / 8;  // score n-tiles of a row block
  constexpr int NO = D / 8;    // output n-tiles
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + 64 * LD;   // two stages
  T* Vs = Ks + 128 * LD;  // two stages

  const int iq = gridDim.x - 1 - blockIdx.x;  // longest causal loops first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const long long q0 = static_cast<long long>(iq) * BQ;  // local row
  const long long q_lo = q0 + (Sk - Sq);                 // its position
  const uint8_t* kv_row =
      mk.kv_mask ? mk.kv_mask + static_cast<long long>(b) * Sk : nullptr;

  long long kv_begin, kv_end;
  kv_range(q_lo, Sk / BKV, mk, &kv_begin, &kv_end);

  const T* kb = k + b * k_sb + h * D;
  const T* vb = v + b * v_sb + h * D;
  copy_tile<T, D, LD>(Qs, q + b * q_sb + q0 * q_ss + h * D, q_ss);
  cp_async_commit();
  if (kv_begin < kv_end) {
    copy_tile<T, D, LD>(Ks, kb + kv_begin * BKV * k_ss, k_ss);
    copy_tile<T, D, LD>(Vs, vb + kv_begin * BKV * v_ss, v_ss);
  }
  cp_async_commit();

  // This thread's two rows of the warp's 16: r and r + 8.
  const int r0 = warp * ROWS + g;
  const long long qpos[2] = {q_lo + r0, q_lo + r0 + 8};
  const long long qw_lo = q_lo + warp * ROWS;  // the warp's first position
  uint32_t qf[D / 16][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.0f, 0.0f};  // this thread's share of the row sums

  for (long long t = kv_begin; t < kv_end; ++t) {
    const int stage = static_cast<int>(t - kv_begin) & 1;
    T* Kt = Ks + stage * 64 * LD;
    T* Vt = Vs + stage * 64 * LD;
    if (t + 1 < kv_end) {  // prefetch the next tile into the other stage
      copy_tile<T, D, LD>(Ks + (stage ^ 1) * 64 * LD,
                      kb + (t + 1) * BKV * k_ss, k_ss);
      copy_tile<T, D, LD>(Vs + (stage ^ 1) * 64 * LD,
                      vb + (t + 1) * BKV * v_ss, v_ss);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == kv_begin) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk],
                Qs + (warp * ROWS + lane % 16) * LD + kk * 16 + lane / 16 * 8);
    }

    // S = Q K^T: n-tile n covers keys n*8 .. n*8+7.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
        uint32_t kf[4];  // B fragments of two k-steps (d kk*32 .. +31)
        ldsm_x4(kf, Kt + (n * 8 + lane % 8) * LD + kk * 32 + lane / 8 * 8);
        Mma<T>::mma(s[n], qf[2 * kk], kf);
        Mma<T>::mma(s[n], qf[2 * kk + 1], kf + 2);
      }
    }

    // Scale and mask; element e of n-tile n is row e / 2, key
    // n*8 + 2*tig + e % 2.  A tile every row of the warp admits skips the
    // per-element test.
    const long long kv0 = t * BKV;
    const bool full = (!mk.causal || kv0 + BKV - 1 <= qw_lo) &&
                      (!mk.has_window || qw_lo + ROWS - 1 - kv0 <= mk.window) &&
                      kv_row == nullptr;
    float mc[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (!full && !mk.ok(qpos[e / 2], kv0 + n * 8 + 2 * tig + e % 2, kv_row))
          x = NEG_INF;
        s[n][e] = x;
        mc[e / 2] = fmaxf(mc[e / 2], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the row's four threads share a max
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 1));
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 2));
      const float m_new = fmaxf(m[i], mc[i]);
      corr[i] = m[i] > NEG_INF / 2 ? __expf(m[i] - m_new) : 0.0f;
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // A fully masked row leaves m at NEG_INF, where
        // exp(NEG_INF - NEG_INF) = 1 would pollute l: zero those terms.
        const float p =
            s[n][e] > NEG_INF / 2 ? __expf(s[n][e] - m[e / 2]) : 0.0f;
        s[n][e] = p;
        l[e / 2] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V, P rounded to V's type: score tiles 2j and 2j+1 are the A
    // fragment of k-step j (keys j*16 .. j*16+15).
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      uint32_t pf[4] = {Mma<T>::pack(s[2 * j][0], s[2 * j][1]),
                        Mma<T>::pack(s[2 * j][2], s[2 * j][3]),
                        Mma<T>::pack(s[2 * j + 1][0], s[2 * j + 1][1]),
                        Mma<T>::pack(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NO / 2; ++n) {
        uint32_t vf[4];  // B fragments of output n-tiles 2n and 2n+1
        ldsm_x4_t(vf, Vt + (j * 16 + lane % 8 + (lane / 8) % 2 * 8) * LD +
                          n * 16 + lane / 16 * 8);
        Mma<T>::mma(acc[2 * n], pf, vf);
        Mma<T>::mma(acc[2 * n + 1], pf, vf + 2);
      }
    }
    __syncthreads();  // this stage is refilled by the next prefetch
  }
  cp_async_wait<0>();

  // Finalize: O = acc / l, LSE = m + log(l); fully masked rows -> 0, NEG_INF.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float safe_l = l[i] == 0.0f ? 1.0f : l[i];
    const float inv = 1.0f / safe_l;
    const long long row = q0 + r0 + 8 * i;
    T* orow = o + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * tig) = Mma<T>::pack(
          acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    if (tig == 0)
      lse[(static_cast<long long>(b) * H + h) * Sq + row] =
          l[i] == 0.0f ? NEG_INF : m[i] + logf(safe_l);
  }
}

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

template <typename T, int D>
int launch_mma(const void* q, const void* k, const void* v, const Masks& mk,
               void* o, float* lse, int B, int H, int Sq, int Sk,
               const long long* st, float scale, cudaStream_t stream) {
  return launch_kernel<flash_fwd_mma<T, D>>(
      MmaSmem<T, D>::bytes, dim3(Sq / BQ, H, B), stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mk, static_cast<T*>(o), lse, H, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], scale);
}

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
// Sq and Sk are multiples of 64.  Launches on `stream`, allocates nothing,
// and returns the launch's cudaError_t (0 on success).
extern "C" int flash_fwd(int dtype, int D, const void* q, const void* k,
                         const void* v, const void* kv_mask, void* o,
                         void* lse, int B, int H, int Sq, int Sk,
                         long long q_sb, long long q_ss, long long k_sb,
                         long long k_ss, long long v_sb, long long v_ss,
                         float scale, int causal, int has_window,
                         long long window, void* stream) {
  if (Sq % BQ != 0 || Sk % BKV != 0 || B < 1 || H < 1 || Sq < 1 || Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Masks mk{static_cast<const uint8_t*>(kv_mask), causal, has_window,
                 window};
  const long long st[6] = {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss};
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_f32<64>(q, k, v, mk, o, l, B, H, Sq, Sk, st, scale, s);
  if (dtype == 0 && D == 128)
    return launch_f32<128>(q, k, v, mk, o, l, B, H, Sq, Sk, st, scale, s);
  if (dtype == 1 && D == 64)
    return launch_mma<__nv_bfloat16, 64>(q, k, v, mk, o, l, B, H, Sq, Sk, st,
                                         scale, s);
  if (dtype == 1 && D == 128)
    return launch_mma<__nv_bfloat16, 128>(q, k, v, mk, o, l, B, H, Sq, Sk, st,
                                          scale, s);
  if (dtype == 2 && D == 64)
    return launch_mma<__half, 64>(q, k, v, mk, o, l, B, H, Sq, Sk, st, scale,
                                  s);
  if (dtype == 2 && D == 128)
    return launch_mma<__half, 128>(q, k, v, mk, o, l, B, H, Sq, Sk, st, scale,
                                   s);
  return static_cast<int>(cudaErrorInvalidValue);
}
