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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                  // query rows of a block
constexpr int BKV = 64;                 // key rows of a streamed tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;        // query rows a warp owns (16)
constexpr float NEG_INF = -1e30f;       // flash.py NEG_INF, not -inf

// The (q, k) admission rule shared by both paths.
struct Masks {
  const uint8_t* kv_mask;  // [B, Sk] bytes or null
  int causal, has_window;
  long long window;

  __device__ __forceinline__ bool ok(long long qpos, long long kpos,
                                     const uint8_t* kv_row) const {
    return (!causal || qpos >= kpos) &&
           (!has_window || qpos - kpos <= window) &&
           (kv_row == nullptr || kv_row[kpos] != 0);
  }
};

// The kv tiles any row of a block starting at position q_lo can admit
// (_block_needed, and the window's _kv_base remap), as [begin, end).
__device__ __forceinline__ void kv_range(long long q_lo, int n_kv,
                                         const Masks& mk, long long* begin,
                                         long long* end) {
  const long long q_hi = q_lo + BQ - 1;
  *begin = 0;
  *end = n_kv;
  if (mk.causal) *end = q_hi < 0 ? 0 : q_hi / BKV + 1;
  if (mk.has_window && q_lo - mk.window > 0)
    *begin = (q_lo - mk.window) / BKV;
  if (*end > n_kv) *end = n_kv;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------- bf16/fp16

template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  __device__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
    return *reinterpret_cast<uint32_t*>(&v);
  }
  // c[16x8] += a[16x16] b[16x8], f32 accumulators.
  __device__ static void mma(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};
template <> struct Mma<__half> {
  __device__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static void mma(float* c, const uint32_t* a, const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane i gives the address of row i % 8 of matrix
// i / 8 and receives, in r[m], row lane / 4, columns 2 * (lane % 4) + {0, 1}
// of matrix m (of its transpose with .trans).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int D>
struct MmaSmem {
  static constexpr int LD = D + 8;  // 16-byte row pad: ldmatrix bank spread
  static constexpr size_t tile = sizeof(T) * 64 * LD;
  static constexpr size_t bytes = tile * 5;  // Q, K x 2 stages, V x 2
};

// 64 rows of D elements (row stride `stride` elements, rows contiguous
// inside) into shared memory rows of LD elements, 16 bytes a thread,
// asynchronously (cp.async; the caller commits and waits).
template <typename T, int D>
__device__ __forceinline__ void copy_tile(T* dst, const T* src,
                                          long long stride) {
  constexpr int LD = MmaSmem<T, D>::LD;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    cp_async16(dst + r * LD + c, src + r * stride + c);
  }
}

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
  copy_tile<T, D>(Qs, q + b * q_sb + q0 * q_ss + h * D, q_ss);
  cp_async_commit();
  if (kv_begin < kv_end) {
    copy_tile<T, D>(Ks, kb + kv_begin * BKV * k_ss, k_ss);
    copy_tile<T, D>(Vs, vb + kv_begin * BKV * v_ss, v_ss);
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
      copy_tile<T, D>(Ks + (stage ^ 1) * 64 * LD,
                      kb + (t + 1) * BKV * k_ss, k_ss);
      copy_tile<T, D>(Vs + (stage ^ 1) * 64 * LD,
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

// 64 rows of D floats into shared memory rows of LD floats, synchronously.
template <int D, int LD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              long long stride) {
  constexpr int PER_ROW = D / 4;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 4;
    *reinterpret_cast<float4*>(dst + r * LD + c) =
        *reinterpret_cast<const float4*>(src + r * stride + c);
  }
}

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

template <typename T, int D, typename Kernel>
int launch(Kernel kernel, size_t bytes, const void* q, const void* k,
           const void* v, const Masks& mk, void* o, float* lse, int B, int H,
           int Sq, int Sk, const long long* st, float scale,
           cudaStream_t stream) {
  static bool configured = false;  // once per kernel instantiation
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid(Sq / BQ, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mk, static_cast<T*>(o), lse, H, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_mma(const void* q, const void* k, const void* v, const Masks& mk,
               void* o, float* lse, int B, int H, int Sq, int Sk,
               const long long* st, float scale, cudaStream_t stream) {
  return launch<T, D>(flash_fwd_mma<T, D>, MmaSmem<T, D>::bytes, q, k, v, mk,
                      o, lse, B, H, Sq, Sk, st, scale, stream);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const Masks& mk,
               void* o, float* lse, int B, int H, int Sq, int Sk,
               const long long* st, float scale, cudaStream_t stream) {
  return launch<float, D>(flash_fwd_f32<D>, F32Smem<D>::bytes, q, k, v, mk,
                          o, lse, B, H, Sq, Sk, st, scale, stream);
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
