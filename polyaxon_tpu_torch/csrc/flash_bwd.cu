// Flash-attention backward for Hopper (sm_90a), CUDA C++ with a plain C
// interface; built by polyaxon_tpu_torch/ops/_build.py with nvcc and
// loaded with ctypes by polyaxon_tpu_torch/ops/flash.py.
//
// Replaces the two TPU kernels of polyaxon_tpu/ops/flash.py's
// _flash_backward: _bwd_dq_kernel (entry flash_bwd_dq) and _bwd_dkv_kernel
// (entry flash_bwd_dkv).  Both recompute P = exp(S * scale - LSE) from the
// forward's row logsumexp, with the forward's masks (causal with q_shift =
// Sk - Sq, raw window, key padding) applied as a select, never a multiply:
// a fully masked row has LSE = -1e30, where exp overflows to inf.  With
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
// 3.35 TB/s.  Both are bound by operations.
//
// What this design does about it: the [S, S] scores never reach device
// memory.  dq: one block per (q tile of 64 rows, head, batch) holds its Q
// and dO tiles in shared memory and streams K/V tiles over the range its
// masks admit (kv_range: the forward's loop ends); dQ stays in registers.
// dkv: one block per (kv tile of 64 rows, head, batch) holds K and V and
// streams Q, dO, LSE and delta tiles over the q range its masks admit
// (q_range: from the tile whose last query reaches the tile's first key
// under causality, to the last query the window lets reach its last key,
// the mirror of _q_base); dK and dV stay in registers.  Streamed tiles are
// double-buffered with cp.async.
//
// bf16 / fp16: four warps own 16 rows each, everything of a row in
// mma.sync fragments as in flash_fwd.cu.  Score-shaped f32 C fragments (P,
// dS) are rounded to the input type and reused directly as the A operand
// of the next product (the C layout of two m16n8 tiles is the A layout of
// one m16k16 tile), so P and dS never touch shared memory.  Operands read
// along their rows come through ldmatrix, operands read down their
// columns through ldmatrix.trans, from rows padded by 16 bytes.  At D = 128
// the dkv block keeps dK and dV (2 x 16 x 128 f32 a warp, 128 registers a
// thread) plus the 16 x 64 S and dP fragments live; its shared memory
// (about 106 KB) is raised past 48 KB with cudaFuncSetAttribute.  No wgmma
// or TMA yet.
//
// float32: a shared-memory version with f32 FMAs (the tensor cores would
// round to TF32); each warp walks its 16 rows one at a time, the row's P
// and dS live in shared memory and the dQ (dK, dV) accumulators too.

#include "flash_common.cuh"

namespace {

struct Strides {  // batch and sequence strides, in elements
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss;
};

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

// ---------------------------------------------------------------- bf16/fp16

template <typename T, int D>
struct MmaBwdSmem {
  static constexpr int LD = D + 8;  // 16-byte row pad: ldmatrix bank spread
  static constexpr size_t tile = sizeof(T) * 64 * LD;
  // dq: Q, dO, K x 2 stages, V x 2.
  static constexpr size_t dq_bytes = tile * 6;
  // dkv: K, V, Q x 2, dO x 2, then LSE and delta rows x 2 stages.
  static constexpr size_t dkv_bytes = tile * 6 + 4 * BQ * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_mma(const BwdArgs<T> a, const Masks mk) {
  constexpr int LD = MmaBwdSmem<T, D>::LD;
  constexpr int NS = BKV / 8;  // score n-tiles of a row block
  constexpr int NO = D / 8;    // dQ n-tiles
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + 64 * LD;
  T* Ks = dOs + 64 * LD;  // two stages
  T* Vs = Ks + 128 * LD;  // two stages

  const int iq = gridDim.x - 1 - blockIdx.x;  // longest causal loops first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const long long q0 = static_cast<long long>(iq) * BQ;  // local row
  const long long q_lo = q0 + (a.Sk - a.Sq);             // its position
  const uint8_t* kv_row =
      mk.kv_mask ? mk.kv_mask + static_cast<long long>(b) * a.Sk : nullptr;
  long long kv_begin, kv_end;
  kv_range(q_lo, a.Sk / BKV, mk, &kv_begin, &kv_end);

  const Strides& st = a.st;
  const T* kb = a.k + b * st.k_sb + h * D;
  const T* vb = a.v + b * st.v_sb + h * D;
  copy_tile<T, D, LD>(Qs, a.q + b * st.q_sb + q0 * st.q_ss + h * D, st.q_ss);
  copy_tile<T, D, LD>(dOs, a.dout + b * st.do_sb + q0 * st.do_ss + h * D,
                      st.do_ss);
  cp_async_commit();
  if (kv_begin < kv_end) {
    copy_tile<T, D, LD>(Ks, kb + kv_begin * BKV * st.k_ss, st.k_ss);
    copy_tile<T, D, LD>(Vs, vb + kv_begin * BKV * st.v_ss, st.v_ss);
  }
  cp_async_commit();

  // This thread's two rows of the warp's 16: r0 and r0 + 8.
  const int r0 = warp * ROWS + g;
  const long long qpos[2] = {q_lo + r0, q_lo + r0 + 8};
  const long long qw_lo = q_lo + warp * ROWS;  // the warp's first position
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq + q0;
  const float lse_r[2] = {a.lse[row_base + r0], a.lse[row_base + r0 + 8]};
  const float delta_r[2] = {a.delta[row_base + r0],
                            a.delta[row_base + r0 + 8]};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (long long t = kv_begin; t < kv_end; ++t) {
    const int stage = static_cast<int>(t - kv_begin) & 1;
    const T* Kt = Ks + stage * 64 * LD;
    const T* Vt = Vs + stage * 64 * LD;
    if (t + 1 < kv_end) {  // prefetch the next tile into the other stage
      copy_tile<T, D, LD>(Ks + (stage ^ 1) * 64 * LD,
                          kb + (t + 1) * BKV * st.k_ss, st.k_ss);
      copy_tile<T, D, LD>(Vs + (stage ^ 1) * 64 * LD,
                          vb + (t + 1) * BKV * st.v_ss, st.v_ss);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T; n-tile n covers keys n*8 .. n*8+7.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      uint32_t qf[2][4], df[2][4];  // A fragments of k-steps 2kk, 2kk+1
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int off = (warp * ROWS + lane % 16) * LD + (2 * kk + u) * 16 +
                        lane / 16 * 8;
        ldsm_x4(qf[u], Qs + off);
        ldsm_x4(df[u], dOs + off);
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t kf[4], vf[4];  // B fragments of the two k-steps
        const int off = (n * 8 + lane % 8) * LD + kk * 32 + lane / 8 * 8;
        ldsm_x4(kf, Kt + off);
        ldsm_x4(vf, Vt + off);
        Mma<T>::mma(s[n], qf[0], kf);
        Mma<T>::mma(s[n], qf[1], kf + 2);
        Mma<T>::mma(dp[n], df[0], vf);
        Mma<T>::mma(dp[n], df[1], vf + 2);
      }
    }

    // dS = P * (dP - delta) * scale into s; element e of n-tile n is row
    // e / 2, key n*8 + 2*tig + e % 2.  A tile every row of the warp admits
    // skips the per-element test.
    const long long kv0 = t * BKV;
    const bool full = (!mk.causal || kv0 + BKV - 1 <= qw_lo) &&
                      (!mk.has_window || qw_lo + ROWS - 1 - kv0 <= mk.window) &&
                      kv_row == nullptr;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        float p = 0.0f;
        if (full || mk.ok(qpos[i], kv0 + n * 8 + 2 * tig + e % 2, kv_row))
          p = __expf(s[n][e] * a.scale - lse_r[i]);
        s[n][e] = p * (dp[n][e] - delta_r[i]) * a.scale;
      }
    }

    // dQ += dS K, dS rounded to K's type: score tiles 2j and 2j+1 are the
    // A fragment of k-step j (keys j*16 .. j*16+15); K is read down its
    // columns (ldmatrix.trans).
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      uint32_t sf[4] = {Mma<T>::pack(s[2 * j][0], s[2 * j][1]),
                        Mma<T>::pack(s[2 * j][2], s[2 * j][3]),
                        Mma<T>::pack(s[2 * j + 1][0], s[2 * j + 1][1]),
                        Mma<T>::pack(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NO / 2; ++n) {
        uint32_t kf[4];  // B fragments of dQ n-tiles 2n and 2n+1
        ldsm_x4_t(kf, Kt + (j * 16 + lane % 8 + (lane / 8) % 2 * 8) * LD +
                          n * 16 + lane / 16 * 8);
        Mma<T>::mma(acc[2 * n], sf, kf);
        Mma<T>::mma(acc[2 * n + 1], sf, kf + 2);
      }
    }
    __syncthreads();  // this stage is refilled by the next prefetch
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = q0 + r0 + 8 * i;
    T* out = a.dq + ((static_cast<long long>(b) * a.Sq + row) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * tig) =
          Mma<T>::pack(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_mma(const BwdArgs<T> a, const Masks mk) {
  constexpr int LD = MmaBwdSmem<T, D>::LD;
  constexpr int NS = BQ / 8;  // score n-tiles: queries of a q tile
  constexpr int NO = D / 8;   // dK / dV n-tiles
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + 64 * LD;
  T* Qs = Vs + 64 * LD;    // two stages
  T* dOs = Qs + 128 * LD;  // two stages
  float* Ls = reinterpret_cast<float*>(dOs + 128 * LD);  // two stages
  float* Ds = Ls + 2 * BQ;                               // two stages

  const int ikv = blockIdx.x;  // low kv tiles have the longest causal loops
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const long long kv0 = static_cast<long long>(ikv) * BKV;
  const long long q_shift = a.Sk - a.Sq;
  const uint8_t* kv_row =
      mk.kv_mask ? mk.kv_mask + static_cast<long long>(b) * a.Sk : nullptr;
  long long q_begin, q_end;
  q_range(kv0, a.Sq / BQ, q_shift, mk, &q_begin, &q_end);

  const Strides& st = a.st;
  const T* qb = a.q + b * st.q_sb + h * D;
  const T* dob = a.dout + b * st.do_sb + h * D;
  const long long row_base = (static_cast<long long>(b) * a.H + h) * a.Sq;
  // Q, dO, LSE and delta rows of q tile t into stage `stage`.
  auto load_q_tile = [&](int stage, long long t) {
    copy_tile<T, D, LD>(Qs + stage * 64 * LD, qb + t * BQ * st.q_ss, st.q_ss);
    copy_tile<T, D, LD>(dOs + stage * 64 * LD, dob + t * BQ * st.do_ss,
                        st.do_ss);
    if (threadIdx.x < 2 * BQ / 4) {  // 16 chunks of 4 floats each
      const int c = threadIdx.x % (BQ / 4) * 4;
      const float* src = threadIdx.x < BQ / 4 ? a.lse : a.delta;
      float* dst = threadIdx.x < BQ / 4 ? Ls : Ds;
      cp_async16(dst + stage * BQ + c, src + row_base + t * BQ + c);
    }
  };
  copy_tile<T, D, LD>(Ks, a.k + b * st.k_sb + kv0 * st.k_ss + h * D, st.k_ss);
  copy_tile<T, D, LD>(Vs, a.v + b * st.v_sb + kv0 * st.v_ss + h * D, st.v_ss);
  cp_async_commit();
  if (q_begin < q_end) load_q_tile(0, q_begin);
  cp_async_commit();

  // This thread's two key rows of the warp's 16: r0 and r0 + 8.
  const int r0 = warp * ROWS + g;
  const long long kpos[2] = {kv0 + r0, kv0 + r0 + 8};
  const bool kv_ok[2] = {kv_row == nullptr || kv_row[kpos[0]] != 0,
                         kv_row == nullptr || kv_row[kpos[1]] != 0};
  const long long kw_lo = kv0 + warp * ROWS;  // the warp's first key
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  for (long long t = q_begin; t < q_end; ++t) {
    const int stage = static_cast<int>(t - q_begin) & 1;
    const T* Qt = Qs + stage * 64 * LD;
    const T* dOt = dOs + stage * 64 * LD;
    const float* Lt = Ls + stage * BQ;
    const float* Dt = Ds + stage * BQ;
    if (t + 1 < q_end) {  // prefetch the next tile into the other stage
      load_q_tile(stage ^ 1, t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: rows are this warp's 16 keys, n-tile
    // n covers queries n*8 .. n*8+7 of the tile.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      uint32_t kf[2][4], vf[2][4];  // A fragments of k-steps 2kk, 2kk+1
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int off = (warp * ROWS + lane % 16) * LD + (2 * kk + u) * 16 +
                        lane / 16 * 8;
        ldsm_x4(kf[u], Ks + off);
        ldsm_x4(vf[u], Vs + off);
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        uint32_t qf[4], df[4];  // B fragments of the two k-steps
        const int off = (n * 8 + lane % 8) * LD + kk * 32 + lane / 8 * 8;
        ldsm_x4(qf, Qt + off);
        ldsm_x4(df, dOt + off);
        Mma<T>::mma(s[n], kf[0], qf);
        Mma<T>::mma(s[n], kf[1], qf + 2);
        Mma<T>::mma(dp[n], vf[0], df);
        Mma<T>::mma(dp[n], vf[1], df + 2);
      }
    }

    // P^T into s and dS^T into dp; element e of n-tile n is key row e / 2,
    // query n*8 + 2*tig + e % 2.
    const long long q_lo = t * BQ + q_shift;  // the tile's first position
    const bool full = (!mk.causal || q_lo >= kw_lo + ROWS - 1) &&
                      (!mk.has_window || q_lo + BQ - 1 - kw_lo <= mk.window) &&
                      kv_row == nullptr;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const int c = n * 8 + 2 * tig + e % 2;
        float p = 0.0f;
        if (full || (kv_ok[i] && mk.pos_ok(q_lo + c, kpos[i])))
          p = __expf(s[n][e] * a.scale - Lt[c]);
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - Dt[c]) * a.scale;
      }
    }

    // dV += P^T dO (P rounded to dO's type) and dK += dS^T Q (dS rounded to
    // Q's type); dO and Q are read down their columns (ldmatrix.trans).
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      const uint32_t pf[4] = {Mma<T>::pack(s[2 * j][0], s[2 * j][1]),
                              Mma<T>::pack(s[2 * j][2], s[2 * j][3]),
                              Mma<T>::pack(s[2 * j + 1][0], s[2 * j + 1][1]),
                              Mma<T>::pack(s[2 * j + 1][2], s[2 * j + 1][3])};
      const uint32_t sf[4] = {
          Mma<T>::pack(dp[2 * j][0], dp[2 * j][1]),
          Mma<T>::pack(dp[2 * j][2], dp[2 * j][3]),
          Mma<T>::pack(dp[2 * j + 1][0], dp[2 * j + 1][1]),
          Mma<T>::pack(dp[2 * j + 1][2], dp[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < NO / 2; ++n) {
        const int off = (j * 16 + lane % 8 + (lane / 8) % 2 * 8) * LD +
                        n * 16 + lane / 16 * 8;
        uint32_t df[4], qf[4];  // B fragments of n-tiles 2n and 2n+1
        ldsm_x4_t(df, dOt + off);
        Mma<T>::mma(dv[2 * n], pf, df);
        Mma<T>::mma(dv[2 * n + 1], pf, df + 2);
        ldsm_x4_t(qf, Qt + off);
        Mma<T>::mma(dk[2 * n], sf, qf);
        Mma<T>::mma(dk[2 * n + 1], sf, qf + 2);
      }
    }
    __syncthreads();  // this stage is refilled by the next prefetch
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long off =
        ((static_cast<long long>(b) * a.Sk + kpos[i]) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<uint32_t*>(a.dk + off + n * 8 + 2 * tig) =
          Mma<T>::pack(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(a.dv + off + n * 8 + 2 * tig) =
          Mma<T>::pack(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------------ float32

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

struct RawArgs {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, Sq, Sk;
  Strides st;
  float scale;
};

template <typename T>
BwdArgs<T> typed(const RawArgs& r) {
  return BwdArgs<T>{static_cast<const T*>(r.q), static_cast<const T*>(r.k),
                    static_cast<const T*>(r.v), static_cast<const T*>(r.dout),
                    static_cast<const float*>(r.lse),
                    static_cast<const float*>(r.delta), static_cast<T*>(r.dq),
                    static_cast<T*>(r.dk), static_cast<T*>(r.dv), r.H, r.Sq,
                    r.Sk, r.st, r.scale};
}

// dkv = 0: flash_bwd_dq over (Sq / 64, H, B); dkv = 1: flash_bwd_dkv over
// (Sk / 64, H, B).
template <typename T, int D>
int launch(int dkv, const RawArgs& r, const Masks& mk, cudaStream_t s) {
  const BwdArgs<T> a = typed<T>(r);
  const dim3 grid(dkv ? r.Sk / BKV : r.Sq / BQ, r.H, r.B);
  if constexpr (sizeof(T) == sizeof(float)) {
    using L = F32BwdSmem<D>;
    return dkv ? launch_kernel<flash_bwd_dkv_f32<D>>(L::dkv_bytes, grid, s,
                                                     a, mk)
               : launch_kernel<flash_bwd_dq_f32<D>>(L::dq_bytes, grid, s, a,
                                                    mk);
  } else {
    using L = MmaBwdSmem<T, D>;
    return dkv ? launch_kernel<flash_bwd_dkv_mma<T, D>>(L::dkv_bytes, grid,
                                                        s, a, mk)
               : launch_kernel<flash_bwd_dq_mma<T, D>>(L::dq_bytes, grid, s,
                                                       a, mk);
  }
}

int dispatch(int dkv, int dtype, int D, const RawArgs& r, const Masks& mk,
             cudaStream_t s) {
  if (r.Sq % BQ != 0 || r.Sk % BKV != 0 || r.B < 1 || r.H < 1 || r.Sq < 1 ||
      r.Sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 64) return launch<float, 64>(dkv, r, mk, s);
  if (dtype == 0 && D == 128) return launch<float, 128>(dkv, r, mk, s);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(dkv, r, mk, s);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(dkv, r, mk, s);
  if (dtype == 2 && D == 64) return launch<__half, 64>(dkv, r, mk, s);
  if (dtype == 2 && D == 128) return launch<__half, 128>(dkv, r, mk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; D: 64 or 128.  q/k/v/dout
// are BSHD with a contiguous [H, D] inner block, 16-byte aligned rows and
// the given batch and sequence strides (in elements); lse and delta are
// [B, H, Sq] f32; dq, dk, dv are contiguous BSHD in the input type (the
// entry writes only its own: dq, or dk and dv); kv_mask is null or [B, Sk]
// bytes (nonzero = attend).  Sq and Sk are multiples of 64.  Each entry
// launches one kernel on `stream`, allocates nothing, and returns the
// launch's cudaError_t (0 on success).
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
