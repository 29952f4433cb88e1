// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the float32 kernels' tile sizes, the (q, k) admission rule, packing to
// bf16 / fp16, tile loads and launches.  ops/_build.py hashes this header
// into every kernel library's name, so an edit here rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                  // query rows of a tile
constexpr int BKV = 64;                 // key rows of a tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;        // rows a warp owns (16)
constexpr float NEG_INF = -1e30f;       // flash.py NEG_INF, not -inf

// The (q, k) admission rule of every kernel.
struct Masks {
  const uint8_t* kv_mask;  // [B, Sk] bytes or null
  int causal, has_window;
  long long window;

  // Causal (q_pos >= k_pos) and window (q_pos - k_pos <= window) only.
  __device__ __forceinline__ bool pos_ok(long long qpos,
                                         long long kpos) const {
    return (!causal || qpos >= kpos) && (!has_window || qpos - kpos <= window);
  }
  __device__ __forceinline__ bool ok(long long qpos, long long kpos,
                                     const uint8_t* kv_row) const {
    return pos_ok(qpos, kpos) && (kv_row == nullptr || kv_row[kpos] != 0);
  }
};

// The kv tiles any row of a q tile starting at position q_lo can admit
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

// Two f32 values rounded to T and packed, lo in the low half.
template <typename T> struct Mma;
template <> struct Mma<__nv_bfloat16> {
  __device__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <> struct Mma<__half> {
  __device__ static uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// Raise the kernel's dynamic shared-memory limit (once), launch it with
// `threads` threads a block on `stream`, and return the launch's
// cudaError_t.
template <auto Kernel, typename... Args>
int launch_kernel_threads(size_t bytes, dim3 grid, int threads,
                          cudaStream_t stream, Args... args) {
  static bool configured = false;  // once per kernel
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  Kernel<<<grid, threads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The same with THREADS threads a block (the float32 kernels).
template <auto Kernel, typename... Args>
int launch_kernel(size_t bytes, dim3 grid, cudaStream_t stream,
                  Args... args) {
  return launch_kernel_threads<Kernel>(bytes, grid, THREADS, stream,
                                       args...);
}

}  // namespace
