// Shared by every kernel library of paddle_tpu_torch (each csrc/*.cu builds
// into its own shared library, see ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The wrappers raise with this text when an entry point returns an error.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace ptt {

constexpr float kNeg = -1e30f;  // large-negative mask value: no inf - inf NaNs

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

// Rows [r0, r0 + kRows) of a [*, D] bf16 operand (row stride in elements,
// unit stride on D, 16-byte aligned rows) into shared memory, zero past
// `limit`, by kThreads threads. stage_transposed writes dst [D][kRows]:
// consecutive threads take consecutive rows of one 16-byte chunk, so the
// shared-memory stores do not conflict. stage_rows writes dst [kRows][D].
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void stage_transposed(__nv_bfloat16* dst,
                                                 const __nv_bfloat16* src,
                                                 long long row_stride, int r0,
                                                 int limit) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c % kRows, ch = c / kRows;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride +
                                            ch * 8);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(ch * 8 + i) * kRows + r] = e[i];
  }
}

template <int D, int kRows, int kThreads>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long row_stride, int r0,
                                           int limit) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * row_stride +
                                            ch * 8);
    *reinterpret_cast<uint4*>(dst + r * D + ch * 8) = val;
  }
}

// Attention dropout: the counter hash of
// paddle_tpu/ops/flash_attention_kernel.py::_mix/_keep_mask (a murmur3
// finalizer), bit for bit, so every kernel and every plain version drops the
// same (batch, query head, q, k) entries at the same seed.
__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

struct Dropout {
  uint32_t seed;    // the caller's seed as uint32
  uint32_t thresh;  // keep iff bits >= thresh: min(int(p 2^32), 2^32 - 1)
  float scale;      // 1 / (1 - p)
  int on;           // p > 0

  // per (batch, query head) part of the hash
  __device__ __forceinline__ uint32_t head_key(int b, int h) const {
    return mix(seed ^ (static_cast<uint32_t>(b) * 0x9E3779B9u) ^
               (static_cast<uint32_t>(h) * 0x85EBCA77u));
  }
  __device__ __forceinline__ bool keep(uint32_t hk, int q, int k) const {
    return mix(mix(static_cast<uint32_t>(q) + hk) ^
               static_cast<uint32_t>(k)) >= thresh;
  }
};

}  // namespace ptt
