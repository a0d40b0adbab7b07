// Shared by every kernel library of paddle_tpu_torch (each csrc/*.cu builds
// into its own shared library, see ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// One tile of single-query decode attention for the `group` (at most
// kMaxGroup) query heads that share one kv head (paged_decode.cu: a page;
// decode_mha.cu: 64 cache rows), folded into their fp32 online softmax (m,
// l, acc). k and v point at column 0 of the tile's first token; token t's
// row is t * k_stride (v: v_stride) further on, and `valid` tokens are
// live. Rows hold d <= D live columns: the tile is instantiated at D = 32,
// 64 or 128 and a narrower head masks its lanes past d (no padded copy of
// the cache). Each K row is loaded once for the whole group: warp w takes
// tokens w, w + kWarps, ... (lanes across D, kPerLane = D / 32 columns
// each) and leaves the group's scores in s_sm [group][s_cap]; then thread
// c < d streams column c of V and keeps column c of each head's
// accumulator. Values are scaled by kq / vq after
// the load (int8 pools; 1 otherwise). A score is q.k * scale, then
// soft_cap * tanh(score / soft_cap) where soft_cap > 0 (the stock TPU
// paged-attention kernel's attn_logits_soft_cap; 0 turns it off). Both
// barriers are inside, so every thread of the block must call it.
template <typename T, int D, int kMaxGroup, int kThreads>
__device__ __forceinline__ void decode_tile(
    const T* __restrict__ k, const T* __restrict__ v, long long k_stride,
    long long v_stride, int valid, int d, float kq, float vq,
    float (&qv)[kMaxGroup][D / 32], int group, float scale, float soft_cap,
    float* s_sm, int s_cap, float (&m)[kMaxGroup], float (&l)[kMaxGroup],
    float (&acc)[kMaxGroup]) {
  constexpr int kPerLane = D / 32;
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int t = warp; t < valid; t += kWarps) {
    const T* krow = k + t * k_stride + lane * kPerLane;
    float kx[kPerLane];
#pragma unroll
    for (int e = 0; e < kPerLane; ++e)
      kx[e] = lane * kPerLane + e < d ? to_float(krow[e]) * kq : 0.f;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) {  // uniform across the warp
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) dot = fmaf(qv[g][e], kx[e], dot);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (lane == 0) {
          float sc = dot * scale;
          if (soft_cap > 0.f) sc = soft_cap * tanhf(sc / soft_cap);
          s_sm[g * s_cap + t] = sc;
        }
      }
    }
  }
  __syncthreads();

  if (tid < d) {  // one thread per output column
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < group) {
        float mx = m[g];
        for (int t = 0; t < valid; ++t) mx = fmaxf(mx, s_sm[g * s_cap + t]);
        const float alpha = expf(m[g] - mx);
        acc[g] *= alpha;
        l[g] *= alpha;
        m[g] = mx;
      }
    }
    const T* vcol = v + tid;
    for (int t = 0; t < valid; ++t) {
      const float vv = to_float(vcol[t * v_stride]) * vq;
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          const float pr = expf(s_sm[g * s_cap + t] - m[g]);
          l[g] += pr;
          acc[g] = fmaf(pr, vv, acc[g]);
        }
      }
    }
  }
  __syncthreads();  // the next tile overwrites the scores
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
