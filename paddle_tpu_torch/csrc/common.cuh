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
template <>
__device__ __forceinline__ int8_t from_float<int8_t>(float x) {
  return static_cast<int8_t>(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes < 16
// reads that many and fills the rest with zeros (0 reads nothing, but src
// must still be a valid address). src and dst are 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -- Split decode attention: K7 (decode_mha.cu) and K4 (paged_decode.cu) ----
//
// One decode step, out[b, h] = softmax(score(q[b, h], K[b, :len])) V[b,
// :len], as flash-decoding: each row's context is cut into splits of `split`
// tokens (a size the wrapper derives from the shapes alone, so the grid
// never depends on the lengths), and one block takes one split of one (row,
// kv head) for at most kMaxDecodeGroup query heads of that kv head's group,
// walking the split in tiles of DecodeShape::kTile tokens with an fp32
// online softmax. It leaves, for each of its heads, the split's running max
// m, its sum l = sum exp(s - m) and acc = sum exp(s - m) v, unnormalized.
// With one split the block writes acc / max(l, 1e-30) itself; otherwise a
// second kernel (decode_combine) merges the splits. A block whose split
// starts at or past the row's length returns at once and writes nothing,
// and the combine reads only the ceil(len / split) partials that exist.
//
// Per tile, inside a block of kDecodeThreads threads:
//  1. loads: the tile's K and V rows go to shared memory as 16-byte cp.async
//     copies (zero past d), and the next tile's are issued before this one
//     is computed (two stages). A row is found through Src: Src::row(t)
//     gives token t's K and V rows (K7: cache strides; K4: page table and
//     pool strides) and, for int8 pools, Src::scales(t) their scales. Where
//     the rows are not 16-byte aligned the copies go element by element.
//  2. scores: kDecodeThreads / kTile threads a token, each over a part of
//     D, q from shared memory (fp32, zero past d); a shuffle adds the parts.
//  3. softmax: warp w takes heads w, w + 4, ..: the tile's max by a warp
//     reduction, then p = exp(s - m_new), computed once per (token, head)
//     and kept in shared memory (times the V scale for int8 pools), and l.
//  4. P.V: thread (token group, 8-column group) keeps its 8 columns of each
//     head's acc in registers, rescaled by exp(m_old - m_new) per tile, over
//     every kTG-th token of the tile.
// At the end of the split the token groups' sums are added by shuffles in a
// warp and through shared memory across the warps, in a fixed order: no
// atomics anywhere, so two launches give bitwise-equal results.

constexpr int kDecodeThreads = 128;
constexpr int kMaxDecodeGroup = 8;  // query heads a block takes at most

// Shared-memory layout of a split-decode block for K/V of type T, tile
// width D (a head dim d <= D is masked) and kG query heads.
template <typename T, int D, int kG>
struct DecodeShape {
  static constexpr int kTile = sizeof(T) == 4 ? 32 : 64;   // tokens a stage
  // bytes a row in shared memory: an odd multiple of 16, so 8 threads
  // reading 16 bytes each from 8 rows hit 8 different bank quads
  static constexpr int kPitch = D * static_cast<int>(sizeof(T)) + 16;
  static constexpr int kStage = 2 * kTile * kPitch;         // K and V
  static constexpr int kFloats = kG * D + kG * kTile + kTile + 3 * kG;
  static constexpr int kSmem = 2 * kStage + 4 * kFloats;
  static_assert((kPitch / 16) % 2 == 1, "row pitch");
  static_assert(4 * (kDecodeThreads / 32) * kG * D <= 2 * kStage,
                "the final reduction reuses the stages");
  static_assert(kSmem <= 232448, "more than a block's shared memory");
};

template <typename T>
struct KVRow {
  const T* k;
  const T* v;
};

// 16 bytes of shared memory as 16 / sizeof(T) floats.
__device__ __forceinline__ void chunk_to_float(const unsigned char* p,
                                               float (&out)[8],
                                               __nv_bfloat16) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void chunk_to_float(const unsigned char* p,
                                               float (&out)[8], __half) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void chunk_to_float(const unsigned char* p,
                                               float (&out)[4], float) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}
__device__ __forceinline__ void chunk_to_float(const unsigned char* p,
                                               float (&out)[16], int8_t) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(c[i]);
}

// 8 elements of type T from shared memory (8 * sizeof(T)-byte aligned) as
// floats.
template <typename T>
__device__ __forceinline__ void eight_to_float(const unsigned char* p,
                                               float (&out)[8]) {
  if constexpr (sizeof(T) == 4) {
    float a[4], b[4];
    chunk_to_float(p, a, T{});
    chunk_to_float(p + 16, b, T{});
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[i] = a[i];
      out[4 + i] = b[i];
    }
  } else if constexpr (sizeof(T) == 1) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(c[i]);
  } else {
    chunk_to_float(p, out, T{});
  }
}

template <int kW>
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = kW / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
// A butterfly: every lane ends with the same sum, in the same order.
template <int kW>
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kW / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Which (row, kv head, query heads) block (blockIdx.x, blockIdx.y) takes:
// blockIdx.x = hk * parts + part, parts = ceil(group / 8); part p holds
// query heads hk * group + 8 p .. of kv head hk, ng of them. h0 is the
// first of them as a flat (row, head) index.
struct DecodeBlock {
  int b, hk, ng, hq;
  long long h0;
};
__device__ __forceinline__ DecodeBlock decode_block(int hq, int hkv) {
  const int group = hq / hkv;
  const int parts = (group + kMaxDecodeGroup - 1) / kMaxDecodeGroup;
  const int hk = blockIdx.x / parts;
  const int g0 = (blockIdx.x % parts) * kMaxDecodeGroup;
  DecodeBlock blk;
  blk.b = blockIdx.y;
  blk.hk = hk;
  blk.ng = min(kMaxDecodeGroup, group - g0);
  blk.hq = hq;
  blk.h0 = static_cast<long long>(blockIdx.y) * hq + hk * group + g0;
  return blk;
}

// Split blockIdx.z of block blk (see above). q and out are [B, Hq, d] in
// Tq; the partials acc [splits, B, Hq, d] and m, l [splits, B, Hq] (fp32,
// unused with one split). Scores are q.k * scale, then soft_cap *
// tanh(score / soft_cap) where soft_cap > 0. len is the row's length
// clipped to the cache. vec: every K and V row Src gives is 16-byte
// aligned. Every thread of the block must call it.
template <typename Tq, typename T, int D, int kG, bool kQuant, class Src>
__device__ __forceinline__ void decode_split(
    const Src& src, const DecodeBlock& blk, const Tq* __restrict__ q,
    Tq* __restrict__ out, int d, int len, int split, float scale,
    float soft_cap, bool vec, float* __restrict__ part_acc,
    float* __restrict__ part_m, float* __restrict__ part_l) {
  using S = DecodeShape<T, D, kG>;
  constexpr int kTile = S::kTile, kPitch = S::kPitch;
  constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;  // a row
  constexpr int kEl = 16 / static_cast<int>(sizeof(T));  // a chunk
  constexpr int kTPT = kDecodeThreads / kTile;  // score threads a token
  constexpr int kTokWarp = 32 / kTPT;           // tokens a warp scores
  constexpr int kPartChunks = kChunks / kTPT;   // chunks a score thread
  constexpr int kCG = D / 8;                    // P.V column groups
  constexpr int kTG = kDecodeThreads / kCG;     // P.V token groups
  constexpr int kWarps = kDecodeThreads / 32;
  // unrolled fully, two fp32 instances at D = 128 spilled (ptxas -v)
  constexpr int kScoreUnroll = sizeof(T) == 4 ? 2 : kPartChunks;
  static_assert(kChunks % kTPT == 0 && kEl % 4 == 0 && kCG <= 32,
                "tile shape");
  extern __shared__ __align__(16) unsigned char decode_smem[];
  unsigned char* stages = decode_smem;  // [2][K, V][kTile][kPitch]
  float* q_sm = reinterpret_cast<float*>(decode_smem + 2 * S::kStage);
  float* p_sm = q_sm + kG * D;          // [kG][kTile] scores, then p
  float* vq_sm = p_sm + kG * kTile;     // [kTile] V scales (int8 pools)
  float* m_sm = vq_sm + kTile;          // [kG] running max
  float* l_sm = m_sm + kG;              // [kG] running sum
  float* a_sm = l_sm + kG;              // [kG] this tile's rescale
  float* red = reinterpret_cast<float*>(decode_smem);  // [kWarps][kG][D]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ng = blk.ng;
  const int t_begin = blockIdx.z * split;
  if (gridDim.z > 1 && t_begin >= len) return;  // an empty split
  const int t_end = min(len, t_begin + split);
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + kTile - 1) / kTile
                                      : 0;

  q += blk.h0 * d;
  for (int i = tid; i < kG * D; i += kDecodeThreads) {
    const int g = i / D, c = i % D;
    q_sm[i] = g < ng && c < d ? to_float(q[g * d + c]) : 0.f;
  }
  if (tid < kG) {
    m_sm[tid] = kNeg;
    l_sm[tid] = 0.f;
    a_sm[tid] = 1.f;
  }

  // tokens t0 .. t0 + valid - 1 into stage st
  const int row_bytes = d * static_cast<int>(sizeof(T));
  auto load = [&](int t0, int valid, int st) {
    unsigned char* ks = stages + st * S::kStage;
    unsigned char* vs = ks + kTile * kPitch;
    if (vec) {
      for (int i = tid; i < kTile * kChunks; i += kDecodeThreads) {
        const int r = i / kChunks, c = i % kChunks;
        if (r >= valid) break;
        const KVRow<T> row = src.row(t0 + r);
        const int nb = min(16, max(0, row_bytes - c * 16));
        const int off = nb > 0 ? c * 16 : 0;
        cp_async16(ks + r * kPitch + c * 16,
                   reinterpret_cast<const unsigned char*>(row.k) + off, nb);
        cp_async16(vs + r * kPitch + c * 16,
                   reinterpret_cast<const unsigned char*>(row.v) + off, nb);
      }
    } else {
      for (int i = tid; i < kTile * D; i += kDecodeThreads) {
        const int r = i / D, c = i % D;
        if (r >= valid) break;
        const KVRow<T> row = src.row(t0 + r);
        reinterpret_cast<T*>(ks + r * kPitch)[c] =
            c < d ? row.k[c] : from_float<T>(0.f);
        reinterpret_cast<T*>(vs + r * kPitch)[c] =
            c < d ? row.v[c] : from_float<T>(0.f);
      }
    }
  };

  if (n_tiles > 0) load(t_begin, min(kTile, t_end - t_begin), 0);
  cp_async_commit();
  __syncthreads();  // q_sm, m_sm, l_sm

  const int cg = tid % kCG, tg = tid / kCG;
  float acc[kG][8];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * kTile;
    const int valid = min(kTile, t_end - t0);
    if (it + 1 < n_tiles)
      load(t0 + kTile, min(kTile, t_end - t0 - kTile), (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile it is in shared memory
    const unsigned char* ks = stages + (it & 1) * S::kStage;
    const unsigned char* vs = ks + kTile * kPitch;

    {  // 2. scores
      const int tt = warp * kTokWarp + lane % kTokWarp;
      const int part = lane / kTokWarp;
      float dot[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) dot[g] = 0.f;
      if (tt < valid) {
        const unsigned char* krow = ks + tt * kPitch + part * kPartChunks * 16;
#pragma unroll(kScoreUnroll)
        for (int j = 0; j < kPartChunks; ++j) {
          float kx[kEl];
          chunk_to_float(krow + j * 16, kx, T{});
          const int c0 = (part * kPartChunks + j) * kEl;
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (g < ng) {
              const float4* qp =
                  reinterpret_cast<const float4*>(q_sm + g * D + c0);
#pragma unroll
              for (int e = 0; e < kEl / 4; ++e) {
                const float4 qq = qp[e];
                dot[g] = fmaf(qq.x, kx[4 * e], dot[g]);
                dot[g] = fmaf(qq.y, kx[4 * e + 1], dot[g]);
                dot[g] = fmaf(qq.z, kx[4 * e + 2], dot[g]);
                dot[g] = fmaf(qq.w, kx[4 * e + 3], dot[g]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int off = kTokWarp; off < 32; off <<= 1)
#pragma unroll
        for (int g = 0; g < kG; ++g)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
      if (part == 0) {
        float kq = 1.f, vq = 1.f;
        if (kQuant && tt < valid) src.scales(t0 + tt, kq, vq);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          float sc = dot[g] * kq * scale;
          if (soft_cap > 0.f) sc = soft_cap * tanhf(sc / soft_cap);
          p_sm[g * kTile + tt] = sc;
        }
        if (kQuant) vq_sm[tt] = vq;
      }
    }
    __syncthreads();

    // 3. softmax: the tile's max, p once per (token, head), l
    for (int g = warp; g < ng; g += kWarps) {
      float* pg = p_sm + g * kTile;
      float mx = kNeg;
      for (int t = lane; t < valid; t += 32) mx = fmaxf(mx, pg[t]);
      mx = warp_max<32>(mx);
      const float m_old = m_sm[g], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < valid; t += 32) {
        const float pr = expf(pg[t] - m_new);
        sum += pr;
        pg[t] = kQuant ? pr * vq_sm[t] : pr;
      }
      sum = warp_sum<32>(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_sm[g] = alpha;
        l_sm[g] = l_sm[g] * alpha + sum;
        m_sm[g] = m_new;
      }
    }
    __syncthreads();

    // 4. P.V over this thread's tokens and 8 columns
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g < ng) {
        const float alpha = a_sm[g];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] *= alpha;
      }
    }
    for (int t = tg; t < valid; t += kTG) {
      float vx[8];
      eight_to_float<T>(vs + t * kPitch + cg * 8 * sizeof(T), vx);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g < ng) {
          const float pr = p_sm[g * kTile + t];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[g][j] = fmaf(pr, vx[j], acc[g][j]);
        }
      }
    }
    __syncthreads();  // the next tile's loads and scores overwrite these
  }
  cp_async_wait<0>();

  // the token groups of a warp (lanes cg, cg + kCG, ..), then the warps
#pragma unroll
  for (int off = kCG; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], off);
  if (lane < kCG) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
      if (g < ng)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          red[(warp * kG + g) * D + cg * 8 + j] = acc[g][j];
  }
  __syncthreads();
  const bool direct = gridDim.z == 1;
  const long long ph =  // this split's first head among the partials
      static_cast<long long>(blockIdx.z) * gridDim.y * blk.hq + blk.h0;
  for (int i = tid; i < ng * D; i += kDecodeThreads) {
    const int g = i / D, c = i % D;
    if (c >= d) continue;
    float o = red[g * D + c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) o += red[(w * kG + g) * D + c];
    if (direct)
      out[(blk.h0 + g) * d + c] = from_float<Tq>(o / fmaxf(l_sm[g], 1e-30f));
    else
      part_acc[(ph + g) * d + c] = o;
  }
  if (!direct && tid < ng) {
    part_m[ph + tid] = m_sm[tid];
    part_l[ph + tid] = l_sm[tid];
  }
}

// Merges decode_split's partials: warp w of block (x, b) takes query head
// h = 4 x + w of row b, reads the row's ceil(len / split) partials in split
// order, rescales each by exp(m_i - M) (M their max) and writes acc / max(l,
// 1e-30) in Tq. A row of length 0 has no partial and gets zeros. len is
// lens[b] clipped to max_len. Each library wraps it in a kernel of its own
// name (decode_mha_combine_kernel, paged_decode_combine_kernel), so that a
// profile tells the two apart.
template <typename Tq>
__device__ __forceinline__ void decode_combine(
    const float* __restrict__ part_acc, const float* __restrict__ part_m,
    const float* __restrict__ part_l, const int* __restrict__ lens,
    Tq* __restrict__ out, int hq, int d, int max_len, int split) {
  const int lane = threadIdx.x & 31, b = blockIdx.y;
  const int h = blockIdx.x * (kDecodeThreads / 32) + (threadIdx.x >> 5);
  if (h >= hq) return;
  const int len = max(0, min(lens[b], max_len));
  const int n = (len + split - 1) / split;
  const long long per_split = static_cast<long long>(gridDim.y) * hq;
  const long long bh = static_cast<long long>(b) * hq + h;
  float mx = kNeg;
  for (int s = lane; s < n; s += 32)
    mx = fmaxf(mx, part_m[s * per_split + bh]);
  mx = warp_max<32>(mx);
  float l = 0.f;
  for (int s = lane; s < n; s += 32) {
    const long long i = s * per_split + bh;
    l += part_l[i] * expf(part_m[i] - mx);
  }
  l = fmaxf(warp_sum<32>(l), 1e-30f);
  for (int c = lane; c < d; c += 32) {
    float o = 0.f;
    for (int s = 0; s < n; ++s) {
      const long long i = s * per_split + bh;
      o = fmaf(part_acc[i * d + c], expf(part_m[i] - mx), o);
    }
    out[bh * d + c] = from_float<Tq>(o / l);
  }
}

// The combine's signature, for launch_split_decode.
template <typename Tq>
using DecodeCombine = void (*)(const float*, const float*, const float*,
                               const int*, Tq*, int, int, int, int);

// Splits of `split` tokens over a context of max_len: at least one.
__host__ __device__ inline int decode_splits(int max_len, int split) {
  return max_len > split ? (max_len + split - 1) / split : 1;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Launches `kernel` (a split-decode kernel of DecodeShape smem bytes) over
// grid (blocks per row, B, splits) with its arguments, then, for more than
// one split, `combine` (a kernel around decode_combine) over the partials
// into out. Returns the first CUDA error.
template <typename Tq, typename... P, typename... A>
cudaError_t launch_split_decode(void (*kernel)(P...),
                                DecodeCombine<Tq> combine, int smem,
                                dim3 grid, cudaStream_t stream,
                                const float* part_acc,
                                const float* part_m, const float* part_l,
                                const int* lens, Tq* out, int hq, int d,
                                int max_len, int split, A... args) {
  if (grid.z > 1 && !(part_acc && part_m && part_l))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kDecodeThreads, smem, stream>>>(args...);
  e = cudaGetLastError();
  if (e != cudaSuccess || grid.z == 1) return e;
  const dim3 cgrid((hq + kDecodeThreads / 32 - 1) / (kDecodeThreads / 32),
                   grid.y);
  combine<<<cgrid, kDecodeThreads, 0, stream>>>(
      part_acc, part_m, part_l, lens, out, hq, d, max_len, split);
  return cudaGetLastError();
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
