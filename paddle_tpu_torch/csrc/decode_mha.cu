// K7: decode attention over a dense KV cache for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas_kernels.py::decode_mha (_decode_kernel,
// launched through pl.pallas_call in _decode_mha_jit at
// pallas_kernels.py:368), and the grouped einsum of
// paddle_tpu/ops/_decode.py::gqa_decode_attention that the TPU package used
// for GQA because its kernel was MHA-only.
//
// One decode step: for each row b and query head h,
//   out[b, h] = softmax(q[b, h] . K[b, :len]^T / sqrt(D)) V[b, :len]
// with len = min(seq_lens[b], S), over caches [B, S, Hkv, D] read through
// their strides (unit stride on D). Query head h reads kv head h / (Hq /
// Hkv). fp32 softmax and accumulation, one rounding to the output type at
// the end; a row with length 0 returns zeros (the divide is guarded as the
// TPU kernel's max(l, 1e-30)). bf16, fp16 or fp32 inputs, any D <= 128
// (instances at widths 32, 64 and 128 mask the columns past D), any GQA
// group (a block takes at most 8 query heads of a group; larger groups are
// split over blocks, each loading the K/V rows once for its heads).
//
// What bounds it: each live token's K and V row is read once for 4 * D
// flops per query head of its group, about one flop per byte in bf16, so
// memory bandwidth bounds it: the bytes are the live tokens' K and V (cache
// rows past a row's length are never read), q and the output.
//
// Design: the TPU grid (B, S-blocks) runs in order and carries the online
// softmax across the S axis in VMEM. Here each row's cache is split over
// blocks instead (flash-decoding, ptt::decode_split in common.cuh, shared
// with paged_decode.cu): block (kv head x group part, row, split) walks its
// split of `split` tokens in 64-token tiles (32 in fp32) with an fp32
// online softmax, the next tile's K and V prefetched by cp.async, and
// leaves (m, l, acc) for its query heads; decode_mha_combine_kernel
// (ptt::decode_combine) merges the splits in split order, or, with one
// split, the block writes the output itself. The wrapper sizes the split
// from the shapes alone (the cache's capacity S, never the lengths) so
// that the grid covers the SMs several times over. Blocks whose split
// starts past a row's length return at once. No atomics: two launches give
// bitwise-equal outputs. This file only says where a token's K and V rows
// are.
#include "common.cuh"

namespace {

struct CacheStrides {
  long long b, s, h;  // elements; D has unit stride
};

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const int* lens;
  T* out;
  int hq, hkv, d, s_max, split;
  CacheStrides ks, vs;
  float scale;
  bool vec;  // every cache row 16-byte aligned
  float* part_acc;
  float* part_m;
  float* part_l;
};

// Token t of one (row, kv head): its rows are t cache rows on.
template <typename T>
struct CacheRows {
  const T* k;
  const T* v;
  long long k_stride, v_stride;
  __device__ __forceinline__ ptt::KVRow<T> row(int t) const {
    return {k + t * k_stride, v + t * v_stride};
  }
  __device__ __forceinline__ void scales(int, float&, float&) const {}
};

// Width D is the instance (32, 64 or 128), d <= D the head dim; kG the
// query heads a block holds at most (1, 4 or 8).
template <typename T, int D, int kG>
__global__ void __launch_bounds__(ptt::kDecodeThreads)
decode_mha_kernel(const Params<T> p) {
  const ptt::DecodeBlock blk = ptt::decode_block(p.hq, p.hkv);
  const int len = max(0, min(p.lens[blk.b], p.s_max));
  const CacheRows<T> src{p.k + blk.b * p.ks.b + blk.hk * p.ks.h,
                         p.v + blk.b * p.vs.b + blk.hk * p.vs.h, p.ks.s,
                         p.vs.s};
  ptt::decode_split<T, T, D, kG, false>(src, blk, p.q, p.out, p.d, len,
                                        p.split, p.scale, 0.f, p.vec,
                                        p.part_acc, p.part_m, p.part_l);
}

template <typename T>
__global__ void __launch_bounds__(ptt::kDecodeThreads)
decode_mha_combine_kernel(const float* part_acc, const float* part_m,
                          const float* part_l, const int* lens, T* out,
                          int hq, int d, int s_max, int split) {
  ptt::decode_combine(part_acc, part_m, part_l, lens, out, hq, d, s_max,
                      split);
}

template <typename T, int D, int kG>
cudaError_t launch(const Params<T>& p, int batch, cudaStream_t stream) {
  const int group = p.hq / p.hkv;
  const dim3 grid(p.hkv * ((group + ptt::kMaxDecodeGroup - 1) /
                           ptt::kMaxDecodeGroup),
                  batch, ptt::decode_splits(p.s_max, p.split));
  return ptt::launch_split_decode(
      decode_mha_kernel<T, D, kG>, decode_mha_combine_kernel<T>,
      ptt::DecodeShape<T, D, kG>::kSmem, grid, stream, p.part_acc, p.part_m,
      p.part_l, p.lens, p.out, p.hq, p.d, p.s_max, p.split, p);
}

template <typename T, int D>
cudaError_t launch_width(const Params<T>& p, int batch, cudaStream_t st) {
  const int heads = min(p.hq / p.hkv, ptt::kMaxDecodeGroup);
  if (heads == 1) return launch<T, D, 1>(p, batch, st);
  if (heads <= 4) return launch<T, D, 4>(p, batch, st);
  return launch<T, D, 8>(p, batch, st);
}

template <typename T>
int dispatch(const void* q, const void* kc, const void* vc, const void* lens,
             void* out, int batch, int hq, int hkv, int d, int s_max,
             long long ksb, long long kss, long long ksh, long long vsb,
             long long vss, long long vsh, float scale, int split,
             void* part_acc, void* part_m, void* part_l, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || d <= 0 || split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr long long kAlign = 16 / sizeof(T);  // elements in 16 bytes
  const bool vec = ptt::aligned16(kc) && ptt::aligned16(vc) &&
                   ksb % kAlign == 0 && kss % kAlign == 0 &&
                   ksh % kAlign == 0 && vsb % kAlign == 0 &&
                   vss % kAlign == 0 && vsh % kAlign == 0;
  const Params<T> p{static_cast<const T*>(q),
                    static_cast<const T*>(kc),
                    static_cast<const T*>(vc),
                    static_cast<const int*>(lens),
                    static_cast<T*>(out),
                    hq,
                    hkv,
                    d,
                    s_max,
                    split,
                    {ksb, kss, ksh},
                    {vsb, vss, vsh},
                    scale,
                    vec,
                    static_cast<float*>(part_acc),
                    static_cast<float*>(part_m),
                    static_cast<float*>(part_l)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32) return launch_width<T, 32>(p, batch, st);
  if (d <= 64) return launch_width<T, 64>(p, batch, st);
  if (d <= 128) return launch_width<T, 128>(p, batch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, Hq, D] and out [B, Hq, D] contiguous; k/v caches [B, S, Hkv, D]
// with the given element strides of B, S and Hkv (unit stride on D);
// lens [B] int32. split: tokens a block takes (a multiple of 64); with
// more than one split of S, part_acc [splits, B, Hq, D] and part_m,
// part_l [splits, B, Hq] are fp32 workspace (unused, may be null, with
// one). Returns cudaGetLastError() after the launches.
#define DECODE_MHA_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* q, const void* k_cache,                   \
                      const void* v_cache, const void* lens, void* out,     \
                      int batch, int hq, int hkv, int d, int s_max,         \
                      long long ksb, long long kss, long long ksh,          \
                      long long vsb, long long vss, long long vsh,          \
                      float scale, int split, void* part_acc, void* part_m, \
                      void* part_l, void* stream) {                         \
    return dispatch<T>(q, k_cache, v_cache, lens, out, batch, hq, hkv, d,   \
                       s_max, ksb, kss, ksh, vsb, vss, vsh, scale, split,   \
                       part_acc, part_m, part_l, stream);                   \
  }

DECODE_MHA_ENTRY(decode_mha_bf16, __nv_bfloat16)
DECODE_MHA_ENTRY(decode_mha_f16, __half)
DECODE_MHA_ENTRY(decode_mha_f32, float)
