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
// (the tile is instantiated at 32, 64 and 128 and masks the lanes past D),
// any GQA group (a block takes at most 8 query heads of a group; larger
// groups are split over blocks, each loading the K/V rows once for its
// heads).
//
// What bounds it: each live token's K and V row is read once for 4 * D
// flops per query head of its group, about one flop per byte in bf16, so
// memory bandwidth bounds it: the bytes are the live tokens' K and V (cache
// rows past a row's length are never read), q and the output.
//
// Design: the TPU grid (B, S-blocks) carries the online softmax across the
// S axis in VMEM scratch and skips blocks past the length. Here one block per
// (kv head, row) walks that row's cache in tiles of 64 tokens up to
// ceil(len / 64), masking the ragged tail, with the online softmax in
// registers (ptt::decode_tile, shared with paged_decode.cu): every K and V
// row is loaded once for all query heads of its GQA group (for the block's
// 8 where a group is larger). No split of a
// long row over several blocks yet: at B = 8 and 32 kv heads that is 256
// blocks on 132 SMs, each walking its tiles one after the other, so the
// kernel is latency-bound far above its bandwidth bound.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGroup = 8;
constexpr int kTile = 64;  // cache rows per online-softmax step

struct CacheStrides {
  long long b, s, h;  // elements; D has unit stride
};

// Width D is the instance (32, 64 or 128), d <= D the head dim; block
// (hk * n_split + part, b) takes query heads hk * group + 8 part .. of kv
// head hk.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_mha_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                  const T* __restrict__ v_cache, const int* __restrict__ lens,
                  T* __restrict__ out, int hq, int hkv, int d, int s_max,
                  CacheStrides ks, CacheStrides vs, float scale) {
  constexpr int kPerLane = D / 32;
  __shared__ float s_sm[kMaxGroup * kTile];  // [group][kTile] scores
  const int group = hq / hkv;
  const int n_split = (group + kMaxGroup - 1) / kMaxGroup;
  const int hk = blockIdx.x / n_split, b = blockIdx.y;
  const int g0 = (blockIdx.x % n_split) * kMaxGroup;
  const int ng = min(kMaxGroup, group - g0);  // this block's query heads
  const int tid = threadIdx.x, lane = tid & 31;
  const int len = max(0, min(lens[b], s_max));
  const long long q_row =
      (static_cast<long long>(b) * hq + hk * group + g0) * d;

  float qv[kMaxGroup][kPerLane];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int c = lane * kPerLane + e;
      qv[g][e] = g < ng && c < d ? ptt::to_float(q[q_row + g * d + c]) : 0.f;
    }

  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    m[g] = ptt::kNeg;
    l[g] = 0.f;
    acc[g] = 0.f;
  }

  const T* kb = k_cache + b * ks.b + hk * ks.h;
  const T* vb = v_cache + b * vs.b + hk * vs.h;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    ptt::decode_tile<T, D, kMaxGroup, kThreads>(
        kb + t0 * ks.s, vb + t0 * vs.s, ks.s, vs.s, min(kTile, len - t0), d,
        1.f, 1.f, qv, ng, scale, 0.f, s_sm, kTile, m, l, acc);
  }

  if (tid < d) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < ng)
        out[q_row + g * d + tid] =
            ptt::from_float<T>(acc[g] / fmaxf(l[g], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const void* lens, void* out, int batch, int hq, int hkv,
                   int d, int s_max, CacheStrides ks, CacheStrides vs,
                   float scale, cudaStream_t stream) {
  const int group = hq / hkv;
  const dim3 grid(hkv * ((group + kMaxGroup - 1) / kMaxGroup), batch);
  decode_mha_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(lens),
      static_cast<T*>(out), hq, hkv, d, s_max, ks, vs, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* kc, const void* vc, const void* lens,
             void* out, int batch, int hq, int hkv, int d, int s_max,
             long long ksb, long long kss, long long ksh, long long vsb,
             long long vss, long long vsh, float scale, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const CacheStrides ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  if (d <= 32)
    return launch<T, 32>(q, kc, vc, lens, out, batch, hq, hkv, d, s_max, ks,
                         vs, scale, st);
  if (d <= 64)
    return launch<T, 64>(q, kc, vc, lens, out, batch, hq, hkv, d, s_max, ks,
                         vs, scale, st);
  if (d <= 128)
    return launch<T, 128>(q, kc, vc, lens, out, batch, hq, hkv, d, s_max, ks,
                          vs, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, Hq, D] and out [B, Hq, D] contiguous; k/v caches [B, S, Hkv, D]
// with the given element strides of B, S and Hkv (unit stride on D);
// lens [B] int32. Returns cudaGetLastError() after the launch.
#define DECODE_MHA_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* q, const void* k_cache,                   \
                      const void* v_cache, const void* lens, void* out,     \
                      int batch, int hq, int hkv, int d, int s_max,         \
                      long long ksb, long long kss, long long ksh,          \
                      long long vsb, long long vss, long long vsh,          \
                      float scale, void* stream) {                          \
    return dispatch<T>(q, k_cache, v_cache, lens, out, batch, hq, hkv, d,   \
                       s_max, ksb, kss, ksh, vsb, vss, vsh, scale, stream); \
  }

DECODE_MHA_ENTRY(decode_mha_bf16, __nv_bfloat16)
DECODE_MHA_ENTRY(decode_mha_f16, __half)
DECODE_MHA_ENTRY(decode_mha_f32, float)
