// K4: paged decode attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/paged_attention.py::paged_decode_mha
// (_paged_decode_kernel, launched through pl.pallas_call at
// paged_attention.py:268).
//
// Also the Hopper counterpart of JAX's stock TPU paged-attention kernel
// (paddle_tpu/ops/pallas.py::paged_attention): its pools are
// [Hkv, num_pages, page_size, D] and it neither scales q nor leaves the
// logits uncapped, so the kernel reads the pools through strides and takes
// the scale and an optional logit soft cap as arguments.
//
// One decode step: for each row b and query head h,
//   out[b, h] = softmax(cap(q[b, h] . K^T * scale)) V
// over the row's first lens[b] tokens, with cap(s) = c tanh(s / c) for a
// soft cap c > 0 and cap(s) = s for c = 0. Token t of row b lives in page
// page_table[b, t / page_size], at offset t % page_size, of the pools, read
// through the page, token and kv-head strides in elements that K and V
// share (unit stride on D): [num_pages, page_size, Hkv, D] for the engines,
// [Hkv, num_pages, page_size, D] for the stock layout. Pools are bf16 under
// a bf16 query, int8 with per-(page, kv head) absmax scales [num_pages, Hkv]
// (value = int8 * scale / 127) under a bf16 query, or fp16 or fp32 under a
// query of the same type; the output takes the query's type. Any D <= 128
// (the tile is instantiated at 32, 64 and 128 and masks the lanes past D)
// and any GQA group (a block takes at most 8 query heads; larger groups are
// split over blocks, each loading the pages once for its heads). Query head
// h reads kv head h / (Hq / Hkv). fp32 softmax and accumulation; a row with
// lens 0 returns zeros; a -1 table entry inside the length reads page 0, as
// the TPU kernel does, and entries past the length are never read.
//
// What bounds it: every live token's K and V row is read once for 4 * D
// flops per query head, about one flop per byte in bf16, so memory bandwidth
// bounds it (the bytes are the live tokens' K and V, not the pool).
//
// Design: one block per (row, kv head) walks the row's pages in order with
// an online softmax, reading its own page ids from the table (a group of
// more than 8 query heads takes one block per 8). Each K and V row is
// loaded once for all g query heads of the block: a warp takes one token's
// K row (lanes across D) and produces the g scores, then one
// thread per output column streams the page's V column (ptt::decode_tile in
// common.cuh, shared with decode_mha.cu). Only the g x page_size scores
// pass through shared memory. There is no split of a long
// context over several blocks yet: at B = 8 and 32 kv heads that is 256
// blocks on 132 SMs, each walking its pages one after the other.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGroup = 8;
constexpr float kQMax = 127.f;  // quantization/kv.py KV_QMAX

struct PoolStrides {
  long long page, tok, head;  // elements; D has unit stride
};

// kStrided: the pools are read through the strides in st and the logits
// capped by soft_cap, as the arguments say (the stock layout, a soft cap,
// or a head dim d narrower than the instance's width D). Otherwise the
// pools are the engines' contiguous [P, page_size, Hkv, D], addressed from
// hkv and D (shifts by log2(D); strides read from the parameters made the
// engines' decode measurably slower), and uncapped, so the tanh drops out.
// Block (hk * n_split + part, b) takes query heads hk * group + 8 part ..
template <typename Tq, typename T, int D, bool kStrided>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Tq* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lens, Tq* __restrict__ out,
                    int hq, int hkv, int d, int page_size, int max_pages,
                    PoolStrides st, float scale, float soft_cap) {
  constexpr int kPerLane = D / 32;
  extern __shared__ float s_sm[];  // [group][page_size] scores of one page
  const int group = hq / hkv;
  const int n_split = (group + kMaxGroup - 1) / kMaxGroup;
  const int hk = blockIdx.x / n_split, b = blockIdx.y;
  const int g0 = (blockIdx.x % n_split) * kMaxGroup;
  const int ng = min(kMaxGroup, group - g0);  // this block's query heads
  const int tid = threadIdx.x, lane = tid & 31;
  const int len = lens[b];
  const int n_pages = len <= 0 ? 0 : min((len + page_size - 1) / page_size,
                                         max_pages);
  const long long tok_stride =
      kStrided ? st.tok : static_cast<long long>(hkv) * D;
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

  for (int p = 0; p < n_pages; ++p) {
    int pid = page_table[static_cast<long long>(b) * max_pages + p];
    pid = pid < 0 ? 0 : pid;
    const long long base =
        kStrided ? pid * st.page + hk * st.head
                 : static_cast<long long>(pid) * page_size * tok_stride +
                       static_cast<long long>(hk) * D;
    const float kq = k_scale ? k_scale[pid * hkv + hk] / kQMax : 1.f;
    const float vq = v_scale ? v_scale[pid * hkv + hk] / kQMax : 1.f;
    const int valid = min(page_size, len - p * page_size);
    ptt::decode_tile<T, D, kMaxGroup, kThreads>(
        k_pool + base, v_pool + base, tok_stride, tok_stride, valid,
        kStrided ? d : D, kq, vq, qv, ng, scale, kStrided ? soft_cap : 0.f,
        s_sm, page_size, m, l, acc);
  }

  if (tid < d) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < ng)
        out[q_row + g * d + tid] =
            ptt::from_float<Tq>(acc[g] / fmaxf(l[g], 1e-30f));
  }
}

template <typename Tq, typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* ks, const void* vs, const void* table,
                   const void* lens, void* out, int batch, int hq, int hkv,
                   int d, int page_size, int max_pages, PoolStrides st,
                   float scale, float soft_cap, cudaStream_t stream) {
  const int group = hq / hkv;
  const size_t smem = sizeof(float) * min(group, kMaxGroup) * page_size;
  const dim3 grid(hkv * ((group + kMaxGroup - 1) / kMaxGroup), batch);
  const bool engine_layout = d == D && st.page == 1LL * page_size * hkv * D &&
                             st.tok == 1LL * hkv * D && st.head == D &&
                             soft_cap == 0.f;
  auto kernel = engine_layout ? paged_decode_kernel<Tq, T, D, false>
                              : paged_decode_kernel<Tq, T, D, true>;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Tq*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(lens), static_cast<Tq*>(out), hq, hkv, d,
      page_size, max_pages, st, scale, soft_cap);
  return cudaGetLastError();
}

template <typename Tq, typename T>
int dispatch(const void* q, const void* kp, const void* vp, const void* ks,
             const void* vs, const void* table, const void* lens, void* out,
             int batch, int hq, int hkv, int d, int page_size, int max_pages,
             PoolStrides st, float scale, float soft_cap, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch<Tq, T, 32>(q, kp, vp, ks, vs, table, lens, out, batch, hq,
                             hkv, d, page_size, max_pages, st, scale,
                             soft_cap, s);
  if (d <= 64)
    return launch<Tq, T, 64>(q, kp, vp, ks, vs, table, lens, out, batch, hq,
                             hkv, d, page_size, max_pages, st, scale,
                             soft_cap, s);
  if (d <= 128)
    return launch<Tq, T, 128>(q, kp, vp, ks, vs, table, lens, out, batch, hq,
                              hkv, d, page_size, max_pages, st, scale,
                              soft_cap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, Hq, D] bf16, contiguous; pools with unit stride on D and the
// element strides page_stride, tok_stride, head_stride of their page, token
// and kv-head dims, the same for K and V; page_table [B, max_pages] int32;
// lens [B] int32; out [B, Hq, D] bf16. soft_cap 0 leaves the logits
// uncapped.
extern "C" int paged_decode_bf16(const void* q, const void* k_pool,
                                 const void* v_pool, const void* page_table,
                                 const void* lens, void* out, int batch,
                                 int hq, int hkv, int d, int page_size,
                                 int max_pages, long long page_stride,
                                 long long tok_stride, long long head_stride,
                                 float scale, float soft_cap, void* stream) {
  return dispatch<__nv_bfloat16, __nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, page_table, lens, out, batch, hq,
      hkv, d, page_size, max_pages,
      PoolStrides{page_stride, tok_stride, head_stride}, scale, soft_cap,
      stream);
}

// As above with int8 pools and their [P, Hkv] fp32 scales (contiguous).
extern "C" int paged_decode_int8(const void* q, const void* k_pool,
                                 const void* v_pool, const void* k_scale,
                                 const void* v_scale, const void* page_table,
                                 const void* lens, void* out, int batch,
                                 int hq, int hkv, int d, int page_size,
                                 int max_pages, long long page_stride,
                                 long long tok_stride, long long head_stride,
                                 float scale, float soft_cap, void* stream) {
  return dispatch<__nv_bfloat16, int8_t>(
      q, k_pool, v_pool, k_scale, v_scale, page_table, lens, out, batch, hq,
      hkv, d, page_size, max_pages,
      PoolStrides{page_stride, tok_stride, head_stride}, scale, soft_cap,
      stream);
}

// As paged_decode_bf16 with query, pools and output all fp16 (_f16) or all
// fp32 (_f32).
#define PAGED_DECODE_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* q, const void* k_pool, const void* v_pool, \
                      const void* page_table, const void* lens, void* out,   \
                      int batch, int hq, int hkv, int d, int page_size,      \
                      int max_pages, long long page_stride,                  \
                      long long tok_stride, long long head_stride,           \
                      float scale, float soft_cap, void* stream) {           \
    return dispatch<T, T>(q, k_pool, v_pool, nullptr, nullptr, page_table,   \
                          lens, out, batch, hq, hkv, d, page_size,           \
                          max_pages,                                         \
                          PoolStrides{page_stride, tok_stride, head_stride}, \
                          scale, soft_cap, stream);                          \
  }

PAGED_DECODE_ENTRY(paged_decode_f16, __half)
PAGED_DECODE_ENTRY(paged_decode_f32, float)
