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
// [Hkv, num_pages, page_size, D] for the stock layout. Pools are int8 with
// per-(page, kv head) absmax scales [num_pages, Hkv] (value = int8 * scale
// / 127) under a bf16, fp16 or fp32 query, or bf16, fp16 or fp32 under a
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
// Design: as K7 (decode_mha.cu), flash-decoding over ptt::decode_split in
// common.cuh: block (kv head x group part, row, split) walks its split of
// `split` tokens (a multiple of the page size, from the shapes alone: the
// capacity max_pages * page_size, never the lengths) in 64-token tiles (32
// in fp32) that may span several pages, each token's K and V rows found
// through the row's page-table entry and prefetched by cp.async, and
// leaves (m, l, acc) for its query heads; paged_decode_combine_kernel
// (ptt::decode_combine) merges the splits in split order, or, with one
// split, the block writes the output itself. int8 pools fold the K scale
// into the score and the V scale into p. Blocks whose split starts past a
// row's length return at once. No atomics: two launches give bitwise-equal
// outputs. This file only says where a token's K and V rows are.
#include "common.cuh"

namespace {

constexpr float kQMax = 127.f;  // quantization/kv.py KV_QMAX

struct PoolStrides {
  long long page, tok, head;  // elements; D has unit stride
};

template <typename Tq, typename T>
struct Params {
  const Tq* q;
  const T* k;
  const T* v;
  const float* k_scale;  // [P, Hkv], int8 pools only
  const float* v_scale;
  const int* table;
  const int* lens;
  Tq* out;
  int hq, hkv, d, page_size, max_pages, split;
  PoolStrides st;
  float scale, soft_cap;
  bool vec;  // every pool row 16-byte aligned
  float* part_acc;
  float* part_m;
  float* part_l;
};

// Token t of one (row, kv head): page table[t / page_size] (-1 reads page
// 0), offset t % page_size; k and v point at the kv head of page 0.
template <typename T>
struct PageRows {
  const T* k;
  const T* v;
  const int* table;  // the row's page ids
  const float* k_scale;
  const float* v_scale;
  long long page_stride, tok_stride;
  int page_size, hkv, hk;
  __device__ __forceinline__ int page(int t) const {
    const int pid = table[t / page_size];
    return pid < 0 ? 0 : pid;
  }
  __device__ __forceinline__ ptt::KVRow<T> row(int t) const {
    const long long off =
        page(t) * page_stride + (t % page_size) * tok_stride;
    return {k + off, v + off};
  }
  __device__ __forceinline__ void scales(int t, float& kq, float& vq) const {
    const long long i = static_cast<long long>(page(t)) * hkv + hk;
    kq = k_scale[i] / kQMax;
    vq = v_scale[i] / kQMax;
  }
};

// kStrided: the pools are read through the strides in p.st and the logits
// capped by soft_cap, as the arguments say (the stock layout, a soft cap,
// or a head dim d narrower than the instance's width D). Otherwise the
// pools are the engines' contiguous [P, page_size, Hkv, D], addressed from
// hkv and D, uncapped, so the tanh drops out. kG: the query heads a block
// holds at most (1, 4 or 8).
template <typename Tq, typename T, int D, int kG, bool kStrided>
__global__ void __launch_bounds__(ptt::kDecodeThreads)
paged_decode_kernel(const Params<Tq, T> p) {
  const ptt::DecodeBlock blk = ptt::decode_block(p.hq, p.hkv);
  const int cap = p.max_pages * p.page_size;
  const int len = max(0, min(p.lens[blk.b], cap));
  const long long tok =
      kStrided ? p.st.tok : static_cast<long long>(p.hkv) * D;
  const long long page = kStrided ? p.st.page : tok * p.page_size;
  const long long head = (kStrided ? p.st.head : D) * blk.hk;
  const PageRows<T> src{p.k + head,
                        p.v + head,
                        p.table + static_cast<long long>(blk.b) * p.max_pages,
                        p.k_scale,
                        p.v_scale,
                        page,
                        tok,
                        p.page_size,
                        p.hkv,
                        blk.hk};
  ptt::decode_split<Tq, T, D, kG, sizeof(T) == 1>(
      src, blk, p.q, p.out, kStrided ? p.d : D, len, p.split, p.scale,
      kStrided ? p.soft_cap : 0.f, p.vec, p.part_acc, p.part_m, p.part_l);
}

template <typename Tq>
__global__ void __launch_bounds__(ptt::kDecodeThreads)
paged_decode_combine_kernel(const float* part_acc, const float* part_m,
                            const float* part_l, const int* lens, Tq* out,
                            int hq, int d, int cap, int split) {
  ptt::decode_combine(part_acc, part_m, part_l, lens, out, hq, d, cap, split);
}

template <typename Tq, typename T, int D, int kG>
cudaError_t launch(const Params<Tq, T>& p, int batch, cudaStream_t stream) {
  const int group = p.hq / p.hkv;
  const int cap = p.max_pages * p.page_size;
  const dim3 grid(p.hkv * ((group + ptt::kMaxDecodeGroup - 1) /
                           ptt::kMaxDecodeGroup),
                  batch, ptt::decode_splits(cap, p.split));
  const bool engine_layout =
      p.d == D && p.st.page == 1LL * p.page_size * p.hkv * D &&
      p.st.tok == 1LL * p.hkv * D && p.st.head == D && p.soft_cap == 0.f;
  auto kernel = engine_layout ? paged_decode_kernel<Tq, T, D, kG, false>
                              : paged_decode_kernel<Tq, T, D, kG, true>;
  return ptt::launch_split_decode(
      kernel, paged_decode_combine_kernel<Tq>,
      ptt::DecodeShape<T, D, kG>::kSmem, grid, stream, p.part_acc, p.part_m,
      p.part_l, p.lens, p.out, p.hq, p.d, cap, p.split, p);
}

template <typename Tq, typename T, int D>
cudaError_t launch_width(const Params<Tq, T>& p, int batch,
                         cudaStream_t st) {
  const int heads = min(p.hq / p.hkv, ptt::kMaxDecodeGroup);
  if (heads == 1) return launch<Tq, T, D, 1>(p, batch, st);
  if (heads <= 4) return launch<Tq, T, D, 4>(p, batch, st);
  return launch<Tq, T, D, 8>(p, batch, st);
}

template <typename Tq, typename T>
int dispatch(const void* q, const void* kp, const void* vp, const void* ks,
             const void* vs, const void* table, const void* lens, void* out,
             int batch, int hq, int hkv, int d, int page_size, int max_pages,
             PoolStrides st, float scale, float soft_cap, int split,
             void* part_acc, void* part_m, void* part_l, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || d <= 0 || page_size <= 0 || split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr long long kAlign = 16 / sizeof(T);  // elements in 16 bytes
  const bool vec = ptt::aligned16(kp) && ptt::aligned16(vp) &&
                   st.page % kAlign == 0 && st.tok % kAlign == 0 &&
                   st.head % kAlign == 0;
  const Params<Tq, T> p{static_cast<const Tq*>(q),
                        static_cast<const T*>(kp),
                        static_cast<const T*>(vp),
                        static_cast<const float*>(ks),
                        static_cast<const float*>(vs),
                        static_cast<const int*>(table),
                        static_cast<const int*>(lens),
                        static_cast<Tq*>(out),
                        hq,
                        hkv,
                        d,
                        page_size,
                        max_pages,
                        split,
                        st,
                        scale,
                        soft_cap,
                        vec,
                        static_cast<float*>(part_acc),
                        static_cast<float*>(part_m),
                        static_cast<float*>(part_l)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32) return launch_width<Tq, T, 32>(p, batch, s);
  if (d <= 64) return launch_width<Tq, T, 64>(p, batch, s);
  if (d <= 128) return launch_width<Tq, T, 128>(p, batch, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B, Hq, D] bf16, contiguous; pools with unit stride on D and the
// element strides page_stride, tok_stride, head_stride of their page, token
// and kv-head dims, the same for K and V; page_table [B, max_pages] int32;
// lens [B] int32; out [B, Hq, D] bf16. soft_cap 0 leaves the logits
// uncapped. split: tokens a block takes (a multiple of page_size); with
// more than one split of max_pages * page_size, part_acc [splits, B, Hq, D]
// and part_m, part_l [splits, B, Hq] are fp32 workspace (unused, may be
// null, with one). Returns cudaGetLastError() after the launches.
extern "C" int paged_decode_bf16(const void* q, const void* k_pool,
                                 const void* v_pool, const void* page_table,
                                 const void* lens, void* out, int batch,
                                 int hq, int hkv, int d, int page_size,
                                 int max_pages, long long page_stride,
                                 long long tok_stride, long long head_stride,
                                 float scale, float soft_cap, int split,
                                 void* part_acc, void* part_m, void* part_l,
                                 void* stream) {
  return dispatch<__nv_bfloat16, __nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, page_table, lens, out, batch, hq,
      hkv, d, page_size, max_pages,
      PoolStrides{page_stride, tok_stride, head_stride}, scale, soft_cap,
      split, part_acc, part_m, part_l, stream);
}

// As above with int8 pools and their [P, Hkv] fp32 scales (contiguous),
// under a bf16 query (_int8), an fp16 one (_int8_f16) or an fp32 one
// (_int8_f32); the output takes the query's type.
#define PAGED_DECODE_INT8_ENTRY(NAME, Tq)                                    \
  extern "C" int NAME(const void* q, const void* k_pool, const void* v_pool, \
                      const void* k_scale, const void* v_scale,              \
                      const void* page_table, const void* lens, void* out,   \
                      int batch, int hq, int hkv, int d, int page_size,      \
                      int max_pages, long long page_stride,                  \
                      long long tok_stride, long long head_stride,           \
                      float scale, float soft_cap, int split,                \
                      void* part_acc, void* part_m, void* part_l,            \
                      void* stream) {                                        \
    return dispatch<Tq, int8_t>(q, k_pool, v_pool, k_scale, v_scale,         \
                                page_table, lens, out, batch, hq, hkv, d,    \
                                page_size, max_pages,                        \
                                PoolStrides{page_stride, tok_stride,         \
                                            head_stride},                    \
                                scale, soft_cap, split, part_acc, part_m,    \
                                part_l, stream);                             \
  }

PAGED_DECODE_INT8_ENTRY(paged_decode_int8, __nv_bfloat16)
PAGED_DECODE_INT8_ENTRY(paged_decode_int8_f16, __half)
PAGED_DECODE_INT8_ENTRY(paged_decode_int8_f32, float)

// As paged_decode_bf16 with query, pools and output all fp16 (_f16) or all
// fp32 (_f32).
#define PAGED_DECODE_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* q, const void* k_pool, const void* v_pool, \
                      const void* page_table, const void* lens, void* out,   \
                      int batch, int hq, int hkv, int d, int page_size,      \
                      int max_pages, long long page_stride,                  \
                      long long tok_stride, long long head_stride,           \
                      float scale, float soft_cap, int split,                \
                      void* part_acc, void* part_m, void* part_l,            \
                      void* stream) {                                        \
    return dispatch<T, T>(q, k_pool, v_pool, nullptr, nullptr, page_table,   \
                          lens, out, batch, hq, hkv, d, page_size,           \
                          max_pages,                                         \
                          PoolStrides{page_stride, tok_stride, head_stride}, \
                          scale, soft_cap, split, part_acc, part_m, part_l,  \
                          stream);                                           \
  }

PAGED_DECODE_ENTRY(paged_decode_f16, __half)
PAGED_DECODE_ENTRY(paged_decode_f32, float)
