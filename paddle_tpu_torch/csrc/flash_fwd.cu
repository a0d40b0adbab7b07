// K3: flash attention forward for Hopper (sm_90a), bf16 and fp16 on the
// tensor cores.
//
// Replaces paddle_tpu/ops/flash_attention_kernel.py::_fwd_kernel, launched by
// _fwd_impl through pl.pallas_call (flash_attention_kernel.py:331). Its fp32
// instance is flash_f32.cu.
//
// Computes, for q [B, Sq, Hq, D] and k, v [B, Sk, Hkv, D] in bf16 or fp16
// (any batch/sequence/head strides, unit stride on D),
//   out = softmax(q k^T * scale + mask) v   (input dtype, [B, Sq, Hq, D])
//   lse = log-sum-exp of each score row     (fp32, [B, Hq, Sq])
// with an fp32 online softmax and fp32 accumulation. P is rounded to the
// input dtype before P.V, at the running max of its 64-key tile, as the JAX
// kernel rounds it (pv.astype(v.dtype), :292); the normalizer sums the
// unrounded fp32 p. The causal mask is bottom-right aligned: query i
// attends keys <= i + (Sk - Sq). Query head h reads kv head h / (Hq / Hkv)
// (GQA). Any lengths: the ragged edge is masked here. Dropout (p > 0) keeps the
// normalizer over the undropped probabilities and drops entries of P.V
// only, scaled by 1 / (1 - p), with the keep-mask of _keep_mask
// (ptt::Dropout, a hash of the global coordinates, so it does not depend
// on the tile sizes). Rows with no key give out 0 and lse -1e30.
//
// What bounds it: at prefill and training lengths one head does 4 Sq Sk D
// flops (half that causal) on (2 Sq + 2 Sk) D * 2 bytes, hundreds of flops
// per byte, above the ~295 at which the H100's bf16 tensor cores outrun its
// memory: operations bound it.
//
// Design (that of flash_bwd.cu's dq kernel, applied to the forward). Both
// products are mma.sync m16n8k16 with fp32 accumulators (mma.cuh). A
// block owns 64 queries of one (query head, batch), a warp 16 of them. Q is
// staged once and its fragments kept in registers; K and V stream through
// two cp.async buffers of 64 keys, so the next tile loads while this one
// multiplies. Per tile a warp forms S = Q K^T (16 x 64) in registers,
// reduces the row max and sum across the 4 lanes that share a row, rounds P
// to the input dtype straight into the A fragments of O += P V, and keeps O
// (16 x D fp32), m and l in registers for the whole walk: no score or
// probability goes through shared memory. Q, K and V are row-major [rows][D]
// tiles padded by 16 bytes a row; K^T comes from ldmatrix without .trans, V
// from ldmatrix.trans, so nothing is transposed in memory. Only the tiles
// the causal diagonal or a ragged edge cuts test each entry; tiles wholly
// above a warp's diagonal are skipped by that warp. The blocks of the last
// query tiles (the longest causal walks) launch first. No atomics: two
// launches give bitwise-equal results.
//
// The prefix-chunk instance (flash_fwd_prefix_*, kPos) is the same kernel for
// chunked prefill, the port of
// paddle_tpu/ops/pallas.py::prefix_chunk_attention (:167-213, the
// absolute-position mask of _chunked_attention, :33-93; XLA on the TPU):
// q is one chunk of C queries whose row i sits at absolute position pos + i,
// k and v a cache of W rows whose first pos + C are written, and row i
// attends keys <= pos + i. The kernel reads pos from device memory, so the
// host never learns it and a captured program can replay at any offset: the
// grid stays (heads, batch, C / 64), each block walks key tiles from 0 to the
// one holding its last query's diagonal, and the key rows it stages stop at
// min(W, pos + C). That is the causal instance with Sk = min(W, pos + C) and
// the diagonal's offset pos in place of Sk - Sq, so a row's tiles, their
// masks and its arithmetic are those of the same row in a one-shot causal
// prefill: the rows agree bitwise. A query block that starts off a multiple
// of 64 cuts key tiles elsewhere than the one-shot grid does; a masked entry
// contributes an exact 0, and a tile wholly masked for a row leaves its m
// and l as they were (alpha = 1).
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // queries per block
constexpr int kBK = 64;  // keys per tile: _KEY_TILE of the plain version

struct Strides {
  long long b, s, h;
};

template <int D>
constexpr size_t smem_bytes() {  // q_s; k_s, v_s double-buffered
  return 2 * (kRows + 4 * kBK) * ptt::pitch<D>();
}

// T: __nv_bfloat16 or __half. kPos: the prefix-chunk instance, which takes
// the diagonal's offset from *pos (and caps the keys at *pos + sq).
template <typename T, int D, bool kPos>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ pos,
                 Strides qs, Strides ks, Strides vs, Strides os, int sq,
                 int sk_cap, int hq, int group, float scale, int causal,
                 ptt::Dropout drop) {
  constexpr int P = ptt::pitch<D>();
  constexpr int kN = kBK / 8;  // n-tiles of a score row
  constexpr int kK = D / 16;   // k-steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);  // [kRows][P]
  T* k_s = q_s + kRows * P;             // [2][kBK][P]
  T* v_s = k_s + 2 * kBK * P;           // [2][kBK][P]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // heavy tiles first
  const int qw0 = q0 + warp * 16;                        // the warp's rows
  const int offset = kPos ? *pos : sk_cap - sq;
  const int sk = kPos ? min(sk_cap, offset + sq) : sk_cap;
  const T* kb = k + b * ks.b + (h / group) * ks.h;
  const T* vb = v + b * vs.b + (h / group) * vs.h;

  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {  // the block's last query attends keys <= last_key
    const int last_key = q0 + kRows - 1 + offset;
    n_tiles = min(n_tiles, last_key < 0 ? 0 : last_key / kBK + 1);
  }

  ptt::stage_tile<kRows, D, P, kThreads>(q_s, q + b * qs.b + h * qs.h, qs.s,
                                         q0, sq, 0, D, true);
  ptt::cp_async_commit();
  auto stage_kv = [&](int t) {
    const int off = (t & 1) * kBK * P;
    ptt::stage_tile<kBK, D, P, kThreads>(k_s + off, kb, ks.s, t * kBK, sk,
                                         0, D, true);
    ptt::stage_tile<kBK, D, P, kThreads>(v_s + off, vb, vs.s, t * kBK, sk,
                                         0, D, true);
  };
  if (n_tiles > 0) stage_kv(0);
  ptt::cp_async_commit();
  ptt::cp_async_wait<1>();  // Q has landed
  __syncthreads();

  uint32_t qf[kK][4];  // the warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < kK; ++kk)
    ptt::ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * P + kk * 16 +
                                 (lane >> 4) * 8);

  // this thread's two rows: qw0 + g (r = 0) and qw0 + g + 8 (r = 1)
  const uint32_t hkey = drop.head_key(b, h);
  uint32_t row_hash[2];
  float m[2], l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_hash[r] = ptt::mix(static_cast<uint32_t>(qw0 + g + 8 * r) + hkey);
    m[r] = ptt::kNeg;
    l[r] = 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) stage_kv(t + 1);
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const int k0 = t * kBK;
    const T* kt = k_s + (t & 1) * kBK * P;
    const T* vt = v_s + (t & 1) * kBK * P;
    // warp-uniform: skip a tile wholly above the diagonal or past Sq
    if (qw0 < sq && !(causal && k0 > qw0 + 15 + offset)) {
      float s[kN][4];
#pragma unroll
      for (int j = 0; j < kN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
        for (int jp = 0; jp < kN / 2; ++jp) {
          const int br = jp * 16 + (lane & 7) + (lane >> 4) * 8;
          const int bc = kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t r[4];
          ptt::ldmatrix_x4(r, kt + br * P + bc);
          ptt::mma_16816<T>(s[2 * jp], qf[kk], r[0], r[1]);
          ptt::mma_16816<T>(s[2 * jp + 1], qf[kk], r[2], r[3]);
        }
      }
      // scale and mask (only where the diagonal or an edge cuts the tile)
      const bool edge = qw0 + 15 >= sq || k0 + kBK > sk ||
                        (causal && k0 + kBK - 1 > qw0 + offset);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int qpos = qw0 + g + 8 * r, kpos = k0 + 8 * j + c2 + (e & 1);
          const bool valid = !edge || (qpos < sq && kpos < sk &&
                                       (!causal || kpos <= qpos + offset));
          s[j][e] = valid ? s[j][e] * scale : ptt::kNeg;
          mx[r] = fmaxf(mx[r], s[j][e]);
        }
      }
      // online softmax: the 4 lanes of a row share its max and sum
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          // a masked entry is exactly kNeg; exp of it is 0 unless the row
          // has seen no key yet (m == kNeg), so it is zeroed here
          const float p = (edge && s[j][e] == ptt::kNeg)
                              ? 0.f
                              : expf(s[j][e] - m[r]);
          sum[r] += p;  // the normalizer sums the undropped p
          if (drop.on) {  // only P.V sees the mask
            const int kpos = k0 + 8 * j + c2 + (e & 1);
            s[j][e] = ptt::mix(row_hash[r] ^ static_cast<uint32_t>(kpos)) >=
                              drop.thresh
                          ? p * drop.scale
                          : 0.f;
          } else {
            s[j][e] = p;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * alpha[r] + sum[r];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }
      uint32_t a_p[kN / 2][4];
      ptt::to_a_frags<T, kN>(s, a_p);  // P rounded to T
      ptt::accumulate<T, D, kN / 2>(a_p, vt, 0, acc);
    }
    __syncthreads();  // the next stage overwrites this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qw0 + g + 8 * r;
    if (qpos >= sq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    T* orow = o + b * os.b + qpos * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + c2) = ptt::pack2<T>(
          acc[j][2 * r] / l_safe, acc[j][2 * r + 1] / l_safe);
    if (c2 == 0)
      lse[(static_cast<long long>(b) * hq + h) * sq + qpos] =
          m[r] + logf(l_safe);
  }
}

template <typename T, int D, bool kPos>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, const int* pos, int batch, int sq, int sk,
                   int hq, int hkv, Strides qs, Strides ks, Strides vs,
                   Strides os, float scale, int causal, ptt::Dropout drop,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, kPos>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_kernel<T, D, kPos>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(hq, batch, (sq + kRows - 1) / kRows);
  flash_fwd_kernel<T, D, kPos><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      pos, qs, ks, vs, os, sq, sk, hq, hq / hkv, scale, causal, drop);
  return cudaGetLastError();
}

template <typename T, bool kPos>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             const int* pos, int batch, int sq, int sk, int hq, int hkv,
             int d, const long long (&st)[12], float scale, int causal,
             ptt::Dropout drop, void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<T, 64, kPos>(q, k, v, o, lse, pos, batch, sq, sk, hq, hkv,
                                 qs, ks, vs, os, scale, causal, drop, s);
    case 128:
      return launch<T, 128, kPos>(q, k, v, o, lse, pos, batch, sq, sk, hq,
                                  hkv, qs, ks, vs, os, scale, causal, drop, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides are in elements. q/k/v rows must be 16-byte aligned and every
// non-unit stride a multiple of 8 elements, o rows 4-byte aligned (the
// wrapper checks); d is 64 or 128 (the wrapper zero-pads other head dims).
// Dropout: seed, keep threshold, 1 / (1 - p), on (see ptt::Dropout).
// Returns cudaGetLastError() after the launch. flash_fwd_bf16 takes bf16
// tensors, flash_fwd_f16 fp16 ones.
#define FLASH_FWD_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, \
                      void* lse, int batch, int sq, int sk, int hq, int hkv, \
                      int d, long long qsb, long long qss, long long qsh,    \
                      long long ksb, long long kss, long long ksh,           \
                      long long vsb, long long vss, long long vsh,           \
                      long long osb, long long oss, long long osh,           \
                      float scale, int causal, unsigned int seed,            \
                      unsigned int thresh, float drop_scale, int dropout,    \
                      void* stream) {                                        \
    const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,                  \
                              vsb, vss, vsh, osb, oss, osh};                 \
    return dispatch<T, false>(q, k, v, o, lse, nullptr, batch, sq, sk, hq,  \
                              hkv, d, st, scale, causal,                     \
                              ptt::Dropout{seed, thresh, drop_scale,         \
                                           dropout},                         \
                              stream);                                       \
  }

FLASH_FWD_ENTRY(flash_fwd_bf16, __nv_bfloat16)
FLASH_FWD_ENTRY(flash_fwd_f16, __half)

// The prefix-chunk instance: the arguments of flash_fwd_bf16 with pos, a
// device pointer to one int32 (the chunk's first absolute position), after
// lse; sq is the chunk's length C and sk the cache's capacity W. Causal by
// construction: causal and the dropout arguments are taken and ignored.
#define FLASH_FWD_PREFIX_ENTRY(NAME, T)                                      \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, \
                      void* lse, const void* pos, int batch, int sq, int sk, \
                      int hq, int hkv, int d, long long qsb, long long qss,  \
                      long long qsh, long long ksb, long long kss,           \
                      long long ksh, long long vsb, long long vss,           \
                      long long vsh, long long osb, long long oss,           \
                      long long osh, float scale, int, unsigned int,         \
                      unsigned int, float, int, void* stream) {              \
    const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,                  \
                              vsb, vss, vsh, osb, oss, osh};                 \
    return dispatch<T, true>(q, k, v, o, lse, static_cast<const int*>(pos),  \
                             batch, sq, sk, hq, hkv, d, st, scale, 1,        \
                             ptt::Dropout{0u, 0u, 1.f, 0}, stream);          \
  }

FLASH_FWD_PREFIX_ENTRY(flash_fwd_prefix_bf16, __nv_bfloat16)
FLASH_FWD_PREFIX_ENTRY(flash_fwd_prefix_f16, __half)
