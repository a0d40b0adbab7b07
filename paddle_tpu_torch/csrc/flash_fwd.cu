// K3: flash attention forward for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/flash_attention_kernel.py::_fwd_kernel, launched by
// _fwd_impl through pl.pallas_call (flash_attention_kernel.py:331).
//
// Computes, for q [B, Sq, Hq, D] and k, v [B, Sk, Hkv, D] in bf16 (any
// batch/sequence/head strides, unit stride on D),
//   out = softmax(q k^T * scale + mask) v   (bf16, [B, Sq, Hq, D])
//   lse = log-sum-exp of each score row     (fp32, [B, Hq, Sq])
// with fp32 softmax and accumulation. The causal mask is bottom-right
// aligned: query i attends keys <= i + (Sk - Sq). Query head h reads kv head
// h / (Hq / Hkv) (GQA). Any lengths: the ragged edge is masked here.
// Dropout (p > 0) keeps the softmax normalizer over the undropped
// probabilities and drops entries of P.V only, scaled by 1 / (1 - p), with
// the keep-mask of _keep_mask (ptt::Dropout, a hash of the global
// coordinates, so it does not depend on the tile sizes).
//
// What bounds it: at prefill lengths one head does 4 * Sq * Sk * D flops
// (half that causal) on (2 Sq + 2 Sk) * D * 2 bytes, hundreds of flops per
// byte, above the ~295 at which the H100's bf16 tensor cores outrun its
// memory: operations bound it.
//
// Design: the flash recurrence keeps every score and probability tile on
// chip. A block owns 64 queries of one (batch, head); it walks 64-key tiles,
// staging Q (once), K and V in shared memory, and skips the tiles above the
// causal diagonal. Q and K are staged transposed ([D][64]) so the score loop
// reads consecutive keys across a half-warp, and the probability tile's row
// stride (80 floats, 16 mod 32) puts the two rows a warp touches in disjoint
// banks. This first version multiplies with fp32 FMAs on the CUDA cores, not
// the tensor cores, so it sits well above its bound; moving both products to
// wgmma is the step after correctness.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // thread (ty, tx) = (tid / 16, tid % 16) owns
                               // rows ty + 16 i and keys tx + 16 j, i, j < 4
constexpr int kPStride = 80;   // fp32 row stride of the probability tile

struct Strides {
  long long b, s, h;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (D * kBQ + D * kBK + kBK * D) +
         sizeof(float) * kBQ * kPStride;
}

// Sum / max over the 16 lanes that share a row (a half-warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 Strides qs, Strides ks, Strides vs, Strides os, int sq,
                 int sk, int hq, int group, float scale, int causal,
                 ptt::Dropout drop) {
  constexpr int kCols = D / 16;   // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_t = reinterpret_cast<__nv_bfloat16*>(smem);  // [D][kBQ]
  __nv_bfloat16* k_t = q_t + D * kBQ;                             // [D][kBK]
  __nv_bfloat16* v_s = k_t + D * kBK;                             // [kBK][D]
  float* p_s = reinterpret_cast<float*>(v_s + kBK * D);  // [kBQ][kPStride]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int offset = sk - sq;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + (h / group) * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + (h / group) * vs.h;
  const uint32_t hkey = drop.head_key(b, h);

  ptt::stage_transposed<D, kBQ, kThreads>(q_t, qb, qs.s, q0, sq);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = ptt::kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    // the block's last query attends keys <= q0 + kBQ - 1 + offset
    const int last_key = q0 + kBQ - 1 + offset;
    n_tiles = min(n_tiles, last_key < 0 ? 0 : last_key / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    ptt::stage_transposed<D, kBK, kThreads>(k_t, kb, ks.s, k0, sk);
    ptt::stage_rows<D, kBK, kThreads>(v_s, vb, vs.s, k0, sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = __bfloat162float(q_t[d * kBQ + ty + 16 * i]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = __bfloat162float(k_t[d * kBK + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax over this tile; every lane of a half-warp ends with the
    // same m and l for its rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool valid[4];
      float mx = ptt::kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        valid[j] = kpos < sk && (!causal || kpos <= qpos + offset);
        s[i][j] = valid[j] ? s[i][j] * scale : ptt::kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;  // the normalizer sums the undropped p
        float pv = p;
        if (drop.on)  // only P.V sees the mask
          pv = drop.keep(hkey, qpos, k0 + tx + 16 * j) ? p * drop.scale
                                                        : 0.f;
        p_s[(ty + 16 * i) * kPStride + tx + 16 * j] = pv;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * kPStride + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = __bfloat162float(v_s[key * D + tx + 16 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = o + b * os.b + qpos * os.s + h * os.h;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      orow[tx + 16 * c] = __float2bfloat16(acc[i][c] / l_safe);
    if (tx == 0)
      lse[(static_cast<long long>(b) * hq + h) * sq + qpos] =
          m[i] + logf(l_safe);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int sq, int sk, int hq, int hkv,
                   Strides qs, Strides ks, Strides vs, Strides os, float scale,
                   int causal, ptt::Dropout drop, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, batch);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), qs, ks, vs, os, sq, sk, hq, hq / hkv, scale,
      causal, drop);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements. q/k/v/o rows must be 16-byte aligned (the wrapper
// checks). Dropout: seed, keep threshold, 1 / (1 - p), on (see
// ptt::Dropout). Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int batch, int sq, int sk,
                              int hq, int hkv, int d, long long qsb,
                              long long qss, long long qsh, long long ksb,
                              long long kss, long long ksh, long long vsb,
                              long long vss, long long vsh, long long osb,
                              long long oss, long long osh, float scale,
                              int causal, unsigned int seed,
                              unsigned int thresh, float drop_scale,
                              int dropout, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      os{osb, oss, osh};
  const ptt::Dropout drop{seed, thresh, drop_scale, dropout};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, o, lse, batch, sq, sk, hq, hkv, qs, ks, vs,
                        os, scale, causal, drop, st);
    case 128:
      return launch<128>(q, k, v, o, lse, batch, sq, sk, hq, hkv, qs, ks, vs,
                         os, scale, causal, drop, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
