// Flash attention backward for Hopper (sm_90a): flash_bwd_dq and
// flash_bwd_dkv.
//
// Replaces paddle_tpu/ops/flash_attention_kernel.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel, launched by _bwd_impl through pl.pallas_call
// (flash_attention_kernel.py:497 and :519).
//
// For q [B, Sq, Hq, D], k, v [B, Sk, Hkv, D], dO [B, Sq, Hq, D] in bf16 (any
// batch/sequence/head strides, unit stride on D), the forward's lse and
// delta = rowsum(dO * O) ([B, Hq, Sq] fp32, contiguous):
//   P  = exp(q k^T * scale - lse), 0 where masked (rows with no key included)
//   dP = dO v^T
//   dS = P (dP - delta), or with dropout P_drop dP - P delta
//   dq = dS k * scale                      (flash_bwd_dq)
//   dk = sum over the GQA group of dS^T q * scale,
//   dv = sum over the GQA group of P_drop^T dO         (flash_bwd_dkv)
// with P_drop = P * keep / (1 - p) from the forward's hash (ptt::Dropout),
// fp32 throughout, bf16 outputs. Causal masks are bottom-right aligned
// (query i attends keys <= i + Sk - Sq), as in K3.
//
// What bounds them: per (batch, head) dq does 3 and dk/dv 4 products of
// 2 * Sq * Sk * D flops (half that causal) on a few (S * D) bf16 arrays:
// hundreds of flops per byte at training lengths, so operations bound them.
//
// Design. The TPU grids carry their accumulators across the innermost grid
// axis in VMEM; here a block loops over that axis itself.
// - flash_bwd_dq: one block per (batch, query head, 64-query tile) stages its
//   Q and dO tiles once and walks the 64-key tiles up to the causal diagonal,
//   keeping dq (64 x D) in fp32 registers.
// - flash_bwd_dkv: one block per (batch, kv head, 64-key tile) stages its K
//   and V tiles once and walks every query head of its GQA group and every
//   query tile at or below the diagonal, keeping dk and dv in fp32 registers
//   for the whole walk: that takes the place of the TPU's (g, iq)-innermost
//   grid and needs no atomics. Its shared memory (K, V, Q, dO tiles in both
//   orientations and two fp32 64 x 64 tiles, 137 KB at D = 128) is above
//   48 KB, so it is dynamic and raised with cudaFuncSetAttribute.
// Thread (ty, tx) = (tid / 16, tid % 16) owns score rows ty + 16 i and
// columns tx + 16 j (i, j < 4), and output rows ty + 16 i, columns tx + 16 c.
// Operands read along D by the score loops are staged transposed ([D][64])
// so a half-warp reads consecutive entries; operands read along rows by the
// accumulation loops are staged row-major. As in K3, the products are fp32
// FMAs on the CUDA cores; mma.sync / wgmma are the next step.
#include "common.cuh"

namespace {

constexpr int kB = 64;         // queries and keys per tile
constexpr int kThreads = 256;
constexpr int kPStride = 80;   // fp32 row stride of the score tiles

struct Strides {
  long long b, s, h;
};

template <int D>
constexpr size_t dq_smem_bytes() {  // q_t, do_t, k_t, v_t, k_s; ds_s
  return sizeof(__nv_bfloat16) * 5 * D * kB + sizeof(float) * kB * kPStride;
}

template <int D>
constexpr size_t dkv_smem_bytes() {  // k_t, v_t, q_t, do_t, q_s, do_s;
                                     // p_s, ds_s; lse_s, delta_s
  return sizeof(__nv_bfloat16) * 6 * D * kB +
         sizeof(float) * (2 * kB * kPStride + 2 * kB);
}

// P and dS of one score entry (see the header).
__device__ __forceinline__ void p_and_ds(float s, float dp, float lse,
                                         float delta, bool valid, bool keep,
                                         const ptt::Dropout& drop, float scale,
                                         float* pd, float* ds) {
  const float p = valid ? expf(s * scale - lse) : 0.f;
  if (drop.on) {
    *pd = keep ? p * drop.scale : 0.f;
    *ds = *pd * dp - p * delta;
  } else {
    *pd = p;
    *ds = p * (dp - delta);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, Strides qs, Strides ks,
                    Strides vs, Strides dos, Strides dqs, int sq, int sk,
                    int hq, int group, float scale, int causal,
                    ptt::Dropout drop) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_t = reinterpret_cast<__nv_bfloat16*>(smem);  // [D][kB]
  __nv_bfloat16* do_t = q_t + D * kB;                             // [D][kB]
  __nv_bfloat16* k_t = do_t + D * kB;                             // [D][kB]
  __nv_bfloat16* v_t = k_t + D * kB;                              // [D][kB]
  __nv_bfloat16* k_s = v_t + D * kB;                              // [kB][D]
  float* ds_s = reinterpret_cast<float*>(k_s + kB * D);  // [kB][kPStride]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int offset = sk - sq;
  const __nv_bfloat16* kb = k + b * ks.b + (h / group) * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + (h / group) * vs.h;
  const uint32_t hkey = drop.head_key(b, h);

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* dob = dout + b * dos.b + h * dos.h;
  ptt::stage_transposed<D, kB, kThreads>(q_t, qb, qs.s, q0, sq);
  ptt::stage_transposed<D, kB, kThreads>(do_t, dob, dos.s, q0, sq);

  float lse_r[4], delta_r[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    const long long row = (static_cast<long long>(b) * hq + h) * sq + qpos;
    lse_r[i] = qpos < sq ? lse[row] : 0.f;
    delta_r[i] = qpos < sq ? delta[row] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (sk + kB - 1) / kB;
  if (causal) {  // tiles above the diagonal hold no valid key (:408-412)
    const int last_key = q0 + kB - 1 + offset;
    n_tiles = min(n_tiles, last_key < 0 ? 0 : last_key / kB + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // the previous tile's readers are done
    ptt::stage_transposed<D, kB, kThreads>(k_t, kb, ks.s, k0, sk);
    ptt::stage_transposed<D, kB, kThreads>(v_t, vb, vs.s, k0, sk);
    ptt::stage_rows<D, kB, kThreads>(k_s, kb, ks.s, k0, sk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = __bfloat162float(q_t[d * kB + ty + 16 * i]);
        dov[i] = __bfloat162float(do_t[d * kB + ty + 16 * i]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = __bfloat162float(k_t[d * kB + tx + 16 * j]);
        vv[j] = __bfloat162float(v_t[d * kB + tx + 16 * j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = qpos < sq && kpos < sk &&
                           (!causal || kpos <= qpos + offset);
        const bool keep = drop.on && drop.keep(hkey, qpos, kpos);
        float pd, ds;
        p_and_ds(s[i][j], dp[i][j], lse_r[i], delta_r[i], valid, keep, drop,
                 scale, &pd, &ds);
        ds_s[(ty + 16 * i) * kPStride + tx + 16 * j] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < kB; ++key) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(ty + 16 * i) * kPStride + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float kk = __bfloat162float(k_s[key * D + tx + 16 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= sq) continue;
    __nv_bfloat16* row = dq + b * dqs.b + qpos * dqs.s + h * dqs.h;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      row[tx + 16 * c] = __float2bfloat16(acc[i][c] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, Strides qs, Strides ks,
                     Strides vs, Strides dos, Strides dks, Strides dvs,
                     int sq, int sk, int hq, int group, float scale,
                     int causal, ptt::Dropout drop) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* k_t = reinterpret_cast<__nv_bfloat16*>(smem);  // [D][kB]
  __nv_bfloat16* v_t = k_t + D * kB;                              // [D][kB]
  __nv_bfloat16* q_t = v_t + D * kB;                              // [D][kB]
  __nv_bfloat16* do_t = q_t + D * kB;                             // [D][kB]
  __nv_bfloat16* q_s = do_t + D * kB;                             // [kB][D]
  __nv_bfloat16* do_s = q_s + kB * D;                             // [kB][D]
  float* p_s = reinterpret_cast<float*>(do_s + kB * D);  // [kB keys][stride]
  float* ds_s = p_s + kB * kPStride;                      // [kB keys][stride]
  float* lse_s = ds_s + kB * kPStride;                    // [kB queries]
  float* delta_s = lse_s + kB;                            // [kB queries]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kB, hk = blockIdx.y, b = blockIdx.z;
  const int offset = sk - sq;

  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;
  ptt::stage_transposed<D, kB, kThreads>(k_t, kb, ks.s, k0, sk);
  ptt::stage_transposed<D, kB, kThreads>(v_t, vb, vs.s, k0, sk);

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int n_qtiles = (sq + kB - 1) / kB;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const uint32_t hkey = drop.head_key(b, h);
    const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
    const __nv_bfloat16* dob = dout + b * dos.b + h * dos.h;
    const long long row0 = (static_cast<long long>(b) * hq + h) * sq;
    for (int iq = 0; iq < n_qtiles; ++iq) {
      const int q0 = iq * kB;
      // tiles whose every query sits above this key tile (:461-465)
      if (causal && k0 > q0 + kB - 1 + offset) continue;
      __syncthreads();  // the previous tile's readers are done
      ptt::stage_transposed<D, kB, kThreads>(q_t, qb, qs.s, q0, sq);
      ptt::stage_transposed<D, kB, kThreads>(do_t, dob, dos.s, q0, sq);
      ptt::stage_rows<D, kB, kThreads>(q_s, qb, qs.s, q0, sq);
      ptt::stage_rows<D, kB, kThreads>(do_s, dob, dos.s, q0, sq);
      if (tid < kB) {
        const bool in = q0 + tid < sq;
        lse_s[tid] = in ? lse[row0 + q0 + tid] : 0.f;
        delta_s[tid] = in ? delta[row0 + q0 + tid] : 0.f;
      }
      __syncthreads();

      // transposed scores: s[i][j] for key ty + 16 i, query tx + 16 j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = __bfloat162float(k_t[d * kB + ty + 16 * i]);
          vv[i] = __bfloat162float(v_t[d * kB + ty + 16 * i]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = __bfloat162float(q_t[d * kB + tx + 16 * j]);
          dov[j] = __bfloat162float(do_t[d * kB + tx + 16 * j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = tx + 16 * j, qpos = q0 + qi;
          const bool valid = qpos < sq && kpos < sk &&
                             (!causal || kpos <= qpos + offset);
          const bool keep = drop.on && drop.keep(hkey, qpos, kpos);
          float pd, ds;
          p_and_ds(s[i][j], dp[i][j], lse_s[qi], delta_s[qi], valid, keep,
                   drop, scale, &pd, &ds);
          p_s[(ty + 16 * i) * kPStride + qi] = pd;
          ds_s[(ty + 16 * i) * kPStride + qi] = ds;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < kB; ++qq) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = p_s[(ty + 16 * i) * kPStride + qq];
          dsv[i] = ds_s[(ty + 16 * i) * kPStride + qq];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float dov = __bfloat162float(do_s[qq * D + tx + 16 * c]);
          const float qv = __bfloat162float(q_s[qq * D + tx + 16 * c]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][c] = fmaf(pv[i], dov, acc_v[i][c]);
            acc_k[i][c] = fmaf(dsv[i], qv, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= sk) continue;
    __nv_bfloat16* krow = dk + b * dks.b + kpos * dks.s + hk * dks.h;
    __nv_bfloat16* vrow = dv + b * dvs.b + kpos * dvs.s + hk * dvs.h;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      krow[tx + 16 * c] = __float2bfloat16(acc_k[i][c] * scale);
      vrow[tx + 16 * c] = __float2bfloat16(acc_v[i][c]);
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int batch, int sq, int sk, int hq, int hkv,
                      Strides qs, Strides ks, Strides vs, Strides dos,
                      Strides dqs, float scale, int causal, ptt::Dropout drop,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kB - 1) / kB, hq, batch);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), qs, ks, vs, dos, dqs, sq, sk, hq,
      hq / hkv, scale, causal, drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int batch, int sq, int sk, int hq,
                       int hkv, Strides qs, Strides ks, Strides vs,
                       Strides dos, Strides dks, Strides dvs, float scale,
                       int causal, ptt::Dropout drop, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + kB - 1) / kB, hkv, batch);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), qs,
      ks, vs, dos, dks, dvs, sq, sk, hq, hq / hkv, scale, causal, drop);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements; q/k/v/dO rows must be 16-byte aligned (the
// wrapper checks); lse and delta are contiguous [B, Hq, Sq] fp32. Dropout:
// seed, keep threshold, 1 / (1 - p), on (see ptt::Dropout). Each returns
// cudaGetLastError() after its launch.
extern "C" int flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int sq, int sk,
    int hq, int hkv, int d, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long dosb, long long doss, long long dosh,
    long long dqsb, long long dqss, long long dqsh, float scale, int causal,
    unsigned int seed, unsigned int thresh, float drop_scale, int dropout,
    void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      dos{dosb, doss, dosh}, dqs{dqsb, dqss, dqsh};
  const ptt::Dropout drop{seed, thresh, drop_scale, dropout};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, batch, sq, sk, hq,
                           hkv, qs, ks, vs, dos, dqs, scale, causal, drop, st);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, batch, sq, sk, hq,
                            hkv, qs, ks, vs, dos, dqs, scale, causal, drop,
                            st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch, int sq,
    int sk, int hq, int hkv, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long dosb, long long doss,
    long long dosh, long long dksb, long long dkss, long long dksh,
    long long dvsb, long long dvss, long long dvsh, float scale, int causal,
    unsigned int seed, unsigned int thresh, float drop_scale, int dropout,
    void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh},
      dos{dosb, doss, dosh}, dks{dksb, dkss, dksh}, dvs{dvsb, dvss, dvsh};
  const ptt::Dropout drop{seed, thresh, drop_scale, dropout};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, batch, sq, sk,
                            hq, hkv, qs, ks, vs, dos, dks, dvs, scale, causal,
                            drop, st);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, batch, sq, sk,
                             hq, hkv, qs, ks, vs, dos, dks, dvs, scale, causal,
                             drop, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
