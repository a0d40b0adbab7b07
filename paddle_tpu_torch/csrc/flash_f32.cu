// The fp32 instances of K3 (flash forward), K5 (flash_bwd_dq) and K6
// (flash_bwd_dkv) for Hopper (sm_90a), on the CUDA cores.
//
// Replace paddle_tpu/ops/flash_attention_kernel.py::_fwd_kernel,
// ::_bwd_dq_kernel and ::_bwd_dkv_kernel (pallas_calls at :331, :497, :519)
// for fp32 inputs, which the JAX kernels run natively and round nothing in.
// The bf16 instances are flash_fwd.cu and flash_bwd.cu; these compute the
// same functions (see their headers) with every product an fp32 FMA, so P
// and dS stay fp32 as in the JAX kernels at fp32. The tensor cores would
// have to take fp32 as TF32 and lose the fp32 product.
//
// What bounds them: operations, at the card's fp32 rate (67 TFLOP/s):
// 4 D flops per causal (query, key) pair forward, 6 D for dq, 8 D for dk/dv.
//
// Design: 64 x 64 tiles, 256 threads; thread (ty, tx) = (tid / 16, tid % 16)
// owns score rows ty + 16 i and columns tx + 16 j (i, j < 4), and output
// rows ty + 16 i, columns tx + 16 c. Every operand tile is staged once,
// row-major, with a row pitch of D + 1 floats: a half-warp reading one
// column of 16 rows and a half-warp reading 16 consecutive columns of one
// row both hit 16 different banks, so the score loops (along D) and the
// accumulation loops (along rows) read the same tile without conflicts.
// Score and probability tiles go through shared memory with a row stride
// of 80 floats (the two rows a warp touches fall in disjoint banks).
// - flash_fwd_f32: one block per (64-query tile, query head, batch) walks
//   the 64-key tiles up to the causal diagonal with an online softmax.
//   flash_fwd_prefix_f32 is its prefix-chunk instance (kPos), the fp32 twin
//   of flash_fwd.cu's: the diagonal's offset read from *pos on the device,
//   the keys capped at min(Sk, *pos + Sq).
// - flash_bwd_dq_f32: one block per (64-query tile, query head, batch)
//   walks the key tiles, keeping dq in registers.
// - flash_bwd_dkv_f32: one block per (64-key tile, kv head, batch) walks
//   every query head of its GQA group and every query tile at or below the
//   diagonal, keeping dk and dv in registers: no atomics.
// Shared memory at D = 128: 119,552 / 152,576 / 173,568 bytes (one block an
// SM). Simple, right and slow: the fp32 path is for checking and for
// models that train in fp32, not for speed.
#include "common.cuh"

namespace {

constexpr int kB = 64;  // queries and keys per tile
constexpr int kThreads = 256;
constexpr int kPStride = 80;  // row stride of the score tiles

struct Strides {
  long long b, s, h;
};

template <int D>
__host__ __device__ constexpr int pitch() {
  return D + 1;
}

// Rows [r0, r0 + kB) of a [*, D] fp32 operand (unit stride on D) into a
// [kB][D + 1] tile, zero past `limit`.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long row_stride, int r0,
                                      int limit) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * pitch<D>() + c] = r0 + r < limit ? src[(r0 + r) * row_stride + c]
                                             : 0.f;
  }
}

// s[i][j] (+)= sum over D of a[ty + 16 i] . b[tx + 16 j]: two tiles of
// pitch D + 1, rows of a by ty, rows of b by tx.
template <int D>
__device__ __forceinline__ void dots(const float* a, const float* b, int ty,
                                     int tx, float (&s)[4][4]) {
  constexpr int P = pitch<D>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * P + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * P + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][c] += sum over the tile's 64 columns of w[ty + 16 i][col] *
// b[col][tx + 16 c]: w a [kB][kPStride] score tile, b a tile of pitch D + 1.
template <int D>
__device__ __forceinline__ void accumulate(const float* w, const float* b,
                                           int ty, int tx,
                                           float (&acc)[4][D / 16]) {
#pragma unroll 4
  for (int col = 0; col < kB; ++col) {
    float wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = w[(ty + 16 * i) * kPStride + col];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float bv = b[col * pitch<D>() + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(wv[i], bv, acc[i][c]);
    }
  }
}

// max / sum over the 16 lanes that share a row (a half-warp)
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

// P_drop and dS of one score entry from the raw score s = q.k and dp = dO.v
__device__ __forceinline__ void p_and_ds(float s, float dp, float lse,
                                         float delta, float scale, bool valid,
                                         bool keep, const ptt::Dropout& drop,
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
constexpr size_t fwd_smem() {  // q_s, k_s, v_s; p_s
  return sizeof(float) * (3 * kB * pitch<D>() + kB * kPStride);
}
template <int D>
constexpr size_t dq_smem() {  // q_s, do_s, k_s, v_s; ds_s
  return sizeof(float) * (4 * kB * pitch<D>() + kB * kPStride);
}
template <int D>
constexpr size_t dkv_smem() {  // k_s, v_s, q_s, do_s; p_s, ds_s; lse, delta
  return sizeof(float) * (4 * kB * pitch<D>() + 2 * kB * kPStride + 2 * kB);
}

template <int D, bool kPos>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ pos,
                     Strides qs, Strides ks, Strides vs, Strides os, int sq,
                     int sk_cap, int hq, int group, float scale, int causal,
                     ptt::Dropout drop) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [kB][D + 1]
  float* k_s = q_s + kB * pitch<D>();           // [kB][D + 1]
  float* v_s = k_s + kB * pitch<D>();           // [kB][D + 1]
  float* p_s = v_s + kB * pitch<D>();           // [kB][kPStride]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int offset = kPos ? *pos : sk_cap - sq;
  const int sk = kPos ? min(sk_cap, offset + sq) : sk_cap;
  const float* kb = k + b * ks.b + (h / group) * ks.h;
  const float* vb = v + b * vs.b + (h / group) * vs.h;
  const uint32_t hkey = drop.head_key(b, h);
  stage<D>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, sq);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = ptt::kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (sk + kB - 1) / kB;
  if (causal) {
    const int last_key = q0 + kB - 1 + offset;
    n_tiles = min(n_tiles, last_key < 0 ? 0 : last_key / kB + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();  // the previous tile's readers are done
    stage<D>(k_s, kb, ks.s, k0, sk);
    stage<D>(v_s, vb, vs.s, k0, sk);
    __syncthreads();
    float s[4][4];
    dots<D>(q_s, k_s, ty, tx, s);
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
    accumulate<D>(p_s, v_s, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    float* orow = o + b * os.b + qpos * os.s + h * os.h;
#pragma unroll
    for (int c = 0; c < kCols; ++c) orow[tx + 16 * c] = acc[i][c] / l_safe;
    if (tx == 0)
      lse[(static_cast<long long>(b) * hq + h) * sq + qpos] =
          m[i] + logf(l_safe);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, Strides qs, Strides ks,
                        Strides vs, Strides dos, Strides dqs, int sq, int sk,
                        int hq, int group, float scale, int causal,
                        ptt::Dropout drop) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [kB][D + 1]
  float* do_s = q_s + kB * pitch<D>();          // [kB][D + 1]
  float* k_s = do_s + kB * pitch<D>();          // [kB][D + 1]
  float* v_s = k_s + kB * pitch<D>();           // [kB][D + 1]
  float* ds_s = v_s + kB * pitch<D>();          // [kB][kPStride]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int offset = sk - sq;
  const float* kb = k + b * ks.b + (h / group) * ks.h;
  const float* vb = v + b * vs.b + (h / group) * vs.h;
  const uint32_t hkey = drop.head_key(b, h);
  stage<D>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, sq);
  stage<D>(do_s, dout + b * dos.b + h * dos.h, dos.s, q0, sq);

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
  if (causal) {  // tiles above the diagonal hold no valid key
    const int last_key = q0 + kB - 1 + offset;
    n_tiles = min(n_tiles, last_key < 0 ? 0 : last_key / kB + 1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kB;
    __syncthreads();
    stage<D>(k_s, kb, ks.s, k0, sk);
    stage<D>(v_s, vb, vs.s, k0, sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    dots<D>(q_s, k_s, ty, tx, s);
    dots<D>(do_s, v_s, ty, tx, dp);
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
        p_and_ds(s[i][j], dp[i][j], lse_r[i], delta_r[i], scale, valid, keep,
                 drop, &pd, &ds);
        ds_s[(ty + 16 * i) * kPStride + tx + 16 * j] = ds;
      }
    }
    __syncthreads();
    accumulate<D>(ds_s, k_s, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= sq) continue;
    float* row = dq + b * dqs.b + qpos * dqs.s + h * dqs.h;
#pragma unroll
    for (int c = 0; c < kCols; ++c) row[tx + 16 * c] = acc[i][c] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         Strides qs, Strides ks, Strides vs, Strides dos,
                         Strides dks, Strides dvs, int sq, int sk, int hq,
                         int group, float scale, int causal,
                         ptt::Dropout drop) {
  constexpr int kCols = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);  // [kB][D + 1]
  float* v_s = k_s + kB * pitch<D>();           // [kB][D + 1]
  float* q_s = v_s + kB * pitch<D>();           // [kB][D + 1]
  float* do_s = q_s + kB * pitch<D>();          // [kB][D + 1]
  float* p_s = do_s + kB * pitch<D>();          // [kB keys][kPStride]
  float* ds_s = p_s + kB * kPStride;            // [kB keys][kPStride]
  float* lse_s = ds_s + kB * kPStride;          // [kB queries]
  float* delta_s = lse_s + kB;                  // [kB queries]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kB, hk = blockIdx.y, b = blockIdx.z;
  const int offset = sk - sq;
  stage<D>(k_s, k + b * ks.b + hk * ks.h, ks.s, k0, sk);
  stage<D>(v_s, v + b * vs.b + hk * vs.h, vs.s, k0, sk);

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int n_qtiles = (sq + kB - 1) / kB;
  for (int gg = 0; gg < group; ++gg) {
    const int h = hk * group + gg;
    const uint32_t hkey = drop.head_key(b, h);
    const float* qb = q + b * qs.b + h * qs.h;
    const float* dob = dout + b * dos.b + h * dos.h;
    const long long row0 = (static_cast<long long>(b) * hq + h) * sq;
    for (int iq = 0; iq < n_qtiles; ++iq) {
      const int q0 = iq * kB;
      // tiles whose every query sits above this key tile
      if (causal && k0 > q0 + kB - 1 + offset) continue;
      __syncthreads();  // the previous tile's readers are done
      stage<D>(q_s, qb, qs.s, q0, sq);
      stage<D>(do_s, dob, dos.s, q0, sq);
      if (tid < kB) {
        const bool in = q0 + tid < sq;
        lse_s[tid] = in ? lse[row0 + q0 + tid] : 0.f;
        delta_s[tid] = in ? delta[row0 + q0 + tid] : 0.f;
      }
      __syncthreads();

      // transposed scores: s[i][j] for key ty + 16 i, query tx + 16 j
      float s[4][4], dp[4][4];
      dots<D>(k_s, q_s, ty, tx, s);
      dots<D>(v_s, do_s, ty, tx, dp);
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
          p_and_ds(s[i][j], dp[i][j], lse_s[qi], delta_s[qi], scale, valid,
                   keep, drop, &pd, &ds);
          p_s[(ty + 16 * i) * kPStride + qi] = pd;
          ds_s[(ty + 16 * i) * kPStride + qi] = ds;
        }
      }
      __syncthreads();
      accumulate<D>(p_s, do_s, ty, tx, acc_v);
      accumulate<D>(ds_s, q_s, ty, tx, acc_k);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= sk) continue;
    float* krow = dk + b * dks.b + kpos * dks.s + hk * dks.h;
    float* vrow = dv + b * dvs.b + kpos * dvs.s + hk * dvs.h;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      krow[tx + 16 * c] = acc_k[i][c] * scale;
      vrow[tx + 16 * c] = acc_v[i][c];
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D, bool kPos>
cudaError_t launch_fwd(const float* q, const float* k, const float* v,
                       float* o, float* lse, const int* pos, int batch,
                       int sq, int sk, int hq, int hkv, Strides qs,
                       Strides ks, Strides vs, Strides os, float scale,
                       int causal, ptt::Dropout drop, cudaStream_t stream) {
  cudaError_t err = set_smem(flash_fwd_f32_kernel<D, kPos>, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kB - 1) / kB, hq, batch);
  flash_fwd_f32_kernel<D, kPos><<<grid, kThreads, fwd_smem<D>(), stream>>>(
      q, k, v, o, lse, pos, qs, ks, vs, os, sq, sk, hq, hq / hkv, scale,
      causal, drop);
  return cudaGetLastError();
}

template <bool kPos>
int dispatch_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, const int* pos, int batch, int sq, int sk, int hq,
                 int hkv, int d, const Strides (&st)[4], float scale,
                 int causal, ptt::Dropout drop, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float *fo = static_cast<float*>(o), *fl = static_cast<float*>(lse);
  switch (d) {
    case 64:
      return launch_fwd<64, kPos>(fq, fk, fv, fo, fl, pos, batch, sq, sk, hq,
                                  hkv, st[0], st[1], st[2], st[3], scale,
                                  causal, drop, s);
    case 128:
      return launch_fwd<128, kPos>(fq, fk, fv, fo, fl, pos, batch, sq, sk,
                                   hq, hkv, st[0], st[1], st[2], st[3],
                                   scale, causal, drop, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* delta,
                      float* dq, int batch, int sq, int sk, int hq, int hkv,
                      Strides qs, Strides ks, Strides vs, Strides dos,
                      Strides dqs, float scale, int causal, ptt::Dropout drop,
                      cudaStream_t stream) {
  cudaError_t err = set_smem(flash_bwd_dq_f32_kernel<D>, dq_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kB - 1) / kB, hq, batch);
  flash_bwd_dq_f32_kernel<D><<<grid, kThreads, dq_smem<D>(), stream>>>(
      q, k, v, dout, lse, delta, dq, qs, ks, vs, dos, dqs, sq, sk, hq,
      hq / hkv, scale, causal, drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const float* dout, const float* lse,
                       const float* delta, float* dk, float* dv, int batch,
                       int sq, int sk, int hq, int hkv, Strides qs,
                       Strides ks, Strides vs, Strides dos, Strides dks,
                       Strides dvs, float scale, int causal,
                       ptt::Dropout drop, cudaStream_t stream) {
  cudaError_t err = set_smem(flash_bwd_dkv_f32_kernel<D>, dkv_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + kB - 1) / kB, hkv, batch);
  flash_bwd_dkv_f32_kernel<D><<<grid, kThreads, dkv_smem<D>(), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, qs, ks, vs, dos, dks, dvs, sq, sk,
      hq, hq / hkv, scale, causal, drop);
  return cudaGetLastError();
}

}  // namespace

// The entry points take the arguments of flash_fwd_bf16, flash_bwd_dq_bf16
// and flash_bwd_dkv_bf16 with fp32 tensors: strides in elements, unit
// stride on D, d 64 or 128 (the wrapper zero-pads other head dims); lse and
// delta contiguous [B, Hq, Sq] fp32. Each returns cudaGetLastError() after
// its launch.
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, int batch, int sq, int sk,
                             int hq, int hkv, int d, long long qsb,
                             long long qss, long long qsh, long long ksb,
                             long long kss, long long ksh, long long vsb,
                             long long vss, long long vsh, long long osb,
                             long long oss, long long osh, float scale,
                             int causal, unsigned int seed,
                             unsigned int thresh, float drop_scale,
                             int dropout, void* stream) {
  const Strides st[4] = {{qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
                         {osb, oss, osh}};
  return dispatch_fwd<false>(q, k, v, o, lse, nullptr, batch, sq, sk, hq, hkv,
                             d, st, scale, causal,
                             ptt::Dropout{seed, thresh, drop_scale, dropout},
                             stream);
}

// K3's prefix-chunk instance in fp32: the arguments of flash_fwd_prefix_bf16
// (flash_fwd.cu) with fp32 tensors; pos is a device pointer to one int32.
extern "C" int flash_fwd_prefix_f32(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* pos, int batch, int sq, int sk, int hq, int hkv, int d,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, float scale, int, unsigned int,
    unsigned int, float, int, void* stream) {
  const Strides st[4] = {{qsb, qss, qsh}, {ksb, kss, ksh}, {vsb, vss, vsh},
                         {osb, oss, osh}};
  return dispatch_fwd<true>(q, k, v, o, lse, static_cast<const int*>(pos),
                            batch, sq, sk, hq, hkv, d, st, scale, 1,
                            ptt::Dropout{0u, 0u, 1.f, 0}, stream);
}

extern "C" int flash_bwd_dq_f32(
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
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v),
              *fdo = static_cast<const float*>(dout),
              *fl = static_cast<const float*>(lse),
              *fd = static_cast<const float*>(delta);
  float* fdq = static_cast<float*>(dq);
  switch (d) {
    case 64:
      return launch_dq<64>(fq, fk, fv, fdo, fl, fd, fdq, batch, sq, sk, hq,
                           hkv, qs, ks, vs, dos, dqs, scale, causal, drop, st);
    case 128:
      return launch_dq<128>(fq, fk, fv, fdo, fl, fd, fdq, batch, sq, sk, hq,
                            hkv, qs, ks, vs, dos, dqs, scale, causal, drop,
                            st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dkv_f32(
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
  const float *fq = static_cast<const float*>(q),
              *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v),
              *fdo = static_cast<const float*>(dout),
              *fl = static_cast<const float*>(lse),
              *fd = static_cast<const float*>(delta);
  float *fdk = static_cast<float*>(dk), *fdv = static_cast<float*>(dv);
  switch (d) {
    case 64:
      return launch_dkv<64>(fq, fk, fv, fdo, fl, fd, fdk, fdv, batch, sq, sk,
                            hq, hkv, qs, ks, vs, dos, dks, dvs, scale, causal,
                            drop, st);
    case 128:
      return launch_dkv<128>(fq, fk, fv, fdo, fl, fd, fdk, fdv, batch, sq,
                             sk, hq, hkv, qs, ks, vs, dos, dks, dvs, scale,
                             causal, drop, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
