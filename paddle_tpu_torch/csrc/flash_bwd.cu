// Flash attention backward for Hopper (sm_90a): flash_bwd_dq and
// flash_bwd_dkv, on the tensor cores.
//
// Replaces paddle_tpu/ops/flash_attention_kernel.py::_bwd_dq_kernel and
// ::_bwd_dkv_kernel, launched by _bwd_impl through pl.pallas_call
// (flash_attention_kernel.py:497 and :519).
//
// For q [B, Sq, Hq, D], k, v [B, Sk, Hkv, D], dO [B, Sq, Hq, D] in bf16 or
// fp16 (any batch/sequence/head strides, unit stride on D; fp32 is
// flash_f32.cu), the forward's lse and delta = rowsum(dO * O) ([B, Hq, Sq]
// fp32, contiguous):
//   P  = exp(q k^T * scale - lse), 0 where masked (rows with no key included)
//   dP = dO v^T
//   dS = P (dP - delta), or with dropout P_drop dP - P delta
//   dq = rnd(dS) k * scale                      (flash_bwd_dq)
//   dk = sum over the GQA group of rnd(dS)^T q * scale,
//   dv = sum over the GQA group of rnd(P_drop)^T dO  (flash_bwd_dkv)
// with P_drop = P * keep / (1 - p) from the forward's hash (ptt::Dropout).
// rnd rounds P_drop and dS to the input dtype before the second products,
// as the JAX kernels do (:405, :455, :458); every product sums in fp32,
// outputs are in the input dtype. Causal masks are bottom-right aligned
// (query i attends keys <= i + Sk - Sq), as in K3.
//
// What bounds them: operations. Per causal (query, key) pair dq does 3
// products of 2 D flops (6 D) and dk/dv 4 (8 D), on a few S x D bf16 arrays
// per (batch, head): at training lengths hundreds of flops per byte, far
// above the card's ridge, so the bound is the bf16 tensor-core rate (989
// TFLOP/s dense).
//
// Design. Every product is an mma.sync m16n8k16 with fp32 accumulators
// (csrc/mma.cuh), and a warp owns 16 rows of the block's 64: query rows in
// flash_bwd_dq, key rows in flash_bwd_dkv.
// - flash_bwd_dq: one block per (query head, batch, 64-query tile) keeps its
//   Q and dO tiles in shared memory and walks the 64-key tiles up to the
//   causal diagonal, K and V streamed through two cp.async buffers (the next
//   tile loads while this one multiplies). Per tile a warp forms S = Q K^T
//   and dP = dO V^T (16 x 64 each) in registers, turns them into dS there,
//   rounds it to bf16 straight into the A fragments of dq += dS K, and keeps
//   dq (16 x D fp32) in registers for the whole walk.
// - flash_bwd_dkv: one block per (kv head, batch, 64-key tile) keeps its K
//   and V tiles in shared memory and walks every query head of its GQA group
//   and every query tile at or below the diagonal, Q, dO, lse and delta
//   streamed through two cp.async buffers. A warp forms S^T = K Q^T and
//   dP^T = V dO^T for 32 queries at a time (the 64-query tile in two halves,
//   so S^T, dP^T and the dk/dv accumulators, 2 x 16 x D fp32, stay in
//   registers) and feeds P_drop^T and dS^T, in bf16, to dv += P_drop^T dO
//   and dk += dS^T Q. The walk over the group and the query tiles takes the
//   place of the TPU's (g, iq)-innermost grid: dk and dv are summed in one
//   block in a fixed order, with no atomics, so a launch is deterministic.
// Operand orientations come from ldmatrix with or without .trans on the
// row-major [rows][D] tiles: no tile is transposed in memory or staged
// twice. Shared rows are padded by 16 bytes (conflict-free ldmatrix); one
// block takes 102-103 KB at D = 128, so two blocks share an SM. Only the
// tiles the causal diagonal or a ragged edge cuts test each entry; tiles
// wholly above the diagonal are skipped per warp. The blocks of the
// heaviest causal tiles (last query tiles, first key tiles) launch first.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a block owns: queries or keys
constexpr int kTile = 64;           // rows of each streamed tile
constexpr int kHalf = 32;           // flash_bwd_dkv: queries per score pass
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;
};

using ptt::accumulate;
using ptt::pitch;
using ptt::store_rows;
using ptt::to_a_frags;

template <int D>
constexpr size_t dq_smem_bytes() {  // q_s, do_s; k_s, v_s double-buffered
  return 2 * (2 * kRows + 4 * kTile) * pitch<D>();
}

template <int D>
constexpr size_t dkv_smem_bytes() {  // k_s, v_s; q_s, do_s, lse_s, dl_s x2
  return 2 * (2 * kRows + 4 * kTile) * pitch<D>() +
         sizeof(float) * 4 * kTile;
}

// 4 bytes from global to shared memory, asynchronously (lse and delta rows
// need not be 16-byte aligned); src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   ptt::smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// Two 16-row products over D whose B operands share their rows: c0 += A0
// B0^T and c1 += A1 B1^T, where A0, A1 are the warp's 16 rows (a_row0..) of
// the [rows][P] tiles a0, a1, and B0, B1 rows b_row0.. b_row0 + 8 N - 1 of
// the [rows][P] tiles b0, b1 (non-transposed ldmatrix gives the
// column-major B fragment of a row-major [n][k] tile).
template <typename T, int D, int N>
__device__ __forceinline__ void scores(const T* a0, const T* a1, int a_row0,
                                       const T* b0, const T* b1, int b_row0,
                                       float (&c0)[N][4], float (&c1)[N][4]) {
  constexpr int P = pitch<D>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c0[j][e] = c1[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t f0[4], f1[4];
    const int ar = a_row0 + (lane & 15), ac = kk * 16 + (lane >> 4) * 8;
    ptt::ldmatrix_x4(f0, a0 + ar * P + ac);
    ptt::ldmatrix_x4(f1, a1 + ar * P + ac);
#pragma unroll
    for (int jp = 0; jp < N / 2; ++jp) {
      const int br = b_row0 + jp * 16 + (lane & 7) + (lane >> 4) * 8;
      const int bc = kk * 16 + ((lane >> 3) & 1) * 8;
      uint32_t r0[4], r1[4];
      ptt::ldmatrix_x4(r0, b0 + br * P + bc);
      ptt::ldmatrix_x4(r1, b1 + br * P + bc);
      ptt::mma_16816<T>(c0[2 * jp], f0, r0[0], r0[1]);
      ptt::mma_16816<T>(c0[2 * jp + 1], f0, r0[2], r0[3]);
      ptt::mma_16816<T>(c1[2 * jp], f1, r1[0], r1[1]);
      ptt::mma_16816<T>(c1[2 * jp + 1], f1, r1[2], r1[3]);
    }
  }
}

// P_drop and dS of one score entry from the raw score s = q.k and dp = dO.v
// (see the header); lse2 is lse * log2(e), scale2 the softmax scale times
// log2(e).
__device__ __forceinline__ void p_and_ds(float s, float dp, float lse2,
                                         float delta, float scale2,
                                         bool valid, bool keep,
                                         const ptt::Dropout& drop, float* pd,
                                         float* ds) {
  const float p = valid ? exp2f(fmaf(s, scale2, -lse2)) : 0.f;
  if (drop.on) {
    *pd = keep ? p * drop.scale : 0.f;
    *ds = *pd * dp - p * delta;
  } else {
    *pd = p;
    *ds = p * (dp - delta);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    T* __restrict__ dq, Strides qs, Strides ks,
                    Strides vs, Strides dos, Strides dqs, int sq, int sk,
                    int hq, int group, float scale, int causal,
                    ptt::Dropout drop) {
  constexpr int P = pitch<D>();
  constexpr int kN = kTile / 8;  // n-tiles of a score row
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);  // [kRows][P]
  T* do_s = q_s + kRows * P;            // [kRows][P]
  T* k_s = do_s + kRows * P;            // [2][kTile][P]
  T* v_s = k_s + 2 * kTile * P;         // [2][kTile][P]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // heavy tiles first
  const int qw0 = q0 + warp * 16;                        // the warp's rows
  const int offset = sk - sq;
  const T* kb = k + b * ks.b + (h / group) * ks.h;
  const T* vb = v + b * vs.b + (h / group) * vs.h;

  int n_tiles = (sk + kTile - 1) / kTile;
  if (causal) {  // tiles above the diagonal hold no valid key (:408-412)
    const int last_key = q0 + kRows - 1 + offset;
    n_tiles = min(n_tiles, last_key < 0 ? 0 : last_key / kTile + 1);
  }

  ptt::stage_tile<kRows, D, P, kThreads>(q_s, q + b * qs.b + h * qs.h, qs.s,
                                         q0, sq, 0, D, true);
  ptt::stage_tile<kRows, D, P, kThreads>(
      do_s, dout + b * dos.b + h * dos.h, dos.s, q0, sq, 0, D, true);
  auto stage_kv = [&](int t) {
    const int off = (t & 1) * kTile * P;
    ptt::stage_tile<kTile, D, P, kThreads>(k_s + off, kb, ks.s, t * kTile,
                                           sk, 0, D, true);
    ptt::stage_tile<kTile, D, P, kThreads>(v_s + off, vb, vs.s, t * kTile,
                                           sk, 0, D, true);
  };
  if (n_tiles > 0) stage_kv(0);
  ptt::cp_async_commit();

  // this thread's two rows: qw0 + g and qw0 + g + 8
  const uint32_t hkey = drop.head_key(b, h);
  float lse2[2], dlt[2];
  uint32_t row_hash[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qw0 + g + 8 * r;
    const long long row = (static_cast<long long>(b) * hq + h) * sq + qpos;
    lse2[r] = qpos < sq ? lse[row] * kLog2e : 0.f;
    dlt[r] = qpos < sq ? delta[row] : 0.f;
    row_hash[r] = ptt::mix(static_cast<uint32_t>(qpos) + hkey);
  }
  const float scale2 = scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) stage_kv(t + 1);
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();  // tile t (and Q, dO) have landed
    __syncthreads();
    const int k0 = t * kTile;
    const T* kt = k_s + (t & 1) * kTile * P;
    const T* vt = v_s + (t & 1) * kTile * P;
    // warp-uniform: skip a tile wholly above the diagonal or past Sq
    if (qw0 < sq && !(causal && k0 > qw0 + 15 + offset)) {
      float s[kN][4], dp[kN][4];
      scores<T, D, kN>(q_s, do_s, warp * 16, kt, vt, 0, s, dp);
      const bool edge = qw0 + 15 >= sq || k0 + kTile > sk ||
                        (causal && k0 + kTile - 1 > qw0 + offset);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int qpos = qw0 + g + 8 * r, kpos = k0 + 8 * j + c2 + (e & 1);
          const bool valid = !edge || (qpos < sq && kpos < sk &&
                                       (!causal || kpos <= qpos + offset));
          const bool keep =
              drop.on && ptt::mix(row_hash[r] ^ static_cast<uint32_t>(kpos)) >=
                             drop.thresh;
          float pd;
          p_and_ds(s[j][e], dp[j][e], lse2[r], dlt[r], scale2, valid, keep,
                   drop, &pd, &dp[j][e]);
        }
      }
      uint32_t a_ds[kN / 2][4];
      to_a_frags<T, kN>(dp, a_ds);
      accumulate<T, D, kN / 2>(a_ds, kt, 0, acc);
    }
    __syncthreads();  // the next stage overwrites this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qw0 + g + 8 * r;
    if (qpos < sq)
      store_rows<T, D>(dq + b * dqs.b + qpos * dqs.s + h * dqs.h, r, acc,
                       scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, Strides qs,
                     Strides ks,
                     Strides vs, Strides dos, Strides dks, Strides dvs,
                     int sq, int sk, int hq, int group, float scale,
                     int causal, ptt::Dropout drop) {
  constexpr int P = pitch<D>();
  constexpr int kN = kHalf / 8;  // n-tiles of a score pass
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);  // [kRows][P]
  T* v_s = k_s + kRows * P;             // [kRows][P]
  T* q_s = v_s + kRows * P;             // [2][kTile][P]
  T* do_s = q_s + 2 * kTile * P;        // [2][kTile][P]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTile * P);  // [2][kTile]
  float* dl_s = lse_s + 2 * kTile;                                // [2][kTile]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kRows;  // the first key tiles are the heaviest
  const int kw0 = k0 + warp * 16;     // the warp's keys
  const int offset = sk - sq;

  ptt::stage_tile<kRows, D, P, kThreads>(k_s, k + b * ks.b + hk * ks.h, ks.s,
                                         k0, sk, 0, D, true);
  ptt::stage_tile<kRows, D, P, kThreads>(v_s, v + b * vs.b + hk * vs.h, vs.s,
                                         k0, sk, 0, D, true);

  // the walk: (group head gg, query tile iq) for iq from the first tile
  // with a query at or below this key tile (:461-465)
  const int n_qtiles = (sq + kTile - 1) / kTile;
  const int iq0 = causal && k0 > offset ? min((k0 - offset) / kTile, n_qtiles)
                                        : 0;
  const int per_head = n_qtiles - iq0;
  const int n_items = group * per_head;
  auto stage_q = [&](int it) {
    const int hh = hk * group + it / per_head;
    const int qq0 = (iq0 + it % per_head) * kTile;
    const int buf = it & 1;
    ptt::stage_tile<kTile, D, P, kThreads>(q_s + buf * kTile * P,
                                           q + b * qs.b + hh * qs.h, qs.s,
                                           qq0, sq, 0, D, true);
    ptt::stage_tile<kTile, D, P, kThreads>(do_s + buf * kTile * P,
                                           dout + b * dos.b + hh * dos.h,
                                           dos.s, qq0, sq, 0, D, true);
    const long long row0 = (static_cast<long long>(b) * hq + hh) * sq + qq0;
    for (int i = threadIdx.x; i < 2 * kTile; i += kThreads) {
      const int r = i % kTile;
      const bool in = qq0 + r < sq;
      const float* src = (i < kTile ? lse : delta) + (in ? row0 + r : 0);
      float* dst = (i < kTile ? lse_s : dl_s) + buf * kTile + r;
      cp_async4(dst, src, in ? 4 : 0);
    }
  };
  if (n_items > 0) stage_q(0);
  ptt::cp_async_commit();

  const float scale2 = scale * kLog2e;
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  for (int it = 0; it < n_items; ++it) {
    if (it + 1 < n_items) stage_q(it + 1);
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();  // item it (and K, V) have landed
    __syncthreads();
    const int hh = hk * group + it / per_head;
    const int qq0 = (iq0 + it % per_head) * kTile;
    const int buf = it & 1;
    const T* qt = q_s + buf * kTile * P;
    const T* dot = do_s + buf * kTile * P;
    const float* lt = lse_s + buf * kTile;
    const float* dlt = dl_s + buf * kTile;
    const uint32_t hkey = drop.head_key(b, hh);

#pragma unroll 1
    for (int half = 0; half < kTile / kHalf; ++half) {
      const int qa = qq0 + half * kHalf, qb = qa + kHalf - 1;
      // warp-uniform: skip a pass wholly above the diagonal or past the end
      if (kw0 >= sk || qa >= sq || (causal && kw0 > qb + offset)) continue;
      float st[kN][4], dpt[kN][4];
      scores<T, D, kN>(k_s, v_s, warp * 16, qt, dot, half * kHalf, st, dpt);
      const bool edge = kw0 + 15 >= sk || qb >= sq ||
                        (causal && kw0 + 15 > qa + offset);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {  // this thread's two query columns
          const int ql = half * kHalf + 8 * j + c2 + cc, qpos = qq0 + ql;
          const float lse2 = lt[ql] * kLog2e, dl = dlt[ql];
          const uint32_t col_hash =
              drop.on ? ptt::mix(static_cast<uint32_t>(qpos) + hkey) : 0u;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int e = 2 * r + cc, kpos = kw0 + g + 8 * r;
            const bool valid = !edge || (qpos < sq && kpos < sk &&
                                         (!causal || kpos <= qpos + offset));
            const bool keep =
                drop.on && ptt::mix(col_hash ^ static_cast<uint32_t>(kpos)) >=
                               drop.thresh;
            p_and_ds(st[j][e], dpt[j][e], lse2, dl, scale2, valid, keep,
                     drop, &st[j][e], &dpt[j][e]);
          }
        }
      }
      uint32_t a_p[kN / 2][4], a_ds[kN / 2][4];
      to_a_frags<T, kN>(st, a_p);
      to_a_frags<T, kN>(dpt, a_ds);
      accumulate<T, D, kN / 2>(a_p, dot, half * kHalf, acc_v);
      accumulate<T, D, kN / 2>(a_ds, qt, half * kHalf, acc_k);
    }
    __syncthreads();  // the next stage overwrites this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = kw0 + g + 8 * r;
    if (kpos < sk) {
      store_rows<T, D>(dk + b * dks.b + kpos * dks.s + hk * dks.h, r, acc_k,
                    scale);
      store_rows<T, D>(dv + b * dvs.b + kpos * dvs.s + hk * dvs.h, r, acc_v,
                    1.f);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  // room for two blocks per SM
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int batch, int sq, int sk, int hq, int hkv,
                      Strides qs, Strides ks, Strides vs, Strides dos,
                      Strides dqs, float scale, int causal, ptt::Dropout drop,
                      cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  cudaError_t err = set_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(hq, batch, (sq + kRows - 1) / kRows);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), qs, ks, vs, dos, dqs, sq, sk, hq, hq / hkv, scale,
      causal, drop);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int batch, int sq, int sk, int hq,
                       int hkv, Strides qs, Strides ks, Strides vs,
                       Strides dos, Strides dks, Strides dvs, float scale,
                       int causal, ptt::Dropout drop, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = set_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(hkv, batch, (sk + kRows - 1) / kRows);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), qs, ks, vs, dos, dks, dvs, sq,
      sk, hq, hq / hkv, scale, causal, drop);
  return cudaGetLastError();
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, int batch,
                int sq, int sk, int hq, int hkv, int d,
                const long long (&st)[15], float scale, int causal,
                ptt::Dropout drop, void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, dos{st[9], st[10], st[11]},
      dqs{st[12], st[13], st[14]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, batch, sq, sk,
                              hq, hkv, qs, ks, vs, dos, dqs, scale, causal,
                              drop, s);
    case 128:
      return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, batch, sq, sk,
                               hq, hkv, qs, ks, vs, dos, dqs, scale, causal,
                               drop, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int batch, int sq, int sk, int hq,
                 int hkv, int d, const long long (&st)[18], float scale,
                 int causal, ptt::Dropout drop, void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, dos{st[9], st[10], st[11]},
      dks{st[12], st[13], st[14]}, dvs{st[15], st[16], st[17]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, batch, sq,
                               sk, hq, hkv, qs, ks, vs, dos, dks, dvs, scale,
                               causal, drop, s);
    case 128:
      return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, batch, sq,
                                sk, hq, hkv, qs, ks, vs, dos, dks, dvs, scale,
                                causal, drop, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides are in elements; q/k/v/dO rows must be 16-byte aligned and every
// non-unit stride a multiple of 8 elements (the wrapper checks); dq, dk, dv
// rows 4-byte aligned; lse and delta are contiguous [B, Hq, Sq] fp32; d is
// 64 or 128 (the wrapper zero-pads other head dims). Dropout: seed, keep
// threshold, 1 / (1 - p), on (see ptt::Dropout). Each returns
// cudaGetLastError() after its launch. The *_bf16 entry points take bf16
// tensors, the *_f16 ones fp16.
#define FLASH_BWD_DQ_ENTRY(NAME, T)                                          \
  extern "C" int NAME(                                                       \
      const void* q, const void* k, const void* v, const void* dout,         \
      const void* lse, const void* delta, void* dq, int batch, int sq,       \
      int sk, int hq, int hkv, int d, long long qsb, long long qss,          \
      long long qsh, long long ksb, long long kss, long long ksh,            \
      long long vsb, long long vss, long long vsh, long long dosb,           \
      long long doss, long long dosh, long long dqsb, long long dqss,        \
      long long dqsh, float scale, int causal, unsigned int seed,            \
      unsigned int thresh, float drop_scale, int dropout, void* stream) {    \
    const long long st[15] = {qsb, qss,  qsh,  ksb,  kss,  ksh,  vsb,  vss,  \
                              vsh, dosb, doss, dosh, dqsb, dqss, dqsh};      \
    return dispatch_dq<T>(q, k, v, dout, lse, delta, dq, batch, sq, sk, hq,  \
                          hkv, d, st, scale, causal,                         \
                          ptt::Dropout{seed, thresh, drop_scale, dropout},   \
                          stream);                                           \
  }

#define FLASH_BWD_DKV_ENTRY(NAME, T)                                         \
  extern "C" int NAME(                                                       \
      const void* q, const void* k, const void* v, const void* dout,         \
      const void* lse, const void* delta, void* dk, void* dv, int batch,     \
      int sq, int sk, int hq, int hkv, int d, long long qsb, long long qss,  \
      long long qsh, long long ksb, long long kss, long long ksh,            \
      long long vsb, long long vss, long long vsh, long long dosb,           \
      long long doss, long long dosh, long long dksb, long long dkss,        \
      long long dksh, long long dvsb, long long dvss, long long dvsh,        \
      float scale, int causal, unsigned int seed, unsigned int thresh,       \
      float drop_scale, int dropout, void* stream) {                         \
    const long long st[18] = {qsb,  qss,  qsh,  ksb,  kss,  ksh,             \
                              vsb,  vss,  vsh,  dosb, doss, dosh,            \
                              dksb, dkss, dksh, dvsb, dvss, dvsh};           \
    return dispatch_dkv<T>(q, k, v, dout, lse, delta, dk, dv, batch, sq, sk, \
                           hq, hkv, d, st, scale, causal,                    \
                           ptt::Dropout{seed, thresh, drop_scale, dropout},  \
                           stream);                                          \
  }

FLASH_BWD_DQ_ENTRY(flash_bwd_dq_bf16, __nv_bfloat16)
FLASH_BWD_DQ_ENTRY(flash_bwd_dq_f16, __half)
FLASH_BWD_DKV_ENTRY(flash_bwd_dkv_bf16, __nv_bfloat16)
FLASH_BWD_DKV_ENTRY(flash_bwd_dkv_f16, __half)
