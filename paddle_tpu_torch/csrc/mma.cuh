// Building blocks of the GEMM-shaped kernels (grad_add.cu,
// grouped_matmul.cu) and the flash kernels (flash_fwd.cu, flash_bwd.cu):
// staging into shared memory (cp.async, in common.cuh), ldmatrix fragment
// loads and the bf16 (or fp16) mma.sync m16n8k16 with fp32 accumulation
// (Ampere-style warp MMAs, which sm_90a runs; the GEMM kernels' Hopper
// instances are in wgmma.cuh); then the GEMM kernels' block raster and
// their fp32 tile on the CUDA cores.
#pragma once

#include "common.cuh"

namespace ptt {

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i (16 contiguous bytes each). Without .trans lane l receives, in r[i],
// row l/4, columns 2(l%4) and 2(l%4)+1 of matrix i; with .trans, rows
// 2(l%4) and 2(l%4)+1 of column l/4.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// d += a (16x16, row-major fragment) * b (16x8, column-major fragment),
// bf16 in, fp32 accumulate. Lane l = 4 g + c holds d[0..1] at row g,
// columns 2c and 2c+1, and d[2..3] at row g + 8.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same product with fp16 operands.
__device__ __forceinline__ void mma_f16_16816(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The product and the packing of two fp32 values for operands of type T
// (__nv_bfloat16 or __half).
template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1);
template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  mma_bf16_16816(d, a, b0, b1);
}
template <>
__device__ __forceinline__ void mma_16816<__half>(float (&d)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  mma_f16_16816(d, a, b0, b1);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo,
                                                         float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A [kRows][kCols] tile of a row-major operand of 2-byte elements (bf16 or
// fp16) into shared memory of row pitch kPitch elements: rows r0..,
// columns c0.., zero past (rows, cols). vec: the operand's rows are
// 16-byte aligned and cols % 8 == 0, so each 8-column chunk is wholly
// inside or outside and goes as one cp.async; otherwise element by element
// (plain loads and stores of the 16-bit patterns).
template <int kRows, int kCols, int kPitch, int kThreads, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, long long ld,
                                           int r0, int rows, int c0,
                                           int cols, bool vec) {
  static_assert(sizeof(T) == 2, "stage_tile moves 2-byte elements");
  constexpr int kChunks = kCols / 8;
  if (vec) {
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool in = r0 + r < rows && c0 + c < cols;
      const T* s = in ? src + (r0 + r) * ld + c0 + c : src;
      cp_async16(dst + r * kPitch + c, s, in ? 16 : 0);
    }
  } else {
    const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
    uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      d16[r * kPitch + c] = (r0 + r < rows && c0 + c < cols)
                                ? s16[(r0 + r) * ld + c0 + c]
                                : uint16_t{0};
    }
  }
}

// Row pitch, in elements, of a [rows][D] bf16 or fp16 tile of the flash
// kernels: 16 bytes of padding make ldmatrix conflict-free.
template <int D>
__host__ __device__ constexpr int pitch() {
  return D + 8;
}

// A fragments of a 16 x (8 N) operand of type T from the fp32
// accumulators of the product that made it, each value rounded to T: the
// accumulator layout of n-tiles 2k and 2k + 1 is the A layout of k-step k.
template <typename T, int N>
__device__ __forceinline__ void to_a_frags(const float (&c)[N][4],
                                           uint32_t (&a)[N / 2][4]) {
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    a[k][0] = pack2<T>(c[2 * k][0], c[2 * k][1]);
    a[k][1] = pack2<T>(c[2 * k][2], c[2 * k][3]);
    a[k][2] = pack2<T>(c[2 * k + 1][0], c[2 * k + 1][1]);
    a[k][3] = pack2<T>(c[2 * k + 1][2], c[2 * k + 1][3]);
  }
}

// acc[D / 8] += A (16 x 16 K, T fragments) x B, B rows b_row0.. b_row0 +
// 16 K - 1 of a row-major [rows][pitch<D>()] tile b_s (transposed ldmatrix
// gives the column-major B fragment of a row-major [k][n] tile).
template <typename T, int D, int K>
__device__ __forceinline__ void accumulate(const uint32_t (&a)[K][4],
                                           const T* b_s, int b_row0,
                                           float (&acc)[D / 8][4]) {
  constexpr int P = pitch<D>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      const int br = b_row0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int bc = np * 16 + (lane >> 4) * 8;
      uint32_t r[4];
      ldmatrix_x4_trans(r, b_s + br * P + bc);
      mma_16816<T>(acc[2 * np], a[kk], r[0], r[1]);
      mma_16816<T>(acc[2 * np + 1], a[kk], r[2], r[3]);
    }
  }
}

// Row g (half 0) or g + 8 (half 1) of a 16-row fp32 accumulator [D / 8][4]
// to T with a scale: lane 4 g + c holds row g (e = 0, 1) and row g + 8 (e =
// 2, 3), columns 8 j + 2 c and 8 j + 2 c + 1.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* row, int half,
                                           const float (&acc)[D / 8][4],
                                           float scale) {
  const int c2 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    *reinterpret_cast<uint32_t*>(row + 8 * j + c2) =
        pack2<T>(acc[j][2 * half] * scale, acc[j][2 * half + 1] * scale);
}

// -- GEMM kernels (K9, K10): block raster ------------------------------------

// Block b of a grid of tiles_m x tiles_n output tiles, walked in bands of
// kBand row tiles: within a band the column tiles are the outer loop and
// the band's row tiles the inner one, so the blocks in flight together
// share the band's A rows and each column's B slab (read from memory once,
// then from L2).
constexpr int kBand = 8;
__device__ __forceinline__ void band_raster(int b, int tiles_m, int tiles_n,
                                            int& tm, int& tn) {
  const int per_band = kBand * tiles_n;
  const int band = b / per_band, rest = b - band * per_band;
  const int rows = min(kBand, tiles_m - band * kBand);
  tn = rest / rows;
  tm = band * kBand + rest % rows;
}

// -- GEMM kernels (K9, K10): fp32 on the CUDA cores ---------------------------
//
// A 128 x 128 output tile in a block of 256 threads, each holding 8 x 8
// outputs in registers: thread 16 ty + tx holds rows 8 ty .. 8 ty + 7 (a
// warp holds 16 whole rows) and columns 4 tx .. 4 tx + 3 and 64 + 4 tx ..
// 64 + 4 tx + 3. A chunk of kF32Depth steps of the reduction sits in shared
// memory depth-major for both operands, a_s[t][m] and b_s[t][n], in rows of
// kF32Pitch floats (16-byte aligned; the padding spreads the transposing
// stores of K10's lhs over the banks). Every product is an fp32 FMA, as the
// JAX kernels' fp32 products.
constexpr int kF32Tile = 128, kF32Depth = 16, kF32Pitch = kF32Tile + 4;
constexpr int kF32Threads = 256;

__device__ __forceinline__ int f32_row(int i) {
  return 8 * (threadIdx.x >> 4) + i;
}
__device__ __forceinline__ int f32_col(int j) {
  return (j & 4) * 16 + 4 * (threadIdx.x & 15) + (j & 3);
}

// acc += the chunk's products.
__device__ __forceinline__ void f32_chunk(float (&acc)[8][8],
                                          const float* a_s,
                                          const float* b_s) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int t = 0; t < kF32Depth; ++t) {
    const float* ar = a_s + t * kF32Pitch + 8 * ty;
    const float* br = b_s + t * kF32Pitch + 4 * tx;
    const float4 a0 = *reinterpret_cast<const float4*>(ar);
    const float4 a1 = *reinterpret_cast<const float4*>(ar + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(br);
    const float4 b1 = *reinterpret_cast<const float4*>(br + 64);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Elements c .. c + 3 of row r of a row-major fp32 operand, zero past
// (rows, cols). vec: one 16-byte load (the operand's rows are 16-byte
// aligned and cols % 4 == 0, so the four are all inside or all outside);
// else element by element.
__device__ __forceinline__ float4 f32_load4(const float* src, long long ld,
                                            int r, int rows, int c, int cols,
                                            bool vec) {
  if (vec)
    return r < rows && c < cols
               ? *reinterpret_cast<const float4*>(src + r * ld + c)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = r < rows && c + e < cols ? src[r * ld + c + e] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// A chunk whose rows are the reduction (x, dy, rhs[g]): [kF32Depth rows
// r0 ..][128 columns c0 ..], two float4 a thread, fetched into registers
// (the next chunk's loads fly while this one multiplies) and then put.
__device__ __forceinline__ void f32_fetch_rows(float4 (&v)[2],
                                               const float* src, long long ld,
                                               int r0, int rows, int c0,
                                               int cols, bool vec) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = threadIdx.x + kF32Threads * h;
    v[h] = f32_load4(src, ld, r0 + (q >> 5), rows, c0 + (q & 31) * 4, cols,
                     vec);
  }
}
__device__ __forceinline__ void f32_put_rows(float* s, const float4 (&v)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = threadIdx.x + kF32Threads * h;
    *reinterpret_cast<float4*>(s + (q >> 5) * kF32Pitch + (q & 31) * 4) =
        v[h];
  }
}
// A chunk of an operand whose rows are the output rows (K10's lhs [M, K]):
// [128 rows r0 ..][kF32Depth columns d0 ..], put transposed.
__device__ __forceinline__ void f32_fetch_cols(float4 (&v)[2],
                                               const float* src, long long ld,
                                               int r0, int rows, int d0,
                                               int depth, bool vec) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = threadIdx.x + kF32Threads * h;
    v[h] = f32_load4(src, ld, r0 + (q >> 2), rows, d0 + (q & 3) * 4, depth,
                     vec);
  }
}
__device__ __forceinline__ void f32_put_cols(float* s, const float4 (&v)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = threadIdx.x + kF32Threads * h;
    float* d = s + (q & 3) * 4 * kF32Pitch + (q >> 2);
    d[0] = v[h].x;
    d[kF32Pitch] = v[h].y;
    d[2 * kF32Pitch] = v[h].z;
    d[3 * kF32Pitch] = v[h].w;
  }
}

}  // namespace ptt
