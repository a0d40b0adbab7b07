// Tensor-core building blocks of the GEMM-shaped kernels (grad_add.cu,
// grouped_matmul.cu) and the flash kernels (flash_fwd.cu, flash_bwd.cu):
// staging into shared memory (cp.async, in common.cuh), ldmatrix fragment
// loads and the bf16 (or fp16) mma.sync m16n8k16 with fp32 accumulation.
// Plain Ampere-style warp MMAs, which sm_90a runs; wgmma and TMA are for a
// later, faster version.
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

}  // namespace ptt
