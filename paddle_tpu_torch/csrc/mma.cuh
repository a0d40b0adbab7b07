// Tensor-core building blocks of the GEMM-shaped kernels (grad_add.cu,
// grouped_matmul.cu): cp.async staging into shared memory, ldmatrix
// fragment loads and the bf16 mma.sync m16n8k16 with fp32 accumulation.
// Plain Ampere-style warp MMAs, which sm_90a runs; wgmma and TMA are for a
// later, faster version.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0
// writes 16 zero bytes and reads nothing (src must still be a valid
// address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

// A [kRows][kCols] bf16 tile of a row-major operand into shared memory of
// row pitch kPitch elements: rows r0.., columns c0.., zero past (rows,
// cols). vec: the operand's rows are 16-byte aligned and cols % 8 == 0,
// so each 8-column chunk is wholly inside or outside and goes as one
// cp.async; otherwise element by element (plain loads and stores).
template <int kRows, int kCols, int kPitch, int kThreads>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long ld, int r0, int rows,
                                           int c0, int cols, bool vec) {
  constexpr int kChunks = kCols / 8;
  if (vec) {
    for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool in = r0 + r < rows && c0 + c < cols;
      const __nv_bfloat16* s = in ? src + (r0 + r) * ld + c0 + c : src;
      cp_async16(dst + r * kPitch + c, s, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      dst[r * kPitch + c] = (r0 + r < rows && c0 + c < cols)
                                ? src[(r0 + r) * ld + c0 + c]
                                : __float2bfloat16(0.f);
    }
  }
}

}  // namespace ptt
