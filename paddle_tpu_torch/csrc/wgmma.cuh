// Hopper (sm_90a) building blocks of the GEMM kernels K9 (grad_add.cu,
// fused_linear_param_grad_add) and K10 (grouped_matmul.cu, the MoE grouped
// matmul): TMA loads into a ring of shared-memory stages completed on
// mbarriers, wgmma.mma_async with fp32 accumulators in registers, one
// producer warp and two consumer warpgroups. Inline PTX, as mma.cuh.
//
// The TPU kernels they serve: paddle_tpu/ops/pallas_kernels.py:439
// (fused_linear_param_grad_add) and megablox gmm behind
// paddle_tpu/ops/pallas.py:231 (grouped_matmul). What bounds them on an
// H100: K9 at the 7B linears by operations (2 T K N at 989 TFLOP/s bf16,
// about 300 operations per byte moved); K10 at the ERNIE-MoE expert GEMMs
// by bytes (every live expert's weights read once at 3.35 TB/s).
//
// gemm_tile: a block computes one kBM x BN output tile (kBM = 128 rows, BN
// = 128 or 256 columns) over the depth in chunks of kBK = 64 (128 bytes of
// bf16, the width of the 128-byte swizzle). Warpgroup 0 is the producer:
// one thread keeps Stages chunks in flight, each a few TMA boxes landing
// on the stage's `full` barrier (arrive.expect_tx with the stage's bytes),
// and its warpgroup hands registers to the consumers (setmaxnreg).
// Warpgroups 1 and 2 are the consumers: consumer c owns rows 64 c .. 64 c
// + 63 of the tile, waits for a stage, issues kBK / 16 wgmma m64nBNk16 on
// it, commits them, and when the previous stage's group has completed
// (wait_group 1) releases that stage on its `empty` barrier (one arrival
// per consumer warp). A consumer whose rows all lie past the rows the
// caller stores skips its products but keeps the barriers going.
//
// A stage holds A, then B, in boxes whose inner dimension is 64 elements
// (128 bytes), 1024-byte aligned and swizzled by TMA's 128-byte mode; the
// wgmma descriptors describe the same bytes (the canonical 128-byte
// swizzled layouts of the PTX ISA's "Shared Memory Matrix Layout"):
//   A K-major (lhs [M, K], K contiguous): one box [kBM rows][64 K]; row r
//     at 128 r bytes; SBO (stride byte offset) = 1024 bytes between groups
//     of 8 rows, LBO unused (16); a k16 step adds 32 bytes.
//   A MN-major (x^T for x [T, K], K contiguous): two boxes [64 depth
//     rows][64 M]; consumer c reads box c; SBO = 1024 bytes between groups
//     of 8 depth rows, a k16 step adds 16 rows (2048 bytes), tnspA = 1.
//   B MN-major (rhs[g] [K, N] or dy [T, N], N contiguous): BN / 64 boxes
//     [64 depth rows][64 N], 8 KB apart: LBO = those 8192 bytes between
//     64-column atoms, SBO = 1024, a k16 step adds 2048 bytes, tnspB = 1.
// The accumulator of consumer c (acc_row, acc_col): acc[2 j] and acc[2 j +
// 1] sit at tile row 64 c + 16 warp + lane / 4 + 8 (j % 2), columns 8 (j /
// 2) + 2 (lane % 4) and the next.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)

#include "common.cuh"

namespace ptt {
namespace sm90 {

constexpr int kBM = 128;              // two consumer warpgroups of 64 rows
constexpr int kBK = 64;               // depth of a stage: 128 bytes of bf16
constexpr int kBoxBytes = 64 * kBK * 2;  // one [64][64] bf16 box, 8 KB
constexpr int kABytes = kBM * kBK * 2;   // A of a stage, 16 KB
constexpr int kThreads = 384;         // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;

// Shared memory of a tile of BN columns with Stages stages: the stages,
// their 2 Stages barriers and 1024 bytes to align the first stage.
template <int BN, int Stages>
struct Tile {
  static constexpr int kStageBytes = kABytes + BN * kBK * 2;
  static constexpr int kSmemBytes = Stages * kStageBytes + 16 * Stages + 1024;
};

// -- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// Makes the barriers' initialisation visible to the TMA unit (the async
// proxy) and the other threads; a __syncthreads() follows.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The producer's arrival: the phase completes when `bytes` have landed.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Spins until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0, so waiting on parity 1 returns at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA --------------------------------------------------------------------

// The tensor map is a __grid_constant__ kernel parameter: its generic
// address is what the instructions take.
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}
// One box at element coordinates (c0 innermost, c1) into dst, completing
// its bytes on bar; coordinates past the tensor read zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// -- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte swizzled operand at p:
// start address, leading and stride byte offsets (in 16-byte units) and
// the swizzle mode (1: 128 bytes) in bits 62-63. Adding n >> 4 to the
// descriptor moves its start by n bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// d (64 x N, fp32) += A (64 x 16, bf16) B (16 x N, bf16) from shared
// memory; kTransA / kTransB = 1 for MN-major operands.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(kTransA), "n"(kTransB));
}

template <int BN, int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 128)
    wgmma_m64n128k16<kTransA, kTransB>(d, da, db);
  else
    wgmma_m64n256k16<kTransA, kTransB>(d, da, db);
}

// Where acc[2 j] and acc[2 j + 1] of consumer `cons` sit in the tile.
__device__ __forceinline__ int acc_row(int cons, int j) {
  return 64 * cons + 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) +
         8 * (j & 1);
}
__device__ __forceinline__ int acc_col(int j) {
  return 8 * (j >> 1) + 2 * (threadIdx.x & 3);
}

// -- the mainloop -----------------------------------------------------------

// One kBM x BN tile over `depth` elements of reduction, in a block of
// kThreads threads with Tile<BN, Stages>::kSmemBytes of dynamic shared
// memory. load(a, b, bar, d0) is called by one producer thread per stage
// and issues the TMA boxes of depth d0 .. d0 + kBK - 1 into a (A) and b
// (B), completing on bar; store(acc, cons) is called by every consumer
// thread once its products are done. `rows`: the tile rows the caller
// stores (a consumer whose 64 rows are all past it multiplies nothing).
template <bool kAKMajor, int BN, int Stages, typename Load, typename Store>
__device__ __forceinline__ void gemm_tile(int depth, int rows, const Load& load,
                                          const Store& store) {
  using T = Tile<BN, Stages>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Stages * T::kStageBytes);
  uint64_t* empty = full + Stages;
  const int chunks = (depth + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < Stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(empty + s, phase ^ 1);
        uint8_t* a = smem + s * T::kStageBytes;
        mbar_expect_tx(full + s, T::kStageBytes);
        load(a, a + kABytes, full + s, c * kBK);
        if (++s == Stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // consumers
    setmaxnreg_inc<232>();
    const int cons = (threadIdx.x >> 7) - 1;
    const bool active = 64 * cons < rows;
    constexpr int kTransA = kAKMajor ? 0 : 1;
    constexpr uint32_t kAStep = kAKMajor ? 32 : 16 * 128;  // bytes per k16
    constexpr uint32_t kALbo = kAKMajor ? 16 : kBoxBytes;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_acc(acc);
    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(full + s, phase);
      if (active) {
        const uint8_t* st = smem + s * T::kStageBytes;
        const uint64_t da = smem_desc(st + cons * kBoxBytes, kALbo, 1024);
        const uint64_t db = smem_desc(st + kABytes, kBoxBytes, 1024);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kBK / 16; ++k)
          wgmma_tile<BN, kTransA, 1>(acc, da + ((k * kAStep) >> 4),
                                     db + ((k * 16 * 128) >> 4));
        wgmma_commit();
      }
      wgmma_wait<1>();  // the previous stage's products are done
      if (c > 0 && (threadIdx.x & 31) == 0) mbar_arrive(empty + prev);
      prev = s;
      if (++s == Stages) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    store(acc, cons);
  }
}

// -- host: tensor maps ------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (so nothing links against libcuda); null where the driver lacks it.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map over a bf16 tensor of `rank` (2 or 3) dimensions, dims
// innermost first, byte strides of dims 1 .. rank - 1, boxes of `box`
// elements, 128-byte swizzle, zeros read past the tensor. TMA needs a
// 16-byte aligned base and strides that are multiples of 16 bytes; the
// encoder refuses anything else (cudaErrorInvalidValue).
inline cudaError_t bf16_tensor_map(CUtensorMap* map, const void* base,
                                   int rank, const cuuint64_t* dims,
                                   const cuuint64_t* strides,
                                   const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace ptt
