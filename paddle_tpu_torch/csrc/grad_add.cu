// K9: fused_linear_param_grad_add for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas_kernels.py::fused_linear_param_grad_add
// (_grad_add_kernel, launched through pl.pallas_call at
// pallas_kernels.py:439).
//
// out[K, N] (fp32) = dweight[K, N] + x[T, K]^T . dy[T, N], with x and dy
// bf16 or fp32 and dweight fp32, bf16 or fp16; every product is summed in
// fp32 and the prior dweight is folded in once. out is a new tensor: the
// caller's dweight is left as it was, as under jax.jit without donation.
//
// What bounds it: 2 T K N operations on K N + T (K + N) elements. At the
// widths of a 7B Llama layer (T = 4096 tokens, K, N = 4096 or 11008) that
// is 1.4e11 to 3.7e11 operations against 0.1-0.5 GB, far above the card's
// ridge point: the tensor cores' rate bounds it. fp32 inputs run on the
// CUDA cores (67 TFLOP/s at most), bf16 inputs on the tensor cores.
//
// Design: the TPU grid (nK, nN, nT) keeps T innermost and carries the fp32
// tile in VMEM scratch across it. Here a block owns one output tile and
// walks T itself, so the accumulator stays in registers and each tile is
// written once, and no sum is split over blocks (no atomics: two launches
// give bitwise-equal results). Three instances;
// ops/grad_add.py::kernel_for chooses and calls its entry point.
//
// grad_add_wgmma (bf16 x and dy TMA can read: 16-byte aligned bases, row
// strides multiples of 16 bytes, K and N multiples of 8): wgmma.cuh's
// mainloop over a 128 x 256 tile (rows k0.. of x^T, columns n0.. of dy), T
// in chunks of 64 through 4 TMA stages; x^T and dy are both MN-major
// (their rows are T), read as boxes of [64 T rows][64 columns] with the
// descriptors' transpose bits; blocks walked in bands of row tiles
// (band_raster) so the blocks in flight share x's and dy's panels in L2;
// the epilogue reads dweight once and writes dweight + acc in fp32. At K =
// N = 4096 the 512 tiles make 3.9 waves over 132 SMs (a persistent tile
// loop is later work).
//
// grad_add (bf16 operands TMA cannot take, and fp32): bf16 inputs: a 128 x
// 128 tile, 8 warps of 64 x 32, T in chunks of 32 staged by cp.async into
// two shared-memory buffers (the next chunk loads while this one
// multiplies). x is [T, K] row-major, so the tile's rows are T and its
// columns K: ldmatrix.trans turns those rows into the row-major A fragment
// of x^T, and dy's [T, N] rows into the column-major B fragment, for
// mma.sync m16n8k16 with fp32 accumulation. Ragged K, N and T are
// zero-filled at the load and masked at the store. fp32 inputs: 128 x 128
// tiles of 8 x 8 register micro-tiles over T chunks of 16 (mma.cuh), fp32
// FMAs, the next chunk's 16-byte loads in flight while one multiplies.
#include <cuda_fp16.h>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float dw_load(const float* p) { return *p; }
__device__ __forceinline__ float dw_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float dw_load(const __half* p) {
  return __half2float(*p);
}
// dweight[o], dweight[o + 1] (o even, the row's width even)
__device__ __forceinline__ float2 dw_load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 dw_load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 dw_load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// -- bf16 inputs: tensor cores ----------------------------------------------

constexpr int kBM = 128, kBN = 128, kBT = 32;
constexpr int kPitchM = kBM + 8, kPitchN = kBN + 8;  // conflict-free ldmatrix

template <typename DW>
__global__ void __launch_bounds__(kThreads)
grad_add_mma_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ dy,
                    const DW* __restrict__ dw, float* __restrict__ out,
                    int T, int K, int N, long long ldx, long long ldy,
                    bool vec) {
  __shared__ __align__(16) __nv_bfloat16 xs[2][kBT * kPitchM];
  __shared__ __align__(16) __nv_bfloat16 ds[2][kBT * kPitchN];
  const int n0 = blockIdx.x * kBN, k0 = blockIdx.y * kBM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int chunks = (T + kBT - 1) / kBT;
  auto stage = [&](int buf, int c) {
    ptt::stage_tile<kBT, kBM, kPitchM, kThreads>(xs[buf], x, ldx, c * kBT, T,
                                                 k0, K, vec);
    ptt::stage_tile<kBT, kBN, kPitchN, kThreads>(ds[buf], dy, ldy, c * kBT,
                                                 T, n0, N, vec);
  };
  if (chunks > 0) stage(0, 0);
  ptt::cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) stage((c + 1) & 1, c + 1);
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* xb = xs[c & 1];
    const __nv_bfloat16* db = ds[c & 1];
#pragma unroll
    for (int kk = 0; kk < kBT; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // x^T rows m = k0 + 64 wm + 16 i .. +15, columns t = kk .. kk + 15:
        // matrices (m 0-7, t 0-7), (m 8-15, t 0-7), (m 0-7, t 8-15),
        // (m 8-15, t 8-15), each read as 8 rows t of x, transposed
        const int t = kk + (lane & 7) + ((lane >> 4) << 3);
        const int m = wm * 64 + i * 16 + ((lane >> 3) & 1) * 8;
        ptt::ldmatrix_x4_trans(a[i], xb + t * kPitchM + m);
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        // dy rows t = kk .. kk + 15, columns n .. n + 15: the B fragments
        // of two n8 tiles
        const int t = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int n = wn * 32 + jp * 16 + (lane >> 4) * 8;
        uint32_t r[4];
        ptt::ldmatrix_x4_trans(r, db + t * kPitchN + n);
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ptt::mma_bf16_16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();  // the next stage overwrites this buffer
  }

  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = k0 + wm * 64 + i * 16 + g + h * 8;
      if (row >= K) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wn * 32 + j * 8 + c2 + e;
          if (col < N) {
            const long long o = static_cast<long long>(row) * N + col;
            out[o] = dw_load(dw + o) + acc[i][j][2 * h + e];
          }
        }
      }
    }
  }
}

// -- bf16 through TMA: wgmma ------------------------------------------------

constexpr int kWN = 256, kWStages = 4;  // tile columns, pipeline stages
using WTile = ptt::sm90::Tile<kWN, kWStages>;

template <typename DW>
__global__ void __launch_bounds__(ptt::sm90::kThreads, 1)
grad_add_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap dy_map,
                      const DW* __restrict__ dw, float* __restrict__ out,
                      int T, int K, int N, int tiles_m, int tiles_n) {
  int tm, tn;
  ptt::band_raster(blockIdx.x, tiles_m, tiles_n, tm, tn);
  const int k0 = tm * ptt::sm90::kBM, n0 = tn * kWN;
  if (threadIdx.x == 0) {
    ptt::sm90::tma_prefetch(&x_map);
    ptt::sm90::tma_prefetch(&dy_map);
  }
  ptt::sm90::gemm_tile<false, kWN, kWStages>(
      T, K - k0,
      [&](uint8_t* a, uint8_t* b, uint64_t* bar, int t0) {
        ptt::sm90::tma_load_2d(a, &x_map, bar, k0, t0);
        ptt::sm90::tma_load_2d(a + ptt::sm90::kBoxBytes, &x_map, bar, k0 + 64,
                               t0);
#pragma unroll
        for (int h = 0; h < kWN / 64; ++h)
          ptt::sm90::tma_load_2d(b + h * ptt::sm90::kBoxBytes, &dy_map, bar,
                                 n0 + 64 * h, t0);
      },
      [&](const float(&acc)[kWN / 2], int cons) {
#pragma unroll
        for (int j = 0; j < kWN / 4; ++j) {
          const int row = k0 + ptt::sm90::acc_row(cons, j);
          const int col = n0 + ptt::sm90::acc_col(j);
          if (row < K && col < N) {  // N % 8 == 0: col + 1 < N too
            const long long o = static_cast<long long>(row) * N + col;
            const float2 d = dw_load2(dw + o);
            *reinterpret_cast<float2*>(out + o) =
                make_float2(d.x + acc[2 * j], d.y + acc[2 * j + 1]);
          }
        }
      });
}

// -- fp32 inputs: CUDA cores ------------------------------------------------

template <typename DW>
__global__ void __launch_bounds__(ptt::kF32Threads)
grad_add_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                    const DW* __restrict__ dw, float* __restrict__ out, int T,
                    int K, int N, long long ldx, long long ldy, int tiles_m,
                    int tiles_n, bool vec) {
  __shared__ __align__(16) float xs[ptt::kF32Depth * ptt::kF32Pitch];
  __shared__ __align__(16) float ds[ptt::kF32Depth * ptt::kF32Pitch];
  int tm, tn;
  ptt::band_raster(blockIdx.x, tiles_m, tiles_n, tm, tn);
  const int k0 = tm * ptt::kF32Tile, n0 = tn * ptt::kF32Tile;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float4 vx[2], vd[2];
  ptt::f32_fetch_rows(vx, x, ldx, 0, T, k0, K, vec);
  ptt::f32_fetch_rows(vd, dy, ldy, 0, T, n0, N, vec);
  for (int t0 = 0; t0 < T; t0 += ptt::kF32Depth) {
    __syncthreads();  // the last chunk's products are done
    ptt::f32_put_rows(xs, vx);
    ptt::f32_put_rows(ds, vd);
    __syncthreads();
    if (t0 + ptt::kF32Depth < T) {
      ptt::f32_fetch_rows(vx, x, ldx, t0 + ptt::kF32Depth, T, k0, K, vec);
      ptt::f32_fetch_rows(vd, dy, ldy, t0 + ptt::kF32Depth, T, n0, N, vec);
    }
    ptt::f32_chunk(acc, xs, ds);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = k0 + ptt::f32_row(i);
    if (row >= K) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + ptt::f32_col(j);
      if (col < N) {
        const long long o = static_cast<long long>(row) * N + col;
        out[o] = dw_load(dw + o) + acc[i][j];
      }
    }
  }
}

template <typename DW>
cudaError_t launch(const void* x, const void* dy, const void* dw, float* out,
                   int T, int K, int N, long long ldx, long long ldy,
                   int in_f32, cudaStream_t st) {
  if (in_f32) {
    const int tiles_m = (K + ptt::kF32Tile - 1) / ptt::kF32Tile;
    const int tiles_n = (N + ptt::kF32Tile - 1) / ptt::kF32Tile;
    // 16-byte loads: 4-column chunks wholly inside or outside
    const bool vec = K % 4 == 0 && N % 4 == 0 && ldx % 4 == 0 &&
                     ldy % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dy) % 16 == 0;
    grad_add_f32_kernel<DW><<<tiles_m * tiles_n, ptt::kF32Threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy),
        static_cast<const DW*>(dw), out, T, K, N, ldx, ldy, tiles_m, tiles_n,
        vec);
  } else {
    // 16-byte rows: cp.async of whole 8-column chunks
    const bool vec = K % 8 == 0 && N % 8 == 0 && ldx % 8 == 0 &&
                     ldy % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dy) % 16 == 0;
    const dim3 grid((N + kBN - 1) / kBN, (K + kBM - 1) / kBM);
    grad_add_mma_kernel<DW><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), static_cast<const DW*>(dw),
        out, T, K, N, ldx, ldy, vec);
  }
  return cudaGetLastError();
}

template <typename DW>
cudaError_t launch_wgmma(const void* x, const void* dy, const void* dw,
                         float* out, int T, int K, int N, long long ldx,
                         long long ldy, cudaStream_t st) {
  namespace h = ptt::sm90;
  CUtensorMap x_map, dy_map;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(T)};
  const cuuint64_t dy_dims[2] = {static_cast<cuuint64_t>(N),
                                 static_cast<cuuint64_t>(T)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(ldx) * 2};
  const cuuint64_t dy_strides[1] = {static_cast<cuuint64_t>(ldy) * 2};
  const cuuint32_t box[2] = {64, h::kBK};
  cudaError_t err = h::bf16_tensor_map(&x_map, x, 2, x_dims, x_strides, box);
  if (err == cudaSuccess)
    err = h::bf16_tensor_map(&dy_map, dy, 2, dy_dims, dy_strides, box);
  if (err != cudaSuccess) return err;
  auto kernel = grad_add_wgmma_kernel<DW>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WTile::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles_m = (K + h::kBM - 1) / h::kBM;
  const int tiles_n = (N + kWN - 1) / kWN;
  kernel<<<tiles_m * tiles_n, h::kThreads, WTile::kSmemBytes, st>>>(
      x_map, dy_map, static_cast<const DW*>(dw), out, T, K, N, tiles_m,
      tiles_n);
  return cudaGetLastError();
}

}  // namespace

// x [T, K] and dy [T, N] with row strides ldx, ldy (unit column stride),
// both bf16 (in_f32 = 0) or both fp32 (in_f32 = 1); dweight [K, N]
// contiguous, fp32 (dw_dtype 0), bf16 (1) or fp16 (2); out [K, N] fp32
// contiguous. The mma.sync instance for bf16, the CUDA-core one for fp32.
// Returns cudaGetLastError() after the launch.
extern "C" int grad_add(const void* x, const void* dy, const void* dweight,
                        void* out, int T, int K, int N, long long ldx,
                        long long ldy, int in_f32, int dw_dtype,
                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (dw_dtype) {
    case 0:
      return launch<float>(x, dy, dweight, o, T, K, N, ldx, ldy, in_f32, st);
    case 1:
      return launch<__nv_bfloat16>(x, dy, dweight, o, T, K, N, ldx, ldy,
                                   in_f32, st);
    case 2:
      return launch<__half>(x, dy, dweight, o, T, K, N, ldx, ldy, in_f32, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same arguments, bf16 x and dy TMA can read (in_f32 = 0, 16-byte
// aligned bases, ldx and ldy multiples of 8, K and N multiples of 8, T >
// 0).
extern "C" int grad_add_wgmma(const void* x, const void* dy,
                              const void* dweight, void* out, int T, int K,
                              int N, long long ldx, long long ldy, int in_f32,
                              int dw_dtype, void* stream) {
  if (in_f32 || T <= 0 || K % 8 || N % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (dw_dtype) {
    case 0:
      return launch_wgmma<float>(x, dy, dweight, o, T, K, N, ldx, ldy, st);
    case 1:
      return launch_wgmma<__nv_bfloat16>(x, dy, dweight, o, T, K, N, ldx, ldy,
                                         st);
    case 2:
      return launch_wgmma<__half>(x, dy, dweight, o, T, K, N, ldx, ldy, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
