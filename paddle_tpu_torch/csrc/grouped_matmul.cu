// K10: grouped matmul (the MoE expert GEMM) for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/pallas.py::grouped_matmul (:231-247), which runs
// JAX's megablox gmm kernel on the TPU (a pl.pallas_call in
// jax/experimental/pallas/ops/tpu/megablox/gmm.py).
//
// out[r, :] = lhs[r, :] . rhs[g(r)] for lhs [M, K], rhs [G, K, N] and
// group_sizes [G]: rows are grouped in order, group g holding
// group_sizes[g] rows from start_g = sizes[0] + ... + sizes[g - 1]; empty
// groups hold none. Rows past sum(group_sizes) belong to the last group,
// as in the JAX package's fallback (clip(#{g: r >= start_g} - 1)); gmm
// assumes the sum is M. bf16 or fp32 in, fp32 accumulation, fp32 or bf16
// out. The
// wrapper passes the groups' ends (a cumulative sum made on the card), so
// nothing is read back to the host.
//
// What bounds it: 2 M K N operations; the bytes are lhs, the weights of
// every non-empty group and out. At the ERNIE-MoE "large" widths (M = 8192
// rows, K, N = 1024 / 4096, 64 experts) that is 6.9e10 operations against
// 0.7 GB: 0.07 ms at the bf16 peak, 0.2 ms at the memory rate, so reading
// every expert's weights once bounds it.
//
// Three instances; ops/grouped_matmul.py::kernel_for chooses and calls its
// entry point.
//
// grouped_matmul_wgmma (bf16 operands TMA can read: 16-byte aligned bases,
// row and group strides multiples of 16 bytes, K and N multiples of 8):
// megablox walks a flattened (group, row tile) schedule built on the host
// (make_group_metadata); here a one-warp kernel builds it on the card from
// the groups' ends into the wrapper's workspace: each group's row tiles
// start at its first row, so a group of s rows takes ceil(s / 128) tiles,
// and the grid, ceil(M / 128) + G - 1 row tiles (the most any sizes need)
// by the column tiles, comes from the shapes alone; blocks past the
// schedule's end return at once. A block multiplies its tile's 128 rows
// (rows past the group's end are loaded, multiplied and not stored) by its
// group's weights through wgmma.cuh's mainloop (TMA: lhs K-major in one box
// of 128 rows, rhs one 3-D tensor map over [G, K, N] so a group is a
// coordinate; wgmma m64n256k16), blocks walked in bands of row tiles
// (band_raster) so that a group's row tiles at one column tile run close
// together and its weight slab comes from L2 after the first read. Every
// output row is written once, by its own group's tile.
//
// grouped_matmul (bf16 operands TMA cannot take): one block owns a 128 x
// 128 output tile aligned to M (rows m0.., columns n0..), finds the groups
// whose rows meet its rows from the ends, and for each non-empty one runs
// the K loop against that group's weights, writing only the rows of that
// group: a tile that straddles g groups multiplies g times. The K loop is
// K9's: 8 warps of 64 x 32, K in chunks of 32 staged by cp.async in two
// buffers, ldmatrix (lhs rows as the row-major A fragment, rhs rows
// transposed as the column-major B fragment), mma.sync m16n8k16 with fp32
// accumulators in registers.
//
// fp32 operands (the grouped_matmul entry): the wgmma instance's schedule
// and raster over 128 x 128 tiles of 8 x 8 register micro-tiles (mma.cuh),
// fp32 FMAs; a warp whose 16 rows are all past its group's end skips the
// products.
#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kPitchA = kBK + 8, kPitchB = kBN + 8;  // conflict-free ldmatrix

template <typename TO>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const __nv_bfloat16* __restrict__ lhs,
                      const __nv_bfloat16* __restrict__ rhs,
                      const int* __restrict__ ends, TO* __restrict__ out,
                      int M, int K, int N, int G, long long lda,
                      long long rhs_g, long long ldb, bool vec) {
  __shared__ __align__(16) __nv_bfloat16 as[2][kBM * kPitchA];
  __shared__ __align__(16) __nv_bfloat16 bs[2][kBK * kPitchB];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 64 x 32
  const int chunks = (K + kBK - 1) / kBK;
  const int m_end = min(m0 + kBM, M);

  int start = 0;
  for (int grp = 0; grp < G && start < m_end; ++grp) {
    const int end = grp == G - 1 ? M : min(ends[grp], M);
    const int lo = max(start, m0), hi = min(end, m_end);
    start = max(start, end);
    if (lo >= hi) continue;  // an empty group, or none of this tile's rows
    const __nv_bfloat16* w = rhs + grp * rhs_g;

    float acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    auto stage = [&](int buf, int c) {
      ptt::stage_tile<kBM, kBK, kPitchA, kThreads>(as[buf], lhs, lda, m0, M,
                                                   c * kBK, K, vec);
      ptt::stage_tile<kBK, kBN, kPitchB, kThreads>(bs[buf], w, ldb, c * kBK,
                                                   K, n0, N, vec);
    };
    if (chunks > 0) stage(0, 0);
    ptt::cp_async_commit();
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) stage((c + 1) & 1, c + 1);
      ptt::cp_async_commit();
      ptt::cp_async_wait<1>();
      __syncthreads();
      const __nv_bfloat16* ab = as[c & 1];
      const __nv_bfloat16* bb = bs[c & 1];
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // lhs rows m .. m + 15, columns kk .. kk + 15: matrices (m 0-7,
          // k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
          const int m = wm * 64 + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int k = kk + (lane >> 4) * 8;
          ptt::ldmatrix_x4(a[i], ab + m * kPitchA + k);
        }
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int k = kk + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int n = wn * 32 + jp * 16 + (lane >> 4) * 8;
          uint32_t r[4];
          ptt::ldmatrix_x4_trans(r, bb + k * kPitchB + n);
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
        const int row = m0 + wm * 64 + i * 16 + g + h * 8;
        if (row < lo || row >= hi) continue;  // another group's row
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + wn * 32 + j * 8 + c2 + e;
            if (col < N)
              out[static_cast<long long>(row) * N + col] =
                  ptt::from_float<TO>(acc[i][j][2 * h + e]);
          }
        }
      }
    }
  }
}

// -- the schedule of the wgmma and fp32 instances --------------------------

// One warp: tile i (of max_tiles) gets (group, first row, end row) in
// sched[3 i ..]; tiles past the last get group -1. Group g holds rows
// [s_g, e_g): e_g = min(ends[g], M) (M for the last group, which also takes
// the rows past the sum), s_g the largest end before it; its tiles start
// at s_g, s_g + bm, ... and end at the next start or e_g.
__global__ void grouped_matmul_kernel_schedule(const int* __restrict__ ends,
                                               int* __restrict__ sched, int M,
                                               int G, int bm, int max_tiles) {
  const int lane = threadIdx.x;
  int start = 0, base = 0;  // the rows and tiles of the groups before
  for (int g0 = 0; g0 < G; g0 += 32) {
    const int g = g0 + lane;
    const int e = g >= G ? 0 : g == G - 1 ? M : min(max(ends[g], 0), M);
    int hi = e;  // inclusive running max of the ends
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, hi, o);
      if (lane >= o) hi = max(hi, v);
    }
    int s = __shfl_up_sync(0xffffffffu, hi, 1);
    s = max(start, lane == 0 ? 0 : s);
    const int t = g < G ? (max(e - s, 0) + bm - 1) / bm : 0;
    int sum = t;  // inclusive prefix of the tile counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, sum, o);
      if (lane >= o) sum += v;
    }
    for (int j = 0; j < t; ++j) {
      const int i = base + sum - t + j;
      if (i < max_tiles) {
        sched[3 * i] = g;
        sched[3 * i + 1] = s + j * bm;
        sched[3 * i + 2] = min(s + (j + 1) * bm, e);
      }
    }
    start = max(start, __shfl_sync(0xffffffffu, hi, 31));
    base += __shfl_sync(0xffffffffu, sum, 31);
  }
  for (int i = base + lane; i < max_tiles; i += 32) {
    sched[3 * i] = -1;
    sched[3 * i + 1] = 0;
    sched[3 * i + 2] = 0;
  }
}

template <typename TO>
__device__ __forceinline__ void store2(TO* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = ptt::pack2<__nv_bfloat16>(a, b);
}

// -- bf16 through TMA: wgmma ------------------------------------------------

constexpr int kWN = 256, kWStages = 4;  // tile columns, pipeline stages
using WTile = ptt::sm90::Tile<kWN, kWStages>;

template <typename TO>
__global__ void __launch_bounds__(ptt::sm90::kThreads, 1)
grouped_matmul_kernel_wgmma(const __grid_constant__ CUtensorMap lhs_map,
                            const __grid_constant__ CUtensorMap rhs_map,
                            const int* __restrict__ sched,
                            TO* __restrict__ out, int K, int N, int tiles_m,
                            int tiles_n) {
  int tm, tn;
  ptt::band_raster(blockIdx.x, tiles_m, tiles_n, tm, tn);
  const int grp = sched[3 * tm];
  if (grp < 0) return;  // past the schedule's last tile
  const int r0 = sched[3 * tm + 1], r1 = sched[3 * tm + 2], n0 = tn * kWN;
  if (threadIdx.x == 0) {
    ptt::sm90::tma_prefetch(&lhs_map);
    ptt::sm90::tma_prefetch(&rhs_map);
  }
  ptt::sm90::gemm_tile<true, kWN, kWStages>(
      K, r1 - r0,
      [&](uint8_t* a, uint8_t* b, uint64_t* bar, int k0) {
        ptt::sm90::tma_load_2d(a, &lhs_map, bar, k0, r0);
#pragma unroll
        for (int h = 0; h < kWN / 64; ++h)
          ptt::sm90::tma_load_3d(b + h * ptt::sm90::kBoxBytes, &rhs_map, bar,
                                 n0 + 64 * h, k0, grp);
      },
      [&](const float(&acc)[kWN / 2], int cons) {
#pragma unroll
        for (int j = 0; j < kWN / 4; ++j) {
          const int row = r0 + ptt::sm90::acc_row(cons, j);
          const int col = n0 + ptt::sm90::acc_col(j);
          if (row < r1 && col < N)  // N % 8 == 0: col + 1 < N too
            store2(out + static_cast<long long>(row) * N + col, acc[2 * j],
                   acc[2 * j + 1]);
        }
      });
}

// -- fp32 inputs: CUDA cores ------------------------------------------------

template <typename TO>
__global__ void __launch_bounds__(ptt::kF32Threads)
grouped_matmul_kernel_f32(const float* __restrict__ lhs,
                          const float* __restrict__ rhs,
                          const int* __restrict__ sched, TO* __restrict__ out,
                          int M, int K, int N, long long lda, long long rhs_g,
                          long long ldb, int tiles_m, int tiles_n, bool vec) {
  __shared__ __align__(16) float as[ptt::kF32Depth * ptt::kF32Pitch];
  __shared__ __align__(16) float bs[ptt::kF32Depth * ptt::kF32Pitch];
  int tm, tn;
  ptt::band_raster(blockIdx.x, tiles_m, tiles_n, tm, tn);
  const int grp = sched[3 * tm];
  if (grp < 0) return;  // past the schedule's last tile
  const int r0 = sched[3 * tm + 1], r1 = sched[3 * tm + 2];
  const int n0 = tn * ptt::kF32Tile;
  const float* w = rhs + grp * rhs_g;
  const bool live = 16 * (threadIdx.x >> 5) < r1 - r0;  // the warp's rows

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float4 va[2], vb[2];
  ptt::f32_fetch_cols(va, lhs, lda, r0, M, 0, K, vec);
  ptt::f32_fetch_rows(vb, w, ldb, 0, K, n0, N, vec);
  for (int k0 = 0; k0 < K; k0 += ptt::kF32Depth) {
    __syncthreads();  // the last chunk's products are done
    ptt::f32_put_cols(as, va);
    ptt::f32_put_rows(bs, vb);
    __syncthreads();
    if (k0 + ptt::kF32Depth < K) {
      ptt::f32_fetch_cols(va, lhs, lda, r0, M, k0 + ptt::kF32Depth, K, vec);
      ptt::f32_fetch_rows(vb, w, ldb, k0 + ptt::kF32Depth, K, n0, N, vec);
    }
    if (live) ptt::f32_chunk(acc, as, bs);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + ptt::f32_row(i);
    if (row >= r1) continue;  // another group's row
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + ptt::f32_col(j);
      if (col < N)
        out[static_cast<long long>(row) * N + col] =
            ptt::from_float<TO>(acc[i][j]);
    }
  }
}

// The schedule of row tiles of `bm` rows into sched; returns the grid's row
// tiles (the most any group sizes need).
int schedule(const int* ends, int* sched, int M, int G, int bm,
             cudaStream_t st) {
  const int tiles = (M + bm - 1) / bm + G - 1;
  grouped_matmul_kernel_schedule<<<1, 32, 0, st>>>(ends, sched, M, G, bm,
                                                   tiles);
  return tiles;
}

template <typename TO>
cudaError_t launch(const void* lhs, const void* rhs, const void* ends,
                   void* out, int M, int K, int N, int G, long long lda,
                   long long rhs_g, long long ldb, int in_f32, int* sched,
                   cudaStream_t st) {
  if (in_f32) {
    if (sched == nullptr) return cudaErrorInvalidValue;
    const int tiles_m = schedule(static_cast<const int*>(ends), sched, M, G,
                                 ptt::kF32Tile, st);
    const int tiles_n = (N + ptt::kF32Tile - 1) / ptt::kF32Tile;
    // 16-byte loads: 4-column chunks wholly inside or outside
    const bool vec = K % 4 == 0 && N % 4 == 0 && lda % 4 == 0 &&
                     ldb % 4 == 0 && rhs_g % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(lhs) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(rhs) % 16 == 0;
    grouped_matmul_kernel_f32<TO><<<tiles_m * tiles_n, ptt::kF32Threads, 0,
                                    st>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(rhs), sched,
        static_cast<TO*>(out), M, K, N, lda, rhs_g, ldb, tiles_m, tiles_n,
        vec);
    return cudaGetLastError();
  }
  // 16-byte rows: cp.async of whole 8-column chunks
  const bool vec = K % 8 == 0 && N % 8 == 0 && lda % 8 == 0 &&
                   ldb % 8 == 0 && rhs_g % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(lhs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rhs) % 16 == 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  grouped_matmul_kernel<TO><<<grid, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(lhs),
      static_cast<const __nv_bfloat16*>(rhs), static_cast<const int*>(ends),
      static_cast<TO*>(out), M, K, N, G, lda, rhs_g, ldb, vec);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t launch_wgmma(const void* lhs, const void* rhs, const void* ends,
                         void* out, int M, int K, int N, int G, long long lda,
                         long long rhs_g, long long ldb, int* sched,
                         cudaStream_t st) {
  namespace h = ptt::sm90;
  CUtensorMap lhs_map, rhs_map;
  const cuuint64_t l_dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(M)};
  const cuuint64_t l_strides[1] = {static_cast<cuuint64_t>(lda) * 2};
  const cuuint32_t l_box[2] = {h::kBK, h::kBM};
  const cuuint64_t r_dims[3] = {static_cast<cuuint64_t>(N),
                                static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(G)};
  const cuuint64_t r_strides[2] = {static_cast<cuuint64_t>(ldb) * 2,
                                   static_cast<cuuint64_t>(rhs_g) * 2};
  const cuuint32_t r_box[3] = {64, h::kBK, 1};
  cudaError_t err =
      h::bf16_tensor_map(&lhs_map, lhs, 2, l_dims, l_strides, l_box);
  if (err == cudaSuccess)
    err = h::bf16_tensor_map(&rhs_map, rhs, 3, r_dims, r_strides, r_box);
  if (err != cudaSuccess) return err;
  auto kernel = grouped_matmul_kernel_wgmma<TO>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WTile::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles_m = schedule(static_cast<const int*>(ends), sched, M, G,
                               h::kBM, st);
  const int tiles_n = (N + kWN - 1) / kWN;
  kernel<<<tiles_m * tiles_n, h::kThreads, WTile::kSmemBytes, st>>>(
      lhs_map, rhs_map, sched, static_cast<TO*>(out), K, N, tiles_m,
      tiles_n);
  return cudaGetLastError();
}

}  // namespace

// lhs [M, K] (row stride lda, unit column stride) and rhs [G, K, N] (group
// stride rhs_g, row stride ldb, unit column stride), both bf16 (in_f32 = 0)
// or both fp32 (in_f32 = 1); ends [G] int32, the cumulative sums of the
// group sizes; out [M, N] contiguous, fp32 (out_bf16 = 0) or bf16 (1);
// workspace: 3 (ceil(M / 128) + G - 1) int32 for the schedule (fp32
// operands; unused for bf16). The mma.sync instance for bf16, the CUDA-core
// one for fp32. Returns cudaGetLastError() after the launches.
extern "C" int grouped_matmul(const void* lhs, const void* rhs,
                              const void* ends, void* out, int M, int K,
                              int N, int G, long long lda, long long rhs_g,
                              long long ldb, int in_f32, int out_bf16,
                              void* workspace, void* stream) {
  if (G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* sched = static_cast<int*>(workspace);
  return out_bf16 ? launch<__nv_bfloat16>(lhs, rhs, ends, out, M, K, N, G,
                                          lda, rhs_g, ldb, in_f32, sched, st)
                  : launch<float>(lhs, rhs, ends, out, M, K, N, G, lda, rhs_g,
                                  ldb, in_f32, sched, st);
}

// The same arguments, bf16 operands TMA can read (in_f32 = 0, 16-byte
// aligned bases, lda, ldb and rhs_g multiples of 8, K and N multiples of 8,
// K > 0); workspace as above, always used.
extern "C" int grouped_matmul_wgmma(const void* lhs, const void* rhs,
                                    const void* ends, void* out, int M,
                                    int K, int N, int G, long long lda,
                                    long long rhs_g, long long ldb,
                                    int in_f32, int out_bf16, void* workspace,
                                    void* stream) {
  if (G <= 0 || in_f32 || K <= 0 || K % 8 || N % 8 || workspace == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* sched = static_cast<int*>(workspace);
  return out_bf16 ? launch_wgmma<__nv_bfloat16>(lhs, rhs, ends, out, M, K, N,
                                                G, lda, rhs_g, ldb, sched, st)
                  : launch_wgmma<float>(lhs, rhs, ends, out, M, K, N, G, lda,
                                        rhs_g, ldb, sched, st);
}
