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
// Design: megablox walks a flattened (group, row tile) schedule built on
// the host (make_group_metadata). Here one block owns a 128 x 128 output
// tile (rows m0.., columns n0..), finds the groups whose rows meet its
// rows from the ends, and for each non-empty one runs the K loop against
// that group's weights, writing only the rows of that group: a tile that
// straddles g groups multiplies g times, and a tile inside one group once.
// The K loop is K9's: 8 warps of 64 x 32, K in chunks of 32 staged by
// cp.async in two buffers, ldmatrix (lhs rows as the row-major A fragment,
// rhs rows transposed as the column-major B fragment), mma.sync m16n8k16
// with fp32 accumulators in registers. fp32 inputs take the CUDA cores, as
// K9's do: a 64 x 64 tile of 4 x 4 register micro-tiles over K chunks of 16
// in shared memory, fp32 FMAs, with the same walk over the groups.
#include "common.cuh"
#include "mma.cuh"

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

// -- fp32 inputs: CUDA cores ------------------------------------------------

constexpr int kFM = 64, kFN = 64, kFK = 16;

template <typename TO>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_f32_kernel(const float* __restrict__ lhs,
                          const float* __restrict__ rhs,
                          const int* __restrict__ ends, TO* __restrict__ out,
                          int M, int K, int N, int G, long long lda,
                          long long rhs_g, long long ldb) {
  __shared__ float as[kFK][kFM + 1];  // lhs tile, transposed; +1: no conflict
  __shared__ float bs[kFK][kFN];
  const int n0 = blockIdx.x * kFN, m0 = blockIdx.y * kFM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // 16 x 16
  const int m_end = min(m0 + kFM, M);

  int start = 0;
  for (int grp = 0; grp < G && start < m_end; ++grp) {
    const int end = grp == G - 1 ? M : min(ends[grp], M);
    const int lo = max(start, m0), hi = min(end, m_end);
    start = max(start, end);
    if (lo >= hi) continue;  // an empty group, or none of this tile's rows
    const float* w = rhs + grp * rhs_g;

    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += kFK) {
      for (int i = threadIdx.x; i < kFK * kFM; i += kThreads) {
        const int r = i / kFK, c = i % kFK;  // lhs rows are K-contiguous
        as[c][r] = (m0 + r < M && k0 + c < K) ? lhs[(m0 + r) * lda + k0 + c]
                                              : 0.f;
        const int t = i / kFN, n = i % kFN;
        bs[t][n] = (k0 + t < K && n0 + n < N) ? w[(k0 + t) * ldb + n0 + n]
                                              : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kFK; ++t) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[t][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = bs[t][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row < lo || row >= hi) continue;  // another group's row
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (col < N)
          out[static_cast<long long>(row) * N + col] =
              ptt::from_float<TO>(acc[i][j]);
      }
    }
  }
}

template <typename TO>
cudaError_t launch(const void* lhs, const void* rhs, const void* ends,
                   void* out, int M, int K, int N, int G, long long lda,
                   long long rhs_g, long long ldb, int in_f32,
                   cudaStream_t st) {
  if (in_f32) {
    const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
    grouped_matmul_f32_kernel<TO><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(rhs),
        static_cast<const int*>(ends), static_cast<TO*>(out), M, K, N, G,
        lda, rhs_g, ldb);
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

}  // namespace

// lhs [M, K] (row stride lda, unit column stride) and rhs [G, K, N] (group
// stride rhs_g, row stride ldb, unit column stride), both bf16 (in_f32 = 0)
// or both fp32 (in_f32 = 1); ends [G] int32,
// the cumulative sums of the group sizes; out [M, N] contiguous, fp32
// (out_bf16 = 0) or bf16 (1). Returns cudaGetLastError() after the launch.
extern "C" int grouped_matmul(const void* lhs, const void* rhs,
                              const void* ends, void* out, int M, int K,
                              int N, int G, long long lda, long long rhs_g,
                              long long ldb, int in_f32, int out_bf16,
                              void* stream) {
  if (G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch<__nv_bfloat16>(lhs, rhs, ends, out, M, K, N, G,
                                          lda, rhs_g, ldb, in_f32, st)
                  : launch<float>(lhs, rhs, ends, out, M, K, N, G, lda, rhs_g,
                                  ldb, in_f32, st);
}
