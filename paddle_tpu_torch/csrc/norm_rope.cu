// K1 rms_norm and K2 fused_rope for Hopper (sm_90a).
//
// K1 replaces paddle_tpu/ops/pallas_kernels.py::rms_norm (_rms_kernel,
// launched through pl.pallas_call in _rms_fwd_impl at pallas_kernels.py:67):
//   y[r, :] = x[r, :] * rsqrt(sum(x[r, :]^2) / H + eps) * w
// over rows of H, fp32 throughout, one rounding to x's type at the end.
//
// K2 replaces paddle_tpu/ops/pallas_kernels.py::fused_rope (_rope_kernel,
// launched through pl.pallas_call in _rope_impl at pallas_kernels.py:245):
// the rotate-half rotary embedding of x [B, S, H, D] by tables cos, sin
// [S, D/2] that every batch row and head shares:
//   out[.., :D/2] = x1 cos - x2 sin,  out[.., D/2:] = x2 cos + x1 sin
// with x1, x2 the two halves of D, fp32 products and differences (not
// contracted into FMAs, so the values before the final rounding are the
// plain version's), one rounding to x's type. The backward of K2 is K2 on
// (dO, cos, -sin).
//
// What bounds them: both read each input once and write each output once,
// with a handful of flops per element, so memory bandwidth bounds them:
// 2 H bytes-per-element a row (K1), 2 D a head and position (K2). At the
// training shapes ([8,2048,1024] and [8,2048,8,128], bf16) that is 67 MB,
// 20 us at 3.35 TB/s; at a prefill (S = 512, 7B widths) 8.4 MB, 2.5 us, so
// a launch's fixed start-up and its first dependent trip to memory weigh as
// much as the stream; at a decode step (8 rows) only those are left.
//
// Design, K1 (rms_norm_vec_kernel): a team of W warps owns a row; every lane
// holds N 16-byte chunks of it in registers, neighbouring lanes on
// neighbouring chunks (each load instruction of a warp reads 512 contiguous
// bytes). The sum of squares is reduced by __shfl_xor_sync within a warp
// (four partial sums a lane, so the FMAs do not form one chain); a team of 8
// warps adds its warps' sums through shared memory behind a barrier. The
// split, from a sweep on an H100: a row of up to 2 KB takes one warp at up
// to 4 chunks a lane (the training step's 16384 rows of H = 1024 in bf16,
// where 2 or 8 warps a row were slower), a wider row 8 warps at up to 8
// chunks a lane (H = 4096 in bf16, 2 chunks: the prefill, generate and
// decode rows, where 4 warps at 4 chunks were slower, and one warp at 16
// slower still, its instances spilling). w's chunks are loaded once per
// team, before the first row and together with its loads, and stay in
// registers for every row the team walks (at 8 chunks a lane, and for fp32
// weights under a 16-bit x, they are read again for every row, from L1). The
// grid depends on the shapes only: as many teams as the SMs hold at once at
// the instance's registers (the wrapper's rms_norm_plan), then a stride over
// rows, and each team issues its next row's loads before it reduces the
// current one, so two rows are in flight; where those teams outnumber the
// rows, an instance without the stride (a fifth fewer instructions than the
// striding one) takes one row a team. x is read and y written as streams
// (ld.global.cs / st.global.cs, evict-first), so the training step's passes
// do not evict what L2 holds (faster there than plain loads and stores).
// Offsets are 32-bit; tensors whose offsets do not fit take the element-wise
// path.
//
// Design, K2 (rope_vec_kernel): a block of (C, P, T) threads, C the 16-byte
// chunks of a half, takes P heads of T positions; thread (j, p, t) loads
// chunk j of its position's cos and sin rows (one fetch from memory a block:
// its P heads' threads hit L1) and chunk j of both halves of its head, 16
// bytes each, and stores 16 bytes of each output half. The grid (positions /
// T, batch rows, heads / P) covers every (position, head, chunk) once, so a
// thread finds its work without dividing or looping and issues its four
// loads at once, with 32-bit offsets (a version that walked heads and
// positions in loops, with 64-bit offsets and a division of a flat index,
// took longer at the prefill and decode shapes on an H100). P is every head
// that fits 256 threads, halved where the positions alone would leave SMs
// idle (a decode step: 16 blocks for 8 positions). The x strides of b, s and
// h are the caller's, so q and k views of a fused projection are read in
// place; the output is contiguous.
//
// Rows, heads or tables that are not 16-byte aligned, and widths that are
// not a whole number of 16-byte chunks, take the element-wise kernels of
// the same file (rms_norm_elem_kernel, rope_elem_kernel); the wrapper's
// kernel_for picks the path and these entry points refuse a vector path
// the pointers or strides do not allow. No atomics and a fixed order of
// every sum: two launches give bitwise-equal outputs.
#include "common.cuh"

namespace {

constexpr int kRmsThreads = 128;  // a block of K1's element-wise path
constexpr int kRmsWarps = kRmsThreads / 32;
constexpr int kRopeThreads = 256;  // a block of K2 at most
// the vector paths count elements in 32 bits: no offset may pass this
constexpr long long kMaxIndex = 0x7fffffff;

// A K1 vector block with W warps a row (1 or 8) and N chunks a lane: 4
// teams of a warp, or one team of 8 warps, and the blocks an SM holds of
// it: its registers are about 12 N a thread (two rows in flight and w; w
// stays in L1 at N = 8) plus addressing. ops/fused_kernels.py's
// _RMS_BLOCKS_PER_SM holds the same table.
template <int W, int N>
struct RmsShape {
  static_assert(W == 1 || W == 8, "a warp or 8 warps a row");
  static constexpr int kWarps = W > 4 ? W : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kTeams = kWarps / W;
  static constexpr int kBlocks = W == 1 ? (N >= 4 ? 6 : 8)
                                        : (N >= 8 ? 2 : N >= 4 ? 3 : 4);
};

// 16 bytes of T as floats, and back.
template <typename T>
struct Chunk {
  static constexpr int kEl = 16 / static_cast<int>(sizeof(T));
};

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8],
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8],
                                       __half) {
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __half22float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4],
                                       float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ uint4 pack(const float (&f)[8], __nv_bfloat16) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}
__device__ __forceinline__ uint4 pack(const float (&f)[8], __half) {
  uint4 u;
  __half2* h = reinterpret_cast<__half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
  return u;
}
__device__ __forceinline__ uint4 pack(const float (&f)[4], float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// kEl values of type Tv (T itself, or fp32 weights or tables under a
// narrower x) that go with one 16-byte chunk of x: one or two 16-byte
// words, read through the read-only path (they are reused).
template <typename T, typename Tv>
struct Side {
  static constexpr int kEl = Chunk<T>::kEl;
  static constexpr int kWords = kEl * static_cast<int>(sizeof(Tv)) / 16;
  uint4 u[kWords];
  __device__ __forceinline__ void load(const Tv* p) {
#pragma unroll
    for (int i = 0; i < kWords; ++i)
      u[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  __device__ __forceinline__ void get(float (&f)[kEl]) const {
    if constexpr (sizeof(Tv) == sizeof(T)) {
      unpack(u[0], f, T{});
    } else {  // fp32 values under a 16-bit x
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        float g[4];
        unpack(u[i], g, float{});
#pragma unroll
        for (int e = 0; e < 4; ++e) f[4 * i + e] = g[e];
      }
    }
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// -- K1: vector path ---------------------------------------------------------

// Team (blockIdx.x * teams + warp / W) takes rows team, team + teams, ..
// (kStride), or that row alone where the grid covers every row once; lane l
// of warp i of a team holds chunks j * 32 W + 32 i + l, j < N, of its row
// (those below the row's h / kEl chunks).
template <typename T, typename Tw, int W, int N, bool kStride>
__global__ void __launch_bounds__(RmsShape<W, N>::kThreads,
                                  RmsShape<W, N>::kBlocks)
    rms_norm_vec_kernel(const T* __restrict__ x, const Tw* __restrict__ w,
                        T* __restrict__ y, int rows, int h, int x_stride,
                        float eps) {
  constexpr int kEl = Chunk<T>::kEl;
  constexpr int kTeams = RmsShape<W, N>::kTeams;
  __shared__ float red[2][RmsShape<W, N>::kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int team = warp / W;
  const int tl = (warp % W) * 32 + lane;  // lane in the team
  const int chunks = h / kEl;
  const int stride = gridDim.x * kTeams;
  int row = blockIdx.x * kTeams + team;

  // w in registers, unless it would crowd two rows (8 chunks a lane) or
  // fp32 weights under a 16-bit x would double it: then it is read again
  // for every row, from L1
  constexpr bool kKeepW = sizeof(Tw) == sizeof(T) && N <= 4;
  Side<T, Tw> wc[kKeepW ? N : 1];
  uint4 cur[N], nxt[N];
  // The first row's loads and w's. Without the stride they go out
  // unconditionally, all at once: a lane past the row's chunks re-reads its
  // last chunk and a team past the rows the last row (neither is used);
  // under a branch the compiler placed their first use inside it, so each
  // chunk waited for the one before (slower at a decode step on an H100).
  // The striding instance keeps the branch, which read faster at the
  // training shape.
  if constexpr (kStride) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = j * 32 * W + tl;
      if (c < chunks) {
        if constexpr (kKeepW) wc[j].load(w + c * kEl);
        if (row < rows)
          cur[j] = __ldcs(reinterpret_cast<const uint4*>(x + row * x_stride) +
                          c);
      }
    }
  } else {
    const uint4* x0 =
        reinterpret_cast<const uint4*>(x + min(row, rows - 1) * x_stride);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = min(j * 32 * W + tl, chunks - 1);
      if constexpr (kKeepW) wc[j].load(w + c * kEl);
      cur[j] = __ldcs(x0 + c);
    }
  }
  const float inv_h = 1.f / static_cast<float>(h);
  int parity = 0;
  for (; row < rows; row += stride) {
    const int next = row + stride;
    if (kStride && next < rows) {
      const uint4* xn = reinterpret_cast<const uint4*>(x + next * x_stride);
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int c = j * 32 * W + tl;
        if (c < chunks) nxt[j] = __ldcs(xn + c);
      }
    }
    // four partial sums, so the FMAs do not wait on each other in one chain
    float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (j * 32 * W + tl < chunks) {
        float f[kEl];
        unpack(cur[j], f, T{});
#pragma unroll
        for (int e = 0; e < kEl; ++e)
          part[e % 4] = fmaf(f[e], f[e], part[e % 4]);
      }
    }
    float ss = warp_sum((part[0] + part[1]) + (part[2] + part[3]));
    if constexpr (W > 1) {
      // the team's warps, in order; red[parity] is written again two rows
      // later, after every warp of the team has passed the next barrier
      if (lane == 0) red[parity][warp] = ss;
      asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "r"(W * 32)
                   : "memory");
      ss = 0.f;
#pragma unroll
      for (int i = 0; i < W; ++i) ss += red[parity][team * W + i];
      parity ^= 1;
    }
    const float r = rsqrtf(ss * inv_h + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + row * h);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int c = j * 32 * W + tl;
      if (c < chunks) {
        float f[kEl], g[kEl];
        unpack(cur[j], f, T{});
        if constexpr (kKeepW) {
          wc[j].get(g);
        } else {
          Side<T, Tw> wj;
          wj.load(w + c * kEl);
          wj.get(g);
        }
#pragma unroll
        for (int e = 0; e < kEl; ++e) f[e] = __fmul_rn(__fmul_rn(f[e], r), g[e]);
        __stcs(yr + c, pack(f, T{}));
      }
    }
    if constexpr (!kStride) break;
#pragma unroll
    for (int j = 0; j < N; ++j) cur[j] = nxt[j];
  }
}

// -- K1: element-wise path (any h, any alignment) ----------------------------

// A warp a row (team = warp), rows as in the vector path; x is read twice,
// the second time from L2.
template <typename T, typename Tw>
__global__ void __launch_bounds__(kRmsThreads)
    rms_norm_elem_kernel(const T* __restrict__ x, const Tw* __restrict__ w,
                         T* __restrict__ y, long long rows, int h,
                         long long x_stride, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kRmsWarps;
  const float inv_h = 1.f / static_cast<float>(h);
  for (long long row = static_cast<long long>(blockIdx.x) * kRmsWarps + warp;
       row < rows; row += stride) {
    const T* xr = x + row * x_stride;
    float ss = 0.f;
    for (int c = lane; c < h; c += 32) {
      const float f = ptt::to_float(xr[c]);
      ss = fmaf(f, f, ss);
    }
    const float r = rsqrtf(warp_sum(ss) * inv_h + eps);
    for (int c = lane; c < h; c += 32)
      y[row * h + c] = ptt::from_float<T>(
          __fmul_rn(__fmul_rn(ptt::to_float(xr[c]), r), ptt::to_float(w[c])));
  }
}

// The instance without the stride where the blocks' teams cover every row
// once (a prefill or a decode step), else the striding one.
template <typename T, typename Tw, int W, int N>
cudaError_t rms_launch(const void* x, const void* w, void* y, long long rows,
                       int h, long long xs, float eps, int blocks,
                       cudaStream_t st) {
  const bool stride = 1LL * blocks * RmsShape<W, N>::kTeams < rows;
  auto kernel = stride ? rms_norm_vec_kernel<T, Tw, W, N, true>
                       : rms_norm_vec_kernel<T, Tw, W, N, false>;
  kernel<<<blocks, RmsShape<W, N>::kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const Tw*>(w),
      static_cast<T*>(y), static_cast<int>(rows), h, static_cast<int>(xs),
      eps);
  return cudaGetLastError();
}

template <typename T, typename Tw>
cudaError_t rms_dispatch(const void* x, const void* w, void* y,
                         long long rows, int h, long long xs, float eps,
                         int warps_per_row, int chunks_per_lane, int blocks,
                         cudaStream_t st) {
  constexpr int kEl = Chunk<T>::kEl;
  if (rows <= 0 || h <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  if (chunks_per_lane == 0) {
    rms_norm_elem_kernel<T, Tw><<<blocks, kRmsThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const Tw*>(w),
        static_cast<T*>(y), rows, h, xs, eps);
    return cudaGetLastError();
  }
  // the vector path reads and writes whole, aligned 16-byte chunks, counts
  // elements in 32 bits, and the team's lanes must cover the row
  const long long cover = 32LL * warps_per_row * chunks_per_lane * kEl;
  if (h % kEl || xs % kEl || !ptt::aligned16(x) || !ptt::aligned16(w) ||
      !ptt::aligned16(y) || cover < h || xs < 0 ||
      (rows - 1) * xs + h > kMaxIndex || rows * h > kMaxIndex)
    return cudaErrorInvalidValue;
  const int wn = warps_per_row * 100 + chunks_per_lane;
  switch (wn) {
    case 101: return rms_launch<T, Tw, 1, 1>(x, w, y, rows, h, xs, eps, blocks, st);
    case 102: return rms_launch<T, Tw, 1, 2>(x, w, y, rows, h, xs, eps, blocks, st);
    case 104: return rms_launch<T, Tw, 1, 4>(x, w, y, rows, h, xs, eps, blocks, st);
    case 801: return rms_launch<T, Tw, 8, 1>(x, w, y, rows, h, xs, eps, blocks, st);
    case 802: return rms_launch<T, Tw, 8, 2>(x, w, y, rows, h, xs, eps, blocks, st);
    case 804: return rms_launch<T, Tw, 8, 4>(x, w, y, rows, h, xs, eps, blocks, st);
    case 808: return rms_launch<T, Tw, 8, 8>(x, w, y, rows, h, xs, eps, blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

// -- K2: vector path ---------------------------------------------------------

// Block (C, P, teams), grid (ceil(seq / teams), bsz, ceil(heads / P)):
// thread (j, p, t) of block (x, b, z) takes chunk j of each half of head
// z P + p at position (b, x teams + t). Nothing is divided and nothing
// loops, and offsets are 32-bit (the wrapper keeps this path to tensors
// whose offsets fit), so each thread issues its four loads at once.
template <typename T, typename Tc>
__global__ void __launch_bounds__(kRopeThreads)
    rope_vec_kernel(const T* __restrict__ x, const Tc* __restrict__ cos_t,
                    const Tc* __restrict__ sin_t, T* __restrict__ out,
                    int seq, int heads, int half, int sxb, int sxs, int sxh,
                    int scs, int sss) {
  constexpr int kEl = Chunk<T>::kEl;
  const int j = threadIdx.x, hh = blockIdx.z * blockDim.y + threadIdx.y;
  const int s = blockIdx.x * blockDim.z + threadIdx.z, b = blockIdx.y;
  if (hh >= heads || s >= seq) return;
  const T* xp = x + b * sxb + s * sxs + hh * sxh + j * kEl;
  Side<T, Tc> cs, sn;
  cs.load(cos_t + s * scs + j * kEl);
  sn.load(sin_t + s * sss + j * kEl);
  const uint4 u1 = __ldcs(reinterpret_cast<const uint4*>(xp));
  const uint4 u2 = __ldcs(reinterpret_cast<const uint4*>(xp + half));
  float c[kEl], sv[kEl], x1[kEl], x2[kEl], o1[kEl], o2[kEl];
  cs.get(c);
  sn.get(sv);
  unpack(u1, x1, T{});
  unpack(u2, x2, T{});
#pragma unroll
  for (int e = 0; e < kEl; ++e) {
    o1[e] = __fsub_rn(__fmul_rn(x1[e], c[e]), __fmul_rn(x2[e], sv[e]));
    o2[e] = __fadd_rn(__fmul_rn(x2[e], c[e]), __fmul_rn(x1[e], sv[e]));
  }
  T* op = out + ((b * seq + s) * heads + hh) * 2 * half + j * kEl;
  __stcs(reinterpret_cast<uint4*>(op), pack(o1, T{}));
  __stcs(reinterpret_cast<uint4*>(op + half), pack(o2, T{}));
}

// -- K2: element-wise path (any even D, any alignment) -----------------------

// A block a position at a time, positions walked as in the vector path,
// its threads over the position's heads x half pairs.
template <typename T, typename Tc>
__global__ void __launch_bounds__(kRopeThreads)
    rope_elem_kernel(const T* __restrict__ x, const Tc* __restrict__ cos_t,
                     const Tc* __restrict__ sin_t, T* __restrict__ out,
                     int bsz, int seq, int heads, int half, long long sxb,
                     long long sxs, long long sxh, long long scs,
                     long long sss) {
  const int pairs = heads * half;
  for (int b = blockIdx.y; b < bsz; b += gridDim.y) {
    for (int s = blockIdx.x; s < seq; s += gridDim.x) {
      T* op = out + (static_cast<long long>(b) * seq + s) * heads * 2 * half;
      for (int e = threadIdx.x; e < pairs; e += blockDim.x) {
        const int hh = e / half, i = e % half;
        const float c = ptt::to_float(cos_t[s * scs + i]);
        const float sv = ptt::to_float(sin_t[s * sss + i]);
        const T* xr = x + b * sxb + s * sxs + hh * sxh;
        const float x1 = ptt::to_float(xr[i]);
        const float x2 = ptt::to_float(xr[half + i]);
        T* orow = op + static_cast<long long>(hh) * 2 * half;
        orow[i] = ptt::from_float<T>(
            __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, sv)));
        orow[half + i] = ptt::from_float<T>(
            __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, sv)));
      }
    }
  }
}

template <typename T, typename Tc>
cudaError_t rope_dispatch(const void* x, const void* cs, const void* sn,
                          void* out, int bsz, int seq, int heads, int half,
                          long long sxb, long long sxs, long long sxh,
                          long long scs, long long sss, int heads_per_pass,
                          int teams, int grid_s, int grid_b, int grid_h,
                          cudaStream_t st) {
  constexpr int kEl = Chunk<T>::kEl;
  constexpr int kTabEl = 16 / static_cast<int>(sizeof(Tc));
  // a position's pairs are counted in 32 bits
  if (bsz <= 0 || seq <= 0 || heads <= 0 || half <= 0 || grid_s <= 0 ||
      grid_b <= 0 || grid_b > 65535 || grid_h <= 0 || grid_h > 65535 ||
      (heads_per_pass == 0 && grid_h != 1) ||
      1LL * heads * half > kMaxIndex)
    return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const Tc* cp = static_cast<const Tc*>(cs);
  const Tc* sp = static_cast<const Tc*>(sn);
  T* op = static_cast<T*>(out);
  const dim3 grid(grid_s, grid_b, grid_h);
  if (heads_per_pass == 0) {
    rope_elem_kernel<T, Tc><<<grid, kRopeThreads, 0, st>>>(
        xp, cp, sp, op, bsz, seq, heads, half, sxb, sxs, sxh, scs, sss);
    return cudaGetLastError();
  }
  // whole, aligned 16-byte chunks of x, out and the tables, offsets in 32
  // bits, a block of at most 256 threads, and a grid that covers every
  // position and head exactly
  const int chunks = half / kEl;
  const long long x_end = (bsz - 1LL) * sxb + (seq - 1LL) * sxs +
                          (heads - 1LL) * sxh + 2LL * half;
  if (half % kEl || sxb % kEl || sxs % kEl || sxh % kEl || scs % kTabEl ||
      sss % kTabEl || !ptt::aligned16(x) || !ptt::aligned16(cs) ||
      !ptt::aligned16(sn) || !ptt::aligned16(out) || sxb < 0 || sxs < 0 ||
      sxh < 0 || scs < 0 || sss < 0 || x_end > kMaxIndex ||
      1LL * bsz * seq * heads * 2 * half > kMaxIndex ||
      (seq - 1LL) * (scs > sss ? scs : sss) + half > kMaxIndex ||
      teams <= 0 || heads_per_pass <= 0 ||
      1LL * chunks * heads_per_pass * teams > kRopeThreads ||
      grid_b != bsz || 1LL * grid_s * teams < seq ||
      1LL * grid_h * heads_per_pass < heads)
    return cudaErrorInvalidValue;
  rope_vec_kernel<T, Tc><<<grid, dim3(chunks, heads_per_pass, teams), 0,
                           st>>>(
      xp, cp, sp, op, seq, heads, half, static_cast<int>(sxb),
      static_cast<int>(sxs), static_cast<int>(sxh), static_cast<int>(scs),
      static_cast<int>(sss));
  return cudaGetLastError();
}

}  // namespace

// x [rows, h] with row stride x_stride (elements; unit stride along h), w
// [h] of x's type or fp32 (w_f32), y [rows, h] contiguous, all of x's
// dtype: 0 bf16, 1 fp16, 2 fp32. warps_per_row, chunks_per_lane and
// blocks are ops/fused_kernels.py::rms_norm_plan's; chunks_per_lane 0 runs
// the element-wise path. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue, without a launch, for a plan the arguments do
// not allow).
extern "C" int rms_norm(const void* x, const void* w, void* y,
                        long long rows, int h, long long x_stride, float eps,
                        int dtype, int w_f32, int warps_per_row,
                        int chunks_per_lane, int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int wp = warps_per_row, nc = chunks_per_lane;
  switch (dtype * 2 + (w_f32 ? 1 : 0)) {
    case 0: return rms_dispatch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, h, x_stride, eps, wp, nc, blocks, st);
    case 1: return rms_dispatch<__nv_bfloat16, float>(x, w, y, rows, h, x_stride, eps, wp, nc, blocks, st);
    case 2: return rms_dispatch<__half, __half>(x, w, y, rows, h, x_stride, eps, wp, nc, blocks, st);
    case 3: return rms_dispatch<__half, float>(x, w, y, rows, h, x_stride, eps, wp, nc, blocks, st);
    case 4:
    case 5: return rms_dispatch<float, float>(x, w, y, rows, h, x_stride, eps, wp, nc, blocks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x [bsz, seq, heads, 2 half] with element strides sxb, sxs, sxh (unit
// stride on D); cos, sin [seq, half] with row strides scs, sss (unit
// stride), of x's type or fp32 (tab_f32); out [bsz, seq, heads, 2 half]
// contiguous, of x's dtype (0 bf16, 1 fp16, 2 fp32). heads_per_pass,
// teams, grid_s and grid_b are ops/fused_kernels.py::rope_plan's;
// heads_per_pass 0 runs the element-wise path. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue, without a launch, for a plan the
// arguments do not allow).
extern "C" int fused_rope(const void* x, const void* cos_t,
                          const void* sin_t, void* out, int bsz, int seq,
                          int heads, int half, long long sxb, long long sxs,
                          long long sxh, long long scs, long long sss,
                          int dtype, int tab_f32, int heads_per_pass,
                          int teams, int grid_s, int grid_b, int grid_h,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (tab_f32 ? 1 : 0)) {
    case 0: return rope_dispatch<__nv_bfloat16, __nv_bfloat16>(x, cos_t, sin_t, out, bsz, seq, heads, half, sxb, sxs, sxh, scs, sss, heads_per_pass, teams, grid_s, grid_b, grid_h, st);
    case 1: return rope_dispatch<__nv_bfloat16, float>(x, cos_t, sin_t, out, bsz, seq, heads, half, sxb, sxs, sxh, scs, sss, heads_per_pass, teams, grid_s, grid_b, grid_h, st);
    case 2: return rope_dispatch<__half, __half>(x, cos_t, sin_t, out, bsz, seq, heads, half, sxb, sxs, sxh, scs, sss, heads_per_pass, teams, grid_s, grid_b, grid_h, st);
    case 3: return rope_dispatch<__half, float>(x, cos_t, sin_t, out, bsz, seq, heads, half, sxb, sxs, sxh, scs, sss, heads_per_pass, teams, grid_s, grid_b, grid_h, st);
    case 4:
    case 5: return rope_dispatch<float, float>(x, cos_t, sin_t, out, bsz, seq, heads, half, sxb, sxs, sxh, scs, sss, heads_per_pass, teams, grid_s, grid_b, grid_h, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
