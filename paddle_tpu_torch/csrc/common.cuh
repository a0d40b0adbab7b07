// Shared by every kernel library of paddle_tpu_torch (each csrc/*.cu builds
// into its own shared library, see ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The wrappers raise with this text when an entry point returns an error.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace ptt {

constexpr float kNeg = -1e30f;  // large-negative mask value: no inf - inf NaNs

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

}  // namespace ptt
