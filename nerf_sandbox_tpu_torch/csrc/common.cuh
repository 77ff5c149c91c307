// What every kernel library of csrc/ shares: the bf16 type and the error
// string the Python loaders (ops/cuda_build.py) read through ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace nerf {
using bf16 = __nv_bfloat16;
}  // namespace nerf

// weak: every object of a library built in parts carries it; one is kept
extern "C" __attribute__((weak)) const char* nerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
