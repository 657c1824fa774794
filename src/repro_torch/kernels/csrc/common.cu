// Host helpers of the kernel library (no device code).
#include "common.cuh"

REPRO_EXPORT const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
