// Shared C entry point of the repro_torch kernel library: the text of a
// CUDA error code, for the Python wrappers' error messages.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
