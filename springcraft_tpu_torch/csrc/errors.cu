// Message of a CUDA error code returned by the port's C entry points.

#include <cuda_runtime.h>

extern "C" const char* sc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
