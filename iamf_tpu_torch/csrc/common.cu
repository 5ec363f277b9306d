// Shared C entry of the kernel library: error text for the ctypes wrapper.
#include <cuda_runtime.h>

extern "C" const char* iamf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
