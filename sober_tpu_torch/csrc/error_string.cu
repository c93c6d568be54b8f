// Name of a CUDA error code, for the Python wrappers' messages.
#include <cuda_runtime.h>

extern "C" const char* sober_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
