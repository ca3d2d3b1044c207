// The CUDA runtime's message for an error code that an entry point returned.

#include <cuda_runtime.h>

extern "C" const char* sek_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
