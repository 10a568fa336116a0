// Error reporting shared by the kernels' C entry points.
#include <cuda_runtime.h>

extern "C" const char* lako_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
