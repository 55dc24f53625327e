// Error text for the codes that every entry point of the library returns
// (each returns cudaGetLastError() right after its launch).
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
