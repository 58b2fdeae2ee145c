// Error text for the codes the kernel entry points return.
#include "common.cuh"

DH_EXPORT const char* dh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
