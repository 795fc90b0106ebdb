// An empty kernel behind the launchers' plain C interface.
//
// It prices the launch path itself (maniac_tpu_torch/tools/launch_cost.py):
// the host's cost of packing a launcher's tables, calling through ctypes and
// enqueueing a kernel, apart from any kernel's work. It takes tables of any
// length and reads none of them.
#include "common.cuh"

namespace {

__global__ void noop_kernel() {}

}  // namespace

extern "C" int noop_launch(void* const* ptrs, int nptr, const int* ints,
                           int nint, const float* floats, int nfloat,
                           void* stream) {
  (void)ptrs;
  (void)nptr;
  (void)ints;
  (void)nint;
  (void)floats;
  (void)nfloat;
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
