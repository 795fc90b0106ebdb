// One-hot f32 product of the hardware-precision probe (stage 1).
//
// Replaces the Pallas kernel of maniac_tpu/utils/hwprobe.py::
// probe_onehot_exact (inner k, pallas_call at :62). There it asks whether
// the TPU's matrix unit rounds f32 operands to bf16. On this card the
// counterpart risk is TF32 (a 10-bit mantissa) in a library product; this
// kernel computes the product the way the port's own kernels compute every
// product: f32 FMA on the CUDA cores, no tensor cores, no TF32. A column
// read through a one-hot matrix is then exact: one product x * 1 and the
// rest +-0, summed without rounding.
//
// Bound on the H100: bytes, and at the probe's (8, 256) x (256, 8) a few
// KB, so a launch's latency. Design: one thread per output element, a
// sequential f32 FMA over the inner dimension.
#include "common.cuh"

namespace {

enum OnehotPtr { OP_X, OP_OH, OP_OUT, OP_COUNT };
enum OnehotInt { OI_M, OI_K, OI_N, OI_COUNT };

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
onehot_kernel(const float* __restrict__ x, const float* __restrict__ oh,
              float* __restrict__ out, int M, int K, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  const int r = i / N, c = i - r * N;
  float acc = 0.f;
  for (int k = 0; k < K; ++k) acc = fmaf(x[r * K + k], oh[k * N + c], acc);
  out[i] = acc;
}

}  // namespace

extern "C" int onehot_launch(void* const* ptrs, int nptr, const int* ints,
                             int nint, const float* floats, int nfloat,
                             void* stream) {
  (void)floats;
  if (nptr != OP_COUNT || nint != OI_COUNT || nfloat != 0)
    return MANIAC_ERR_TABLES;
  const int M = ints[OI_M], K = ints[OI_K], N = ints[OI_N];
  if (M < 1 || K < 1 || N < 1) return MANIAC_ERR_SHAPE;
  const int blocks = (M * N + THREADS - 1) / THREADS;
  onehot_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ptrs[OP_X]),
      static_cast<const float*>(ptrs[OP_OH]), static_cast<float*>(ptrs[OP_OUT]),
      M, K, N);
  return (int)cudaGetLastError();
}
