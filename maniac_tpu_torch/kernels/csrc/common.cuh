// Shared device helpers for the maniac_tpu_torch CUDA kernels.
//
// Counterparts of maniac_tpu/kernels/common.py: the per-axis complex phase
// powers (_powers) and the signed-index convention of _signed_table become
// device functions here. The f32 erfc is libdevice erfcf (max error 4 ulp,
// tighter than the JAX package's erfcx polynomial, <= 3.1e-7 absolute);
// the library is built without --use_fast_math, so expf, sincosf and erfcf
// keep full f32 accuracy.
//
// Every launcher has a plain C interface: a table of device pointers, a
// table of ints, a table of floats (each with its length, checked against
// the kernel's enum) and the CUDA stream. It returns a cudaError_t, or one
// of the MANIAC_ERR_* codes below for a malformed call.
#pragma once

#include <cuda_runtime.h>

#define MANIAC_ERR_TABLES 100001   // argument table lengths do not match
#define MANIAC_ERR_SHAPE 100002    // a size the kernel does not take

// (re, im) of e^{i j theta} at signed index j from a table of powers
// j = 0..k; negative j is the complex conjugate of |j|.
__device__ __forceinline__ float2 signed_power(const float2* p, int j) {
  float2 v = p[j < 0 ? -j : j];
  if (j < 0) v.y = -v.y;
  return v;
}

// Powers e^{i j theta}, j = 0..k, by repeated complex multiply from one
// sincosf, as maniac_tpu/kernels/common.py::_powers.
__device__ __forceinline__ void phase_powers(float theta, int k, float2* out) {
  float s, c;
  sincosf(theta, &s, &c);
  float re = 1.f, im = 0.f;
  out[0] = make_float2(1.f, 0.f);
  for (int j = 1; j <= k; ++j) {
    const float nr = re * c - im * s;
    const float ni = re * s + im * c;
    re = nr;
    im = ni;
    out[j] = make_float2(re, im);
  }
}

// Squared minimum-image distance in an orthorhombic box (rintf rounds half
// to even, like jnp.round / torch.round).
__device__ __forceinline__ float min_image_r2(float dx, float dy, float dz,
                                              const float* L) {
  dx -= L[0] * rintf(dx / L[0]);
  dy -= L[1] * rintf(dy / L[1]);
  dz -= L[2] * rintf(dz / L[2]);
  return dx * dx + dy * dy + dz * dz;
}

// Sum of NV values over the block; every thread gets the totals in out.
// scratch holds (blockDim.x / 32) * NV floats. Warp shuffles, then one
// sequential pass over the warps: the order is fixed run to run.
template <int NV>
__device__ void block_sum(float (&v)[NV], float* scratch, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float x = v[i];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) scratch[warp * NV + i] = x;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.f;
    for (int w = 0; w < nwarp; ++w) s += scratch[w * NV + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}
