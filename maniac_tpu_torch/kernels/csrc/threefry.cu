// JAX's threefry stream for a block: split each replica's key and draw the
// block's uniforms, in one launch.
//
// Replaces no TPU kernel: the JAX package draws a block's uniforms with
// jax.random (an XLA op), maniac_tpu/mc/driver.py::run_steps :69-72 and
// block_body_group :98-101. For each replica b with key k_b this computes
// (k_next, k_sub) = split(k_b), writes k_next to the new keys, and writes
// uniform(k_sub, (n_steps, 21)) in f32 or f64, the same bits as
// jax.random in its partitionable mode (maniac_tpu_torch/utils/threefry.py
// is the plain version, with the recipe).
//
// Bound on the H100: operations. Each uniform is one threefry2x32 of its
// flat index, 72 32-bit integer operations (the two key adds, 20 rounds of
// add, funnel shift and xor, 5 key injections of one add each word), and a
// few more to make the float: some 0.04 ms at the main path's 8.6 M values
// against 0.01 ms to write them. Design: one thread a value, in CTAs of 256
// over one replica's n_steps x 21 values (grid (chunks, B)); warp 0 of each
// CTA splits the replica's key into shared memory, and the replica's first
// CTA writes the next key (to a buffer of its own: other CTAs still read
// the old key). Not tuned.
#include <cstdint>

#include "common.cuh"

namespace {

enum ThreefryPtr { TP_KEYS, TP_NEW_KEYS, TP_OUT, TP_COUNT };
enum ThreefryInt { TI_B, TI_N, TI_F64, TI_COUNT };

constexpr int THREADS = 256;

__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, r0); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r1); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r2); x1 ^= x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r3); x1 ^= x0;
}

// threefry2x32 of the counter pair (x0, x1) under the key (k0, k1), in place
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  rounds(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  rounds(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
}

// jax.random.uniform's conversion: the top mantissa bits under 1.0, minus 1
__device__ __forceinline__ float to_uniform(uint32_t x0, uint32_t x1,
                                            float*) {
  const float f = __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.f;
  return fmaxf(f, 0.f);
}

__device__ __forceinline__ double to_uniform(uint32_t x0, uint32_t x1,
                                             double*) {
  const unsigned long long bits =
      (static_cast<unsigned long long>(x0) << 20) | (x1 >> 12) |
      0x3FF0000000000000ull;
  return fmax(__longlong_as_double(static_cast<long long>(bits)) - 1.0, 0.0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
threefry_kernel(const long long* __restrict__ keys,
                long long* __restrict__ new_keys, T* __restrict__ out,
                int n) {
  __shared__ uint32_t sub[2];
  const int b = blockIdx.y;
  if (threadIdx.x < 32) {
    const uint32_t k0 = static_cast<uint32_t>(keys[2 * b]);
    const uint32_t k1 = static_cast<uint32_t>(keys[2 * b + 1]);
    uint32_t s0 = 0u, s1 = 1u;  // split's row 1: the block's subkey
    threefry2x32(k0, k1, s0, s1);
    if (threadIdx.x == 0) {
      sub[0] = s0;
      sub[1] = s1;
      if (blockIdx.x == 0) {
        uint32_t n0 = 0u, n1 = 0u;  // split's row 0: the next key
        threefry2x32(k0, k1, n0, n1);
        new_keys[2 * b] = n0;
        new_keys[2 * b + 1] = n1;
      }
    }
  }
  __syncthreads();
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= n) return;
  uint32_t x0 = 0u, x1 = static_cast<uint32_t>(c);
  threefry2x32(sub[0], sub[1], x0, x1);
  out[static_cast<size_t>(b) * n + c] = to_uniform(x0, x1, out);
}

}  // namespace

extern "C" int threefry_launch(void* const* ptrs, int nptr, const int* ints,
                               int nint, const float* floats, int nfloat,
                               void* stream) {
  (void)floats;
  if (nptr != TP_COUNT || nint != TI_COUNT || nfloat != 0)
    return MANIAC_ERR_TABLES;
  const int B = ints[TI_B], n = ints[TI_N];
  if (B < 1 || B > 65535 || n < 1) return MANIAC_ERR_SHAPE;
  const dim3 grid((n + THREADS - 1) / THREADS, B);
  const auto* keys = static_cast<const long long*>(ptrs[TP_KEYS]);
  auto* new_keys = static_cast<long long*>(ptrs[TP_NEW_KEYS]);
  auto s = static_cast<cudaStream_t>(stream);
  if (ints[TI_F64])
    threefry_kernel<double><<<grid, THREADS, 0, s>>>(
        keys, new_keys, static_cast<double*>(ptrs[TP_OUT]), n);
  else
    threefry_kernel<float><<<grid, THREADS, 0, s>>>(
        keys, new_keys, static_cast<float*>(ptrs[TP_OUT]), n);
  return (int)cudaGetLastError();
}
