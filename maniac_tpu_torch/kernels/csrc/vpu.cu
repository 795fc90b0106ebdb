// Micro-benchmarks of the f32 primitives the pair and framework passes are
// built from.
//
// Replaces the two Pallas kernels of tools/vpu_bench.py:
//   K7 `kernel` (:57, launched by run at :63, pallas_call :67): n
//      loop-carried applications of one op to every element of a plane;
//   K8 `kern` in run_cpass (:108, pallas_call :148): the framework Coulomb
//      pass's plane math n times (the per-row scalars, the min-image wrap,
//      r2, rsqrt, the erfc polynomial, the cut-off select, the sum).
// They price primitives in the instructions nvcc emits for blockg.cu and
// stepg.cu, so the build keeps its flags (no --use_fast_math): div is the
// IEEE division, sqrtf the rounded root, expf libdevice's, rsqrtf the
// approximate reciprocal root, rintf rounds half to even like jnp.round.
//
// Bound on the H100: operations (n dependent ops per element against one
// read and one write of the plane; transcendentals run on the SFU, 16
// results per SM and clock against 128 FMAs, which the bound, counting
// each as one operation, does not see). Design: one thread per element, the op chain
// in registers; the ops are a template parameter, so each instantiation
// is the bare chain.
#include "common.cuh"

namespace {

// the op list of tools/vpu_bench.py::_ops, in kernels/vpu.py::VPU_OPS order
enum VpuOp { V_FMA, V_MUL2, V_DIV, V_RSQRT, V_SQRT, V_EXP, V_ROUND, V_CMPSEL,
             V_ERFC, V_COUNT };

// the erfc cost probe of tools/vpu_bench.py:46-53, as written there: the
// A&S 7.1.26 coefficients applied highest power first (not erfc)
__device__ __forceinline__ float erfc_probe(float x) {
  const float t = 1.f / (1.f + 0.3275911f * x);
  float acc = 0.254829592f;
  acc = acc * t + -0.284496736f;
  acc = acc * t + 1.421413741f;
  acc = acc * t + -1.453152027f;
  acc = acc * t + 1.061405429f;
  return acc * expf(-x * x);
}

template <int OP>
__device__ __forceinline__ float apply_op(float x) {
  if constexpr (OP == V_FMA) return fmaf(x, 1.000001f, 1e-6f);
  if constexpr (OP == V_MUL2) return (x * 1.000001f) * 0.999999f;
  if constexpr (OP == V_DIV) return 1.f / (x + 1.f);
  if constexpr (OP == V_RSQRT) return rsqrtf(x + 1.f);
  if constexpr (OP == V_SQRT) return sqrtf(x + 1.f);
  if constexpr (OP == V_EXP) return expf(-x);
  if constexpr (OP == V_ROUND) return x - rintf(x * 0.3f);
  if constexpr (OP == V_CMPSEL) return x > 0.5f ? x * 0.999f : x * 1.001f;
  if constexpr (OP == V_ERFC) return erfc_probe(x);
  return x;
}

constexpr int THREADS = 256;

template <int OP>
__global__ void __launch_bounds__(THREADS)
chain_kernel(const float* __restrict__ x, float* __restrict__ out, int count,
             int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = x[i];
  // unrolled, so that the loop's counter and branch do not price the op
#pragma unroll 16
  for (int k = 0; k < n; ++k) v = apply_op<OP>(v);
  out[i] = v;
}

enum ChainPtr { CP_X, CP_OUT, CP_COUNT };
enum ChainInt { CI_COUNT_ELEMS, CI_N, CI_OP, CI_COUNT };

template <int OP>
int launch_chain(const float* x, float* out, int count, int n,
                 cudaStream_t stream) {
  chain_kernel<OP><<<(count + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      x, out, count, n);
  return (int)cudaGetLastError();
}

// K8: one thread per (row, column) element. The per-row scalars (bx, by,
// bz, qw) come from column 0 of the planes, or with TRANSPOSED from the
// (4, R) table, where qw takes the iteration's offset t too (as
// vpu_bench.py:119-123 adds t to the whole table).
template <bool TRANSPOSED>
__global__ void __launch_bounds__(THREADS)
cpass_kernel(const float* __restrict__ px, const float* __restrict__ py,
             const float* __restrict__ pz, const float* __restrict__ q,
             const float* __restrict__ rows, float* __restrict__ out, int R,
             int C, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * C) return;
  const int r = i / C;
  const float ll = 34.f, il = (float)(1.0 / 34.0);
  const float a2 = 0.52f, rc2 = 72.25f;
  float bx, by, bz, qw;
  if (TRANSPOSED) {
    bx = rows[r];
    by = rows[R + r];
    bz = rows[2 * R + r];
    qw = rows[3 * R + r];
  } else {
    bx = px[r * C];
    by = py[r * C];
    bz = pz[r * C];
    qw = q[r * C];
  }
  const float x = px[i], y = py[i], z = pz[i], qi = q[i];
  float acc = 0.f;
  for (int k = 0; k < n; ++k) {
    const float t = (float)(k % 7) * 0.1f;
    float dx = x - (bx + t);
    float dy = y - (by + t);
    const float dz = z - (bz + t);
    const float w = TRANSPOSED ? qw + t : qw;
    dx -= ll * rintf(dx * il);
    dy -= ll * rintf(dy * il);
    // r2 unfused: each product and sum rounded as the plain version's torch
    // ops round them, so both take the same side of the cut-off select
    const float r2 = fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                               __fmul_rn(dy, dy)),
                                     __fmul_rn(dz, dz)), 1e-18f);
    const float inv_r = rsqrtf(r2);
    const float xab = a2 * (r2 * inv_r);
    const float e = erfc_probe(xab);
    const float coulf = w * qi * e * inv_r;
    acc += r2 < rc2 ? coulf : 0.f;
  }
  out[i] = acc;
}

enum CpassPtr { KP_PX, KP_PY, KP_PZ, KP_Q, KP_ROWS, KP_OUT, KP_COUNT };
enum CpassInt { KI_R, KI_C, KI_N, KI_TRANSPOSED, KI_COUNT };

}  // namespace

extern "C" int vpu_chain_launch(void* const* ptrs, int nptr, const int* ints,
                                int nint, const float* floats, int nfloat,
                                void* stream) {
  (void)floats;
  if (nptr != CP_COUNT || nint != CI_COUNT || nfloat != 0)
    return MANIAC_ERR_TABLES;
  const int count = ints[CI_COUNT_ELEMS], n = ints[CI_N];
  if (count < 1 || n < 0) return MANIAC_ERR_SHAPE;
  const float* x = static_cast<const float*>(ptrs[CP_X]);
  float* out = static_cast<float*>(ptrs[CP_OUT]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ints[CI_OP]) {
    case V_FMA: return launch_chain<V_FMA>(x, out, count, n, s);
    case V_MUL2: return launch_chain<V_MUL2>(x, out, count, n, s);
    case V_DIV: return launch_chain<V_DIV>(x, out, count, n, s);
    case V_RSQRT: return launch_chain<V_RSQRT>(x, out, count, n, s);
    case V_SQRT: return launch_chain<V_SQRT>(x, out, count, n, s);
    case V_EXP: return launch_chain<V_EXP>(x, out, count, n, s);
    case V_ROUND: return launch_chain<V_ROUND>(x, out, count, n, s);
    case V_CMPSEL: return launch_chain<V_CMPSEL>(x, out, count, n, s);
    case V_ERFC: return launch_chain<V_ERFC>(x, out, count, n, s);
    default: return MANIAC_ERR_SHAPE;
  }
}

extern "C" int cpass_launch(void* const* ptrs, int nptr, const int* ints,
                            int nint, const float* floats, int nfloat,
                            void* stream) {
  (void)floats;
  if (nptr != KP_COUNT || nint != KI_COUNT || nfloat != 0)
    return MANIAC_ERR_TABLES;
  const int R = ints[KI_R], C = ints[KI_C], n = ints[KI_N];
  if (R < 1 || C < 1 || n < 0) return MANIAC_ERR_SHAPE;
  const float* px = static_cast<const float*>(ptrs[KP_PX]);
  const float* py = static_cast<const float*>(ptrs[KP_PY]);
  const float* pz = static_cast<const float*>(ptrs[KP_PZ]);
  const float* q = static_cast<const float*>(ptrs[KP_Q]);
  const float* rows = static_cast<const float*>(ptrs[KP_ROWS]);
  float* out = static_cast<float*>(ptrs[KP_OUT]);
  const int blocks = (R * C + THREADS - 1) / THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ints[KI_TRANSPOSED])
    cpass_kernel<true><<<blocks, THREADS, 0, s>>>(px, py, pz, q, rows, out, R,
                                                  C, n);
  else
    cpass_kernel<false><<<blocks, THREADS, 0, s>>>(px, py, pz, q, rows, out,
                                                   R, C, n);
  return (int)cudaGetLastError();
}
