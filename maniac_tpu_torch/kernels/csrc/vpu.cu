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

// K8. One thread an element (r, c); the row's scalars (bx, by, bz, qw)
// come from column 0 of the planes, or with TRANSPOSED from the (4, R)
// table, where qw takes the iteration's offset t too (as
// vpu_bench.py:119-123 adds t to the whole table). Iteration k's offset is
// t_(k % 7), so the n iterations run as n / 7 groups of the seven offsets
// (the wrapper's CPASS_OFFSETS, f32), then the first n % 7 of them; the
// element still adds its terms in the order k = 0, 1, ... The sums bx +
// t_j, by + t_j, bz + t_j (and qw + t_j) are the f32 additions each
// iteration made, taken once a thread into registers. A group's term j is
// the same function of the same inputs in every group, so each group adds
// the opaque zero a.zero (0, but a kernel argument the compiler cannot
// see) to the element's x, y, z and q: every group is then new work, and
// no part of a term (such as the y wrap, which ptxas hoists when only x
// changes) leaves the loop. 256 threads a CTA; PERF.md's K8 finding has
// the CTA sizes, elements a thread and register caps that were slower.
constexpr int CPASS_T = 7;              // distinct offsets: (k % 7) * 0.1

struct CpassArgs {
  const float* px;
  const float* py;
  const float* pz;
  const float* q;
  const float* rows;
  float* out;
  int R, C, n, zero;
  float t[CPASS_T];
};

// One iteration's term of an element at (x, y, z) with charge qi against
// the row's offset scalars (ox, oy, oz) and weight w.
__device__ __forceinline__ float cpass_term(float x, float y, float z,
                                            float qi, float ox, float oy,
                                            float oz, float w) {
  const float ll = 34.f, il = (float)(1.0 / 34.0);
  const float a2 = 0.52f, rc2 = 72.25f;
  float dx = x - ox;
  float dy = y - oy;
  const float dz = z - oz;
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
  return r2 < rc2 ? coulf : 0.f;
}

template <bool TRANSPOSED>
__global__ void __launch_bounds__(THREADS) cpass_kernel(CpassArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.R * a.C) return;
  const int r = i / a.C;
  float bx, by, bz, qw;
  if (TRANSPOSED) {
    bx = a.rows[r];
    by = a.rows[a.R + r];
    bz = a.rows[2 * a.R + r];
    qw = a.rows[3 * a.R + r];
  } else {
    bx = a.px[r * a.C];
    by = a.py[r * a.C];
    bz = a.pz[r * a.C];
    qw = a.q[r * a.C];
  }
  float ox[CPASS_T], oy[CPASS_T], oz[CPASS_T], ow[CPASS_T];
#pragma unroll
  for (int j = 0; j < CPASS_T; ++j) {
    ox[j] = bx + a.t[j];
    oy[j] = by + a.t[j];
    oz[j] = bz + a.t[j];
    ow[j] = TRANSPOSED ? qw + a.t[j] : qw;
  }
  const float x = a.px[i], y = a.py[i], z = a.pz[i], qi = a.q[i];
  float acc = 0.f;
  const int m = a.n / CPASS_T;
  for (int g = 0; g < m; ++g) {
    const float z0 = __int_as_float(g & a.zero);
    const float xg = x + z0, yg = y + z0, zg = z + z0, qg = qi + z0;
#pragma unroll
    for (int j = 0; j < CPASS_T; ++j)
      acc += cpass_term(xg, yg, zg, qg, ox[j], oy[j], oz[j], ow[j]);
  }
  const int rem = a.n - m * CPASS_T;
#pragma unroll
  for (int j = 0; j < CPASS_T - 1; ++j)
    if (j < rem) acc += cpass_term(x, y, z, qi, ox[j], oy[j], oz[j], ow[j]);
  a.out[i] = acc;
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
  if (nptr != KP_COUNT || nint != KI_COUNT || nfloat != CPASS_T)
    return MANIAC_ERR_TABLES;
  CpassArgs a;
  a.px = static_cast<const float*>(ptrs[KP_PX]);
  a.py = static_cast<const float*>(ptrs[KP_PY]);
  a.pz = static_cast<const float*>(ptrs[KP_PZ]);
  a.q = static_cast<const float*>(ptrs[KP_Q]);
  a.rows = static_cast<const float*>(ptrs[KP_ROWS]);
  a.out = static_cast<float*>(ptrs[KP_OUT]);
  a.R = ints[KI_R];
  a.C = ints[KI_C];
  a.n = ints[KI_N];
  a.zero = 0;
  for (int j = 0; j < CPASS_T; ++j) a.t[j] = floats[j];
  if (a.R < 1 || a.C < 1 || a.n < 0) return MANIAC_ERR_SHAPE;
  const int blocks = (a.R * a.C + THREADS - 1) / THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ints[KI_TRANSPOSED])
    cpass_kernel<true><<<blocks, THREADS, 0, s>>>(a);
  else
    cpass_kernel<false><<<blocks, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
