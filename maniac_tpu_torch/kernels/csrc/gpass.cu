// Micro-benchmark of the whole-block kernel's guest pair pass.
//
// Replaces the Pallas kernel of tools/gpass_bench.py (make_kernel :60,
// launched by run_variant :171, pallas_call :172): NSTEP passes of FL*G
// Lennard-Jones rows and FQ*G Coulomb rows against S sites, summed to one
// scalar. Row r reads guest g = r % G; its footprint coordinate is
// col = r * 0.003 + step * 0.01 (varied by step so no pass can be hoisted),
// and it is held against site c at dx = x[g, c] - col, dy = y[g, c] -
// col / 2, dz = z[g, c] - col / 4, wrapped to the nearest image of a
// cubic box (round, unless nowrap), r2 floored at 1e-8. LJ rows take eps
// and sigma^2 of row r / G at site c within RC2; Coulomb rows take
// col * q[c] * erfc(alpha r) / r (Abramowitz & Stegun 7.1.26, as
// gpass_bench.py:52-57; noerfc: col * q[c] / r) within GGR2. `read` sums
// the inputs only: (FL + FQ) * (x + y + z + q) per element and step.
//
// Not carried over: the one-hot etile product (a TPU gather; row r reads
// eps[r / G] directly), the sublane tiles and the chunked fori_loop. The
// TPU layout variants rep, mrg, nodyn, noeps and wN compute cur's number
// and are not kernels here (tools/gpass_bench.py of this package runs cur
// for them).
//
// Bound on the H100: operations (some 30-45 per pair against one read of
// the positions) by the bound's count; on the card the issue slots,
// since the IEEE reciprocal, rsqrtf and expf each issue 5-10
// instructions (40 for an LJ pair, 67 for a Coulomb pair). Design: each
// thread takes one (guest, site) pair (g, c) and reads its position, q[c]
// and each row's eps and sigma^2 at c once, into registers. It loops over
// the rows, then the steps. What does not depend on the step is taken out
// of the step loop: the row's float (f G + g) and the loads; (float)s is
// a float counter, exact below 2^24. A term's float operations are fixed:
// col = fmaf(f G + g, 0.003, s 0.01) is the contraction nvcc makes of
// (f G + g) 0.003 + s 0.01 within one block, written out so that hoisting
// the product out of the step loop cannot change its rounding. The thread
// sums its terms in f32, row by row. 128 threads a CTA; PERF.md's K6
// finding has the CTA sizes, guests a thread, register caps and persistent
// grid that were slower.
// Each CTA sums its threads in f64 in a fixed order into a scratch the
// wrapper allocates (one partial a CTA), and a second kernel sums the
// CTAs' partials in a fixed order: no atomics, the same bits on every
// call. The total is kept in f64: the closest pairs' LJ terms reach 1e17
// and more, where an f32 total would lose every other term.
#include "common.cuh"

namespace {

enum GpassPtr { GP_X, GP_Y, GP_Z, GP_Q, GP_EPS, GP_SIG, GP_PARTIAL, GP_OUT,
                GP_COUNT };
// GI_PARTIALS: the scratch's length, one f64 a CTA
enum GpassInt { GI_G, GI_S, GI_FL, GI_FQ, GI_NSTEP, GI_VARIANT, GI_PARTIALS,
                GI_COUNT };
enum GpassFloat { GF_L, GF_RC2, GF_GGR2, GF_ALPHA, GF_COUNT };
// kernels/gpass.py::GPASS_VARIANTS order
enum GpassVariant { GV_CUR, GV_NOERFC, GV_NOWRAP, GV_READ, GV_COUNT };

struct GpassArgs {
  const float* x;
  const float* y;
  const float* z;
  const float* q;
  const float* eps;
  const float* sig;
  double* partial;
  int G, S, FL, FQ, nstep;
  float L, rc2, ggr2, alpha;
};

constexpr int THREADS = 128;       // a CTA; kernels/gpass.py GPASS_THREADS
constexpr int SUM_THREADS = 256;

__device__ __forceinline__ float erfc_as(float x) {
  const float t = 1.f / (1.f + 0.3275911f * x);
  const float poly = t * (0.254829592f + t * (-0.284496736f
      + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return poly * expf(-x * x);
}

// Squared distance of site (x, y, z) to a footprint coordinate col, on
// the nearest image with WRAP, floored at 1e-8.
template <bool WRAP>
__device__ __forceinline__ float pair_r2(float x, float y, float z,
                                         float col, float L, float inv_l) {
  float dx = x - col, dy = y - col * 0.5f, dz = z - col * 0.25f;
  if constexpr (WRAP) {
    dx -= L * rintf(dx * inv_l);
    dy -= L * rintf(dy * inv_l);
    dz -= L * rintf(dz * inv_l);
  }
  return fmaxf(dx * dx + dy * dy + dz * dz, 1e-8f);
}

// The CTA's per-thread totals summed in f64, lanes then warps in order,
// into partial[blockIdx.x].
__device__ __forceinline__ void store_block_total(double v, double* partial) {
  __shared__ double red[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int w = 0; w < THREADS / 32; ++w) total += red[w];
    partial[blockIdx.x] = total;
  }
}

template <bool WRAP, bool ERFC>
__global__ void __launch_bounds__(THREADS) gpass_kernel(GpassArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  double total = 0.0;
  if (i < a.G * a.S) {
    const int g = i / a.S, c = i - g * a.S;
    const float x = a.x[i], y = a.y[i], z = a.z[i], qc = a.q[c];
    const float inv_l = 1.f / a.L;
    float acc = 0.f;
    for (int f = 0; f < a.FL; ++f) {
      const float ep = a.eps[f * a.S + c], sg = a.sig[f * a.S + c];
      const float rf = (float)(f * a.G + g);
      float sc = 0.f;
      for (int s = 0; s < a.nstep; ++s, sc += 1.f) {
        const float col = fmaf(rf, 0.003f, sc * 0.01f);
        const float r2 = pair_r2<WRAP>(x, y, z, col, a.L, inv_l);
        const float sr2 = sg * (1.f / r2);
        const float sr6 = sr2 * sr2 * sr2;
        const float lj = 4.f * ep * (sr6 * sr6 - sr6);
        acc += r2 < a.rc2 ? lj : 0.f;
      }
    }
    for (int f = 0; f < a.FQ; ++f) {
      const float rf = (float)(f * a.G + g);
      float sc = 0.f;
      for (int s = 0; s < a.nstep; ++s, sc += 1.f) {
        const float col = fmaf(rf, 0.003f, sc * 0.01f);
        const float r2 = pair_r2<WRAP>(x, y, z, col, a.L, inv_l);
        const float inv_r = rsqrtf(r2);
        const float scr = ERFC ? erfc_as(a.alpha * (r2 * inv_r)) : 1.f;
        const float coul = col * qc * scr * inv_r;
        acc += r2 < a.ggr2 ? coul : 0.f;
      }
    }
    total = acc;
  }
  store_block_total(total, a.partial);
}

// The TPU kernel re-reads every chunk each step and adds its sum to the FL
// + FQ row accumulators; here the element is read once, a step adds it in
// a register and the rows scale the total, so this times the one read and
// the reduction, not a per-step read. Its time is two launches: this and
// gpass_sum_kernel (an earlier form, with atomics, had one).
__global__ void __launch_bounds__(THREADS) gpass_read_kernel(GpassArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  double total = 0.0;
  if (i < a.G * a.S) {
    const float v = a.x[i] + a.y[i] + a.z[i] + a.q[i % a.S];
    float acc = 0.f;
    for (int s = 0; s < a.nstep; ++s) acc += v;
    acc *= (float)(a.FL + a.FQ);
    total = acc;
  }
  store_block_total(total, a.partial);
}

// out = the CTAs' partials summed in a fixed order: strided by thread,
// then a tree over the threads.
__global__ void __launch_bounds__(SUM_THREADS)
gpass_sum_kernel(const double* __restrict__ partial, int n,
                 double* __restrict__ out) {
  __shared__ double red[SUM_THREADS];
  double v = 0.0;
  for (int i = threadIdx.x; i < n; i += SUM_THREADS) v += partial[i];
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = SUM_THREADS / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = red[0];
}

}  // namespace

extern "C" int gpass_launch(void* const* ptrs, int nptr, const int* ints,
                            int nint, const float* floats, int nfloat,
                            void* stream) {
  if (nptr != GP_COUNT || nint != GI_COUNT || nfloat != GF_COUNT)
    return MANIAC_ERR_TABLES;
  GpassArgs a;
  a.x = static_cast<const float*>(ptrs[GP_X]);
  a.y = static_cast<const float*>(ptrs[GP_Y]);
  a.z = static_cast<const float*>(ptrs[GP_Z]);
  a.q = static_cast<const float*>(ptrs[GP_Q]);
  a.eps = static_cast<const float*>(ptrs[GP_EPS]);
  a.sig = static_cast<const float*>(ptrs[GP_SIG]);
  a.partial = static_cast<double*>(ptrs[GP_PARTIAL]);
  double* out = static_cast<double*>(ptrs[GP_OUT]);
  a.G = ints[GI_G];
  a.S = ints[GI_S];
  a.FL = ints[GI_FL];
  a.FQ = ints[GI_FQ];
  a.nstep = ints[GI_NSTEP];
  a.L = floats[GF_L];
  a.rc2 = floats[GF_RC2];
  a.ggr2 = floats[GF_GGR2];
  a.alpha = floats[GF_ALPHA];
  if (a.G < 1 || a.S < 1 || a.FL < 0 || a.FQ < 0 || a.nstep < 0
      || (long long)a.G * a.S > 0x7fffffff)
    return MANIAC_ERR_SHAPE;
  const int blocks = (a.G * a.S + THREADS - 1) / THREADS;
  if (ints[GI_PARTIALS] != blocks) return MANIAC_ERR_SHAPE;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ints[GI_VARIANT]) {
    case GV_CUR: gpass_kernel<true, true><<<blocks, THREADS, 0, s>>>(a); break;
    case GV_NOERFC:
      gpass_kernel<true, false><<<blocks, THREADS, 0, s>>>(a);
      break;
    case GV_NOWRAP:
      gpass_kernel<false, true><<<blocks, THREADS, 0, s>>>(a);
      break;
    case GV_READ: gpass_read_kernel<<<blocks, THREADS, 0, s>>>(a); break;
    default: return MANIAC_ERR_SHAPE;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gpass_sum_kernel<<<1, SUM_THREADS, 0, s>>>(a.partial, blocks, out);
  return (int)cudaGetLastError();
}
