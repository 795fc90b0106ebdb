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

// The minimum image of the box kind, as a functor the energy core is
// templated on (physics/pbc.py::min_image_dist2): MinImage<false> holds
// the three box lengths of an orthorhombic box; MinImage<true> holds the
// 27 lattice image shifts of a triclinic box (spec.image_shifts, staged in
// shared memory once per CTA by stage_image_shifts) and takes the brute-
// force minimum of |d + s|^2 over them, in the order of the table, as
// maniac_tpu/kernels/blockg.py does. The caller floors r2 at 1e-18 after
// the minimum.
constexpr int NIMG = 27;

template <bool TRICLINIC>
struct MinImage {
  const float* L;  // (3,) box lengths
  __device__ __forceinline__ float r2(float dx, float dy, float dz) const {
    return min_image_r2(dx, dy, dz, L);
  }
};

template <>
struct MinImage<true> {
  const float* s;  // (27, 3) image shifts, in shared memory
  __device__ __forceinline__ float r2(float dx, float dy, float dz) const {
    float best = 0.f;
    for (int i = 0; i < NIMG; ++i) {
      const float tx = dx + s[3 * i], ty = dy + s[3 * i + 1];
      const float tz = dz + s[3 * i + 2];
      const float r = tx * tx + ty * ty + tz * tz;
      best = i == 0 ? r : fminf(best, r);
    }
    return best;
  }
};

// Copy the 27 image shifts into shared memory (triclinic only: the kernels
// give them room as __shared__ float[TRICLINIC ? 3 * NIMG : 1]; the caller
// synchronizes before use).
template <bool TRICLINIC>
__device__ __forceinline__ void stage_image_shifts(const float* img,
                                                   float* smem) {
  if constexpr (TRICLINIC)
    for (int i = threadIdx.x; i < 3 * NIMG; i += blockDim.x) smem[i] = img[i];
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

// ---------------------------------------------------------------------------
// The energy of one MC step's footprint, shared by the whole-block kernel
// (blockg.cu) and the per-step kernel (stepg.cu): one CTA per replica.
// ---------------------------------------------------------------------------

constexpr int STEP_THREADS = 256;
constexpr int MAXA = 8;          // atoms per molecule
constexpr int MAXF = 2 * MAXA;   // footprint atoms (old | new)
constexpr int JMAX = 32;         // phase powers j = 0..JMAX-1 per axis
constexpr int MAXR = 8;          // residue types
constexpr int NRED = 7;          // reduced partial sums per step

// Shared per-step footprint: atoms f < A_act are the old side, the rest
// the new side.
struct Footprint {
  float p[MAXF][3];
  float q[MAXF];
  int cls[MAXF];
  int m[MAXF];     // m2: atom present and its side moves
  float wk[MAXF];  // k-space weight: sign * q * m
  float wf[MAXF];  // far-field weight: q * m
  int ex_a, ex_b, n_sites, acc;
};

// Complex sum over the footprint atoms in [f0, f1) with weights w of
// w e^{i(jx tx + jy ty + jz tz)}, accumulated as the JAX package does
// (d_re = pz_re t_re - pz_im t_im, d_im = pz_re t_im + pz_im t_re).
__device__ __forceinline__ float2 footprint_mode(
    float2 (*tab)[3][JMAX], const float* w, int f0, int f1, int jx,
    int jy, int jz) {
  float a1 = 0.f, a2 = 0.f, b1 = 0.f, b2 = 0.f;
  for (int f = f0; f < f1; ++f) {
    const float wf = w[f];
    if (wf == 0.f) continue;  // adds exact zeros
    const float2 px = tab[f][0][jx];
    const float xr = px.x * wf, xi = px.y * wf;
    const float2 y = signed_power(tab[f][1], jy);
    const float2 z = signed_power(tab[f][2], jz);
    const float tr = xr * y.x - xi * y.y;
    const float ti = xr * y.y + xi * y.x;
    a1 += z.x * tr;
    a2 += z.y * ti;
    b1 += z.x * ti;
    b2 += z.y * tr;
  }
  return make_float2(a1 - a2, b1 + b2);
}

// Sites a footprint is swept against: the frozen prefix [0, S_frozen),
// then the guest columns from guest_base up to the live end of the type
// regions at or above guest_base (S_frozen = guest_base = 0 without the
// framework split: every type region).
template <class Args>
__device__ int footprint_sites(const Args& a, const int* nmol) {
  int live_end = a.guest_base;
  for (int r = 0; r < a.R; ++r)
    if (a.type_site_base[r] >= a.guest_base)
      live_end = max(live_end, a.type_site_base[r] + nmol[r] * a.type_A[r]);
  return a.S_frozen + (live_end - a.guest_base);
}

// Phase powers of every footprint atom, up to the larger of the main and
// far-field grid orders per axis (threads 0 .. 6 A_act - 1).
template <class Args>
__device__ __forceinline__ void footprint_phase_tables(
    const Args& a, const Footprint& fp, float2 (*tab)[3][JMAX]) {
  const int tid = threadIdx.x;
  if (tid < 3 * 2 * a.A_act) {
    const int f = tid / 3, ax = tid % 3;
    const float* h = a.h2pi + 3 * ax;
    const float th = h[0] * fp.p[f][0] + h[1] * fp.p[f][1]
                     + h[2] * fp.p[f][2];
    const int k1 = ax == 0 ? a.kx : ax == 1 ? a.ky : a.kz;
    const int k2 = ax == 0 ? a.kx2 : ax == 1 ? a.ky2 : a.kz2;
    phase_powers(th, max(k1, k2), tab[f][ax]);
  }
}

// This thread's partial sums of the step's energy terms,
// part = [lj_old, lj_new, coul_old, coul_new, far_old, far_new, d_recip]:
// the pair pass over the live sites (LJ cut at cutoff; real-space Coulomb
// erfc(alpha2 r)/r cut at rcut2 on frozen sites, erfc(alpha r)/r elsewhere,
// cut at gg_rcut when gg_cut), the far-field grid c2 . d per side (c2 is
// zero without the framework split), and the k-space sum
// sum_k w_k (2 A.d + |d|^2). pos, ampre, ampim are this replica's; img is
// the box's minimum image (MinImage).
template <class Args, class Image>
__device__ __forceinline__ void footprint_partials(
    const Args& a, const Footprint& fp, float2 (*tab)[3][JMAX],
    const int* nmol, const float* pos, const float* ampre,
    const float* ampim, const Image& img, float (&part)[NRED]) {
  const int tid = threadIdx.x, S = a.S, F = 2 * a.A_act;
  const int K = a.JzP * a.JxyP, K2 = a.Jz2P * a.Jxy2P;
  const float cut_sq = a.cutoff * a.cutoff, rc2_sq = a.rcut2 * a.rcut2;
#pragma unroll
  for (int i = 0; i < NRED; ++i) part[i] = 0.f;

  // pair pass: frozen prefix, then the live guest columns
  for (int j = tid; j < fp.n_sites; j += STEP_THREADS) {
    const int s = j < a.S_frozen ? j : a.guest_base + (j - a.S_frozen);
    if (a.site_midx[s] >= nmol[a.site_type[s]]) continue;  // inactive
    const int mol = a.site_mol[s];
    if (mol == fp.ex_a || mol == fp.ex_b) continue;
    const float x = pos[s], y = pos[S + s], z = pos[2 * S + s];
    const float qs = a.site_q[s];
    const bool frozen = s < a.S_frozen;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      for (int f = side * a.A_act; f < (side + 1) * a.A_act; ++f) {
        if (!fp.m[f]) continue;
        float r2 = img.r2(x - fp.p[f][0], y - fp.p[f][1], z - fp.p[f][2]);
        r2 = fmaxf(r2, 1e-18f);
        const float inv_r2 = 1.f / r2;
        const float inv_r = sqrtf(inv_r2);
        const float r = r2 * inv_r;
        const float eps = a.eps_site[(size_t)fp.cls[f] * S + s];
        if (eps != 0.f && r2 < cut_sq) {
          const float sr2 = a.sig2_site[(size_t)fp.cls[f] * S + s] * inv_r2;
          const float sr6 = sr2 * sr2 * sr2;
          part[side] += 4.f * eps * (sr6 * sr6 - sr6);
        }
        const float qq = fp.q[f] * qs;
        if (qq == 0.f) continue;
        if (frozen) {
          if (r2 < rc2_sq)
            part[2 + side] += qq * erfcf(a.alpha2 * r) * inv_r;
        } else if (!a.gg_cut || r2 < a.gg_rcut_sq) {
          part[2 + side] += qq * erfcf(a.alpha * r) * inv_r;
        }
      }
    }
  }

  // far field: sum over the alpha2 grid of c2 . d per side
  const int Jz2 = 2 * a.kz2 + 1;
  for (int m = tid; m < K2; m += STEP_THREADS) {
    const int row = m / a.Jxy2P, col = m - row * a.Jxy2P;
    const int jx = a.col2_jx[col];
    if (row >= Jz2 || jx < 0) continue;
    const float cre = a.c2re[m], cim = a.c2im[m];
    if (cre == 0.f && cim == 0.f) continue;
    const int jy = a.col2_jy[col], jz = row - a.kz2;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const float2 d = footprint_mode(tab, fp.wf, side * a.A_act,
                                      (side + 1) * a.A_act, jx, jy, jz);
      part[4 + side] += cre * d.x + cim * d.y;
    }
  }

  // k-space: sum_k w_k (2 A.d + |d|^2) over the modes with weight
  for (int m = tid; m < K; m += STEP_THREADS) {
    const float w = a.kw[m];
    if (w == 0.f) continue;
    const int row = m / a.JxyP, col = m - row * a.JxyP;
    const float2 d = footprint_mode(tab, fp.wk, 0, F, a.col_jx[col],
                                    a.col_jy[col], row - a.kz);
    const float ar = ampre[m], ai = ampim[m];
    part[6] += w * (2.f * (ar * d.x + ai * d.y) + d.x * d.x + d.y * d.y);
  }
}

// Metropolis acceptance probability min(1, pref e^{-dE/T}); a NaN stays
// NaN and so rejects, as jnp.minimum / torch.minimum.
__device__ __forceinline__ float p_accept(float pref, float delta_e,
                                          float temp) {
  const float p = pref * expf(-delta_e / temp);
  return (p < 1.f || p != p) ? p : 1.f;
}
