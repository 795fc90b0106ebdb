// Shared device helpers for the maniac_tpu_torch CUDA kernels.
//
// Counterparts of maniac_tpu/kernels/common.py: the per-axis complex phase
// powers (_powers) and the signed-index convention of _signed_table become
// device functions here. The f32 erfc is libdevice erfcf (max error 4 ulp,
// tighter than the JAX package's erfcx polynomial, <= 3.1e-7 absolute);
// the library is built without --use_fast_math, so expf, sincosf and erfcf
// keep full f32 accuracy.
//
// The footprint energy shared by the whole-block and per-step kernels is
// here too: the pair pass and the k-space sum per thread (footprint_partials)
// and the far field of the framework split as a separable contraction over
// the host's far table (far_sweep, section below): on the H100 it is bound
// by the FMA pipe and shared-memory reads (4 FMA and one 16-byte read of two
// atoms' y powers per nonzero coefficient and atom pair), where the
// per-mode triple product it replaces was bound by index arithmetic and
// lane-divergent shared reads at some 20 instructions per mode and atom.
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

// ---------------------------------------------------------------------------
// The energy of one MC step's footprint, shared by the whole-block kernel
// (blockg.cu) and the per-step kernel (stepg.cu): one replica a CTA of
// STEP_THREADS threads. tid below is the thread's index.
// ---------------------------------------------------------------------------

constexpr int STEP_THREADS = 256;
constexpr int STEP_WARPS = STEP_THREADS / 32;
constexpr int MAXA = 8;          // atoms per molecule
constexpr int MAXF = 2 * MAXA;   // footprint atoms (old | new)
constexpr int JMAX = 32;         // phase powers j = 0..JMAX-1 per axis
constexpr int MAXR = 8;          // residue types
constexpr int NRED = 7;          // reduced partial sums per step

// Sum of NV values over one replica's STEP_THREADS threads; every one of
// them gets the totals in out. scratch holds STEP_WARPS * NV floats. Warp
// shuffles, then one sequential pass over the warps: the order is fixed run
// to run. It synchronizes the CTA (every thread of it calls it).
template <int NV>
__device__ void block_sum(float (&v)[NV], int tid, float* scratch,
                          float* out) {
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float x = v[i];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) scratch[warp * NV + i] = x;
  }
  __syncthreads();
  if (tid < NV) {
    float s = 0.f;
    for (int w = 0; w < STEP_WARPS; ++w) s += scratch[w * NV + tid];
    out[tid] = s;
  }
  __syncthreads();
}

// Section clocks of an instrumented build: tools/section_split.py builds
// the library with -DMANIAC_SECTION_CLOCKS beside the production build (in
// kernels/_build/, git-ignored). There SECTION_MARK(k) synchronizes the CTA
// and adds the clock64 ticks since the replica's previous mark to its
// section k (k < 0 only restarts the clock); blockg.cu's
// maniac_section_clocks copies the ticks out. The production build compiles
// SECTION_MARK to nothing.
constexpr int N_SECTIONS = 8;
#ifdef MANIAC_SECTION_CLOCKS
constexpr int SECTION_REPLICAS = 4096;
static __device__ long long maniac_section_last[SECTION_REPLICAS];
static __device__ long long maniac_section_ticks[SECTION_REPLICAS * N_SECTIONS];
__device__ __forceinline__ void section_mark(int k) {
  const int r = blockIdx.x;  // one replica a CTA
  if (threadIdx.x != 0 || r >= SECTION_REPLICAS) return;
  const long long now = clock64();
  if (k >= 0)
    maniac_section_ticks[r * N_SECTIONS + k] += now - maniac_section_last[r];
  maniac_section_last[r] = now;
}
#define SECTION_MARK(k) \
  do {                  \
    __syncthreads();    \
    section_mark(k);    \
  } while (0)
#else
#define SECTION_MARK(k) \
  do {                  \
  } while (0)
#endif

// Shared per-step footprint: atoms f < A_act are the old side, the rest
// the new side.
struct Footprint {
  float p[MAXF][3];
  float q[MAXF];
  int cls[MAXF];
  int m[MAXF];     // m2: atom present and its side moves
  float wk[MAXF];  // k-space weight: sign * q * m
  float wf[MAXF];  // far-field weight: q * m
  int far_f[MAXF];     // the far field's atoms: those with wf != 0, in order
  int far_side[MAXF];  // and their sides
  int far_n, ex_a, ex_b, n_sites, acc;
};

// The far field's compact atom list (thread 0, after wf is published).
__device__ __forceinline__ void footprint_far_atoms(Footprint& fp, int A_act) {
  int n = 0;
  for (int f = 0; f < 2 * A_act; ++f) {
    if (fp.wf[f] == 0.f) continue;
    fp.far_f[n] = f;
    fp.far_side[n] = f >= A_act;
    ++n;
  }
  fp.far_n = n;
}

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
    const Args& a, const Footprint& fp, float2 (*tab)[3][JMAX], int tid) {
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

// This thread's partial sums of the step's energy terms other than the far
// field, part = [lj_old, lj_new, coul_old, coul_new, 0, 0, d_recip]: the
// pair pass over the live sites (LJ cut at cutoff; real-space Coulomb
// erfc(alpha2 r)/r cut at rcut2 on frozen sites, erfc(alpha r)/r elsewhere,
// cut at gg_rcut when gg_cut) and the k-space sum sum_k w_k (2 A.d + |d|^2).
// far_sweep adds part[4], part[5]. pos, ampre, ampim are this replica's; img
// is the box's minimum image (MinImage).
template <class Args, class Image>
__device__ __forceinline__ void footprint_partials(
    const Args& a, const Footprint& fp, float2 (*tab)[3][JMAX],
    const int* nmol, const float* pos, const float* ampre,
    const float* ampim, const Image& img, int tid, float (&part)[NRED]) {
  const int S = a.S, F = 2 * a.A_act;
  const int K = a.JzP * a.JxyP;
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

  SECTION_MARK(2);  // pair pass

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

// ---------------------------------------------------------------------------
// The far field as a separable contraction.
//
// The far-field term of a side is sum_k c_k . d_k over the alpha2 grid,
// i.e. sum_f w_f Re(sum_{jz,jx,jy} conj(c) x_f^jx y_f^jy z_f^jz): a
// trigonometric polynomial at each footprint atom, separable by axis. The
// host (physics/fwsplit.py FarTable) keeps only the nonzero coefficients, as
// rows of constant (jz, jx) over a contiguous jy range, FAR_LANES rows to a
// warp (one per lane), cut into units of FAR_TCH elements; tile k holds unit
// k of each of the FAR_WARPS warps, laid out so that a warp's read of one
// element is 256 contiguous bytes. Per row and atom the y axis is contracted
// first, T_f = sum_jy conj(c) w_f y_f^jy (one complex multiply-add, 4 FMA,
// per element and atom: the coefficient is loaded once for all atoms, the
// weighted y powers come from a shared table by index, pairs of atoms per
// 16-byte read), then the row is closed with x_f^jx z_f^jz and its real part
// goes to its atom's side. Tiles are staged into shared memory by cp.async,
// double-buffered, by all the CTA's threads. Up to FAR_PASS atoms per sweep
// of the table (water: 3 a side).
// ---------------------------------------------------------------------------

constexpr int FAR_LANES = 32, FAR_TCH = 4, FAR_WARPS = STEP_WARPS;
constexpr int FAR_FIRST = 1, FAR_LAST = 2;    // unit flags
constexpr int FAR_PASS = 8;                   // atoms per sweep
constexpr int FAR_YROWS = 2 * JMAX;           // y table rows (last: zero)
constexpr int FAR_YS = MAXF / 2 + 1;          // float4 per y row (padded)
constexpr int FAR_YTAB = FAR_YROWS * FAR_YS;  // float4 per replica
constexpr int FAR_TILE4 = FAR_WARPS * FAR_TCH * FAR_LANES / 2;  // float4

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The weighted y powers of the far field's atoms, ytab[j + ky2][k] =
// w_k y_k^j as float2 (FAR_YS float4 a row); the other slots and rows are
// zero. Read after the CTA's next barrier.
template <class Args>
__device__ __forceinline__ void far_ytab_fill(const Args& a,
                                              const Footprint& fp,
                                              float2 (*tab)[3][JMAX],
                                              float4* ytab, int tid) {
  float2* y = reinterpret_cast<float2*>(ytab);
  for (int i = tid; i < FAR_YROWS * MAXF; i += STEP_THREADS) {
    const int row = i / MAXF, k = i - row * MAXF;
    const int j = row - a.ky2;
    float2 v = make_float2(0.f, 0.f);
    if (k < fp.far_n && j <= a.ky2) {
      const int f = fp.far_f[k];
      const float2 p = signed_power(tab[f][1], j);
      v = make_float2(fp.wf[f] * p.x, fp.wf[f] * p.y);
    }
    y[row * 2 * FAR_YS + k] = v;
  }
}

// One unit of NP atom pairs: acc[2k] + i acc[2k+1] += conj(c) ytab[yi][k]
// over the unit's nt elements.
template <int NP>
__device__ __forceinline__ void far_unit(float (&acc)[2 * FAR_PASS],
                                         const float2* c, const float4* y,
                                         int yi, int nt) {
#pragma unroll
  for (int t = 0; t < FAR_TCH; ++t) {
    if (t >= nt) break;
    const float2 cf = c[t * FAR_LANES];
    const float4* yr = y + min(yi + t, FAR_YROWS - 1) * FAR_YS;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float4 v = yr[p];
      acc[4 * p] = fmaf(cf.y, v.y, fmaf(cf.x, v.x, acc[4 * p]));
      acc[4 * p + 1] = fmaf(-cf.y, v.x, fmaf(cf.x, v.y, acc[4 * p + 1]));
      acc[4 * p + 2] = fmaf(cf.y, v.w, fmaf(cf.x, v.z, acc[4 * p + 2]));
      acc[4 * p + 3] = fmaf(-cf.y, v.z, fmaf(cf.x, v.w, acc[4 * p + 3]));
    }
  }
}

// part[4 + side] += this thread's share of the far field of the replica's
// footprint (fp, tab, ytab), in npass = ceil(far_n / FAR_PASS) sweeps of the
// table. Every thread of the CTA calls it; it synchronizes the CTA. tiles
// holds two staged tiles (2 FAR_TILE4 float4).
template <class Args>
__device__ void far_sweep(const Args& a, int npass, float4* tiles,
                          const Footprint& fp, float2 (*tab)[3][JMAX],
                          const float4* ytab, int tid, float (&part)[NRED]) {
  const int lane = tid & 31, warp = tid >> 5, n_tiles = a.n_far_tiles;
  for (int pass = 0; pass < npass; ++pass) {
    const int k0 = pass * FAR_PASS;
    const int nk = min(FAR_PASS, fp.far_n - k0);
    const int np = (nk + 1) / 2;  // atom pairs, 1 .. FAR_PASS / 2
    float acc[2 * FAR_PASS];
#pragma unroll
    for (int i = 0; i < 2 * FAR_PASS; ++i) acc[i] = 0.f;
    int jz = 0, jx = 0, yb = 0;
    for (int i = tid; i < FAR_TILE4; i += STEP_THREADS)
      cp_async16(tiles + i, a.far_coef + i);
    cp_async_commit();
    for (int k = 0; k < n_tiles; ++k) {
      if (k + 1 < n_tiles) {
        float4* dst = tiles + ((k + 1) & 1) * FAR_TILE4;
        const float4* src = a.far_coef + (size_t)(k + 1) * FAR_TILE4;
        for (int i = tid; i < FAR_TILE4; i += STEP_THREADS)
          cp_async16(dst + i, src + i);
      }
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();  // tile k is in, and so is ytab
      const int4 u = a.far_units[k * FAR_WARPS + warp];
      if (u.z > 0) {
        if (u.w & FAR_FIRST) {
          const int4 r = a.far_rows[u.x + lane];
          jz = r.x;
          jx = r.y;
          yb = r.z;
#pragma unroll
          for (int i = 0; i < 2 * FAR_PASS; ++i) acc[i] = 0.f;
        }
        const float2* c = reinterpret_cast<const float2*>(
                              tiles + (k & 1) * FAR_TILE4)
                          + warp * FAR_TCH * FAR_LANES + lane;
        const float4* y = ytab + k0 / 2;
        const int yi = yb + u.y;
        switch (np) {
          case 1: far_unit<1>(acc, c, y, yi, u.z); break;
          case 2: far_unit<2>(acc, c, y, yi, u.z); break;
          case 3: far_unit<3>(acc, c, y, yi, u.z); break;
          default: far_unit<4>(acc, c, y, yi, u.z); break;
        }
        if (u.w & FAR_LAST) {  // close the rows: Re(T x^jx z^jz) by side
#pragma unroll
          for (int q = 0; q < FAR_PASS; ++q) {
            if (q >= nk) break;
            const int f = fp.far_f[k0 + q];
            const float2 x = tab[f][0][jx];
            const float2 z = signed_power(tab[f][2], jz);
            const float xr = x.x * z.x - x.y * z.y;
            const float xi = x.x * z.y + x.y * z.x;
            const float v = acc[2 * q] * xr - acc[2 * q + 1] * xi;
            const bool new_side = fp.far_side[k0 + q] != 0;
            part[4] += new_side ? 0.f : v;
            part[5] += new_side ? v : 0.f;
          }
        }
      }
      __syncthreads();  // before tile k + 2 lands in this buffer
    }
  }
}

// Metropolis acceptance probability min(1, pref e^{-dE/T}); a NaN stays
// NaN and so rejects, as jnp.minimum / torch.minimum.
__device__ __forceinline__ float p_accept(float pref, float delta_e,
                                          float temp) {
  const float p = pref * expf(-delta_e / temp);
  return (p < 1.f || p != p) ? p : 1.f;
}
