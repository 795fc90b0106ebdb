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
// here too: the pair pass (the frozen prefix tile by tile, only the tiles
// within the move's reach: frozen_tile_pass) and the k-space sum per thread
// (footprint_partials; the sum walks the host's dense list of the modes
// with weight, not the (JzP, JxyP) grid, whose padding to the TPU's (8, 128)
// tiles left whole warps without a mode) and the far field of the framework
// split as a separable contraction over the host's far table (far_sweep,
// section below): on the H100 it is bound by the FMA pipe and shared-memory
// reads (4 FMA and one 16-byte read of two atoms' y powers per nonzero
// coefficient and atom pair), where the per-mode triple product it replaces
// was bound by index arithmetic and lane-divergent shared reads at some 20
// instructions per mode and atom.
//
// Every launcher has a plain C interface: a table of device pointers, a
// table of ints, a table of floats (each with its length, checked against
// the kernel's enum) and the CUDA stream. It returns a cudaError_t, or one
// of the MANIAC_ERR_* codes below for a malformed call.
#pragma once

#include <cuda_runtime.h>

#include "prims.cuh"

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

// One axis of the orthorhombic minimum image, dx - L rintf(dx / L) (rintf
// rounds half to even, like jnp.round / torch.round), without the
// division. Correctly rounded division is monotone, so rintf(dx / L) is a
// step function of |dx|, odd in dx: 0 up to t1, 1 up to t2 and 2 up to t3,
// the largest floats where it is at most 0, 1 and 2 (kernels.
// image_thresholds, found on the host). For |dx| <= t3, where the step
// gate keeps every pair (kernels.image_failure), the count of thresholds
// |dx| exceeds, with dx's sign, is that integer, and L n is exact: the same
// bits as the division's form (csrc/vpu.cu's check scans every f32 of the
// domain).
__device__ __forceinline__ float min_image_axis(float dx, float L, float t1,
                                                float t2) {
  const float a = fabsf(dx);
  const float n = (a > t1 ? 1.f : 0.f) + (a > t2 ? 1.f : 0.f);
  return dx - L * copysignf(n, dx);
}

// The minimum image of the box kind, as a functor the energy core is
// templated on (physics/pbc.py::min_image_dist2): MinImage<false> holds
// the three box lengths of an orthorhombic box and their thresholds
// (min_image_axis); MinImage<true> holds the 27 lattice image shifts of a
// triclinic box (spec.image_shifts, staged in shared memory once per CTA
// by stage_image_shifts) and takes the brute-force minimum of |d + s|^2
// over them, in the order of the table, as maniac_tpu/kernels/blockg.py
// does. make_min_image builds either. The caller floors r2 at 1e-18 after
// the minimum.
constexpr int NIMG = 27;

template <bool TRICLINIC>
struct MinImage {
  const float* L;      // (3,) box lengths
  float t1[3], t2[3];  // per axis, the thresholds (the kernel's float table)
  __device__ __forceinline__ float axis(int i, float d) const {
    return min_image_axis(d, L[i], t1[i], t2[i]);
  }
  __device__ __forceinline__ float r2(float dx, float dy, float dz) const {
    dx = axis(0, dx);
    dy = axis(1, dy);
    dz = axis(2, dz);
    return dx * dx + dy * dy + dz * dz;
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

// The box's minimum image: L the box lengths and a's thresholds, or the
// staged image shifts of a triclinic box.
template <bool TRICLINIC, class Args>
__device__ __forceinline__ MinImage<TRICLINIC> make_min_image(
    const Args& a, const float* L, const float* shifts) {
  if constexpr (TRICLINIC) {
    return MinImage<true>{shifts};
  } else {
    return MinImage<false>{L, {a.img_t1[0], a.img_t1[1], a.img_t1[2]},
                           {a.img_t2[0], a.img_t2[1], a.img_t2[2]}};
  }
}

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
// STEP_THREADS threads, or (stepg.cu at few replicas) a thread-block
// cluster of CL such CTAs. tid below is the thread's index in its CTA,
// rank the CTA's rank in its cluster (0 where CL is 1): the loops over
// sites and modes take cluster thread rank * STEP_THREADS + tid in strides
// of CL * STEP_THREADS, and with CL = 1 they are the one-CTA loops.
// ---------------------------------------------------------------------------

constexpr int STEP_THREADS = 256;
constexpr int STEP_WARPS = STEP_THREADS / 32;
constexpr int MAXA = 8;          // atoms per molecule
constexpr int MAXF = 2 * MAXA;   // footprint atoms (old | new)
constexpr int JMAX = 32;         // phase powers j = 0..JMAX-1 per axis
constexpr int MAXR = 8;          // residue types
constexpr int NRED = 7;          // reduced partial sums per step
constexpr int FW_PASS = STEP_THREADS;  // frozen tiles tested a pass
// the margin on a footprint side's reach (physics/fwsplit.py FW_CULL_EPS),
// A: some 100 times the float32 rounding of the cull's test and of the pair
// pass's r2 at the box sizes the minimum image takes
constexpr float FW_CULL_EPS = 1e-3f;

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

// The split barrier of a thread-block cluster: arrive (release: this CTA's
// shared-memory writes before it are visible to the cluster after the
// wait) and wait (acquire) for every CTA of the cluster to arrive. Every
// thread of every CTA calls both, in turn.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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
// and the frozen tiles each replica's steps tested and kept (frozen_tile_pass)
static __device__ long long maniac_tile_counts[SECTION_REPLICAS * 2];
__device__ __forceinline__ void tile_count(int tested, int kept) {
  const int r = blockIdx.x;
  if (threadIdx.x != 0 || r >= SECTION_REPLICAS) return;
  maniac_tile_counts[2 * r] += tested;
  maniac_tile_counts[2 * r + 1] += kept;
}
#define TILE_COUNT(tested, kept) tile_count(tested, kept)
#else
#define SECTION_MARK(k) \
  do {                  \
  } while (0)
#define TILE_COUNT(tested, kept) \
  do {                           \
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
  // the frozen tiles' cull: each side's centre (its COM, the proposal's)
  // and squared reach of an uncharged and a charged tile (footprint_reach;
  // -1: no side)
  float cc[2][3], reach_lj[2], reach_q[2];
  int far_n, ex_a, ex_b, n_sites, acc;
};

// The frozen tiles a pass of frozen_tile_pass keeps, and its warps' counts.
struct TileList {
  int kept[FW_PASS];
  int warp_n[STEP_WARPS];
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

// Sites a footprint is swept against: the frozen prefix [0, S_frozen)
// (swept by tiles: frozen_tile_pass), then the guest columns from
// guest_base up to the live end of the type regions at or above guest_base
// (S_frozen = guest_base = 0 without the framework split: every type
// region).
template <class Args>
__device__ int footprint_sites(const Args& a, const int* nmol) {
  int live_end = a.guest_base;
  for (int r = 0; r < a.R; ++r)
    if (a.type_site_base[r] >= a.guest_base)
      live_end = max(live_end, a.type_site_base[r] + nmol[r] * a.type_A[r]);
  return a.S_frozen + (live_end - a.guest_base);
}

// One thread a side, once the footprint and the sides' centres c (their
// COMs, fp.cc) are published: the side's squared reach for the frozen tiles'
// cull (-1 where the side has no atom). A pair of the side's atom f and a
// frozen site adds a term only within cutoff (LJ) or, where both carry
// charge, within rcut2 (pair_terms), and every atom lies within rho =
// max_f |p_f - c| of c, so no site farther than cutoff + rho (max(cutoff,
// rcut2) + rho) from c adds one; FW_CULL_EPS covers the float32 rounding. A
// position that is not finite gives a NaN reach, which keeps every tile
// (tile_in_reach). Read after the CTA's next barrier.
template <class Args>
__device__ __forceinline__ void footprint_reach(const Args& a, Footprint& fp,
                                                int side) {
  const float* c = fp.cc[side];
  float rho2 = 0.f;
  bool present = false, charged = false;
  for (int k = 0; k < a.A_act; ++k) {
    const int f = side * a.A_act + k;
    if (!fp.m[f]) continue;
    const float dx = fp.p[f][0] - c[0], dy = fp.p[f][1] - c[1];
    const float dz = fp.p[f][2] - c[2];
    const float r2 = dx * dx + dy * dy + dz * dz;
    rho2 = (r2 > rho2 || r2 != r2) ? r2 : rho2;  // a NaN stays
    present = true;
    charged = charged || fp.q[f] != 0.f;
  }
  const float rho = sqrtf(rho2);
  const float lj = a.cutoff + rho + FW_CULL_EPS;
  const float q = (charged ? fmaxf(a.cutoff, a.rcut2) : a.cutoff) + rho
                  + FW_CULL_EPS;
  fp.reach_lj[side] = present ? lj * lj : -1.f;
  fp.reach_q[side] = present ? q * q : -1.f;
}

// Phase powers of every footprint atom, up to the larger of the main and
// far-field grid orders per axis (threads 0 .. 6 A_act - 1, at most 48).
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

// The terms of one pair, footprint atom f of side SIDE and site s at (x,
// y, z) with charge qs and LJ row entries eps, sig2 (f's class): LJ cut at
// cut_sq into part[SIDE], the real-space Coulomb into part[2 + SIDE]. The
// reciprocal and the root are prims.cuh's branch-free forms: r2 is
// floored at 1e-18 and bounded by the box, so it and its reciprocal lie
// in their domains and they give the bits of 1.f / r2 and sqrtf. Each
// partial takes its term by a select, part or the fma that added the term
// (nvcc's contraction of part += 4 eps (sr6^2 - sr6) and of part += qq
// erfc inv_r): the bits of a conditional add, with no branch, so that ptxas
// interleaves the two pairs of an iteration. Only on the frozen prefix
// (FROZEN), where few pairs lie within rcut2, erfc stays behind its branch,
// which whole warps skip: one branch-free body for both made the
// flagship's block 6% slower (PERF.md).
template <int SIDE, bool FROZEN, class Args, class Image>
__device__ __forceinline__ void pair_terms(
    const Args& a, const Footprint& fp, const Image& img, int f, float x,
    float y, float z, float qs, float eps, float sig2, float cut_sq,
    float rc2_sq, float (&part)[NRED]) {
  float r2 = img.r2(x - fp.p[f][0], y - fp.p[f][1], z - fp.p[f][2]);
  r2 = fmaxf(r2, 1e-18f);
  const float inv_r2 = prim_rcp(r2);
  const float inv_r = prim_sqrt(inv_r2);
  const float r = r2 * inv_r;
  const float sr2 = sig2 * inv_r2;
  const float sr6 = sr2 * sr2 * sr2;
  const float lj = fmaf(fmaf(sr6, sr6, -sr6), 4.f * eps, part[SIDE]);
  part[SIDE] = eps != 0.f && r2 < cut_sq ? lj : part[SIDE];
  const float qq = fp.q[f] * qs;
  if constexpr (FROZEN) {
    if (qq != 0.f && r2 < rc2_sq)
      part[2 + SIDE] = fmaf(qq * erfcf(a.alpha2 * r), inv_r,
                            part[2 + SIDE]);
  } else {
    const float c = fmaf(qq * erfcf(a.alpha * r), inv_r, part[2 + SIDE]);
    part[2 + SIDE] = qq != 0.f && (!a.gg_cut || r2 < a.gg_rcut_sq)
                         ? c : part[2 + SIDE];
  }
}

// The pairs of one live site with the footprint, into part: atom k of
// the old side (f = k) and of the new side (f = A + k) in one iteration,
// two independent pairs where both sides move (a translation, a rotation,
// a swap), else the one (warp-uniform: the footprint is the CTA's). Each
// partial still takes its side's atoms in order. The sides share their LJ
// classes but in a swap, so the site's LJ entries (column s of eps and
// sig2, rows of S entries a class) are read once a class, sig2 only where
// eps is not 0.
template <bool FROZEN, class Args, class Image>
__device__ __forceinline__ void site_pairs(
    const Args& a, const Footprint& fp, const Image& img, const float* eps,
    const float* sig2, int S, int s, float x, float y, float z, float qs,
    float cut_sq, float rc2_sq, float (&part)[NRED]) {
  const int A = a.A_act;
  for (int k = 0; k < A; ++k) {
    const bool m0 = fp.m[k], m1 = fp.m[A + k];
    if (!m0 && !m1) continue;
    const int c0 = fp.cls[k], c1 = fp.cls[A + k];
    const bool same = m0 && c1 == c0;
    const float e0 = m0 ? eps[c0 * S + s] : 0.f;
    const float e1 = !m1 ? 0.f : same ? e0 : eps[c1 * S + s];
    const float g0 = e0 != 0.f ? sig2[c0 * S + s] : 0.f;
    const float g1 = e1 == 0.f ? 0.f : same ? g0 : sig2[c1 * S + s];
    if (m0 && m1) {
      pair_terms<0, FROZEN>(a, fp, img, k, x, y, z, qs, e0, g0, cut_sq,
                            rc2_sq, part);
      pair_terms<1, FROZEN>(a, fp, img, A + k, x, y, z, qs, e1, g1, cut_sq,
                            rc2_sq, part);
    } else if (m0) {
      pair_terms<0, FROZEN>(a, fp, img, k, x, y, z, qs, e0, g0, cut_sq,
                            rc2_sq, part);
    } else {
      pair_terms<1, FROZEN>(a, fp, img, A + k, x, y, z, qs, e1, g1, cut_sq,
                            rc2_sq, part);
    }
  }
}

// Whether frozen tile t lies within the reach of a present side of the
// footprint (footprint_reach): per axis, the distance from the side's
// centre to the tile's box through the boundary, max(0, |image of c - t| -
// h); the box holds its sites, so a site within reach lies in a tile
// within reach (physics/fwsplit.py tiles_in_reach is its copy).
template <class Args, class Image>
__device__ __forceinline__ bool tile_in_reach(const Args& a,
                                              const Footprint& fp,
                                              const Image& img, int t) {
  const float4 c = a.fw_box[2 * t], h = a.fw_box[2 * t + 1];
  bool keep = false;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const float dx = fmaxf(fabsf(img.axis(0, fp.cc[side][0] - c.x)) - h.x,
                           0.f);
    const float dy = fmaxf(fabsf(img.axis(1, fp.cc[side][1] - c.y)) - h.y,
                           0.f);
    const float dz = fmaxf(fabsf(img.axis(2, fp.cc[side][2] - c.z)) - h.z,
                           0.f);
    const float reach = c.w != 0.f ? fp.reach_q[side] : fp.reach_lj[side];
    keep = keep || !(dx * dx + dy * dy + dz * dz >= reach);
  }
  return keep;
}

// The frozen prefix's pairs with the footprint, into part: in passes of
// FW_PASS tiles, every thread tests one tile (tile_in_reach), a warp ballot
// and the warps' counts in order compact the kept tiles into tl.kept (the
// same list every run), and the threads then take the kept tiles' slots,
// cluster thread t slots t, t + CL 256, ..., site_pairs on the table's
// position, charge and LJ entries (a pad slot adds exact zeros). Every CTA
// of a cluster culls all the tiles itself, into its own list (the same
// list). Skipped sites are out of reach, where every term is an exact zero.
// Synchronizes the CTA.
template <int CL, class Args, class Image>
__device__ __forceinline__ void frozen_tile_pass(
    const Args& a, const Footprint& fp, const Image& img, TileList& tl,
    int tid, int rank, float cut_sq, float rc2_sq, float (&part)[NRED]) {
  const int lane = tid & 31, warp = tid >> 5, sh = a.fw_tile_shift;
  const int ns = a.n_fw_tiles << sh;
  for (int t0 = 0; t0 < a.n_fw_tiles; t0 += FW_PASS) {
    const int t = t0 + tid;
    const bool keep = t < a.n_fw_tiles && tile_in_reach(a, fp, img, t);
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) tl.warp_n[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, n = 0;
    for (int w = 0; w < STEP_WARPS; ++w) {
      const int c = tl.warp_n[w];
      base += w < warp ? c : 0;
      n += c;
    }
    if (keep) tl.kept[base + __popc(ballot & ((1u << lane) - 1u))] = t;
    TILE_COUNT(min(FW_PASS, a.n_fw_tiles - t0), n);
    __syncthreads();
    for (int j = rank * STEP_THREADS + tid; j < (n << sh);
         j += CL * STEP_THREADS) {
      const int slot = (tl.kept[j >> sh] << sh) | (j & ((1 << sh) - 1));
      const float4 p = a.fw_pq[slot];
      site_pairs<true>(a, fp, img, a.fw_eps, a.fw_sig2, ns, slot, p.x, p.y,
                       p.z, p.w, cut_sq, rc2_sq, part);
    }
  }
}

// This thread's partial sums of the step's energy terms other than the far
// field, part = [lj_old, lj_new, coul_old, coul_new, 0, 0, d_recip]: the
// pair pass over the live sites (LJ cut at cutoff; real-space Coulomb
// erfc(alpha2 r)/r cut at rcut2 on frozen sites, erfc(alpha r)/r elsewhere,
// cut at gg_rcut when gg_cut) and the k-space sum sum_k w_k (2 A.d + |d|^2).
// far_sweep adds part[4], part[5]. pos, ampre, ampim are this replica's; img
// is the box's minimum image (MinImage); TILES: the spec has a frozen
// prefix, swept by tiles (tl their list; never on a triclinic box). In a
// cluster of CL CTAs each CTA's threads take their share of the sites and
// modes (the cluster's threads, rank * STEP_THREADS + tid).
template <bool TILES, int CL, class Args, class Image>
__device__ __forceinline__ void footprint_partials(
    const Args& a, const Footprint& fp, float2 (*tab)[3][JMAX],
    const int* nmol, const float* pos, const float* ampre,
    const float* ampim, const Image& img, TileList& tl, int tid, int rank,
    float (&part)[NRED]) {
  const int S = a.S, F = 2 * a.A_act;
  const int ct = rank * STEP_THREADS + tid;  // the thread in its cluster
  const float cut_sq = a.cutoff * a.cutoff, rc2_sq = a.rcut2 * a.rcut2;
#pragma unroll
  for (int i = 0; i < NRED; ++i) part[i] = 0.f;

  // pair pass: the frozen tiles within reach (TILES), then the live sites
  // from j = S_frozen on (the guest columns). Without tiles S_frozen is 0
  // and the loop is the one the kernels ran before the tiles, its frozen
  // branch included, which never runs there: the no-split forms keep their
  // code, where the loop without it made ptxas spill 48 bytes in K3's
  // two-species form and cost it 6% (PERF.md, section 6).
  if constexpr (TILES)
    frozen_tile_pass<CL>(a, fp, img, tl, tid, rank, cut_sq, rc2_sq, part);
  for (int j = ct + (TILES ? a.S_frozen : 0); j < fp.n_sites;
       j += CL * STEP_THREADS) {
    const int s = j < a.S_frozen ? j : a.guest_base + (j - a.S_frozen);
    if (a.site_midx[s] >= nmol[a.site_type[s]]) continue;  // inactive
    const int mol = a.site_mol[s];
    if (mol == fp.ex_a || mol == fp.ex_b) continue;
    const float x = pos[s], y = pos[S + s], z = pos[2 * S + s];
    const float qs = a.site_q[s];
    if (!TILES && s < a.S_frozen)
      site_pairs<true>(a, fp, img, a.eps_site, a.sig2_site, S, s, x, y, z,
                       qs, cut_sq, rc2_sq, part);
    else
      site_pairs<false>(a, fp, img, a.eps_site, a.sig2_site, S, s, x, y, z,
                        qs, cut_sq, rc2_sq, part);
  }

  SECTION_MARK(2);  // pair pass

  // k-space: sum_k w_k (2 A.d + |d|^2) over the host's list of the modes
  // with weight (m, jx, jy, jz), dense, so every warp takes its share
  for (int i = ct; i < a.n_kw; i += CL * STEP_THREADS) {
    const int4 k = a.kmodes[i];
    const float w = a.kmode_w[i];
    const float2 d = footprint_mode(tab, fp.wk, 0, F, k.y, k.z, k.w);
    const float ar = ampre[k.x], ai = ampim[k.x];
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
// holds two staged tiles (2 FAR_TILE4 float4). In a cluster of CL CTAs,
// CTA rank r sweeps the tiles [r n / CL, (r + 1) n / CL) of the n, and a
// row cut by its range's ends is taken up from the unit's row base and
// closed there: Re(T x^jx z^jz) is linear in T, so the row's parts add up
// to the row.
template <int CL, class Args>
__device__ void far_sweep(const Args& a, int npass, float4* tiles,
                          const Footprint& fp, float2 (*tab)[3][JMAX],
                          const float4* ytab, int tid, int rank,
                          float (&part)[NRED]) {
  const int lane = tid & 31, warp = tid >> 5, n_tiles = a.n_far_tiles;
  const int k_lo = CL == 1 ? 0 : rank * n_tiles / CL;
  const int k_hi = CL == 1 ? n_tiles : (rank + 1) * n_tiles / CL;
  for (int pass = 0; pass < npass; ++pass) {
    const int k0 = pass * FAR_PASS;
    const int nk = min(FAR_PASS, fp.far_n - k0);
    const int np = (nk + 1) / 2;  // atom pairs, 1 .. FAR_PASS / 2
    float acc[2 * FAR_PASS];
#pragma unroll
    for (int i = 0; i < 2 * FAR_PASS; ++i) acc[i] = 0.f;
    int jz = 0, jx = 0, yb = 0;
    if (CL == 1 || k_lo < k_hi) {
      for (int i = tid; i < FAR_TILE4; i += STEP_THREADS)
        cp_async16(tiles + i, a.far_coef + (size_t)k_lo * FAR_TILE4 + i);
    }
    cp_async_commit();
    for (int k = k_lo; k < k_hi; ++k) {
      if (k + 1 < k_hi) {
        float4* dst = tiles + ((k + 1 - k_lo) & 1) * FAR_TILE4;
        const float4* src = a.far_coef + (size_t)(k + 1) * FAR_TILE4;
        for (int i = tid; i < FAR_TILE4; i += STEP_THREADS)
          cp_async16(dst + i, src + i);
      }
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();  // tile k is in, and so is ytab
      const int4 u = a.far_units[k * FAR_WARPS + warp];
      if (u.z > 0) {
        if ((u.w & FAR_FIRST) || (CL > 1 && k == k_lo)) {
          const int4 r = a.far_rows[u.x + lane];
          jz = r.x;
          jx = r.y;
          yb = r.z;
#pragma unroll
          for (int i = 0; i < 2 * FAR_PASS; ++i) acc[i] = 0.f;
        }
        const float2* c = reinterpret_cast<const float2*>(
                              tiles + ((k - k_lo) & 1) * FAR_TILE4)
                          + warp * FAR_TCH * FAR_LANES + lane;
        const float4* y = ytab + k0 / 2;
        const int yi = yb + u.y;
        switch (np) {
          case 1: far_unit<1>(acc, c, y, yi, u.z); break;
          case 2: far_unit<2>(acc, c, y, yi, u.z); break;
          case 3: far_unit<3>(acc, c, y, yi, u.z); break;
          default: far_unit<4>(acc, c, y, yi, u.z); break;
        }
        // close the rows: Re(T x^jx z^jz) by side
        if ((u.w & FAR_LAST) || (CL > 1 && k == k_hi - 1)) {
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
