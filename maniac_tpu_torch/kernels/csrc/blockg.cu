// A whole block of MC steps per replica, state resident across steps.
//
// Replaces maniac_tpu/kernels/blockg.py::_blockg_kernel (launcher
// run_block_grouped) in its one-active-species, framework-split,
// orthorhombic, no-reservoir form. Each step is exactly
// maniac_tpu/mc/moves.py::mc_step_u on one row of 21 uniforms:
// proposal (_propose), guest pairs (LJ + erfc(alpha r)/r cut at gg_rcut),
// framework pairs (LJ + erfc(alpha2 r)/r cut at rcut2), the far-field grid
// term, the k-space delta, the Metropolis test and the commits with
// compaction on deletion (_core_xla, _bookkeep).
//
// Bound on the H100: arithmetic, and the step chain. Per step and replica
// the far-field contraction (footprint charges x the 48 x 1152 alpha2 grid)
// and the k-space delta (x 9216 modes) dominate; the pair passes cover
// 2160 framework sites and the live guests. Steps are sequential within a
// replica, so the parallelism is replicas (one CTA each, B = 1024 CTAs)
// times the threads of a CTA within a step.
// Design: one CTA per replica runs all n_steps; thread 0 makes the
// proposal from its uniform row (a transcription of _propose, f32 as in
// the JAX package) and publishes the old/new footprints (<= 2 x 8 atoms)
// in shared memory; all threads build the footprint phase-power tables,
// then sweep the framework and live guest sites, the far-field grid and
// the k-space modes with per-thread partial sums and one block reduction;
// thread 0 decides and commits positions, COMs, populations, energies and
// counters; on acceptance every thread recomputes the delta of its own
// modes and adds it to the amplitudes (no 74 KB delta buffer). Framework
// pairs loop over all frozen sites with minimum image, as the oracle does
// (blockg's ghost-sorted windows were a TPU layout). erfc is libdevice
// erfcf (common.cuh). Speed (shared-memory state, tensor-core contractions,
// window culling) is later work.
#include <algorithm>

#include "common.cuh"

namespace {

enum BlockPtr {
  BP_U,            // (B, n_steps, 21) f32 uniforms, replica-major
  BP_POS_IN,       // (B, 3, S) f32
  BP_COM_IN,       // (B, 3, Mtot+1) f32
  BP_AMPRE_IN,     // (B, K) f32
  BP_AMPIM_IN,
  BP_NMOL_IN,      // (B, R+1) i32
  BP_ENERGY_IN,    // (B, 6) f32
  BP_COUNTERS_IN,  // (B, 2, 5) i32
  BP_EXTRAS_IN,    // (B, 4) i32
  BP_TSTEP,        // (B,) f32
  BP_RSTEP,        // (B,) f32
  BP_POS,          // outputs, same shapes
  BP_COM,
  BP_AMPRE,
  BP_AMPIM,
  BP_NMOL,
  BP_ENERGY,
  BP_COUNTERS,
  BP_EXTRAS,
  BP_SITE_Q,       // (S,) f32
  BP_SITE_TYPE,    // (S,) i32
  BP_SITE_MIDX,    // (S,) i32
  BP_SITE_MOL,     // (S,) i32
  BP_EPS_SITE,     // (C+1, S) f32
  BP_SIG2_SITE,    // (C+1, S) f32
  BP_TYPE_A,       // (R,) i32
  BP_TYPE_CAP,     // (R,) i32
  BP_TYPE_SITE_BASE,  // (R,) i32
  BP_TYPE_MOL_BASE,   // (R,) i32
  BP_TYPE_ACTIVITY,   // (R,) f32
  BP_TYPE_SELF,       // (R,) f32
  BP_TEMPLATE,        // (R, A_act, 3) f32
  BP_TYPE_Q,          // (R, A_act) f32
  BP_TYPE_CLS,        // (R, A_act) i32
  BP_MOL_SITE_START,  // (Mtot,) i32
  BP_PCUM,         // (4,) f32
  BP_LO,           // (3,) f32 box lower bounds
  BP_BOXL,         // (3,) f32 box lengths
  BP_H,            // (3, 3) f32
  BP_H2PI,         // (3, 3) f32
  BP_KW,           // (K,) f32 k_weights
  BP_COL_JX,       // (JxyP,) i32, -1 = pad
  BP_COL_JY,       // (JxyP,) i32 signed
  BP_C2RE,         // (K2,) f32 far-field coefficients
  BP_C2IM,
  BP_COL2_JX,      // (Jxy2P,) i32, -1 = pad
  BP_COL2_JY,
  BP_COUNT
};
enum BlockInt {
  BI_B, BI_NSTEPS, BI_S, BI_S_FROZEN, BI_GUEST_BASE, BI_R, BI_MTOT,
  BI_A_ACT, BI_T_ACT, BI_JZP, BI_JXYP, BI_KX, BI_KY, BI_KZ, BI_JZ2P,
  BI_JXY2P, BI_KX2, BI_KY2, BI_KZ2, BI_GG_CUT, BI_COUNT
};
enum BlockFloat {
  BF_ALPHA, BF_ALPHA2, BF_CUTOFF, BF_RCUT2, BF_GG_RCUT_SQ, BF_TEMP,
  BF_VOLUME, BF_FW_D0, BF_COULOMB_K, BF_TWO_PI, BF_PROB_CD, BF_SMALL_SQ,
  BF_COUNT
};

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int MAXA = 8;          // atoms per molecule
constexpr int MAXF = 2 * MAXA;   // footprint atoms (old | new)
constexpr int JMAX = 32;         // phase powers j = 0..JMAX-1 per axis
constexpr int MAXR = 8;          // residue types
constexpr int NRED = 7;          // reduced partial sums per step

struct Args {
  const float* u;
  const float* pos_in; const float* com_in;
  const float* ampre_in; const float* ampim_in;
  const int* nmol_in; const float* energy_in;
  const int* counters_in; const int* extras_in;
  const float* tstep; const float* rstep;
  float* pos; float* com; float* ampre; float* ampim;
  int* nmol; float* energy; int* counters; int* extras;
  const float* site_q; const int* site_type; const int* site_midx;
  const int* site_mol; const float* eps_site; const float* sig2_site;
  const int* type_A; const int* type_cap; const int* type_site_base;
  const int* type_mol_base; const float* type_activity;
  const float* type_self; const float* templ; const float* type_q;
  const int* type_cls; const int* mol_site_start;
  const float* p_cum; const float* lo; const float* boxl; const float* H;
  const float* h2pi; const float* kw; const int* col_jx; const int* col_jy;
  const float* c2re; const float* c2im; const int* col2_jx;
  const int* col2_jy;
  int B, n_steps, S, S_frozen, guest_base, R, Mtot, A_act, t_act;
  int JzP, JxyP, kx, ky, kz, Jz2P, Jxy2P, kx2, ky2, kz2, gg_cut;
  float alpha, alpha2, cutoff, rcut2, gg_rcut_sq, temp, volume, fw_d0;
  float coulomb_k, two_pi, prob_cd, small_sq;
};

// Everything thread 0 carries from the proposal to the decision.
struct Proposal {
  float P_new[MAXA][3];
  float last[MAXA][3];
  float com_new[3], com_last[3];
  float u_acc, pref, i_old, i_new, s_old, s_new, sw[2];
  int move, valid, cap_blocked, gate, insert_like, remove_like, w_new;
  int t, A, mol_slot_old, slot_new, site_start_old, site_start_new;
};

__device__ __forceinline__ int uint_draw(float u, int n) {
  // floor(u * n) clamped to n - 1 (moves.py::_uint), f32 product
  return min(static_cast<int>(u * static_cast<float>(n)), n - 1);
}

__device__ float intra_energy(const Args& a, float (*P)[3],
                              const float* q, int A) {
  // sum_{i<j} q_i q_j (erfc(alpha r) - 1) / r, minimum image
  float e = 0.f;
  for (int i = 0; i < A; ++i) {
    for (int j = i + 1; j < A; ++j) {
      float r2 = min_image_r2(P[j][0] - P[i][0], P[j][1] - P[i][1],
                              P[j][2] - P[i][2], a.boxl);
      r2 = fmaxf(r2, 1e-18f);
      if (!(r2 > a.small_sq)) continue;
      const float r = sqrtf(r2);
      e += q[j] * q[i] * (erfcf(a.alpha * r) - 1.f) / r;
    }
  }
  return e * a.coulomb_k;
}

__device__ void axis_rotation(int axis, float theta, float (*R)[3]) {
  const float c = cosf(theta), s = sinf(theta);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) R[i][j] = 0.f;
  const int p = (axis + 1) % 3, q = (axis + 2) % 3;
  R[axis][axis] = 1.f;
  // rx: [[1,0,0],[0,c,-s],[0,s,c]]; ry: [[c,0,s],[0,1,0],[-s,0,c]];
  // rz: [[c,-s,0],[s,c,0],[0,0,1]]: the same cyclic pattern
  R[p][p] = c;
  R[q][q] = c;
  R[p][q] = -s;
  R[q][p] = s;
}

__device__ void uniform_rotation(const float* u, float two_pi, float (*R)[3]) {
  // Shoemake quaternion from 3 uniforms (moves.py::_uniform_rotation)
  const float a = sqrtf(1.f - u[0]), b = sqrtf(u[0]);
  const float t2 = two_pi * u[1], t3 = two_pi * u[2];
  const float w = a * sinf(t2), x = a * cosf(t2);
  const float y = b * sinf(t3), z = b * cosf(t3);
  R[0][0] = 1 - 2 * (y * y + z * z);
  R[0][1] = 2 * (x * y - w * z);
  R[0][2] = 2 * (x * z + w * y);
  R[1][0] = 2 * (x * y + w * z);
  R[1][1] = 1 - 2 * (x * x + z * z);
  R[1][2] = 2 * (y * z - w * x);
  R[2][0] = 2 * (x * z - w * y);
  R[2][1] = 2 * (y * z + w * x);
  R[2][2] = 1 - 2 * (x * x + y * y);
}

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

// Thread 0: moves.py::_propose for one replica and one uniform row.
__device__ void propose(const Args& a, int b, int step, const int* nmol,
                        const float* pos, const float* com, float tstep,
                        float rstep, Proposal& pr, Footprint& fp) {
  float u[21];
  const float* ur = a.u + ((size_t)b * a.n_steps + step) * 21;
  for (int i = 0; i < 21; ++i) u[i] = ur[i];
  const int A_act = a.A_act, S = a.S, M1 = a.Mtot + 1;

  const bool is_trans = u[0] <= a.p_cum[0];
  const bool is_rot = !is_trans && u[0] <= a.p_cum[1];
  const bool is_indel = !is_trans && !is_rot && u[0] <= a.p_cum[2];
  const bool is_create = is_indel && u[1] <= a.prob_cd;
  const bool is_delete = is_indel && !is_create;
  // one active species: no swap; a swap draw is dropped (dead draw)
  const bool dead_draw = !is_trans && !is_rot && !is_indel;
  pr.move = is_create ? 0 : is_delete ? 1 : is_trans ? 2 : is_rot ? 3 : 4;
  const bool insert_like = is_create, remove_like = is_delete;
  const bool w_old = is_trans || is_rot || is_delete;
  const bool w_new = is_trans || is_rot || is_create;

  const int t = a.t_act;
  const int n_old = nmol[t];
  const int m_old = uint_draw(u[13], max(n_old, 1));
  const int A = a.type_A[t];
  const int cap = a.type_cap[t];
  const bool valid = (is_create ? true
                      : is_rot ? (n_old > 0 && A > 1) : n_old > 0)
                     && !dead_draw;
  const bool cap_blocked = insert_like && n_old >= cap;

  const int mol_slot_old = a.type_mol_base[t] + m_old;
  const int site_start_old = a.type_site_base[t] + m_old * A;
  const int slot_new = insert_like ? a.type_mol_base[t] + min(n_old, cap - 1)
                                   : mol_slot_old;
  const int site_start_new = a.mol_site_start[slot_new];
  const int last_idx = max(n_old - 1, 0);
  const int start_last = a.type_site_base[t] + last_idx * A;
  const int slot_last = a.type_mol_base[t] + last_idx;

  float P_old[MAXA][3], off_src[MAXA][3], com_old[3];
  for (int i = 0; i < 3; ++i) {
    com_old[i] = com[i * M1 + mol_slot_old];
    pr.com_last[i] = com[i * M1 + slot_last];
  }
  const float* tq = a.type_q + t * A_act;
  for (int k = 0; k < A_act; ++k) {
    for (int i = 0; i < 3; ++i) {
      P_old[k][i] = pos[i * S + site_start_old + k];
      pr.last[k][i] = pos[i * S + start_last + k];
      off_src[k][i] = insert_like ? a.templ[(t * A_act + k) * 3 + i]
                                  : P_old[k][i] - com_old[i];
    }
  }
  float Rm[3][3];
  const float theta = is_rot ? (u[9] - 0.5f) * rstep : 0.f;
  if (insert_like) uniform_rotation(u + 15, a.two_pi, Rm);
  else axis_rotation(uint_draw(u[10], 3), theta, Rm);

  for (int i = 0; i < 3; ++i) {
    float c;
    if (is_trans) {  // wrap_into_box: fmod plus L where negative
      const float x = com_old[i] + (u[3 + i] - 0.5f) * tstep;
      float r = fmodf(x - a.lo[i], a.boxl[i]);
      if (r < 0.f) r += a.boxl[i];
      c = a.lo[i] + r;
    } else if (is_create) {
      c = a.lo[i] + (a.H[3 * i] * u[6] + a.H[3 * i + 1] * u[7]
                     + a.H[3 * i + 2] * u[8]);
    } else {
      c = com_old[i];
    }
    pr.com_new[i] = c;
  }
  for (int k = 0; k < A_act; ++k)
    for (int i = 0; i < 3; ++i)
      pr.P_new[k][i] = pr.com_new[i]
                       + (off_src[k][0] * Rm[i][0] + off_src[k][1] * Rm[i][1]
                          + off_src[k][2] * Rm[i][2]);

  pr.i_old = (remove_like && valid) ? intra_energy(a, P_old, tq, A) : 0.f;
  pr.i_new = insert_like ? intra_energy(a, pr.P_new, tq, A) : 0.f;
  pr.s_old = remove_like ? a.type_self[t] : 0.f;
  pr.s_new = insert_like ? a.type_self[t] : 0.f;
  const float act = a.type_activity[t], V = a.volume;
  float pref = insert_like ? act * V / (static_cast<float>(n_old) + 1.f)
                           : 1.f;
  pref = pref * (remove_like ? static_cast<float>(n_old) / (act * V) : 1.f);

  pr.u_acc = u[2];
  pr.pref = pref;
  pr.valid = valid;
  pr.cap_blocked = cap_blocked;
  pr.gate = valid && !cap_blocked;
  pr.insert_like = insert_like;
  pr.remove_like = remove_like;
  pr.w_new = w_new;
  pr.t = t;
  pr.A = A;
  pr.mol_slot_old = mol_slot_old;
  pr.slot_new = slot_new;
  pr.site_start_old = site_start_old;
  pr.site_start_new = site_start_new;

  // publish the footprint
  const int* tc = a.type_cls + t * A_act;
  pr.sw[0] = pr.sw[1] = 0.f;
  for (int side = 0; side < 2; ++side) {
    const bool w_side = side == 0 ? w_old : w_new;
    for (int k = 0; k < A_act; ++k) {
      const int f = side * A_act + k;
      const bool m = k < A && w_side;
      for (int i = 0; i < 3; ++i)
        fp.p[f][i] = side == 0 ? P_old[k][i] : pr.P_new[k][i];
      fp.q[f] = tq[k];
      fp.cls[f] = tc[k];
      fp.m[f] = m;
      const float qm = tq[k] * (m ? 1.f : 0.f);
      fp.wf[f] = qm;
      fp.wk[f] = qm * (side == 0 ? -(w_old ? 1.f : 0.f)
                                 : (w_new ? 1.f : 0.f));
      pr.sw[side] += qm;
    }
  }
  fp.ex_a = w_old ? mol_slot_old : a.Mtot + 1;
  fp.ex_b = slot_new;
  // sites to sweep: the frozen prefix, then guest columns up to the live
  // end of the guest type regions
  int live_end = a.guest_base;
  for (int r = 0; r < a.R; ++r)
    if (a.type_site_base[r] >= a.guest_base)
      live_end = max(live_end, a.type_site_base[r] + nmol[r] * a.type_A[r]);
  fp.n_sites = a.S_frozen + (live_end - a.guest_base);
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

__global__ void __launch_bounds__(THREADS) blockg_kernel(Args a) {
  __shared__ Footprint fp;
  __shared__ float2 tab[MAXF][3][JMAX];
  __shared__ float scratch[NWARP * NRED];
  __shared__ float red[NRED];
  __shared__ int nmol[MAXR + 1];
  __shared__ float energy[6];
  __shared__ int counters[10];
  __shared__ int extras[4];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int S = a.S, M1 = a.Mtot + 1, K = a.JzP * a.JxyP;
  const int K2 = a.Jz2P * a.Jxy2P, F = 2 * a.A_act;
  const int Jz = 2 * a.kz + 1, Jz2 = 2 * a.kz2 + 1;
  float* pos = a.pos + (size_t)b * 3 * S;
  float* com = a.com + (size_t)b * 3 * M1;
  float* ampre = a.ampre + (size_t)b * K;
  float* ampim = a.ampim + (size_t)b * K;

  for (int i = tid; i < 3 * S; i += THREADS)
    pos[i] = a.pos_in[(size_t)b * 3 * S + i];
  for (int i = tid; i < 3 * M1; i += THREADS)
    com[i] = a.com_in[(size_t)b * 3 * M1 + i];
  for (int i = tid; i < K; i += THREADS) {
    ampre[i] = a.ampre_in[(size_t)b * K + i];
    ampim[i] = a.ampim_in[(size_t)b * K + i];
  }
  if (tid <= a.R) nmol[tid] = a.nmol_in[b * (a.R + 1) + tid];
  if (tid < 6) energy[tid] = a.energy_in[6 * b + tid];
  if (tid < 10) counters[tid] = a.counters_in[10 * b + tid];
  if (tid < 4) extras[tid] = a.extras_in[4 * b + tid];
  const float tstep = a.tstep[b], rstep = a.rstep[b];
  const float cut_sq = a.cutoff * a.cutoff, rc2_sq = a.rcut2 * a.rcut2;
  const float L[3] = {a.boxl[0], a.boxl[1], a.boxl[2]};
  Proposal pr;
  __syncthreads();

  for (int step = 0; step < a.n_steps; ++step) {
    if (tid == 0) propose(a, b, step, nmol, pos, com, tstep, rstep, pr, fp);
    __syncthreads();

    // phase powers of every footprint atom, up to the larger of the main
    // and far-field grid orders per axis
    if (tid < 3 * F) {
      const int f = tid / 3, ax = tid % 3;
      const float* h = a.h2pi + 3 * ax;
      const float th = h[0] * fp.p[f][0] + h[1] * fp.p[f][1]
                       + h[2] * fp.p[f][2];
      const int k1 = ax == 0 ? a.kx : ax == 1 ? a.ky : a.kz;
      const int k2 = ax == 0 ? a.kx2 : ax == 1 ? a.ky2 : a.kz2;
      phase_powers(th, max(k1, k2), tab[f][ax]);
    }
    __syncthreads();

    // [lj_old, lj_new, coul_old, coul_new, far_old, far_new, d_recip]
    float part[NRED] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

    // pair pass: frozen prefix, then the live guest columns
    for (int j = tid; j < fp.n_sites; j += THREADS) {
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
          float r2 = min_image_r2(x - fp.p[f][0], y - fp.p[f][1],
                                  z - fp.p[f][2], L);
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
    for (int m = tid; m < K2; m += THREADS) {
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
    for (int m = tid; m < K; m += THREADS) {
      const float w = a.kw[m];
      if (w == 0.f) continue;
      const int row = m / a.JxyP, col = m - row * a.JxyP;
      const float2 d = footprint_mode(tab, fp.wk, 0, F, a.col_jx[col],
                                      a.col_jy[col], row - a.kz);
      const float ar = ampre[m], ai = ampim[m];
      part[6] += w * (2.f * (ar * d.x + ai * d.y) + d.x * d.x + d.y * d.y);
    }

    block_sum<NRED>(part, scratch, red);

    if (tid == 0) {
      const float e_lj0 = red[0], e_lj1 = red[1];
      const float e_coul0 = red[2] * a.coulomb_k
                            + (red[4] + a.fw_d0 * pr.sw[0]);
      const float e_coul1 = red[3] * a.coulomb_k
                            + (red[5] + a.fw_d0 * pr.sw[1]);
      const float e_recip_old = energy[0];
      const float e_recip_new = e_recip_old
                                + red[6] * a.coulomb_k * a.two_pi / a.volume;
      const float e_other_old = e_lj0 + e_coul0 + pr.s_old + pr.i_old;
      const float e_other_new = e_lj1 + e_coul1 + pr.s_new + pr.i_new;
      const float delta_e = (e_other_new + e_recip_new)
                            - (e_other_old + e_recip_old);
      const float p = pr.pref * expf(-delta_e / a.temp);
      const float p_acc = (p < 1.f || p != p) ? p : 1.f;  // NaN rejects
      const bool acc = pr.gate && pr.u_acc <= p_acc;
      const float accf = acc ? 1.f : 0.f;

      // compaction first (the type's last molecule moves into the freed
      // slot), then the written molecule: new rows win where both apply
      if (acc && pr.remove_like) {
        for (int k = 0; k < pr.A; ++k)
          for (int i = 0; i < 3; ++i)
            pos[i * S + pr.site_start_old + k] = pr.last[k][i];
        for (int i = 0; i < 3; ++i)
          com[i * M1 + pr.mol_slot_old] = pr.com_last[i];
      }
      if (acc && pr.w_new) {
        for (int k = 0; k < pr.A; ++k)
          for (int i = 0; i < 3; ++i)
            pos[i * S + pr.site_start_new + k] = pr.P_new[k][i];
        for (int i = 0; i < 3; ++i)
          com[i * M1 + pr.slot_new] = pr.com_new[i];
      }
      nmol[pr.t] += (acc && pr.insert_like) - (acc && pr.remove_like);
      energy[0] += acc ? e_recip_new - e_recip_old : 0.f;
      energy[1] += accf * (e_lj1 - e_lj0);
      energy[2] += accf * (e_coul1 - e_coul0);
      energy[3] += accf * (pr.s_new - pr.s_old);
      energy[4] += accf * (pr.i_new - pr.i_old);
      energy[5] += accf * delta_e;
      counters[pr.move] += pr.valid;
      counters[5 + pr.move] += acc;
      extras[0] += pr.valid && pr.cap_blocked;
      fp.acc = acc;
    }
    __syncthreads();

    if (fp.acc) {  // amp += d on every grid mode (recomputed, not stored)
      for (int m = tid; m < K; m += THREADS) {
        const int row = m / a.JxyP, col = m - row * a.JxyP;
        const int jx = a.col_jx[col];
        if (row >= Jz || jx < 0) continue;  // d = 0 on pad modes
        const float2 d = footprint_mode(tab, fp.wk, 0, F, jx, a.col_jy[col],
                                        row - a.kz);
        ampre[m] += d.x;
        ampim[m] += d.y;
      }
    }
    __syncthreads();
  }

  if (tid <= a.R) a.nmol[b * (a.R + 1) + tid] = nmol[tid];
  if (tid < 6) a.energy[6 * b + tid] = energy[tid];
  if (tid < 10) a.counters[10 * b + tid] = counters[tid];
  if (tid < 4) a.extras[4 * b + tid] = extras[tid];
}

}  // namespace

extern "C" int blockg_launch(void* const* ptrs, int nptr, const int* ints,
                             int nint, const float* fl, int nfloat,
                             void* stream) {
  if (nptr != BP_COUNT || nint != BI_COUNT || nfloat != BF_COUNT)
    return MANIAC_ERR_TABLES;
  Args a;
  a.u = static_cast<const float*>(ptrs[BP_U]);
  a.pos_in = static_cast<const float*>(ptrs[BP_POS_IN]);
  a.com_in = static_cast<const float*>(ptrs[BP_COM_IN]);
  a.ampre_in = static_cast<const float*>(ptrs[BP_AMPRE_IN]);
  a.ampim_in = static_cast<const float*>(ptrs[BP_AMPIM_IN]);
  a.nmol_in = static_cast<const int*>(ptrs[BP_NMOL_IN]);
  a.energy_in = static_cast<const float*>(ptrs[BP_ENERGY_IN]);
  a.counters_in = static_cast<const int*>(ptrs[BP_COUNTERS_IN]);
  a.extras_in = static_cast<const int*>(ptrs[BP_EXTRAS_IN]);
  a.tstep = static_cast<const float*>(ptrs[BP_TSTEP]);
  a.rstep = static_cast<const float*>(ptrs[BP_RSTEP]);
  a.pos = static_cast<float*>(ptrs[BP_POS]);
  a.com = static_cast<float*>(ptrs[BP_COM]);
  a.ampre = static_cast<float*>(ptrs[BP_AMPRE]);
  a.ampim = static_cast<float*>(ptrs[BP_AMPIM]);
  a.nmol = static_cast<int*>(ptrs[BP_NMOL]);
  a.energy = static_cast<float*>(ptrs[BP_ENERGY]);
  a.counters = static_cast<int*>(ptrs[BP_COUNTERS]);
  a.extras = static_cast<int*>(ptrs[BP_EXTRAS]);
  a.site_q = static_cast<const float*>(ptrs[BP_SITE_Q]);
  a.site_type = static_cast<const int*>(ptrs[BP_SITE_TYPE]);
  a.site_midx = static_cast<const int*>(ptrs[BP_SITE_MIDX]);
  a.site_mol = static_cast<const int*>(ptrs[BP_SITE_MOL]);
  a.eps_site = static_cast<const float*>(ptrs[BP_EPS_SITE]);
  a.sig2_site = static_cast<const float*>(ptrs[BP_SIG2_SITE]);
  a.type_A = static_cast<const int*>(ptrs[BP_TYPE_A]);
  a.type_cap = static_cast<const int*>(ptrs[BP_TYPE_CAP]);
  a.type_site_base = static_cast<const int*>(ptrs[BP_TYPE_SITE_BASE]);
  a.type_mol_base = static_cast<const int*>(ptrs[BP_TYPE_MOL_BASE]);
  a.type_activity = static_cast<const float*>(ptrs[BP_TYPE_ACTIVITY]);
  a.type_self = static_cast<const float*>(ptrs[BP_TYPE_SELF]);
  a.templ = static_cast<const float*>(ptrs[BP_TEMPLATE]);
  a.type_q = static_cast<const float*>(ptrs[BP_TYPE_Q]);
  a.type_cls = static_cast<const int*>(ptrs[BP_TYPE_CLS]);
  a.mol_site_start = static_cast<const int*>(ptrs[BP_MOL_SITE_START]);
  a.p_cum = static_cast<const float*>(ptrs[BP_PCUM]);
  a.lo = static_cast<const float*>(ptrs[BP_LO]);
  a.boxl = static_cast<const float*>(ptrs[BP_BOXL]);
  a.H = static_cast<const float*>(ptrs[BP_H]);
  a.h2pi = static_cast<const float*>(ptrs[BP_H2PI]);
  a.kw = static_cast<const float*>(ptrs[BP_KW]);
  a.col_jx = static_cast<const int*>(ptrs[BP_COL_JX]);
  a.col_jy = static_cast<const int*>(ptrs[BP_COL_JY]);
  a.c2re = static_cast<const float*>(ptrs[BP_C2RE]);
  a.c2im = static_cast<const float*>(ptrs[BP_C2IM]);
  a.col2_jx = static_cast<const int*>(ptrs[BP_COL2_JX]);
  a.col2_jy = static_cast<const int*>(ptrs[BP_COL2_JY]);
  a.B = ints[BI_B];
  a.n_steps = ints[BI_NSTEPS];
  a.S = ints[BI_S];
  a.S_frozen = ints[BI_S_FROZEN];
  a.guest_base = ints[BI_GUEST_BASE];
  a.R = ints[BI_R];
  a.Mtot = ints[BI_MTOT];
  a.A_act = ints[BI_A_ACT];
  a.t_act = ints[BI_T_ACT];
  a.JzP = ints[BI_JZP];
  a.JxyP = ints[BI_JXYP];
  a.kx = ints[BI_KX];
  a.ky = ints[BI_KY];
  a.kz = ints[BI_KZ];
  a.Jz2P = ints[BI_JZ2P];
  a.Jxy2P = ints[BI_JXY2P];
  a.kx2 = ints[BI_KX2];
  a.ky2 = ints[BI_KY2];
  a.kz2 = ints[BI_KZ2];
  a.gg_cut = ints[BI_GG_CUT];
  a.alpha = fl[BF_ALPHA];
  a.alpha2 = fl[BF_ALPHA2];
  a.cutoff = fl[BF_CUTOFF];
  a.rcut2 = fl[BF_RCUT2];
  a.gg_rcut_sq = fl[BF_GG_RCUT_SQ];
  a.temp = fl[BF_TEMP];
  a.volume = fl[BF_VOLUME];
  a.fw_d0 = fl[BF_FW_D0];
  a.coulomb_k = fl[BF_COULOMB_K];
  a.two_pi = fl[BF_TWO_PI];
  a.prob_cd = fl[BF_PROB_CD];
  a.small_sq = fl[BF_SMALL_SQ];
  const int kmax = std::max({a.kx, a.ky, a.kz, a.kx2, a.ky2, a.kz2});
  if (a.B < 1 || a.A_act < 1 || a.A_act > MAXA || a.R + 1 > MAXR + 1
      || kmax >= JMAX || a.JzP < 2 * a.kz + 1 || a.Jz2P < 2 * a.kz2 + 1)
    return MANIAC_ERR_SHAPE;
  blockg_kernel<<<a.B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
