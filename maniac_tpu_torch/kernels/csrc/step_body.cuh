// One whole MC step of one replica, shared by the whole-block kernel
// (blockg.cu: a loop of it, state resident across the block) and the
// per-step kernel (stepg.cu: one of it per launch, in place).
//
// A step is exactly maniac_tpu/mc/moves.py::mc_step_u on one row of 21
// uniforms: thread 0 makes the proposal (propose, a transcription of
// _propose, f32 as in the JAX package) and publishes the old/new footprints
// (<= 2 x 8 atoms, each atom with its own side's charge and LJ class row)
// in shared memory; all threads build the footprint phase-power tables,
// sweep the live sites and the k-space modes with per-thread partial sums,
// contract the far table (common.cuh far_sweep) and make one block
// reduction; thread 0 decides and commits positions, COMs, populations,
// energies, counters and the reservoir rows (commit_reservoir); on
// acceptance every thread recomputes the delta of its own modes and adds it
// to the amplitudes. Nothing else is written.
//
// Both kernels take the tables below (StepPtr, StepInt, StepFloat, in this
// order; kernels/stepg.py::step_tables packs them) and append their own
// entries after SP_SHARED and SI_SHARED; their Args derive from StepArgs,
// filled by unpack_step_args. The functions are templates on that Args.
// a.act_stride is the activity table's stride per replica: blockg.cu's Args
// holds it as a static 0 (one table), stepg.cu's as an int (0, or R for a
// per-replica table).
#pragma once

#include <algorithm>

#include "common.cuh"

// The state pointers are the state a step writes: the block kernel's
// outputs, the step kernel's working copy (updated in place).
enum StepPtr {
  SP_U,            // (B, n_steps, 21) f32 the block's uniforms, replica-major
  SP_POS,          // (B, 3, S) f32
  SP_COM,          // (B, 3, Mtot+1) f32
  SP_AMPRE,        // (B, K) f32
  SP_AMPIM,
  SP_NMOL,         // (B, R+1) i32
  SP_ENERGY,       // (B, 6) f32
  SP_COUNTERS,     // (B, 2, 5) i32
  SP_EXTRAS,       // (B, 4) i32
  SP_TSTEP,        // (B,) f32, read only
  SP_RSTEP,        // (B,) f32, read only
  SP_SITE_Q,       // (S,) f32
  SP_SITE_TYPE,    // (S,) i32
  SP_SITE_MIDX,    // (S,) i32
  SP_SITE_MOL,     // (S,) i32
  SP_EPS_SITE,     // (C+1, S) f32
  SP_SIG2_SITE,    // (C+1, S) f32
  SP_TYPE_A,       // (R,) i32
  SP_TYPE_CAP,     // (R,) i32
  SP_TYPE_SITE_BASE,  // (R,) i32
  SP_TYPE_MOL_BASE,   // (R,) i32
  SP_TYPE_ACTIVITY,   // (R,) or, with act_stride R, (B, R) f32
  SP_TYPE_SELF,       // (R,) f32
  SP_TEMPLATE,        // (R, A_act, 3) f32
  SP_TYPE_Q,          // (R, A_act) f32
  SP_TYPE_CLS,        // (R, A_act) i32
  SP_MOL_SITE_START,  // (Mtot,) i32
  SP_PCUM,         // (4,) f32
  SP_LO,           // (3,) f32 box lower bounds
  SP_BOXL,         // (3,) f32 box lengths
  SP_H,            // (3, 3) f32
  SP_H2PI,         // (3, 3) f32
  SP_KW,           // (K,) f32 k_weights
  SP_COL_JX,       // (JxyP,) i32, -1 = pad
  SP_COL_JY,       // (JxyP,) i32 signed
  SP_FAR_COEF,     // (n_far_tiles, FAR_TILE4) float4 far table coefficients
  SP_FAR_ROWS,     // (n_groups * 32,) int4 jz, jx, y0 + ky2, length
  SP_FAR_UNITS,    // (n_far_tiles, FAR_WARPS) int4 row base, t0, nt, flags
  SP_RES_OFF,      // (B, Sres, 3) f32 reservoir site offsets
  SP_RES_COM,      // (B, Mres+1, 3) f32 reservoir COMs
  SP_RES_N,        // (B, R+1) i32 reservoir populations (the three are
                   // written only with a reservoir)
  SP_RES_SITE_BASE,  // (R,) i32
  SP_RES_MOL_BASE,   // (R,) i32
  SP_RES_CAP,        // (R,) i32
  SP_RES_H,          // (3, 3) f32 reservoir cell vectors
  SP_ACT_IDS,        // (n_active,) i32 active type ids
  SP_HINV,           // (3, 3) f32 inverse cell
  SP_IMG,            // (27, 3) f32 lattice image shifts
  SP_SHARED
};
enum StepInt {
  SI_B, SI_NSTEPS, SI_S, SI_S_FROZEN, SI_GUEST_BASE, SI_R, SI_MTOT,
  SI_A_ACT, SI_N_ACTIVE, SI_JZP, SI_JXYP, SI_KX, SI_KY, SI_KZ, SI_KX2,
  SI_KY2, SI_KZ2, SI_N_FAR_TILES, SI_GG_CUT, SI_HAS_RES, SI_SRES, SI_MRES1,
  SI_TRICLINIC, SI_SHARED
};
enum StepFloat {
  SF_ALPHA, SF_ALPHA2, SF_CUTOFF, SF_RCUT2, SF_GG_RCUT_SQ, SF_TEMP,
  SF_VOLUME, SF_FW_D0, SF_COULOMB_K, SF_TWO_PI, SF_PROB_CD, SF_SMALL_SQ,
  SF_COUNT
};

struct StepArgs {
  const float* u;
  float* pos; float* com; float* ampre; float* ampim;
  int* nmol; float* energy; int* counters; int* extras;
  const float* tstep; const float* rstep;
  const float* site_q; const int* site_type; const int* site_midx;
  const int* site_mol; const float* eps_site; const float* sig2_site;
  const int* type_A; const int* type_cap; const int* type_site_base;
  const int* type_mol_base; const float* type_activity;
  const float* type_self; const float* templ; const float* type_q;
  const int* type_cls; const int* mol_site_start;
  const float* p_cum; const float* lo; const float* boxl; const float* H;
  const float* h2pi; const float* kw; const int* col_jx; const int* col_jy;
  const float4* far_coef; const int4* far_rows; const int4* far_units;
  float* res_off; float* res_com; int* res_n;
  const int* res_site_base; const int* res_mol_base; const int* res_cap;
  const float* res_H;
  const int* act_ids; const float* Hinv; const float* img;
  int B, n_steps, S, S_frozen, guest_base, R, Mtot, A_act, n_active;
  int JzP, JxyP, kx, ky, kz, kx2, ky2, kz2, n_far_tiles, gg_cut;
  int has_res, Sres, Mres1;
  float alpha, alpha2, cutoff, rcut2, gg_rcut_sq, temp, volume, fw_d0;
  float coulomb_k, two_pi, prob_cd, small_sq;
};

// Fill the shared fields of a from the tables; false if a size is one the
// kernels do not take (the caller returns MANIAC_ERR_SHAPE).
inline bool unpack_step_args(StepArgs& a, void* const* p, const int* n,
                             const float* f) {
  a.u = static_cast<const float*>(p[SP_U]);
  a.pos = static_cast<float*>(p[SP_POS]);
  a.com = static_cast<float*>(p[SP_COM]);
  a.ampre = static_cast<float*>(p[SP_AMPRE]);
  a.ampim = static_cast<float*>(p[SP_AMPIM]);
  a.nmol = static_cast<int*>(p[SP_NMOL]);
  a.energy = static_cast<float*>(p[SP_ENERGY]);
  a.counters = static_cast<int*>(p[SP_COUNTERS]);
  a.extras = static_cast<int*>(p[SP_EXTRAS]);
  a.tstep = static_cast<const float*>(p[SP_TSTEP]);
  a.rstep = static_cast<const float*>(p[SP_RSTEP]);
  a.site_q = static_cast<const float*>(p[SP_SITE_Q]);
  a.site_type = static_cast<const int*>(p[SP_SITE_TYPE]);
  a.site_midx = static_cast<const int*>(p[SP_SITE_MIDX]);
  a.site_mol = static_cast<const int*>(p[SP_SITE_MOL]);
  a.eps_site = static_cast<const float*>(p[SP_EPS_SITE]);
  a.sig2_site = static_cast<const float*>(p[SP_SIG2_SITE]);
  a.type_A = static_cast<const int*>(p[SP_TYPE_A]);
  a.type_cap = static_cast<const int*>(p[SP_TYPE_CAP]);
  a.type_site_base = static_cast<const int*>(p[SP_TYPE_SITE_BASE]);
  a.type_mol_base = static_cast<const int*>(p[SP_TYPE_MOL_BASE]);
  a.type_activity = static_cast<const float*>(p[SP_TYPE_ACTIVITY]);
  a.type_self = static_cast<const float*>(p[SP_TYPE_SELF]);
  a.templ = static_cast<const float*>(p[SP_TEMPLATE]);
  a.type_q = static_cast<const float*>(p[SP_TYPE_Q]);
  a.type_cls = static_cast<const int*>(p[SP_TYPE_CLS]);
  a.mol_site_start = static_cast<const int*>(p[SP_MOL_SITE_START]);
  a.p_cum = static_cast<const float*>(p[SP_PCUM]);
  a.lo = static_cast<const float*>(p[SP_LO]);
  a.boxl = static_cast<const float*>(p[SP_BOXL]);
  a.H = static_cast<const float*>(p[SP_H]);
  a.h2pi = static_cast<const float*>(p[SP_H2PI]);
  a.kw = static_cast<const float*>(p[SP_KW]);
  a.col_jx = static_cast<const int*>(p[SP_COL_JX]);
  a.col_jy = static_cast<const int*>(p[SP_COL_JY]);
  a.far_coef = static_cast<const float4*>(p[SP_FAR_COEF]);
  a.far_rows = static_cast<const int4*>(p[SP_FAR_ROWS]);
  a.far_units = static_cast<const int4*>(p[SP_FAR_UNITS]);
  a.res_off = static_cast<float*>(p[SP_RES_OFF]);
  a.res_com = static_cast<float*>(p[SP_RES_COM]);
  a.res_n = static_cast<int*>(p[SP_RES_N]);
  a.res_site_base = static_cast<const int*>(p[SP_RES_SITE_BASE]);
  a.res_mol_base = static_cast<const int*>(p[SP_RES_MOL_BASE]);
  a.res_cap = static_cast<const int*>(p[SP_RES_CAP]);
  a.res_H = static_cast<const float*>(p[SP_RES_H]);
  a.act_ids = static_cast<const int*>(p[SP_ACT_IDS]);
  a.Hinv = static_cast<const float*>(p[SP_HINV]);
  a.img = static_cast<const float*>(p[SP_IMG]);
  a.B = n[SI_B];
  a.n_steps = n[SI_NSTEPS];
  a.S = n[SI_S];
  a.S_frozen = n[SI_S_FROZEN];
  a.guest_base = n[SI_GUEST_BASE];
  a.R = n[SI_R];
  a.Mtot = n[SI_MTOT];
  a.A_act = n[SI_A_ACT];
  a.n_active = n[SI_N_ACTIVE];
  a.JzP = n[SI_JZP];
  a.JxyP = n[SI_JXYP];
  a.kx = n[SI_KX];
  a.ky = n[SI_KY];
  a.kz = n[SI_KZ];
  a.kx2 = n[SI_KX2];
  a.ky2 = n[SI_KY2];
  a.kz2 = n[SI_KZ2];
  a.n_far_tiles = n[SI_N_FAR_TILES];
  a.gg_cut = n[SI_GG_CUT];
  a.has_res = n[SI_HAS_RES];
  a.Sres = n[SI_SRES];
  a.Mres1 = n[SI_MRES1];
  a.alpha = f[SF_ALPHA];
  a.alpha2 = f[SF_ALPHA2];
  a.cutoff = f[SF_CUTOFF];
  a.rcut2 = f[SF_RCUT2];
  a.gg_rcut_sq = f[SF_GG_RCUT_SQ];
  a.temp = f[SF_TEMP];
  a.volume = f[SF_VOLUME];
  a.fw_d0 = f[SF_FW_D0];
  a.coulomb_k = f[SF_COULOMB_K];
  a.two_pi = f[SF_TWO_PI];
  a.prob_cd = f[SF_PROB_CD];
  a.small_sq = f[SF_SMALL_SQ];
  const int kmax = std::max({a.kx, a.ky, a.kz, a.kx2, a.ky2, a.kz2});
  return !(a.B < 1 || a.A_act < 1 || a.A_act > MAXA || a.R + 1 > MAXR + 1
           || a.n_active < 1 || a.n_active > a.R || kmax >= JMAX
           || a.JzP < 2 * a.kz + 1 || a.n_far_tiles < 0
           || (n[SI_TRICLINIC] && (a.S_frozen != 0 || a.n_far_tiles != 0)));
}

// Everything thread 0 carries from the proposal to the decision.
struct Proposal {
  float P_new[MAXA][3];
  float last[MAXA][3];
  float off_old[MAXA][3];  // the old molecule's offsets (a reservoir push)
  float com_new[3], com_last[3];
  float res_pos[3];        // a push's COM in the reservoir box
  float u_acc, pref, i_old, i_new, s_old, s_new, sw[2];
  int move, valid, cap_blocked, gate, insert_like, remove_like, w_new;
  int t_old, t_new, A_old, A_new;
  int mol_slot_old, slot_new, site_start_old, site_start_new;
  int res_pick;
};

// A replica's shared state across the step (a static __shared__ variable
// in both kernels); the far field's y table and two staged tiles
// (FarSmem) are separate, present only with a far table.
struct StepSmem {
  Footprint fp;
  float2 tab[MAXF][3][JMAX];
  float scratch[STEP_WARPS * NRED];
  float red[NRED];
  int nmol[MAXR + 1];
  int res_n[MAXR + 1];
  float energy[6];
  int counters[10];
  int extras[4];
};

struct FarSmem {
  float4 ytab[FAR_YTAB];
  float4 tiles[2 * FAR_TILE4];
};

__device__ __forceinline__ int uint_draw(float u, int n) {
  // floor(u * n) clamped to n - 1 (moves.py::_uint), f32 product
  return min(static_cast<int>(u * static_cast<float>(n)), n - 1);
}

template <class Args, class Image>
__device__ float intra_energy(const Args& a, const Image& img,
                              float (*P)[3], const float* q, int A) {
  // sum_{i<j} q_i q_j (erfc(alpha r) - 1) / r, minimum image
  float e = 0.f;
  for (int i = 0; i < A; ++i) {
    for (int j = i + 1; j < A; ++j) {
      float r2 = img.r2(P[j][0] - P[i][0], P[j][1] - P[i][1],
                        P[j][2] - P[i][2]);
      r2 = fmaxf(r2, 1e-18f);
      if (!(r2 > a.small_sq)) continue;
      const float r = sqrtf(r2);
      e += q[j] * q[i] * (erfcf(a.alpha * r) - 1.f) / r;
    }
  }
  return e * a.coulomb_k;
}

inline __device__ void axis_rotation(int axis, float theta, float (*R)[3]) {
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

inline __device__ void uniform_rotation(const float* u, float two_pi,
                                        float (*R)[3]) {
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

// Thread 0: moves.py::_propose for replica b and uniform row `step` of the
// block's (B, n_steps, 21) uniforms (res_off and res_n are this replica's
// reservoir, unread without one). Every per-type quantity is taken per
// side: t_old is the type of the molecule a translation, rotation, deletion
// or swap takes out, t_new the type a creation or swap puts in (equal but
// for a swap).
template <bool TRICLINIC, bool MULTI, class Args>
__device__ void propose(const Args& a, const MinImage<TRICLINIC>& img,
                        int b, int step, const int* nmol, const float* pos,
                        const float* com, const float* res_off,
                        const int* res_n, float tstep, float rstep,
                        Proposal& pr, Footprint& fp) {
  float u[21];
  const float* ur = a.u + ((size_t)b * a.n_steps + step) * 21;
  for (int i = 0; i < 21; ++i) u[i] = ur[i];
  const int A_act = a.A_act, S = a.S, M1 = a.Mtot + 1;
  const float* act = a.type_activity + (size_t)b * a.act_stride;

  const bool is_trans = u[0] <= a.p_cum[0];
  const bool is_rot = !is_trans && u[0] <= a.p_cum[1];
  const bool is_indel = !is_trans && !is_rot && u[0] <= a.p_cum[2];
  // two or more active species: the swap move is live; with one, a swap
  // draw is dropped (dead draw)
  const bool is_swap = MULTI && !is_trans && !is_rot && !is_indel;
  const bool dead_draw = !MULTI && !is_trans && !is_rot && !is_indel;
  const bool is_create = is_indel && u[1] <= a.prob_cd;
  const bool is_delete = is_indel && !is_create;
  pr.move = is_create ? 0 : is_delete ? 1 : is_trans ? 2 : is_rot ? 3 : 4;
  const bool insert_like = is_create || is_swap;
  const bool remove_like = is_delete || is_swap;
  const bool w_old = is_trans || is_rot || is_delete || is_swap;
  const bool w_new = is_trans || is_rot || is_create || is_swap;

  int t_old = a.act_ids[0], t_new = t_old;
  if (MULTI) {
    const int nA = a.n_active;
    const int i1 = uint_draw(u[11], nA);
    const int di = 1 + uint_draw(u[12], nA - 1);
    const int i2 = (i1 + di) % nA;
    t_old = a.act_ids[i1];
    t_new = is_swap ? a.act_ids[i2] : t_old;
  }
  const int n_old = nmol[t_old], n_new = nmol[t_new];
  const int m_old = uint_draw(u[13], max(n_old, 1));
  const int A_old = a.type_A[t_old], A_new = a.type_A[t_new];
  const int cap_new = a.type_cap[t_new];
  // an empty reservoir blocks insertions (counted invalid, not blocked)
  const bool valid = (is_create ? true
                      : is_rot ? (n_old > 0 && A_old > 1) : n_old > 0)
                     && !dead_draw
                     && (!a.has_res || !insert_like || res_n[t_new] > 0);
  const bool cap_blocked = insert_like && n_new >= cap_new;

  const int mol_slot_old = a.type_mol_base[t_old] + m_old;
  const int site_start_old = a.type_site_base[t_old] + m_old * A_old;
  const int slot_new = insert_like
      ? a.type_mol_base[t_new] + min(n_new, cap_new - 1) : mol_slot_old;
  const int site_start_new = a.mol_site_start[slot_new];
  const int last_idx = max(n_old - 1, 0);
  const int start_last = a.type_site_base[t_old] + last_idx * A_old;
  const int slot_last = a.type_mol_base[t_old] + last_idx;

  // insertion geometry: a random reservoir molecule's offsets as they are
  // (its rotation is the identity), else the template, uniformly rotated
  pr.res_pick = a.has_res ? uint_draw(u[14], max(res_n[t_new], 1)) : 0;
  const float* src = a.has_res
      ? res_off + (size_t)(a.res_site_base[t_new] + pr.res_pick * A_new) * 3
      : a.templ + (size_t)t_new * A_act * 3;
  float P_old[MAXA][3], off_src[MAXA][3], com_old[3];
  for (int i = 0; i < 3; ++i) {
    com_old[i] = com[i * M1 + mol_slot_old];
    pr.com_last[i] = com[i * M1 + slot_last];
  }
  const float* tq_old = a.type_q + t_old * A_act;
  const float* tq_new = a.type_q + t_new * A_act;
  for (int k = 0; k < A_act; ++k) {
    for (int i = 0; i < 3; ++i) {
      P_old[k][i] = pos[i * S + site_start_old + k];
      pr.last[k][i] = pos[i * S + start_last + k];
      pr.off_old[k][i] = P_old[k][i] - com_old[i];
      off_src[k][i] = insert_like ? src[k * 3 + i] : pr.off_old[k][i];
    }
  }
  float Rm[3][3];
  const float theta = is_rot ? (u[9] - 0.5f) * rstep : 0.f;
  if (insert_like && !a.has_res) uniform_rotation(u + 15, a.two_pi, Rm);
  else axis_rotation(uint_draw(u[10], 3), theta, Rm);
  // a push's COM: res_H (u[18:21] - 0.5), centred, no lower bound added
  for (int i = 0; i < 3; ++i)
    pr.res_pos[i] = a.res_H[3 * i] * (u[18] - 0.5f)
                    + a.res_H[3 * i + 1] * (u[19] - 0.5f)
                    + a.res_H[3 * i + 2] * (u[20] - 0.5f);

  // a translation wraps into the box (physics/pbc.py::wrap_into_box): per
  // axis fmod plus L where negative; on a triclinic box the same mod 1 on
  // the fractional coordinates (pos - lo) Hinv^T, then lo + frac H^T
  float c_tr[3];
  if (TRICLINIC) {
    float d[3], frac[3];
    for (int i = 0; i < 3; ++i)
      d[i] = com_old[i] + (u[3 + i] - 0.5f) * tstep - a.lo[i];
    for (int i = 0; i < 3; ++i) {
      float r = fmodf(d[0] * a.Hinv[3 * i] + d[1] * a.Hinv[3 * i + 1]
                      + d[2] * a.Hinv[3 * i + 2], 1.f);
      if (r < 0.f) r += 1.f;
      frac[i] = r;
    }
    for (int i = 0; i < 3; ++i)
      c_tr[i] = a.lo[i] + (frac[0] * a.H[3 * i] + frac[1] * a.H[3 * i + 1]
                           + frac[2] * a.H[3 * i + 2]);
  } else {
    for (int i = 0; i < 3; ++i) {
      const float x = com_old[i] + (u[3 + i] - 0.5f) * tstep;
      float r = fmodf(x - a.lo[i], a.boxl[i]);
      if (r < 0.f) r += a.boxl[i];
      c_tr[i] = a.lo[i] + r;
    }
  }
  for (int i = 0; i < 3; ++i) {
    float c;
    if (is_trans) {
      c = c_tr[i];
    } else if (is_create) {
      c = a.lo[i] + (a.H[3 * i] * u[6] + a.H[3 * i + 1] * u[7]
                     + a.H[3 * i + 2] * u[8]);
    } else {  // rotation, deletion and swap keep the old COM
      c = com_old[i];
    }
    pr.com_new[i] = c;
  }
  for (int k = 0; k < A_act; ++k)
    for (int i = 0; i < 3; ++i)
      pr.P_new[k][i] = pr.com_new[i]
                       + (off_src[k][0] * Rm[i][0] + off_src[k][1] * Rm[i][1]
                          + off_src[k][2] * Rm[i][2]);

  pr.i_old = (remove_like && valid)
      ? intra_energy(a, img, P_old, tq_old, A_old) : 0.f;
  pr.i_new = insert_like ? intra_energy(a, img, pr.P_new, tq_new, A_new)
                         : 0.f;
  pr.s_old = remove_like ? a.type_self[t_old] : 0.f;
  pr.s_new = insert_like ? a.type_self[t_new] : 0.f;
  const float V = a.volume;
  float pref = insert_like
      ? act[t_new] * V / (static_cast<float>(n_new) + 1.f) : 1.f;
  pref = pref * (remove_like
                 ? static_cast<float>(n_old) / (act[t_old] * V)
                 : 1.f);

  pr.u_acc = u[2];
  pr.pref = pref;
  pr.valid = valid;
  pr.cap_blocked = cap_blocked;
  pr.gate = valid && !cap_blocked;
  pr.insert_like = insert_like;
  pr.remove_like = remove_like;
  pr.w_new = w_new;
  pr.t_old = t_old;
  pr.t_new = t_new;
  pr.A_old = A_old;
  pr.A_new = A_new;
  pr.mol_slot_old = mol_slot_old;
  pr.slot_new = slot_new;
  pr.site_start_old = site_start_old;
  pr.site_start_new = site_start_new;

  // publish the footprint: the old side with t_old's charges and classes,
  // the new side with t_new's
  pr.sw[0] = pr.sw[1] = 0.f;
  for (int side = 0; side < 2; ++side) {
    const bool w_side = side == 0 ? w_old : w_new;
    const int A_side = side == 0 ? A_old : A_new;
    const int t_side = side == 0 ? t_old : t_new;
    const float* tq = a.type_q + t_side * A_act;
    const int* tc = a.type_cls + t_side * A_act;
    for (int k = 0; k < A_act; ++k) {
      const int f = side * A_act + k;
      const bool m = k < A_side && w_side;
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
  fp.n_sites = footprint_sites(a, nmol);
  footprint_far_atoms(fp, A_act);
}

// Thread 0: moves.py::_update_reservoir after the decision. Pop on an
// accepted insertion or swap (t_new's last reservoir molecule fills the
// picked slot), push on an accepted removal or swap (the removed offsets
// and res_pos into slot res_n of t_old, or a drop counted in extras[1]
// when t_old's reservoir is full). Both read the reservoir as it was
// before the step; push rows are written first, then pop rows, so pop wins
// where both write (the JAX package's order).
template <class Args>
__device__ void commit_reservoir(const Args& a, const Proposal& pr, bool acc,
                                 float* res_off, float* res_com, int* res_n,
                                 int* extras) {
  const int t_old = pr.t_old, t_new = pr.t_new;
  const bool do_pop = acc && pr.insert_like;
  const bool full = res_n[t_old] >= a.res_cap[t_old];
  const bool do_push = acc && pr.remove_like && !full;
  const int last = max(res_n[t_new] - 1, 0);
  const int last_start = a.res_site_base[t_new] + last * pr.A_new;
  const int last_slot = a.res_mol_base[t_new] + last;
  float pop_rows[MAXA][3], pop_com[3];
  if (do_pop) {
    for (int k = 0; k < pr.A_new; ++k)
      for (int i = 0; i < 3; ++i)
        pop_rows[k][i] = res_off[(last_start + k) * 3 + i];
    for (int i = 0; i < 3; ++i) pop_com[i] = res_com[last_slot * 3 + i];
  }
  if (do_push) {
    const int push_idx = min(res_n[t_old], a.res_cap[t_old] - 1);
    const int push_start = a.res_site_base[t_old] + push_idx * pr.A_old;
    const int push_slot = a.res_mol_base[t_old] + push_idx;
    for (int k = 0; k < pr.A_old; ++k)
      for (int i = 0; i < 3; ++i)
        res_off[(push_start + k) * 3 + i] = pr.off_old[k][i];
    for (int i = 0; i < 3; ++i) res_com[push_slot * 3 + i] = pr.res_pos[i];
  }
  if (do_pop) {
    const int pop_start = a.res_site_base[t_new] + pr.res_pick * pr.A_new;
    const int pop_slot = a.res_mol_base[t_new] + pr.res_pick;
    for (int k = 0; k < pr.A_new; ++k)
      for (int i = 0; i < 3; ++i)
        res_off[(pop_start + k) * 3 + i] = pop_rows[k][i];
    for (int i = 0; i < 3; ++i) res_com[pop_slot * 3 + i] = pop_com[i];
  }
  res_n[t_new] -= do_pop ? 1 : 0;
  res_n[t_old] += do_push ? 1 : 0;
  extras[1] += acc && pr.remove_like && full;
}

// One MC step of replica b on uniform row `step`, by every thread of the
// CTA (it synchronizes the CTA). pos, com, ampre, ampim, res_off and
// res_com are the replica's state in device memory, updated in place;
// populations, reservoir counts, energies, counters and extras are ss's
// (the caller loads them before and stores them after); far is the far
// field's shared memory (read only with FAR). pr is thread 0's.
// Sections of the instrumented build (SECTION_MARK): 0 proposal, 1 phase
// tables, 2 pair pass, 3 k-space delta, 4 far field, 5 reduction, 6
// decision and commits, 7 amplitude commit.
template <bool TRICLINIC, bool MULTI, bool FAR, class Args>
__device__ __forceinline__ void mc_step(
    const Args& a, const MinImage<TRICLINIC>& img, int b, int step,
    StepSmem& ss, FarSmem* far, float* pos, float* com, float* ampre,
    float* ampim, float* res_off, float* res_com, float tstep, float rstep,
    Proposal& pr, int tid) {
  Footprint& fp = ss.fp;
  const int S = a.S, M1 = a.Mtot + 1, K = a.JzP * a.JxyP;
  const int F = 2 * a.A_act, Jz = 2 * a.kz + 1;
  int* nmol = ss.nmol;
  float* energy = ss.energy;
  int* counters = ss.counters;
  int* extras = ss.extras;

  if (tid == 0)
    propose<TRICLINIC, MULTI>(a, img, b, step, nmol, pos, com, res_off,
                              ss.res_n, tstep, rstep, pr, fp);
  __syncthreads();
  SECTION_MARK(0);

  footprint_phase_tables(a, fp, ss.tab, tid);
  __syncthreads();

  float part[NRED];
  if constexpr (FAR) far_ytab_fill(a, fp, ss.tab, far->ytab, tid);
  SECTION_MARK(1);
  footprint_partials(a, fp, ss.tab, nmol, pos, ampre, ampim, img, tid, part);
  SECTION_MARK(3);
  if constexpr (FAR) {
    if (fp.far_n > 0)
      far_sweep(a, (fp.far_n + FAR_PASS - 1) / FAR_PASS, far->tiles, fp,
                ss.tab, far->ytab, tid, part);
  }
  SECTION_MARK(4);
  block_sum<NRED>(part, tid, ss.scratch, ss.red);
  SECTION_MARK(5);

  if (tid == 0) {
    const float* red = ss.red;
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
    const float p_acc = p_accept(pr.pref, delta_e, a.temp);
    const bool acc = pr.gate && pr.u_acc <= p_acc;

    // compaction first (t_old's last molecule moves into the freed
    // slot), then the written molecule: new rows win where both apply
    if (acc && pr.remove_like) {
      for (int k = 0; k < pr.A_old; ++k)
        for (int i = 0; i < 3; ++i)
          pos[i * S + pr.site_start_old + k] = pr.last[k][i];
      for (int i = 0; i < 3; ++i)
        com[i * M1 + pr.mol_slot_old] = pr.com_last[i];
    }
    if (acc && pr.w_new) {
      for (int k = 0; k < pr.A_new; ++k)
        for (int i = 0; i < 3; ++i)
          pos[i * S + pr.site_start_new + k] = pr.P_new[k][i];
      for (int i = 0; i < 3; ++i)
        com[i * M1 + pr.slot_new] = pr.com_new[i];
    }
    if (a.has_res) commit_reservoir(a, pr, acc, res_off, res_com, ss.res_n,
                                    extras);
    nmol[pr.t_new] += acc && pr.insert_like;
    nmol[pr.t_old] -= acc && pr.remove_like;
    // the deltas of an accepted move only (a select, not a 0/1 product:
    // a rejected overlap's LJ is inf - inf = NaN, and 0 x NaN = NaN)
    if (acc) {
      energy[0] += e_recip_new - e_recip_old;
      energy[1] += e_lj1 - e_lj0;
      energy[2] += e_coul1 - e_coul0;
      energy[3] += pr.s_new - pr.s_old;
      energy[4] += pr.i_new - pr.i_old;
      energy[5] += delta_e;
    }
    counters[pr.move] += pr.valid;
    counters[5 + pr.move] += acc;
    extras[0] += pr.valid && pr.cap_blocked;
    fp.acc = acc;
  }
  __syncthreads();
  SECTION_MARK(6);

  if (fp.acc) {  // amp += d on every grid mode (recomputed, not stored)
    for (int m = tid; m < K; m += STEP_THREADS) {
      const int row = m / a.JxyP, col = m - row * a.JxyP;
      const int jx = a.col_jx[col];
      if (row >= Jz || jx < 0) continue;  // d = 0 on pad modes
      const float2 d = footprint_mode(ss.tab, fp.wk, 0, F, jx, a.col_jy[col],
                                      row - a.kz);
      ampre[m] += d.x;
      ampim[m] += d.y;
    }
  }
  __syncthreads();
  SECTION_MARK(7);
}

// Load a replica's per-step counts (populations, reservoir counts,
// energies, counters, extras) from device memory into ss, and store them
// back: the state that mc_step keeps in shared memory. Every thread calls
// them; the caller synchronizes between a load and the first mc_step.
template <class Args>
__device__ __forceinline__ void load_counts(const Args& a, int b, int tid,
                                            const int* nmol,
                                            const int* res_n,
                                            const float* energy,
                                            const int* counters,
                                            const int* extras, StepSmem& ss) {
  if (tid <= a.R) ss.nmol[tid] = nmol[b * (a.R + 1) + tid];
  if (a.has_res && tid <= a.R) ss.res_n[tid] = res_n[b * (a.R + 1) + tid];
  if (tid < 6) ss.energy[tid] = energy[6 * b + tid];
  if (tid < 10) ss.counters[tid] = counters[10 * b + tid];
  if (tid < 4) ss.extras[tid] = extras[4 * b + tid];
}

template <class Args>
__device__ __forceinline__ void store_counts(const Args& a, int b, int tid,
                                             const StepSmem& ss, int* nmol,
                                             int* res_n, float* energy,
                                             int* counters, int* extras) {
  if (tid <= a.R) nmol[b * (a.R + 1) + tid] = ss.nmol[tid];
  if (a.has_res && tid <= a.R) res_n[b * (a.R + 1) + tid] = ss.res_n[tid];
  if (tid < 6) energy[6 * b + tid] = ss.energy[tid];
  if (tid < 10) counters[10 * b + tid] = ss.counters[tid];
  if (tid < 4) extras[4 * b + tid] = ss.extras[tid];
}
