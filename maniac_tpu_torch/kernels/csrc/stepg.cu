// The energy core of one MC step for B replicas, given the proposals.
//
// Replaces maniac_tpu/kernels/stepg.py::_stepg_kernel (launcher
// mc_step_core_grouped), and on a triclinic box the XLA energy core the JAX
// package runs there (its stepg takes orthorhombic boxes only). The
// proposal (mc/moves.py::_propose) and the bookkeeping (_bookkeep) stay in
// torch; this kernel is mc/moves.py::_core_plain: the footprint's pair
// energies against every live site, the far-field grid term (framework
// split), the k-space delta, the Metropolis test, and the commits of
// positions (compaction first, then the written molecule) and amplitudes.
//
// Design: one CTA per replica, one launch per step. Thread 0 publishes the
// old and new footprints (<= 2 x 8 atoms, any active species: each atom
// carries its own charge and LJ class row, so a swap is an old and a new
// footprint of different types) in shared memory; all threads build the
// footprint phase-power tables and sweep the sites and the k-space modes
// with per-thread partial sums, contract the far table (the separable far
// field, common.cuh far_sweep) and make one block
// reduction (common.cuh, the same code as the whole-block kernel); thread 0
// decides. Outputs are written out of place: every thread copies the
// replica's positions and adds the recomputed delta to each amplitude on
// acceptance. Without the framework split S_frozen = guest_base = 0, so
// every live site takes erfc(alpha r)/r (cut at gg_rcut when gg_cut) and
// the far table is empty (FAR false: the far sweep is not compiled in).
// The kernel is a template on TRICLINIC, the box
// kind of the shared core's minimum image (common.cuh MinImage): on a
// triclinic box, which never has the split, every pair takes the minimum
// over the 27 image shifts, staged in shared memory once per CTA.
#include <algorithm>

#include "common.cuh"

namespace {

enum StepPtr {
  SP_POS_IN,       // (B, 3, S) f32
  SP_AMPRE_IN,     // (B, K) f32
  SP_AMPIM_IN,
  SP_NMOL,         // (B, R+1) i32
  SP_P,            // (B, 2, A_act, 3) f32 old | new footprint positions
  SP_Q,            // (B, 2, A_act) f32 charges
  SP_CLS,          // (B, 2, A_act) i32 LJ class rows
  SP_M,            // (B, 2, A_act) i32 atom present and its side moves
  SP_LAST,         // (B, 3, A_act) f32 the type's last molecule (compaction)
  SP_ISCAL,        // (B, IS_COUNT) i32
  SP_FSCAL,        // (B, FS_COUNT) f32
  SP_POS,          // outputs: (B, 3, S), (B, K) x 2, (B, 8) flags
  SP_AMPRE,
  SP_AMPIM,
  SP_FLAGS,
  SP_SITE_Q,       // (S,) f32
  SP_SITE_TYPE,    // (S,) i32
  SP_SITE_MIDX,    // (S,) i32
  SP_SITE_MOL,     // (S,) i32
  SP_EPS_SITE,     // (C+1, S) f32
  SP_SIG2_SITE,    // (C+1, S) f32
  SP_TYPE_A,       // (R,) i32
  SP_TYPE_SITE_BASE,  // (R,) i32
  SP_BOXL,         // (3,) f32 box lengths
  SP_H2PI,         // (3, 3) f32
  SP_KW,           // (K,) f32 k_weights
  SP_COL_JX,       // (JxyP,) i32, -1 = pad
  SP_COL_JY,       // (JxyP,) i32 signed
  SP_FAR_COEF,     // (n_far_tiles, FAR_TILE4) float4 far table coefficients
  SP_FAR_ROWS,     // (n_groups * 32,) int4 jz, jx, y0 + ky2, length
  SP_FAR_UNITS,    // (n_far_tiles, FAR_WARPS) int4 row base, t0, nt, flags
  SP_IMG,          // (27, 3) f32 lattice image shifts
  SP_COUNT
};
// per-replica ints and floats of the proposal
enum StepIScal {
  IS_EX_A, IS_EX_B, IS_START_OLD, IS_START_NEW, IS_A_OLD, IS_A_NEW,
  IS_REMOVE, IS_W_NEW, IS_GATE, IS_COUNT
};
enum StepFScal {
  FS_S_OLD, FS_I_OLD, FS_S_NEW, FS_I_NEW, FS_E_RECIP_OLD, FS_PREF, FS_U_ACC,
  FS_COUNT
};
// flags: acc, e_recip_new, delta_e, e_lj0, e_lj1, e_coul0, e_coul1, p_acc
constexpr int NFLAG = 8;
enum StepInt {
  SI_B, SI_S, SI_S_FROZEN, SI_GUEST_BASE, SI_R, SI_A_ACT, SI_JZP, SI_JXYP,
  SI_KX, SI_KY, SI_KZ, SI_KX2, SI_KY2, SI_KZ2, SI_N_FAR_TILES, SI_GG_CUT,
  SI_TRICLINIC, SI_COUNT
};
enum StepFloat {
  SF_ALPHA, SF_ALPHA2, SF_CUTOFF, SF_RCUT2, SF_GG_RCUT_SQ, SF_TEMP,
  SF_VOLUME, SF_FW_D0, SF_COULOMB_K, SF_TWO_PI, SF_COUNT
};

struct Args {
  const float* pos_in; const float* ampre_in; const float* ampim_in;
  const int* nmol_in; const float* P; const float* q; const int* cls;
  const int* m; const float* last; const int* iscal; const float* fscal;
  float* pos; float* ampre; float* ampim; float* flags;
  const float* site_q; const int* site_type; const int* site_midx;
  const int* site_mol; const float* eps_site; const float* sig2_site;
  const int* type_A; const int* type_site_base;
  const float* boxl; const float* h2pi; const float* kw;
  const int* col_jx; const int* col_jy;
  const float4* far_coef; const int4* far_rows; const int4* far_units;
  const float* img;
  int B, S, S_frozen, guest_base, R, A_act, JzP, JxyP, kx, ky, kz;
  int kx2, ky2, kz2, n_far_tiles, gg_cut;
  float alpha, alpha2, cutoff, rcut2, gg_rcut_sq, temp, volume, fw_d0;
  float coulomb_k, two_pi;
};

// FAR: the spec has a far table (only then is the far sweep compiled in).
template <bool TRICLINIC, bool FAR>
__global__ void __launch_bounds__(STEP_THREADS) stepg_kernel(Args a) {
  __shared__ Footprint fp;
  __shared__ float2 tab[MAXF][3][JMAX];
  __shared__ float scratch[STEP_WARPS * NRED];
  __shared__ float4 ytab[FAR ? FAR_YTAB : 1];
  __shared__ float4 tiles[FAR ? 2 * FAR_TILE4 : 1];
  __shared__ float red[NRED];
  __shared__ int nmol[MAXR + 1];
  __shared__ float sw[2];
  __shared__ float shifts[TRICLINIC ? 3 * NIMG : 1];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int S = a.S, K = a.JzP * a.JxyP, A_act = a.A_act, F = 2 * A_act;
  const int Jz = 2 * a.kz + 1;
  const int* is = a.iscal + (size_t)b * IS_COUNT;
  const float* fs = a.fscal + (size_t)b * FS_COUNT;
  const float* pos_in = a.pos_in + (size_t)b * 3 * S;
  const float* ampre_in = a.ampre_in + (size_t)b * K;
  const float* ampim_in = a.ampim_in + (size_t)b * K;
  float* pos = a.pos + (size_t)b * 3 * S;
  const float L[3] = {a.boxl[0], a.boxl[1], a.boxl[2]};
  const MinImage<TRICLINIC> img{TRICLINIC ? shifts : L};

  if (tid <= a.R) nmol[tid] = a.nmol_in[b * (a.R + 1) + tid];
  stage_image_shifts<TRICLINIC>(a.img, shifts);
  __syncthreads();
  if (tid == 0) {  // publish the footprint
    const float* P = a.P + (size_t)b * F * 3;
    sw[0] = sw[1] = 0.f;
    for (int f = 0; f < F; ++f) {
      const int side = f / A_act;
      const bool m = a.m[(size_t)b * F + f] != 0;
      const float q = a.q[(size_t)b * F + f];
      for (int i = 0; i < 3; ++i) fp.p[f][i] = P[f * 3 + i];
      fp.q[f] = q;
      fp.cls[f] = a.cls[(size_t)b * F + f];
      fp.m[f] = m;
      const float qm = q * (m ? 1.f : 0.f);
      fp.wf[f] = qm;
      fp.wk[f] = side == 0 ? -qm : qm;
      sw[side] += qm;
    }
    fp.ex_a = is[IS_EX_A];
    fp.ex_b = is[IS_EX_B];
    fp.n_sites = footprint_sites(a, nmol);
    footprint_far_atoms(fp, A_act);
  }
  for (int i = tid; i < 3 * S; i += STEP_THREADS) pos[i] = pos_in[i];
  __syncthreads();

  footprint_phase_tables(a, fp, tab, tid);
  __syncthreads();

  float part[NRED];
  if constexpr (FAR) far_ytab_fill(a, fp, tab, ytab, tid);
  footprint_partials(a, fp, tab, nmol, pos_in, ampre_in, ampim_in, img, tid,
                     part);
  if constexpr (FAR) {
    if (fp.far_n > 0)
      far_sweep(a, (fp.far_n + FAR_PASS - 1) / FAR_PASS, tiles, fp, tab, ytab,
                tid, part);
  }
  block_sum<NRED>(part, tid, scratch, red);

  if (tid == 0) {
    const float e_lj0 = red[0], e_lj1 = red[1];
    const float e_coul0 = red[2] * a.coulomb_k + (red[4] + a.fw_d0 * sw[0]);
    const float e_coul1 = red[3] * a.coulomb_k + (red[5] + a.fw_d0 * sw[1]);
    const float e_recip_old = fs[FS_E_RECIP_OLD];
    const float e_recip_new = e_recip_old
                              + red[6] * a.coulomb_k * a.two_pi / a.volume;
    const float e_other_old = e_lj0 + e_coul0 + fs[FS_S_OLD] + fs[FS_I_OLD];
    const float e_other_new = e_lj1 + e_coul1 + fs[FS_S_NEW] + fs[FS_I_NEW];
    const float delta_e = (e_other_new + e_recip_new)
                          - (e_other_old + e_recip_old);
    const float p_acc = p_accept(fs[FS_PREF], delta_e, a.temp);
    const bool acc = is[IS_GATE] && fs[FS_U_ACC] <= p_acc;

    // compaction first (the type's last molecule moves into the freed
    // slot), then the written molecule: new rows win where both apply
    if (acc && is[IS_REMOVE]) {
      const float* last = a.last + (size_t)b * 3 * A_act;
      for (int k = 0; k < is[IS_A_OLD]; ++k)
        for (int i = 0; i < 3; ++i)
          pos[i * S + is[IS_START_OLD] + k] = last[i * A_act + k];
    }
    if (acc && is[IS_W_NEW]) {
      for (int k = 0; k < is[IS_A_NEW]; ++k)
        for (int i = 0; i < 3; ++i)
          pos[i * S + is[IS_START_NEW] + k] = fp.p[A_act + k][i];
    }
    float* fl = a.flags + (size_t)b * NFLAG;
    fl[0] = acc ? 1.f : 0.f;
    fl[1] = e_recip_new;
    fl[2] = delta_e;
    fl[3] = e_lj0;
    fl[4] = e_lj1;
    fl[5] = e_coul0;
    fl[6] = e_coul1;
    fl[7] = p_acc;
    fp.acc = acc;
  }
  __syncthreads();

  // amplitudes: A + d on every grid mode when accepted (d recomputed, not
  // stored), a copy otherwise
  float* ampre = a.ampre + (size_t)b * K;
  float* ampim = a.ampim + (size_t)b * K;
  const bool acc = fp.acc;
  for (int m = tid; m < K; m += STEP_THREADS) {
    float re = ampre_in[m], im = ampim_in[m];
    const int row = m / a.JxyP, col = m - row * a.JxyP;
    const int jx = a.col_jx[col];
    if (acc && row < Jz && jx >= 0) {  // d = 0 on pad modes
      const float2 d = footprint_mode(tab, fp.wk, 0, F, jx, a.col_jy[col],
                                      row - a.kz);
      re += d.x;
      im += d.y;
    }
    ampre[m] = re;
    ampim[m] = im;
  }
}

}  // namespace

extern "C" int stepg_launch(void* const* ptrs, int nptr, const int* ints,
                            int nint, const float* fl, int nfloat,
                            void* stream) {
  if (nptr != SP_COUNT || nint != SI_COUNT || nfloat != SF_COUNT)
    return MANIAC_ERR_TABLES;
  Args a;
  a.pos_in = static_cast<const float*>(ptrs[SP_POS_IN]);
  a.ampre_in = static_cast<const float*>(ptrs[SP_AMPRE_IN]);
  a.ampim_in = static_cast<const float*>(ptrs[SP_AMPIM_IN]);
  a.nmol_in = static_cast<const int*>(ptrs[SP_NMOL]);
  a.P = static_cast<const float*>(ptrs[SP_P]);
  a.q = static_cast<const float*>(ptrs[SP_Q]);
  a.cls = static_cast<const int*>(ptrs[SP_CLS]);
  a.m = static_cast<const int*>(ptrs[SP_M]);
  a.last = static_cast<const float*>(ptrs[SP_LAST]);
  a.iscal = static_cast<const int*>(ptrs[SP_ISCAL]);
  a.fscal = static_cast<const float*>(ptrs[SP_FSCAL]);
  a.pos = static_cast<float*>(ptrs[SP_POS]);
  a.ampre = static_cast<float*>(ptrs[SP_AMPRE]);
  a.ampim = static_cast<float*>(ptrs[SP_AMPIM]);
  a.flags = static_cast<float*>(ptrs[SP_FLAGS]);
  a.site_q = static_cast<const float*>(ptrs[SP_SITE_Q]);
  a.site_type = static_cast<const int*>(ptrs[SP_SITE_TYPE]);
  a.site_midx = static_cast<const int*>(ptrs[SP_SITE_MIDX]);
  a.site_mol = static_cast<const int*>(ptrs[SP_SITE_MOL]);
  a.eps_site = static_cast<const float*>(ptrs[SP_EPS_SITE]);
  a.sig2_site = static_cast<const float*>(ptrs[SP_SIG2_SITE]);
  a.type_A = static_cast<const int*>(ptrs[SP_TYPE_A]);
  a.type_site_base = static_cast<const int*>(ptrs[SP_TYPE_SITE_BASE]);
  a.boxl = static_cast<const float*>(ptrs[SP_BOXL]);
  a.h2pi = static_cast<const float*>(ptrs[SP_H2PI]);
  a.kw = static_cast<const float*>(ptrs[SP_KW]);
  a.col_jx = static_cast<const int*>(ptrs[SP_COL_JX]);
  a.col_jy = static_cast<const int*>(ptrs[SP_COL_JY]);
  a.far_coef = static_cast<const float4*>(ptrs[SP_FAR_COEF]);
  a.far_rows = static_cast<const int4*>(ptrs[SP_FAR_ROWS]);
  a.far_units = static_cast<const int4*>(ptrs[SP_FAR_UNITS]);
  a.img = static_cast<const float*>(ptrs[SP_IMG]);
  a.B = ints[SI_B];
  a.S = ints[SI_S];
  a.S_frozen = ints[SI_S_FROZEN];
  a.guest_base = ints[SI_GUEST_BASE];
  a.R = ints[SI_R];
  a.A_act = ints[SI_A_ACT];
  a.JzP = ints[SI_JZP];
  a.JxyP = ints[SI_JXYP];
  a.kx = ints[SI_KX];
  a.ky = ints[SI_KY];
  a.kz = ints[SI_KZ];
  a.kx2 = ints[SI_KX2];
  a.ky2 = ints[SI_KY2];
  a.kz2 = ints[SI_KZ2];
  a.n_far_tiles = ints[SI_N_FAR_TILES];
  a.gg_cut = ints[SI_GG_CUT];
  a.alpha = fl[SF_ALPHA];
  a.alpha2 = fl[SF_ALPHA2];
  a.cutoff = fl[SF_CUTOFF];
  a.rcut2 = fl[SF_RCUT2];
  a.gg_rcut_sq = fl[SF_GG_RCUT_SQ];
  a.temp = fl[SF_TEMP];
  a.volume = fl[SF_VOLUME];
  a.fw_d0 = fl[SF_FW_D0];
  a.coulomb_k = fl[SF_COULOMB_K];
  a.two_pi = fl[SF_TWO_PI];
  const int kmax = std::max({a.kx, a.ky, a.kz, a.kx2, a.ky2, a.kz2});
  const bool tricl = ints[SI_TRICLINIC] != 0;
  if (a.B < 1 || a.A_act < 1 || a.A_act > MAXA || a.R + 1 > MAXR + 1
      || kmax >= JMAX || a.JzP < 2 * a.kz + 1 || a.n_far_tiles < 0
      || (tricl && (a.S_frozen != 0 || a.n_far_tiles != 0)))
    return MANIAC_ERR_SHAPE;
  void (*kernel)(Args) = tricl ? stepg_kernel<true, false>
                         : a.n_far_tiles > 0 ? stepg_kernel<false, true>
                                             : stepg_kernel<false, false>;
  kernel<<<a.B, STEP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
