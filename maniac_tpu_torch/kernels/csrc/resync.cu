// Amplitude resynthesis for B replicas: the per-block f32 drift bound
// (DIVERGENCES.md #13).
//
// Replaces maniac_tpu/kernels/resync.py::_resyncg_kernel (launcher
// resync_pallas_grouped) and, at B = 1, _resync_kernel (resync_pallas).
// For each replica b it rebuilds the structure factor
//   A(k) = fw_amp(k) + sum_{live guest sites s} q_s e^{i k.r_s}
// on the dense (JzP, JxyP) grid (pad modes, row >= Jz or col_jx < 0, hold
// fw_amp), then E_RECIP = C 2pi/V sum_k w_k |A(k)|^2. The terms a
// population fixes are set too: E_SELF and E_INTRA from the populations
// (a molecule's constants of its type), and a replica without guests
// takes the frozen sites' own LJ and real-space Coulomb (fw_pair); E_TOT
// is the sum of the five. Only the guests' pair terms stay running
// (mc/driver.py::resync_amplitudes_body, the same operations).
//
// Bound on the H100: f32 operations on the water boxes (resv, tricl: some
// 430 charged sites a replica at 2601 real modes), bytes on the framework
// systems (the amplitudes written once). The synthesis is a batched
// complex contraction, as the JAX kernel's MXU product:
//   A_b[z, col] = fw[z, col] + sum_s Pz_b[s, z] T_b[s, col],
//   T_b[s, col] = q_s Px_b[s, jx(col)] Py_b[s, jy(col)],
// so T costs one complex product per (site, column) and the contraction
// one complex multiply-add (4 FMA) per (site, mode).
// Design:
// * Grid (row tiles x column tiles, B): blockIdx.y is the replica, and
//   each CTA owns TZ * zgroups rows by COLS columns of its grid (every row
//   unless the host splits them: a small batch is spread over the card).
//   Thread (zg, cg) of the first 16 * zgroups holds a TZ x TC complex
//   tile in registers for the whole kernel: rows zg * TZ + i, columns
//   cg + 16 j. A CTA has at least 128 threads (a multiple of COLS); those
//   past the tile only help build the tables, which at B = 1 (one CTA
//   per row group and column tile) cut K4's time by 3-5x.
// * Charged live sites only: the sites of replica b are enumerated from
//   the spec's charge table (n_mol[b, type] molecules times the type's
//   charged atoms, region by region, the regions' rows in shared memory);
//   an uncharged site adds exact zeros, so skipping it changes no bit.
//   They go in chunks of CH, each chunk's positions and charges loaded
//   while the previous chunk is contracted. Per chunk: the per-axis phase
//   powers (one sincosf per site and axis, powers by repeated complex
//   multiply as common.cuh phase_powers), x times q and y into shared
//   memory, z straight into the CTA's Pz rows; then the T columns, each
//   thread one column for every (threads / COLS)-th site; then every
//   owner thread runs over the chunk's sites with TZ + TC shared loads
//   (broadcast within a half-warp for Pz, 128 consecutive bytes for T)
//   per 4 TZ TC FMAs.
// * One store of the amplitudes: fw + acc at the tile's real modes, fw at
//   its pad modes. Each CTA writes its tile's sum w |A|^2 to a (B, tiles)
//   scratch, and a second kernel on the same stream sums each replica's
//   partials in a fixed order: no atomics, the same bits on every call.
// Each CTA recomputes its replica's phase powers (3 sincosf and some 30
// complex products a site, against >= 17 x 64 x 4 FMAs a site of its
// contraction); staging them in device memory would move ~127 MB a call
// on resv. What still holds it back (tools/resync_times --split, PERF.md):
// the phase powers and the T build are short dependent chains between
// barriers, a third to a half of a CTA's time on the water boxes.
#include "common.cuh"

namespace {

enum ResyncPtr {
  RP_POS,        // (B, 3, S) f32
  RP_NMOL,       // (B, R+1) i32
  RP_ENERGY_IN,  // (B, 6) f32
  RP_SITE_Q,     // (S,) f32
  RP_H2PI,       // (3, 3) f32: theta = two_pi_Hinv @ r
  RP_KW,         // (JzP * JxyP,) f32 k_weights
  RP_FW_RE,      // (JzP * JxyP,) f32 constant framework amplitude
  RP_FW_IM,
  RP_COL_JX,     // (JxyP,) i32 jx of each column, -1 = pad
  RP_COL_JY,     // (JxyP,) i32 signed jy of each column
  RP_Q_REGIONS,  // (nreg, 5) i32 per covered type: site base, atoms per
                 // molecule, charged atoms per molecule, first entry of
                 // RP_Q_OFFSETS, type
  RP_Q_OFFSETS,  // (n,) i32 charged atoms' offsets within a molecule
  RP_SELF,       // (R,) f32 self energy of a molecule of each type
  RP_INTRA,      // (R,) f32 intramolecular energy of a molecule of each
                 // type (0 for a frozen type)
  RP_ACTIVE,     // (R,) bool type_active
  RP_FW_PAIR,    // (2,) f32 the frozen sites' own LJ, real-space Coulomb
  RP_AMP_RE,     // out (B, JzP * JxyP) f32
  RP_AMP_IM,
  RP_ENERGY_OUT, // out (B, 6) f32
  RP_PARTIAL,    // scratch (B, row tiles * column tiles) f32
  RP_COUNT
};
enum ResyncInt { RI_B, RI_S, RI_R1, RI_JZP, RI_JXYP, RI_KX, RI_KY, RI_KZ,
                 RI_NREG, RI_ZGROUPS, RI_ROW_TILES, RI_COL_TILES, RI_THREADS,
                 RI_COUNT };
enum ResyncFloat { RF_ESCALE_C, RF_ESCALE_2PI, RF_VOLUME, RF_COUNT };

struct ResyncArgs {
  const float* pos;
  const int* n_mol;
  const float* energy_in;
  const float* site_q;
  const float* h2pi;
  const float* kw;
  const float* fw_re;
  const float* fw_im;
  const int* col_jx;
  const int* col_jy;
  const int* regions;
  const int* offsets;
  const float* self_e;
  const float* intra_e;
  const bool* active;
  const float* fw_pair;
  float* amp_re;
  float* amp_im;
  float* energy_out;
  float* partial;
  int B, S, R1, JzP, JxyP, kx, ky, kz, nreg, zgroups, row_tiles, col_tiles,
      threads;
  float coulomb_k, two_pi, volume;
};

constexpr int CH = 32;           // charged sites a chunk
constexpr int COL_GROUPS = 16;   // threads along the columns
constexpr int TC = 4;            // columns a thread
// rows a thread: 4 took 16-25% longer on all four bench systems, the
// frameworks' Jz = 23 included, where both pad to 24 rows (PERF.md)
constexpr int TZ = 3;
constexpr int COLS = COL_GROUPS * TC;
constexpr int MAX_ZGROUPS = 16;  // row groups a CTA
constexpr int MAX_THREADS = COL_GROUPS * MAX_ZGROUPS;
constexpr int UNROLL = 8;        // sites a step of the contraction
constexpr int TBUILD = 4;        // sites a step of a thread's T build

// Where a CTA's time goes (the -DMANIAC_SECTION_CLOCKS build only, read by
// tools/resync_times --split): RS_MARK(k) synchronizes the CTA and adds the
// clock64 ticks since its previous mark to section k, summed over all CTAs
// (k < 0 only restarts the clock). The production build compiles it to
// nothing.
enum ResyncSection { RS_SETUP, RS_SITES, RS_PHASES, RS_TABLES, RS_CONTRACT,
                     RS_EPILOGUE, RS_SECTIONS };
#ifdef MANIAC_SECTION_CLOCKS
static __device__ unsigned long long resync_ticks[RS_SECTIONS];
#define RS_MARK(k)                                                      \
  do {                                                                  \
    __syncthreads();                                                    \
    if (threadIdx.x == 0) {                                             \
      const long long now = clock64();                                  \
      if ((k) >= 0)                                                     \
        atomicAdd(&resync_ticks[(k) < 0 ? 0 : (k)],                     \
                  (unsigned long long)(now - rs_last));                 \
      rs_last = now;                                                    \
    }                                                                   \
  } while (0)
#define RS_CLOCK long long rs_last = 0
#else
#define RS_MARK(k) \
  do {             \
  } while (0)
#define RS_CLOCK
#endif

// Phase powers as common.cuh phase_powers, each stored times q (the x
// axis: the site's charge folded in).
__device__ __forceinline__ void phase_powers_q(float theta, int k, float q,
                                               float2* out) {
  float s, c;
  sincosf(theta, &s, &c);
  float re = 1.f, im = 0.f;
  out[0] = make_float2(q, 0.f * q);
  for (int j = 1; j <= k; ++j) {
    const float nr = re * c - im * s;
    const float ni = re * s + im * c;
    re = nr;
    im = ni;
    out[j] = make_float2(re * q, im * q);
  }
}

// The z powers of one site straight into its Pz row: e^{i jz theta} at
// row kz + jz, for the rows z0 .. z0 + rows - 1 of the CTA (the same
// sincosf and repeated multiply as phase_powers; negative jz conjugate).
__device__ __forceinline__ void z_powers_row(float theta, int kz, int z0,
                                             int rows, float2* row) {
  float s, c;
  sincosf(theta, &s, &c);
  float re = 1.f, im = 0.f;
  if (kz - z0 >= 0 && kz - z0 < rows) row[kz - z0] = make_float2(1.f, 0.f);
  for (int j = 1; j <= kz; ++j) {
    const float nr = re * c - im * s;
    const float ni = re * s + im * c;
    re = nr;
    im = ni;
    const int up = kz + j - z0, down = kz - j - z0;
    if (up >= 0 && up < rows) row[up] = make_float2(re, im);
    if (down >= 0 && down < rows) row[down] = make_float2(re, -im);
  }
}

// Dynamic shared memory of one CTA: the chunk's x and y phase powers, its
// Pz rows and T columns, and the covered regions' rows.
__host__ __device__ inline size_t resync_smem(int kx, int ky, int rows,
                                              int nreg) {
  return sizeof(float2) * CH * (kx + ky + 2 + rows + COLS)
         + sizeof(int) * 5 * nreg;
}

__global__ void __launch_bounds__(MAX_THREADS) resync_kernel(ResyncArgs a) {
  extern __shared__ float2 smem[];
  __shared__ int2 colj[COLS];     // (jx, signed jy) of the tile's columns
  __shared__ float4 site_s[CH];   // the chunk's sites: x, y, z, q
  __shared__ float red[MAX_THREADS / 32];
  RS_CLOCK;
  RS_MARK(-1);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int ct = blockIdx.x % a.col_tiles, rt = blockIdx.x / a.col_tiles;
  const int b = blockIdx.y;
  const int rows = TZ * a.zgroups;
  const int z0 = rt * rows, c0 = ct * COLS;
  const int Jz = 2 * a.kz + 1;
  const int nx = a.kx + 1, pxy = nx + a.ky + 1;
  float2* tab = smem;               // [CH][pxy] x powers times q, y powers
  float2* pz_s = tab + CH * pxy;    // [CH][rows]
  float2* t_s = pz_s + CH * rows;   // [CH][COLS]
  // per covered region: site base, atoms per molecule, charged atoms per
  // molecule, first offset, charged live sites of this replica
  int* reg_s = reinterpret_cast<int*>(t_s + CH * COLS);
  const float* pos = a.pos + (size_t)b * 3 * a.S;

  int mine = 0;
  for (int c = tid; c < COLS; c += nthreads) {
    const int col = c0 + c;
    const int jx = col < a.JxyP ? __ldg(a.col_jx + col) : -1;
    colj[c] = make_int2(jx, jx >= 0 ? __ldg(a.col_jy + col) : 0);
    mine |= jx >= 0;
  }
  for (int r = tid; r < a.nreg; r += nthreads) {
    const int* reg = a.regions + 5 * r;
    for (int k = 0; k < 4; ++k) reg_s[5 * r + k] = __ldg(reg + k);
    reg_s[5 * r + 4] = __ldg(a.n_mol + b * a.R1 + __ldg(reg + 4))
                       * __ldg(reg + 2);
  }
  // the CTA's pad rows (z >= Jz) of Pz stay zero
  for (int t = tid; t < CH * rows; t += nthreads)
    if (z0 + t % rows >= Jz) pz_s[t] = make_float2(0.f, 0.f);
  // a tile with no real mode only writes fw_amp
  const bool live = __syncthreads_or(mine) && z0 < Jz;
  int n_sites = 0;
  for (int r = 0; r < a.nreg; ++r) n_sites += reg_s[5 * r + 4];
  // the thread's T column (the threads are a multiple of COLS)
  const int tcol = tid % COLS, tstep = nthreads / COLS;
  const int tjx = colj[tcol].x, tjy = abs(colj[tcol].y);
  const float tsign = colj[tcol].y < 0 ? -1.f : 1.f;
  RS_MARK(RS_SETUP);

  // charged site i0 + tid of the replica (tid < CH): its position and
  // charge, loaded while the previous chunk is contracted
  float4 next = make_float4(0.f, 0.f, 0.f, 0.f);
  auto fetch = [&](int i0) {
    int i = i0 + tid;
    if (tid >= CH || i >= n_sites) return;
    const int* reg = reg_s;
    while (i >= reg[4]) {
      i -= reg[4];
      reg += 5;
    }
    const int m = i / reg[2];
    const int s = reg[0] + m * reg[1]
                  + __ldg(a.offsets + reg[3] + i - m * reg[2]);
    next = make_float4(__ldg(pos + s), __ldg(pos + a.S + s),
                       __ldg(pos + 2 * a.S + s), __ldg(a.site_q + s));
  };
  if (live) {
    fetch(0);
    if (tid < CH) site_s[tid] = next;
  }
  __syncthreads();
  RS_MARK(RS_SITES);

  // the threads past 16 * zgroups help with the tables only
  const bool owner = tid < COL_GROUPS * a.zgroups;
  const int zg = tid / COL_GROUPS, cg = tid % COL_GROUPS;
  float acc_re[TZ][TC], acc_im[TZ][TC];
#pragma unroll
  for (int i = 0; i < TZ; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc_re[i][j] = acc_im[i][j] = 0.f;

  for (int i0 = 0; live && i0 < n_sites; i0 += CH) {
    const int nc = min(CH, n_sites - i0);
    const int ncu = (nc + UNROLL - 1) / UNROLL * UNROLL;
    // a. per-axis phase powers: x times q and y into tab, z into the Pz
    // rows; the rows of sites past nc are zero
    for (int t = tid; t < ncu * 3; t += nthreads) {
      const int c = t / 3, ax = t - 3 * c;
      float2* pzr = pz_s + c * rows;
      if (c >= nc) {
        if (ax == 2)
          for (int z = 0; z < rows; ++z) pzr[z] = make_float2(0.f, 0.f);
        continue;
      }
      const float4 r = site_s[c];
      const float* h = a.h2pi + 3 * ax;
      const float th = __ldg(h) * r.x + __ldg(h + 1) * r.y
                       + __ldg(h + 2) * r.z;
      if (ax == 0)
        phase_powers_q(th, a.kx, r.w, tab + c * pxy);
      else if (ax == 1)
        phase_powers(th, a.ky, tab + c * pxy + nx);
      else
        z_powers_row(th, a.kz, z0, rows, pzr);
    }
    __syncthreads();
    RS_MARK(RS_PHASES);
    // b. T = (q Px) Py at the thread's column for sites tid / COLS,
    // + tstep, ...: the loads of TBUILD sites before their stores
    for (int c = tid / COLS; c < ncu; c += TBUILD * tstep) {
      float2 x[TBUILD], y[TBUILD];
#pragma unroll
      for (int u = 0; u < TBUILD; ++u) {
        const int cc = c + u * tstep;
        x[u] = y[u] = make_float2(0.f, 0.f);
        if (cc < nc && tjx >= 0) {
          x[u] = tab[cc * pxy + tjx];
          y[u] = tab[cc * pxy + nx + tjy];
        }
      }
#pragma unroll
      for (int u = 0; u < TBUILD; ++u) {
        const int cc = c + u * tstep;
        const float yi = tsign * y[u].y;
        if (cc < ncu)
          t_s[cc * COLS + tcol] = make_float2(x[u].x * y[u].x - x[u].y * yi,
                                              x[u].x * yi + x[u].y * y[u].x);
      }
    }
    __syncthreads();
    RS_MARK(RS_TABLES);
    // the next chunk's sites, in flight during the contraction
    fetch(i0 + CH);
    // c. the contraction: TZ + TC shared loads per TZ x TC complex
    // multiply-adds, as the JAX package's
    // d_re = pz_re@t_re - pz_im@t_im, d_im = pz_re@t_im + pz_im@t_re
    const float2* pzr = pz_s + zg * TZ;
    const float2* tr = t_s + cg;
    for (int c = 0; owner && c < ncu; c += UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float2 pz[TZ], tv[TC];
#pragma unroll
        for (int i = 0; i < TZ; ++i) pz[i] = pzr[(c + u) * rows + i];
#pragma unroll
        for (int j = 0; j < TC; ++j)
          tv[j] = tr[(c + u) * COLS + COL_GROUPS * j];
#pragma unroll
        for (int i = 0; i < TZ; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            acc_re[i][j] = fmaf(pz[i].x, tv[j].x, acc_re[i][j]);
            acc_re[i][j] = fmaf(-pz[i].y, tv[j].y, acc_re[i][j]);
            acc_im[i][j] = fmaf(pz[i].x, tv[j].y, acc_im[i][j]);
            acc_im[i][j] = fmaf(pz[i].y, tv[j].x, acc_im[i][j]);
          }
      }
    }
    // the next chunk's sites (the phases have read this chunk's)
    if (tid < CH) site_s[tid] = next;
    __syncthreads();  // the chunk's tables are consumed
    RS_MARK(RS_CONTRACT);
  }

  // one store of the tile: fw + acc at real modes, fw at pad modes; the
  // tile's sum of w |A|^2. A row's loads go out before its stores.
  const int K = a.JzP * a.JxyP;
  float* are = a.amp_re + (size_t)b * K;
  float* aim = a.amp_im + (size_t)b * K;
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < TZ; ++i) {
    const int z = z0 + zg * TZ + i;
    float fr[TC], fi[TC], w[TC];
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int col = c0 + cg + COL_GROUPS * j;
      fr[j] = fi[j] = w[j] = 0.f;
      if (owner && z < a.JzP && col < a.JxyP) {
        fr[j] = __ldg(a.fw_re + z * a.JxyP + col);
        fi[j] = __ldg(a.fw_im + z * a.JxyP + col);
        w[j] = __ldg(a.kw + z * a.JxyP + col);
      }
    }
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int cl = cg + COL_GROUPS * j, col = c0 + cl;
      if (!owner || z >= a.JzP || col >= a.JxyP) continue;
      float re = fr[j], im = fi[j];
      if (z < Jz && colj[cl].x >= 0) {
        re += acc_re[i][j];
        im += acc_im[i][j];
      }
      are[z * a.JxyP + col] = re;
      aim[z * a.JxyP + col] = im;
      part += w[j] * (re * re + im * im);
    }
  }
  // rows below the last row tile (pad rows of the grid) hold fw_amp
  if (rt == a.row_tiles - 1) {
    const int z1 = z0 + rows;
    for (int t = tid; t < (a.JzP - z1) * COLS; t += nthreads) {
      const int z = z1 + t / COLS, col = c0 + t % COLS;
      if (col >= a.JxyP) continue;
      const int m = z * a.JxyP + col;
      const float re = __ldg(a.fw_re + m), im = __ldg(a.fw_im + m);
      are[m] = re;
      aim[m] = im;
      part += __ldg(a.kw + m) * (re * re + im * im);
    }
  }
  // the CTA's sum in a fixed order: lanes, then warps
  const int lane = tid & 31, warp = tid >> 5;
  for (int o = 16; o > 0; o >>= 1)
    part += __shfl_down_sync(0xffffffffu, part, o);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float sum = 0.f;
    for (int w = 0; w < nthreads / 32; ++w) sum += red[w];
    a.partial[(size_t)b * gridDim.x + blockIdx.x] = sum;
  }
  RS_MARK(RS_EPILOGUE);
}

// The energy of each replica from its tiles' partial sums, in tile order
// (E_RECIP), and from its populations, type after type, a product then a
// sum (no FMA) as the plain version: E_SELF, E_INTRA; the frozen sites'
// own pair terms where no guest (a live molecule of an active type) is
// left; E_TOT the sum of the five.
__global__ void resync_energy_kernel(ResyncArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const int tiles = a.row_tiles * a.col_tiles;
  const float* p = a.partial + (size_t)b * tiles;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += p[t];
  // recip_energy: sum * COULOMB_K * TWOPI / V, in that order
  const float e_recip = s * a.coulomb_k * a.two_pi / a.volume;
  const int* n_mol = a.n_mol + (size_t)b * a.R1;
  float e_self = 0.f, e_intra = 0.f;
  int guests = 0;
  for (int r = 0; r < a.R1 - 1; ++r) {
    const int n = __ldg(n_mol + r);
    e_self = __fadd_rn(e_self, __fmul_rn(__ldg(a.self_e + r), (float)n));
    e_intra = __fadd_rn(e_intra, __fmul_rn(__ldg(a.intra_e + r), (float)n));
    if (a.active[r]) guests += n;
  }
  const float* ein = a.energy_in + 6 * b;
  float* eout = a.energy_out + 6 * b;
  const float e_lj = guests ? ein[1] : __ldg(a.fw_pair);
  const float e_coul = guests ? ein[2] : __ldg(a.fw_pair + 1);
  eout[0] = e_recip;
  eout[1] = e_lj;
  eout[2] = e_coul;
  eout[3] = e_self;
  eout[4] = e_intra;
  eout[5] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(e_recip, e_lj), e_coul),
                                e_self), e_intra);
}

}  // namespace

extern "C" int resync_launch(void* const* ptrs, int nptr, const int* ints,
                             int nint, const float* floats, int nfloat,
                             void* stream) {
  if (nptr != RP_COUNT || nint != RI_COUNT || nfloat != RF_COUNT)
    return MANIAC_ERR_TABLES;
  ResyncArgs a;
  a.pos = static_cast<const float*>(ptrs[RP_POS]);
  a.n_mol = static_cast<const int*>(ptrs[RP_NMOL]);
  a.energy_in = static_cast<const float*>(ptrs[RP_ENERGY_IN]);
  a.site_q = static_cast<const float*>(ptrs[RP_SITE_Q]);
  a.h2pi = static_cast<const float*>(ptrs[RP_H2PI]);
  a.kw = static_cast<const float*>(ptrs[RP_KW]);
  a.fw_re = static_cast<const float*>(ptrs[RP_FW_RE]);
  a.fw_im = static_cast<const float*>(ptrs[RP_FW_IM]);
  a.col_jx = static_cast<const int*>(ptrs[RP_COL_JX]);
  a.col_jy = static_cast<const int*>(ptrs[RP_COL_JY]);
  a.offsets = static_cast<const int*>(ptrs[RP_Q_OFFSETS]);
  a.self_e = static_cast<const float*>(ptrs[RP_SELF]);
  a.intra_e = static_cast<const float*>(ptrs[RP_INTRA]);
  a.active = static_cast<const bool*>(ptrs[RP_ACTIVE]);
  a.fw_pair = static_cast<const float*>(ptrs[RP_FW_PAIR]);
  a.amp_re = static_cast<float*>(ptrs[RP_AMP_RE]);
  a.amp_im = static_cast<float*>(ptrs[RP_AMP_IM]);
  a.energy_out = static_cast<float*>(ptrs[RP_ENERGY_OUT]);
  a.partial = static_cast<float*>(ptrs[RP_PARTIAL]);
  a.B = ints[RI_B];
  a.S = ints[RI_S];
  a.R1 = ints[RI_R1];
  a.JzP = ints[RI_JZP];
  a.JxyP = ints[RI_JXYP];
  a.kx = ints[RI_KX];
  a.ky = ints[RI_KY];
  a.kz = ints[RI_KZ];
  a.nreg = ints[RI_NREG];
  a.zgroups = ints[RI_ZGROUPS];
  a.row_tiles = ints[RI_ROW_TILES];
  a.col_tiles = ints[RI_COL_TILES];
  a.threads = ints[RI_THREADS];
  a.regions = static_cast<const int*>(ptrs[RP_Q_REGIONS]);
  a.coulomb_k = floats[RF_ESCALE_C];
  a.two_pi = floats[RF_ESCALE_2PI];
  a.volume = floats[RF_VOLUME];
  if (a.B < 1 || a.B > 65535 || a.zgroups < 1
      || a.zgroups > MAX_ZGROUPS || a.threads < COL_GROUPS * a.zgroups
      || a.threads > MAX_THREADS || a.threads % COLS != 0
      || a.JzP < 2 * a.kz + 1
      || a.row_tiles * TZ * a.zgroups < 2 * a.kz + 1
      || a.col_tiles * COLS < a.JxyP || a.nreg < 0)
    return MANIAC_ERR_SHAPE;
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = resync_smem(a.kx, a.ky, TZ * a.zgroups, a.nreg);
  cudaError_t err = cudaFuncSetAttribute(
      resync_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.row_tiles * a.col_tiles, a.B);
  resync_kernel<<<grid, a.threads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  resync_energy_kernel<<<(a.B + 127) / 128, 128, 0, s>>>(a);
  return (int)cudaGetLastError();
}

#ifdef MANIAC_SECTION_CLOCKS
// The section ticks summed over the CTAs since the last call (n =
// RS_SECTIONS), then zeroed.
extern "C" int resync_section_clocks(unsigned long long* out, int n) {
  if (n != RS_SECTIONS) return MANIAC_ERR_TABLES;
  const size_t bytes = sizeof(unsigned long long) * n;
  cudaError_t err = cudaMemcpyFromSymbol(out, resync_ticks, bytes);
  if (err != cudaSuccess) return (int)err;
  void* dev = nullptr;
  err = cudaGetSymbolAddress(&dev, resync_ticks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(dev, 0, bytes);
}
#endif

extern "C" const char* maniac_error_string(int err) {
  if (err == MANIAC_ERR_TABLES) return "argument table lengths do not match";
  if (err == MANIAC_ERR_SHAPE) return "a size the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
