// Amplitude resynthesis for B replicas: the per-block f32 drift bound
// (DIVERGENCES.md #13).
//
// Replaces maniac_tpu/kernels/resync.py::_resyncg_kernel (launcher
// resync_pallas_grouped). For each replica it rebuilds the structure factor
//   A(k) = fw_amp(k) + sum_{live guest sites s} q_s e^{i k.r_s}
// on the dense (JzP, JxyP) grid, then E_RECIP = C 2pi/V sum_k w_k |A(k)|^2,
// and E_TOT += E_RECIP_new - E_RECIP_old.
//
// Bound on the H100: arithmetic. Each replica costs (live sites) x (modes)
// complex triple products (768 x 9216 at the flagship); the bytes are one
// read of the guest positions and one write of the amplitudes.
// Design: one CTA per replica; each thread owns a strided set of modes and
// accumulates them in the output array (each mode has exactly one writer,
// so no atomics). Sites go in chunks of CHUNK: per chunk the per-axis phase
// powers (one sincosf per site and axis, powers by repeated complex
// multiply) are built once into shared memory with the charge folded into
// the x table, then every thread sweeps the chunk for each of its modes.
// The grid's column -> (jx, signed jy) tables come from the host, read off
// the selectors ex_sel/ey_sel. Only the live prefix n_mol[type] * A of each
// guest type region is visited (the same bound as resync.py:257-263).
// Speed (tensor cores, mode tiling in registers) is later work.
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
  RP_REGIONS,    // (nreg, 3) i32: site base, atoms per molecule, type
  RP_AMP_RE,     // out (B, JzP * JxyP) f32
  RP_AMP_IM,
  RP_ENERGY_OUT, // out (B, 6) f32
  RP_COUNT
};
enum ResyncInt { RI_B, RI_S, RI_R1, RI_JZP, RI_JXYP, RI_KX, RI_KY, RI_KZ,
                 RI_NREG, RI_COUNT };
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
  float* amp_re;
  float* amp_im;
  float* energy_out;
  int B, S, R1, JzP, JxyP, kx, ky, kz, nreg;
  float coulomb_k, two_pi, volume;
};

constexpr int THREADS = 256;
constexpr int CHUNK = 64;

__global__ void __launch_bounds__(THREADS) resync_kernel(ResyncArgs a) {
  extern __shared__ float2 tab[];  // [CHUNK][nx + ny + nz] phase powers
  __shared__ float red[THREADS / 32];
  __shared__ float e_sum[1];
  const int b = blockIdx.x;
  const int K = a.JzP * a.JxyP;
  const int nx = a.kx + 1, ny = a.ky + 1, nz = a.kz + 1;
  const int per = nx + ny + nz;
  const int Jz = 2 * a.kz + 1;
  const float* pos = a.pos + (size_t)b * 3 * a.S;
  float* are = a.amp_re + (size_t)b * K;
  float* aim = a.amp_im + (size_t)b * K;

  for (int m = threadIdx.x; m < K; m += blockDim.x) {
    are[m] = a.fw_re[m];
    aim[m] = a.fw_im[m];
  }

  for (int r = 0; r < a.nreg; ++r) {
    const int base = a.regions[3 * r];
    const int n_live = a.n_mol[b * a.R1 + a.regions[3 * r + 2]]
                       * a.regions[3 * r + 1];
    for (int c0 = 0; c0 < n_live; c0 += CHUNK) {
      const int nc = min(CHUNK, n_live - c0);
      __syncthreads();  // the previous chunk's tables are consumed
      for (int t = threadIdx.x; t < nc * 3; t += blockDim.x) {
        const int c = t / 3, ax = t % 3;
        const int s = base + c0 + c;
        const float* h = a.h2pi + 3 * ax;
        const float th = h[0] * pos[s] + h[1] * pos[a.S + s]
                         + h[2] * pos[2 * a.S + s];
        float2* p = tab + c * per + (ax == 0 ? 0 : ax == 1 ? nx : nx + ny);
        phase_powers(th, ax == 0 ? a.kx : ax == 1 ? a.ky : a.kz, p);
        if (ax == 0) {  // fold the site charge into the x powers
          const float q = a.site_q[s];
          for (int j = 0; j < nx; ++j) p[j] = make_float2(p[j].x * q,
                                                          p[j].y * q);
        }
      }
      __syncthreads();
      for (int m = threadIdx.x; m < K; m += blockDim.x) {
        const int row = m / a.JxyP, col = m - row * a.JxyP;
        const int jx = a.col_jx[col];
        if (row >= Jz || jx < 0) continue;  // pad modes stay at fw_amp
        const int jy = a.col_jy[col], jz = row - a.kz;
        // d = sum_c pz * (px * py), summed as the JAX package's
        // d_re = pz_re@t_re - pz_im@t_im, d_im = pz_re@t_im + pz_im@t_re
        float a1 = 0.f, a2 = 0.f, b1 = 0.f, b2 = 0.f;
        for (int c = 0; c < nc; ++c) {
          const float2* p = tab + c * per;
          const float2 x = p[jx];
          const float2 y = signed_power(p + nx, jy);
          const float2 z = signed_power(p + nx + ny, jz);
          const float tr = x.x * y.x - x.y * y.y;
          const float ti = x.x * y.y + x.y * y.x;
          a1 += z.x * tr;
          a2 += z.y * ti;
          b1 += z.x * ti;
          b2 += z.y * tr;
        }
        are[m] += a1 - a2;
        aim[m] += b1 + b2;
      }
    }
  }
  __syncthreads();

  float part[1] = {0.f};
  for (int m = threadIdx.x; m < K; m += blockDim.x) {
    const float re = are[m], im = aim[m];
    part[0] += a.kw[m] * (re * re + im * im);
  }
  block_sum<1>(part, threadIdx.x, red, e_sum);
  if (threadIdx.x == 0) {
    const float* ein = a.energy_in + 6 * b;
    float* eout = a.energy_out + 6 * b;
    // recip_energy: sum * COULOMB_K * TWOPI / V, in that order
    const float e_recip = e_sum[0] * a.coulomb_k * a.two_pi / a.volume;
    for (int i = 0; i < 6; ++i) eout[i] = ein[i];
    eout[5] = ein[5] + (e_recip - ein[0]);
    eout[0] = e_recip;
  }
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
  a.regions = static_cast<const int*>(ptrs[RP_REGIONS]);
  a.amp_re = static_cast<float*>(ptrs[RP_AMP_RE]);
  a.amp_im = static_cast<float*>(ptrs[RP_AMP_IM]);
  a.energy_out = static_cast<float*>(ptrs[RP_ENERGY_OUT]);
  a.B = ints[RI_B];
  a.S = ints[RI_S];
  a.R1 = ints[RI_R1];
  a.JzP = ints[RI_JZP];
  a.JxyP = ints[RI_JXYP];
  a.kx = ints[RI_KX];
  a.ky = ints[RI_KY];
  a.kz = ints[RI_KZ];
  a.nreg = ints[RI_NREG];
  a.coulomb_k = floats[RF_ESCALE_C];
  a.two_pi = floats[RF_ESCALE_2PI];
  a.volume = floats[RF_VOLUME];
  if (a.B < 1 || a.JzP < 2 * a.kz + 1) return MANIAC_ERR_SHAPE;
  const size_t smem = sizeof(float2) * CHUNK * (a.kx + a.ky + a.kz + 3);
  cudaError_t err = cudaFuncSetAttribute(
      resync_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  resync_kernel<<<a.B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* maniac_error_string(int err) {
  if (err == MANIAC_ERR_TABLES) return "argument table lengths do not match";
  if (err == MANIAC_ERR_SHAPE) return "a size the kernel does not take";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
