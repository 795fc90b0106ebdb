// A whole block of MC steps per replica, state resident across steps.
//
// Replaces maniac_tpu/kernels/blockg.py::_blockg_kernel (launcher
// run_block_grouped) in all its f32 forms:
//   * framework split: a frozen framework prefix (LJ + erfc(alpha2 r)/r cut
//     at rcut2) plus the far-field alpha2 grid, guests take LJ +
//     erfc(alpha r)/r cut at gg_rcut;
//   * no split (every type active, e.g. a water box): no frozen prefix and
//     an empty far-field grid, so the pair pass covers every live site
//     with LJ + erfc(alpha r)/r (cut at gg_rcut when gg_cut), as
//     physics/energy.py;
//   * one active species, or several (MULTI): the type draws u[11] and
//     u[12] pick an old and, for the live swap move, a new type; every
//     per-type quantity (size, capacity, bases, activity, self energy,
//     population, charges and LJ classes of the footprint, template) is
//     taken per side; with one species a swap draw is a dead draw;
//   * an orthorhombic box, or a triclinic one (TRICLINIC): the minimum
//     image is the brute-force 27-image search and a translated COM wraps
//     through fractional coordinates (physics/pbc.py); the framework split
//     is orthorhombic only, so a triclinic box runs the no-split form;
//   * any of them with a reservoir (-r): an insertion copies a random
//     reservoir molecule of the new type as it is (no rotation), an
//     accepted insertion pops it, an accepted removal pushes the removed
//     molecule back into its type's reservoir (or drops it when that is
//     full, counted in extras[1]); a swap does both in one step.
// Each step is exactly maniac_tpu/mc/moves.py::mc_step_u on one row of 21
// uniforms: proposal (_propose), pair passes, the far-field grid term, the
// k-space delta, the Metropolis test and the commits with compaction on
// removal (_core_xla, _bookkeep, _update_reservoir).
//
// Bound on the H100: arithmetic, and the step chain. Per step and replica
// the pair passes cover the framework's sites within the move's reach (on
// the flagship some 2160 framework sites in all) and the live guests, the
// k-space delta the modes of nonzero weight (2,975 of the flagship's
// 9,216-mode grid; an accepted move's commit its 6,348 real modes), and
// the far field (the framework split)
// one complex multiply-add per nonzero alpha2 coefficient (23,675 on the
// flagship) and charged footprint atom. Without the split there is no far
// field and the pair pass covers every live site instead of the guests
// only; on a triclinic box each pair costs 27 minimum-image candidates. The
// reservoir adds no work to the bound: a few dozen bytes a step (at most
// 2 x 8 offset rows and two COMs read and written by one thread). Steps are
// sequential within a replica, so the parallelism is replicas (B = 1024)
// times the threads of a replica within a step.
// Design: 256 threads per replica run all n_steps of step_body.cuh's
// mc_step (the step stepg.cu runs once a launch): thread 0 proposes from
// its uniform row and publishes the footprints in shared memory; all
// threads sweep the framework and live guest sites and the weighted
// k-space modes, contract the far table one axis at a time (common.cuh
// far_sweep: y first from a shared table of weighted y powers, then each
// row closed with its x and z powers; tiles staged by cp.async), and make
// one block reduction;
// thread 0 decides and commits; on acceptance every thread recomputes the
// delta of its own modes and adds it to the amplitudes (no 74 KB delta
// buffer). Positions, COMs, amplitudes and the reservoir offsets and COMs
// are copied in-to-out at the start and updated in device memory; the
// replica's populations, reservoir counts, energies and counters live in
// shared memory for the block; a triclinic box's 27 image shifts are
// staged in shared memory once. The
// kernel is a template on <TRICLINIC, MULTI, FAR, TILES>: the forms without
// a far table compile without the far sweep, those without a frozen prefix
// without its tiles' cull and sweep. One replica a CTA: G replicas a CTA
// in lockstep, sharing each staged tile of the far table, were measured and
// lost (G = 2 9% and G = 4 20% slower on the flagship at B = 1024: every
// barrier waits for the slowest of the CTA's replicas, and at G = 4 one CTA
// fills an SM; PERF.md). Measured on the flagship at B = 1024 (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md): a 400-step block 241 -> 103 ms, the far
// field from about 68% of the block to about a fifth (clock64 split: the
// pair pass and k-space delta now lead). A replica's state is a static
// __shared__ variable (carved from the dynamic shared memory it cost the
// water boxes 5%).
// The k-space delta and the amplitude commit walk the host's lists of the
// weighted and the real modes (system._mode_lists; rows m, jx, jy, jz),
// thread t entries t, t + 256, ...: the (JzP, JxyP) grid pads its rows to
// a multiple of 8 and its columns to one of 128 for the TPU's (8, 128)
// tiles, and walking it thread t took column t of every row, so warps
// whose columns held no weighted mode idled and the rest ran part-empty
// (on SPC/E water 63 warp-iterations of the delta for 1,152 modes, warp 0
// 17 of them, against 4-5 each now). Every mode's update is computed as
// the grid's walk computed it; only the delta's sum takes another order.
// Framework pairs: the host cuts the live frozen sites into spatially
// compact tiles (physics/fwsplit.py FrozenTiles: each tile's bounding box,
// its sites' positions, charges and LJ entries, shared by every replica),
// and a step tests every tile's box against its footprint's reach (each
// side's COM, the largest distance of its atoms from it, the cutoff or
// rcut2 and a float32 margin) and sweeps only the tiles it keeps, with
// minimum image (common.cuh frozen_tile_pass; the JAX package's blockg
// windowed a table sorted along one axis, which keeps some 70% of the
// graphite slit's sites). A skipped site lies out of reach, where every
// term is an exact zero, so only the order of the per-thread sums
// changes. erfc is libdevice erfcf (common.cuh). A pair takes no division
// and, off the frozen prefix, no branch region (common.cuh min_image_axis,
// pair_terms): the same bits, and on SPC/E water (750 waters, a 30 A box) a
// 400-step block at B = 1024 50.6 -> 43.6 ms (NVIDIA H100 80GB HBM3, 700
// W).
#include "step_body.cuh"

namespace {

// After the tables both kernels take (step_body.cuh, whose state pointers
// are the outputs here): the input state, same shapes.
enum BlockPtr {
  BP_POS_IN = SP_SHARED,
  BP_COM_IN,
  BP_AMPRE_IN,
  BP_AMPIM_IN,
  BP_NMOL_IN,
  BP_ENERGY_IN,
  BP_COUNTERS_IN,
  BP_EXTRAS_IN,
  BP_RES_OFF_IN,   // unread without a reservoir
  BP_RES_COM_IN,
  BP_RES_N_IN,
  BP_COUNT
};
enum BlockInt { BI_COUNT = SI_SHARED };

constexpr int THREADS = STEP_THREADS;

struct Args : StepArgs {
  const float* pos_in; const float* com_in;
  const float* ampre_in; const float* ampim_in;
  const int* nmol_in; const float* energy_in;
  const int* counters_in; const int* extras_in;
  const float* res_off_in; const float* res_com_in; const int* res_n_in;
  static constexpr int act_stride = 0;  // one activity table (step_body.cuh)
};

// 64 registers a thread at most, so that four CTAs share an SM (B = 1024
// replicas then take two waves, not three). One replica a CTA, replica
// blockIdx.x. FAR: the spec has a far table; TILES: a frozen prefix, swept
// tile by tile (only the forms with one compile the far sweep, or the
// tiles' cull and sweep, so the others keep their registers for the rest).
template <bool TRICLINIC, bool MULTI, bool FAR, bool TILES>
__global__ void __launch_bounds__(THREADS, 4) blockg_kernel(Args a) {
  extern __shared__ float4 smem_raw[];
  __shared__ float shifts[TRICLINIC ? 3 * NIMG : 1];
  __shared__ StepSmem ss;
  FarSmem* far = reinterpret_cast<FarSmem*>(smem_raw);
  const int tid = threadIdx.x;

  const int b = blockIdx.x;
  const int S = a.S, M1 = a.Mtot + 1, K = a.JzP * a.JxyP;
  float* pos = a.pos + (size_t)b * 3 * S;
  float* com = a.com + (size_t)b * 3 * M1;
  float* ampre = a.ampre + (size_t)b * K;
  float* ampim = a.ampim + (size_t)b * K;
  float* res_off = a.res_off + (size_t)b * 3 * a.Sres;
  float* res_com = a.res_com + (size_t)b * 3 * a.Mres1;

  if (a.has_res) {
    for (int i = tid; i < 3 * a.Sres; i += THREADS)
      res_off[i] = a.res_off_in[(size_t)b * 3 * a.Sres + i];
    for (int i = tid; i < 3 * a.Mres1; i += THREADS)
      res_com[i] = a.res_com_in[(size_t)b * 3 * a.Mres1 + i];
  }
  for (int i = tid; i < 3 * S; i += THREADS)
    pos[i] = a.pos_in[(size_t)b * 3 * S + i];
  for (int i = tid; i < 3 * M1; i += THREADS)
    com[i] = a.com_in[(size_t)b * 3 * M1 + i];
  for (int i = tid; i < K; i += THREADS) {
    ampre[i] = a.ampre_in[(size_t)b * K + i];
    ampim[i] = a.ampim_in[(size_t)b * K + i];
  }
  load_counts(a, b, tid, a.nmol_in, a.res_n_in, a.energy_in, a.counters_in,
              a.extras_in, ss);
  stage_image_shifts<TRICLINIC>(a.img, shifts);
  const float tstep = a.tstep[b], rstep = a.rstep[b];
  const float L[3] = {a.boxl[0], a.boxl[1], a.boxl[2]};
  const MinImage<TRICLINIC> img = make_min_image<TRICLINIC>(a, L, shifts);
  Proposal pr;
  __syncthreads();
  SECTION_MARK(-1);

  for (int step = 0; step < a.n_steps; ++step)
    mc_step<TRICLINIC, MULTI, FAR, TILES, 1>(a, img, b, 0, step, ss, far,
                                             pos, com, ampre, ampim, res_off,
                                             res_com, tstep, rstep, pr, tid);

  store_counts(a, b, tid, ss, a.nmol, a.res_n, a.energy, a.counters,
               a.extras);
}

// Launch one form, one replica a CTA, with its dynamic shared memory: the
// far field's y table and tiles where there is a far table, none elsewhere.
template <bool TRICLINIC, bool MULTI, bool FAR, bool TILES>
int launch_form(const Args& a, cudaStream_t stream) {
  auto kernel = blockg_kernel<TRICLINIC, MULTI, FAR, TILES>;
  const size_t smem = FAR ? sizeof(FarSmem) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<a.B, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int blockg_launch(void* const* ptrs, int nptr, const int* ints,
                             int nint, const float* fl, int nfloat,
                             void* stream) {
  if (nptr != BP_COUNT || nint != BI_COUNT || nfloat != SF_COUNT)
    return MANIAC_ERR_TABLES;
  Args a;
  if (!unpack_step_args(a, ptrs, ints, fl)) return MANIAC_ERR_SHAPE;
  a.pos_in = static_cast<const float*>(ptrs[BP_POS_IN]);
  a.com_in = static_cast<const float*>(ptrs[BP_COM_IN]);
  a.ampre_in = static_cast<const float*>(ptrs[BP_AMPRE_IN]);
  a.ampim_in = static_cast<const float*>(ptrs[BP_AMPIM_IN]);
  a.nmol_in = static_cast<const int*>(ptrs[BP_NMOL_IN]);
  a.energy_in = static_cast<const float*>(ptrs[BP_ENERGY_IN]);
  a.counters_in = static_cast<const int*>(ptrs[BP_COUNTERS_IN]);
  a.extras_in = static_cast<const int*>(ptrs[BP_EXTRAS_IN]);
  a.res_off_in = static_cast<const float*>(ptrs[BP_RES_OFF_IN]);
  a.res_com_in = static_cast<const float*>(ptrs[BP_RES_COM_IN]);
  a.res_n_in = static_cast<const int*>(ptrs[BP_RES_N_IN]);
  const bool tricl = ints[SI_TRICLINIC] != 0, multi = a.n_active >= 2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tricl)
    return multi ? launch_form<true, true, false, false>(a, st)
                 : launch_form<true, false, false, false>(a, st);
  if (a.n_fw_tiles == 0)
    return multi ? launch_form<false, true, false, false>(a, st)
                 : launch_form<false, false, false, false>(a, st);
  if (a.n_far_tiles == 0)
    return multi ? launch_form<false, true, false, true>(a, st)
                 : launch_form<false, false, false, true>(a, st);
  return multi ? launch_form<false, true, true, true>(a, st)
               : launch_form<false, false, true, true>(a, st);
}

#ifdef MANIAC_SECTION_CLOCKS
// The instrumented build's section ticks, (SECTION_REPLICAS, N_SECTIONS)
// int64 replica-major, copied into out; then zeroed.
extern "C" int maniac_section_clocks(long long* out, int n) {
  if (n != SECTION_REPLICAS * N_SECTIONS) return MANIAC_ERR_TABLES;
  const size_t bytes = sizeof(long long) * n;
  cudaError_t err = cudaMemcpyFromSymbol(out, maniac_section_ticks, bytes);
  if (err != cudaSuccess) return (int)err;
  void* dev = nullptr;
  err = cudaGetSymbolAddress(&dev, maniac_section_ticks);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(dev, 0, bytes);
}

// The instrumented build's frozen tile counts, (SECTION_REPLICAS, 2) int64
// replica-major (tiles tested, tiles kept), copied into out; then zeroed.
extern "C" int maniac_tile_counts_read(long long* out, int n) {
  if (n != SECTION_REPLICAS * 2) return MANIAC_ERR_TABLES;
  const size_t bytes = sizeof(long long) * n;
  cudaError_t err = cudaMemcpyFromSymbol(out, maniac_tile_counts, bytes);
  if (err != cudaSuccess) return (int)err;
  void* dev = nullptr;
  err = cudaGetSymbolAddress(&dev, maniac_tile_counts);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(dev, 0, bytes);
}
#endif
