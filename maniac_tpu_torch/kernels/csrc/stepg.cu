// One whole MC step for B replicas, in place: one launch per step.
//
// Replaces maniac_tpu/kernels/stepg.py::_stepg_kernel (launcher
// mc_step_core_grouped) with what surrounds it there, the proposal and the
// bookkeeping (mc/moves.py::_propose, _bookkeep, _update_reservoir), and on
// a triclinic box the XLA core the JAX package runs there (its stepg takes
// orthorhombic boxes only). A launch is exactly mc/moves.py::mc_step_u on
// row `step` of the block's (B, n_steps, 21) uniforms, for every replica:
// step_body.cuh's mc_step, the same code as the whole-block kernel's loop
// (blockg.cu). It takes every form the per-step path serves: one or more
// active species with swaps, the framework split on or off (an inactive
// type without the split included), an orthorhombic or a triclinic box,
// with or without a reservoir, and one activity table or one per replica
// (an isotherm sweep: act_stride R, the table (B, R)).
//
// Bound on the H100: per replica and step the k-space delta reads the
// replica's amplitudes at the weighted modes once (the host's list of them,
// as blockg.cu) and the pair pass its live positions; the
// operations are those of blockg.cu's step (pair pass, k-space delta, far
// field) plus the proposal. The step is one launch for B replicas; at B = 1
// it is one replica on an otherwise idle card, so a single chain's step is
// its latency.
// Design: one launch per step, state in place (the wrapper,
// kernels/stepg.py::run_steps_kernel, clones the caller's state once per
// block, and one call of stepg_launch queues the block's launches on the
// clone). At few replicas (up to kernels/stepg.py's CLUSTER_MAX_B in the
// run, the wrapper's choice, passed as SI_CLUSTER) a replica's step runs
// on a thread-block cluster of CLUSTER
// CTAs, replica blockIdx.x / CLUSTER, on as many SMs:
// each makes the same proposal, takes its share of the pair pass, the
// k-space delta, the far sweep and the amplitude commit, and reads the
// others' block sums through distributed shared memory (step_body.cuh
// mc_step); at B = 1 one CTA left 131 of the 132 SMs idle. Above, one
// CTA a replica, replica blockIdx.x. The replica's
// populations, reservoir counts, energies, counters and extras (a few
// dozen bytes) are loaded into shared memory, run through mc_step and
// stored back (by rank 0 in a cluster) before the CTA ends, so the next
// launch reads them; positions, COMs, amplitudes and the reservoir rows
// are read and written where they are, and a step writes only what it
// changes (no copy of positions or amplitudes). The kernel is a template on
// <TRICLINIC, MULTI, FAR, TILES, CL> (blockg.cu's forms and the cluster
// size), with blockg.cu's 64-register bound; the far field's shared memory
// (FarSmem, 25 KB) is static here, under the 48 KB a launch takes without
// an attribute call.
#include "step_body.cuh"

namespace {

// After the tables both kernels take (step_body.cuh): the first step
// index, the activity table's stride per replica, the CTAs a replica (1 or
// CLUSTER) and the launches, one a step from the first.
enum StepgInt {
  SI_STEP = SI_SHARED,
  SI_ACT_STRIDE,
  SI_CLUSTER,
  SI_LAUNCHES,
  SI_COUNT
};

// The CTAs of a replica's cluster at few replicas (kernels/stepg.py
// CLUSTER): the portable maximum. 16 (non-portable) took a step of
// spce750's chain in 13.4 us on the H100 against 15.5 at 8; its rate end
// to end and its CLUSTER_MAX_B against 8's were not measured alike.
constexpr int CLUSTER = 8;

struct Args : StepArgs {
  int step, act_stride;
};

#ifdef MANIAC_CLUSTER_SMID
// The instrumented build's record of the SM (%smid) each CTA of the last
// launch ran on, CTA blockIdx.x < SMID_CTAS; maniac_cluster_smids copies it
// out.
constexpr int SMID_CTAS = 1024;
static __device__ int maniac_smid[SMID_CTAS];
#endif

// CL CTAs a replica (a cluster where CL > 1), replica blockIdx.x / CL; 64
// registers a thread at most, as blockg.cu (four CTAs an SM).
template <bool TRICLINIC, bool MULTI, bool FAR, bool TILES, int CL>
__global__ void __launch_bounds__(STEP_THREADS, 4) stepg_kernel(Args a) {
  __shared__ float shifts[TRICLINIC ? 3 * NIMG : 1];
  __shared__ StepSmem ss;
  __shared__ float4 far_raw[FAR ? sizeof(FarSmem) / sizeof(float4) : 1];
  FarSmem* far = reinterpret_cast<FarSmem*>(far_raw);
  const int tid = threadIdx.x, b = blockIdx.x / CL, rank = blockIdx.x % CL;
  const int M1 = a.Mtot + 1, K = a.JzP * a.JxyP;
#ifdef MANIAC_CLUSTER_SMID
  if (tid == 0 && blockIdx.x < SMID_CTAS) {
    int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    maniac_smid[blockIdx.x] = sm;
  }
#endif

  load_counts(a, b, tid, a.nmol, a.res_n, a.energy, a.counters, a.extras,
              ss);
  stage_image_shifts<TRICLINIC>(a.img, shifts);
  const float L[3] = {a.boxl[0], a.boxl[1], a.boxl[2]};
  const MinImage<TRICLINIC> img = make_min_image<TRICLINIC>(a, L, shifts);
  Proposal pr;
  __syncthreads();

  mc_step<TRICLINIC, MULTI, FAR, TILES, CL>(
      a, img, b, rank, a.step, ss, far, a.pos + (size_t)b * 3 * a.S,
      a.com + (size_t)b * 3 * M1, a.ampre + (size_t)b * K,
      a.ampim + (size_t)b * K, a.res_off + (size_t)b * 3 * a.Sres,
      a.res_com + (size_t)b * 3 * a.Mres1, a.tstep[b], a.rstep[b], pr, tid);

  if (rank == 0)
    store_counts(a, b, tid, ss, a.nmol, a.res_n, a.energy, a.counters,
                 a.extras);
}

// One CTA a replica (cl 1) or a cluster of CLUSTER (grid B x CLUSTER).
template <bool TRICLINIC, bool MULTI, bool FAR, bool TILES>
int launch_form(const Args& a, int cl, cudaStream_t stream) {
  if (cl == 1) {
    stepg_kernel<TRICLINIC, MULTI, FAR, TILES, 1>
        <<<a.B, STEP_THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * CLUSTER);
  cfg.blockDim = dim3(STEP_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, stepg_kernel<TRICLINIC, MULTI, FAR, TILES, CLUSTER>, a);
}

}  // namespace

extern "C" int stepg_launch(void* const* ptrs, int nptr, const int* ints,
                            int nint, const float* fl, int nfloat,
                            void* stream) {
  if (nptr != SP_SHARED || nint != SI_COUNT || nfloat != SF_COUNT)
    return MANIAC_ERR_TABLES;
  Args a;
  const bool ok = unpack_step_args(a, ptrs, ints, fl);
  a.step = ints[SI_STEP];
  a.act_stride = ints[SI_ACT_STRIDE];
  const int cl = ints[SI_CLUSTER], n = ints[SI_LAUNCHES];
  if (!ok || a.step < 0 || n < 1 || a.step + n > a.n_steps
      || (a.act_stride != 0 && a.act_stride != a.R)
      || (cl != 1 && cl != CLUSTER))
    return MANIAC_ERR_SHAPE;
  const bool tricl = ints[SI_TRICLINIC] != 0, multi = a.n_active >= 2;
  int (*form)(const Args&, int, cudaStream_t);
  if (tricl)
    form = multi ? launch_form<true, true, false, false>
                 : launch_form<true, false, false, false>;
  else if (a.n_fw_tiles == 0)
    form = multi ? launch_form<false, true, false, false>
                 : launch_form<false, false, false, false>;
  else if (a.n_far_tiles == 0)
    form = multi ? launch_form<false, true, false, true>
                 : launch_form<false, false, false, true>;
  else
    form = multi ? launch_form<false, true, true, true>
                 : launch_form<false, false, true, true>;
  // one launch a step, queued here rather than one host call each: the
  // host's cost of a call through kernels/build.launch (some 12 us) passed
  // a step's device time at B = 1
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (const int end = a.step + n; a.step < end; ++a.step) {
    const int err = form(a, cl, st);
    if (err != 0) return err;
  }
  return 0;
}

#ifdef MANIAC_CLUSTER_SMID
// The instrumented build's SM of each CTA of the last launch, SMID_CTAS
// ints, copied into out.
extern "C" int maniac_cluster_smids(int* out, int n) {
  if (n != SMID_CTAS) return MANIAC_ERR_TABLES;
  return (int)cudaMemcpyFromSymbol(out, maniac_smid, sizeof(int) * n);
}
#endif
