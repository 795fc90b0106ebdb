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
// it is one CTA on one SM, so a single chain's step is its latency.
// Design: one CTA per replica, one launch per step, state in place (the
// wrapper, kernels/stepg.py::run_steps_kernel, clones the caller's state
// once per block and launches on the clone). The replica's populations,
// reservoir counts, energies, counters and extras (a few dozen bytes) are
// loaded into shared memory, run through mc_step and stored back before the
// CTA ends, so the next launch reads them; positions, COMs, amplitudes and
// the reservoir rows are read and written where they are, and a step writes
// only what it changes (no copy of positions or amplitudes). The kernel is a
// template on <TRICLINIC, MULTI, FAR, TILES> as blockg.cu is, with its
// 64-register bound; the far field's shared memory (FarSmem, 25 KB) is
// static here, under the 48 KB a launch takes without an attribute call.
#include "step_body.cuh"

namespace {

// After the tables both kernels take (step_body.cuh): the step index and
// the activity table's stride per replica.
enum StepgInt { SI_STEP = SI_SHARED, SI_ACT_STRIDE, SI_COUNT };

struct Args : StepArgs {
  int step, act_stride;
};

// One replica a CTA, replica blockIdx.x; 64 registers a thread at most, as
// blockg.cu (four CTAs an SM).
template <bool TRICLINIC, bool MULTI, bool FAR, bool TILES>
__global__ void __launch_bounds__(STEP_THREADS, 4) stepg_kernel(Args a) {
  __shared__ float shifts[TRICLINIC ? 3 * NIMG : 1];
  __shared__ StepSmem ss;
  __shared__ float4 far_raw[FAR ? sizeof(FarSmem) / sizeof(float4) : 1];
  FarSmem* far = reinterpret_cast<FarSmem*>(far_raw);
  const int tid = threadIdx.x, b = blockIdx.x;
  const int M1 = a.Mtot + 1, K = a.JzP * a.JxyP;

  load_counts(a, b, tid, a.nmol, a.res_n, a.energy, a.counters, a.extras,
              ss);
  stage_image_shifts<TRICLINIC>(a.img, shifts);
  const float L[3] = {a.boxl[0], a.boxl[1], a.boxl[2]};
  const MinImage<TRICLINIC> img = make_min_image<TRICLINIC>(a, L, shifts);
  Proposal pr;
  __syncthreads();

  mc_step<TRICLINIC, MULTI, FAR, TILES>(
      a, img, b, a.step, ss, far, a.pos + (size_t)b * 3 * a.S,
      a.com + (size_t)b * 3 * M1, a.ampre + (size_t)b * K,
      a.ampim + (size_t)b * K, a.res_off + (size_t)b * 3 * a.Sres,
      a.res_com + (size_t)b * 3 * a.Mres1, a.tstep[b], a.rstep[b], pr, tid);

  store_counts(a, b, tid, ss, a.nmol, a.res_n, a.energy, a.counters,
               a.extras);
}

template <bool TRICLINIC, bool MULTI, bool FAR, bool TILES>
int launch_form(const Args& a, cudaStream_t stream) {
  stepg_kernel<TRICLINIC, MULTI, FAR, TILES>
      <<<a.B, STEP_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
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
  if (!ok || a.step < 0 || a.step >= a.n_steps
      || (a.act_stride != 0 && a.act_stride != a.R))
    return MANIAC_ERR_SHAPE;
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
