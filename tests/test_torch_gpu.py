"""maniac_tpu_torch CUDA kernels against their plain torch versions, on a
card. Every test here needs a CUDA device and skips without one.

The file imports no jax (the machine with the card has none), so it runs
without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import functools

import numpy as np
import pytest
import torch

from maniac_tpu_torch import load_system, replicate, run_block_replicated
from maniac_tpu_torch.kernels import dispatch_report
from maniac_tpu_torch.kernels.blockg import run_block_kernel
from maniac_tpu_torch.kernels.gpass import (GPASS_RTOL, GPASS_VARIANTS,
                                            gpass, gpass_plain, gpass_scale)
from maniac_tpu_torch.kernels.hwprobe import onehot_product
from maniac_tpu_torch.kernels.resync import resync_grouped, resync_plain
from maniac_tpu_torch.kernels.stepg import run_steps_kernel
from maniac_tpu_torch.kernels.vpu import (CPASS_RTOL, PRIM_DOMAINS, PRIMS,
                                          VPU_OPS, VPU_RTOL, cpass,
                                          cpass_plain, f32_bits, prim_check,
                                          vpu_chain, vpu_chain_plain)
from maniac_tpu_torch.kernels.threefry import (split_uniform,
                                               split_uniform_plain)
from maniac_tpu_torch.mc.driver import resync_amplitudes, steps_plain
from maniac_tpu_torch.parallel.replicas import (perturb_activity,
                                                run_block_sweep)
from maniac_tpu_torch.kernels import build
from maniac_tpu_torch.system import E_RECIP, E_TOT
from maniac_tpu_torch.systems import (make_framework_mixed,
                                      make_framework_water,
                                      make_mixed_reservoir, make_mixed_sizes,
                                      make_slit_pore, make_water_box,
                                      make_water_reservoir, make_zif_like,
                                      tiny_system)
from maniac_tpu_torch.tools.gpass_bench import check_inputs
from maniac_tpu_torch.tools.gpass_bench import inputs as gpass_inputs
from maniac_tpu_torch.tools.resync_times import SYSTEMS as RESYNC_SYSTEMS
from maniac_tpu_torch.tools.resync_times import (edge_replicas, load_cell,
                                                 replica)
from maniac_tpu_torch.tools.vpu_bench import cpass_inputs, plane
from maniac_tpu_torch.utils.hwprobe import onehot_operands, probe_onehot_exact
from maniac_tpu_torch.utils.threefry import prng_key, split, uniform

pytestmark = pytest.mark.gpu

# the chip_smoke.py / tests/test_blockg.py bounds: decisions identical,
# positions to f32 ulp, running energies summed in another order
POS_TOL = 1e-4      # Angstrom
ENERGY_TOL = 5.0    # Kelvin
AMP_TOL = 2e-4
E_RTOL = 2e-6       # E_RECIP ~ 2e5 K summed in f32 over ~6000 modes
# one proposal's pair energies reach 1e7 K on overlapping insertions (which
# reject); f32 sums over thousands of sites in another order then differ by
# some 1e-5 relative
PROPOSAL_E_RTOL = 1e-4


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _load(outdir, dev, capacity, dtype=torch.float32, reservoir=None):
    return load_system(f"{outdir}/input.maniac", f"{outdir}/topology.data",
                       f"{outdir}/parameters.inc", reservoir_file=reservoir,
                       capacity=capacity, dtype=dtype, device=dev)


def _draw(spec, B, n_steps, seed):
    """(B, n_steps, 21) uniforms of the threefry key of ``seed``, drawn on
    the spec's device in its dtype."""
    return uniform(prng_key(seed, spec.device), (B, n_steps, 21), spec.dtype)


def _assert_block_parity(spec, states, u):
    k = run_block_kernel(spec, states, u)
    p = steps_plain(spec, states, u)
    torch.testing.assert_close(k.n_mol, p.n_mol, rtol=0, atol=0)
    torch.testing.assert_close(k.counters, p.counters, rtol=0, atol=0)
    torch.testing.assert_close(k.extras, p.extras, rtol=0, atol=0)
    assert float((k.pos - p.pos).abs().max()) <= POS_TOL
    assert float((k.com - p.com).abs().max()) <= POS_TOL
    assert float((k.energy - p.energy).abs().max()) <= ENERGY_TOL
    torch.testing.assert_close(k.res_n, p.res_n, rtol=0, atol=0)
    assert float((k.res_offset - p.res_offset).abs().max()) <= POS_TOL
    assert float((k.res_com - p.res_com).abs().max()) <= POS_TOL
    return k


def test_block_kernel_matches_plain(tmp_path):
    dev = _device()
    make_zif_like(str(tmp_path), n_cells=4, a=5.66, n_water=10,
                  fugacity=50.0, cutoff=6.0)
    sysm = _load(str(tmp_path), dev, 16)
    states = replicate(sysm.spec, sysm.state, 8)
    u = _draw(sysm.spec, 8, 60, 1)
    k = _assert_block_parity(sysm.spec, states, u)
    acc = k.counters[:, 1].sum(0)
    assert int(acc[1]) > 0 and int(acc[2]) > 0 and int(acc[3]) > 0


def test_block_kernel_capacity_overflow(tmp_path):
    """Insertions beyond capacity are rejected and counted in extras[0],
    as in the plain path."""
    dev = _device()
    make_zif_like(str(tmp_path), n_cells=4, a=5.66, n_water=10,
                  fugacity=5e5, cutoff=6.0, probs=(0.1, 0.0, 0.9, 0.0))
    sysm = _load(str(tmp_path), dev, 10)   # full from the start
    states = replicate(sysm.spec, sysm.state, 4)
    u = _draw(sysm.spec, 4, 80, 2)
    k = _assert_block_parity(sysm.spec, states, u)
    assert int(k.n_mol[:, 1].max()) <= 10
    assert int(k.extras[:, 0].sum()) > 0


@functools.cache
def _bench_cell(name):
    """bench.py's system ``name`` (tools/resync_times.SYSTEMS) on the card,
    loaded once."""
    return load_cell(name, torch.device("cuda"))


def _resync_cases():
    """(system, B) of the resync checks: bench.py's four systems at B = 1,
    7 and 1024, and the small framework fixture at B = 8."""
    return [(name, B) for name in RESYNC_SYSTEMS for B in (1, 7, 1024)] + [
        ("zif_small", 8)]


@pytest.mark.parametrize("system,B", _resync_cases())
def test_resync_kernel_matches_plain(tmp_path, system, B):
    """The resync kernel against its plain version: amplitudes within
    AMP_TOL, E_RECIP within E_RTOL relative. The small framework fixture
    after 30 plain steps at B = 8 (every energy within E_RTOL relative and
    0.05 K); bench.py's four systems after 10 plain steps with the edge
    replicas (no guests, every covered type at capacity, a charged-site
    count that is not a multiple of the kernel's chunk; at B = 1 each
    alone, and a fourth), where E_TOT moves by E_RECIP's change and the
    other energies stay as they came in, the replica without guests holds
    fw_amp exactly, and two launches on one input give the same bits."""
    dev = _device()
    if system == "zif_small":
        _zif_small(str(tmp_path))
        sysm = _load(str(tmp_path), dev, 16)
        states = replicate(sysm.spec, sysm.state, B)
        states = steps_plain(sysm.spec, states,
                             _draw(sysm.spec, B, 30, 3))
        k = resync_grouped(sysm.spec, states)
        p = resync_plain(sysm.spec, states)
        torch.testing.assert_close(k.amp_re, p.amp_re, rtol=0, atol=AMP_TOL)
        torch.testing.assert_close(k.amp_im, p.amp_im, rtol=0, atol=AMP_TOL)
        torch.testing.assert_close(k.energy, p.energy, rtol=E_RTOL, atol=0.05)
        return
    sysm = _bench_cell(system)
    spec = sysm.spec
    n = B if B >= 3 else 4
    states = steps_plain(spec, replicate(spec, sysm.state, n),
                         _draw(spec, n, 10, 3))
    states = edge_replicas(spec, states, seed=B)
    batches = [replica(states, i) for i in range(n)] if B == 1 else [states]
    for k_in, st in enumerate(batches):
        k, again = resync_grouped(spec, st), resync_grouped(spec, st)
        for f in ("amp_re", "amp_im", "energy"):
            assert torch.equal(getattr(k, f), getattr(again, f)), f
        p = resync_plain(spec, st)
        torch.testing.assert_close(k.amp_re, p.amp_re, rtol=0, atol=AMP_TOL)
        torch.testing.assert_close(k.amp_im, p.amp_im, rtol=0, atol=AMP_TOL)
        torch.testing.assert_close(k.energy[:, E_RECIP],
                                   p.energy[:, E_RECIP], rtol=E_RTOL, atol=0)
        assert torch.equal(k.energy[:, 1:5], st.energy[:, 1:5])
        assert torch.equal(k.energy[:, E_TOT], st.energy[:, E_TOT] + (
            k.energy[:, E_RECIP] - st.energy[:, E_RECIP]))
        if k_in == 0:
            assert torch.equal(k.amp_re[0], spec.fw_amp_re)
            assert torch.equal(k.amp_im[0], spec.fw_amp_im)


def test_launch_counts_and_refusals(tmp_path):
    """Each wrapper counts one launch per kernel launch on CUDA tensors
    (the step kernel one a step), and raises (no fallback) for a spec
    outside its kernel; two active species run the block kernel, and a
    per-replica activity (an isotherm sweep) runs the per-step path with
    the step kernel and the resync kernel."""
    dev = _device()
    _mixed_sizes(str(tmp_path))
    f32 = _load(str(tmp_path), dev, 16)
    states = replicate(f32.spec, f32.state, 2)
    n0 = resync_grouped.launches
    k = resync_grouped(f32.spec, states)
    assert resync_grouped.launches == n0 + 1
    # without the framework split the resync covers every type region
    p = resync_plain(f32.spec, states)
    torch.testing.assert_close(k.amp_re, p.amp_re, rtol=0, atol=AMP_TOL)
    torch.testing.assert_close(k.energy, p.energy, rtol=E_RTOL, atol=0.05)
    assert "block: CUDA whole-block kernel" in dispatch_report(f32.spec, dev)
    nb, ns, nr = (run_block_kernel.launches, run_steps_kernel.launches,
                  resync_grouped.launches)
    out = run_block_replicated(f32.spec, states, 5, False, True)
    assert run_block_kernel.launches == nb + 1
    assert run_steps_kernel.launches == ns
    assert resync_grouped.launches == nr + 1
    assert int(out.counters[:, 0].sum()) == 10
    sweep = perturb_activity(f32.spec, f32.spec.type_activity.expand(2, -1))
    u = _draw(sweep, 2, 5, 4)
    with pytest.raises(ValueError, match="per-replica activity"):
        run_block_kernel(sweep, states, u)
    # the main path on a spec outside the block kernel's gate: the per-step
    # path with the step kernel, the kernel resync, and the report says so
    assert "per-step path (per-replica activity" in dispatch_report(
        sweep, dev)
    nb, ns, nr = (run_block_kernel.launches, run_steps_kernel.launches,
                  resync_grouped.launches)
    out = run_block_sweep(sweep, states, 5, False, True)
    assert run_block_kernel.launches == nb
    assert run_steps_kernel.launches == ns + 5
    assert resync_grouped.launches == nr + 1
    assert int(out.counters[:, 0].sum()) == 10
    f64 = _load(str(tmp_path), dev, 16, dtype=torch.float64)
    st64 = replicate(f64.spec, f64.state, 2)
    with pytest.raises(ValueError, match="float32"):
        resync_grouped(f64.spec, st64)
    u64 = _draw(f64.spec, 2, 1, 6)
    with pytest.raises(ValueError, match="float32"):
        run_steps_kernel(f64.spec, st64, u64)


def _water(d, **kw):
    # the tests/test_reservoir.py fixture; its reservoir path is returned
    make_water_box(d, n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.2, 0.2, 0.6, 0.0), fugacity=2000.0, **kw)
    return make_water_reservoir(d, n_water=12)


@pytest.mark.parametrize("with_reservoir", [False, True],
                         ids=["no_split", "reservoir"])
def test_block_kernel_water_forms_match_plain(tmp_path, with_reservoir):
    """The block kernel's no-split form (a water box, every type active)
    and its reservoir form against the plain block: the same decisions,
    reservoir counts and extras; positions and reservoir rows within
    1e-4 A; box + reservoir + dropped molecules conserved."""
    dev = _device()
    res = _water(str(tmp_path))
    sysm = _load(str(tmp_path), dev, 16,
                 reservoir=res if with_reservoir else None)
    spec = sysm.spec
    assert not spec.fw_split and spec.has_reservoir == with_reservoir
    assert "block: CUDA whole-block kernel" in dispatch_report(spec, dev)
    states = replicate(spec, sysm.state, 8)
    u = _draw(spec, 8, 60, 11)
    n0 = run_block_kernel.launches
    k = _assert_block_parity(spec, states, u)
    assert run_block_kernel.launches == n0 + 1
    acc = k.counters[:, 1].sum(0)
    assert int(acc[0]) > 0 and int(acc[1]) > 0    # insertions and deletions
    if with_reservoir:
        total = (k.n_mol[:, 0] + k.res_n[:, 0] + k.extras[:, 1])
        assert torch.equal(total, states.n_mol[:, 0] + states.res_n[:, 0])
        assert not torch.equal(k.res_n, states.res_n)


def test_block_kernel_rejected_overlap_keeps_energies_finite(tmp_path):
    """An insertion onto molecule 0's sites (an LJ term that is not
    finite) is rejected by the block kernel as by the plain block, and the
    running energies stay as they were (tests/test_torch_moves.py)."""
    dev = _device()
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.25, 0.25, 0.5, 0.0), fugacity=5000.0)
    sysm = _load(str(tmp_path), dev, 16)
    spec, state = sysm.spec, sysm.state
    com0 = state.com[0, :, 0].double()
    frac = (com0 - spec.bounds[:, 0].double()) @ spec.Hinv.double().T
    u = torch.full((1, 1, 21), 0.37, dtype=torch.float32, device=dev)
    u[0, 0, :3] = torch.tensor([0.7, 0.25, 0.5])   # a creation; u_acc 0.5
    u[0, 0, 6:9] = frac.float()                    # molecule 0's COM
    u[0, 0, 15:17] = torch.tensor([0.0, 0.25])     # the identity rotation
    k = _assert_block_parity(spec, state, u)
    assert torch.equal(k.energy, state.energy)
    assert int(k.counters[0, 0, 0]) == 1 and int(k.counters[0, 1, 0]) == 0


def test_step_kernel_reservoir_matches_plain(tmp_path):
    """The whole-step kernel on the reservoir fixture: 40-step chains
    against the plain steps on the same uniforms, no divergence."""
    dev = _device()
    res = _water(str(tmp_path))
    sysm = _load(str(tmp_path), dev, 16, reservoir=res)
    spec = sysm.spec
    assert "step: CUDA per-step kernel" in dispatch_report(spec, dev)
    states = replicate(spec, sysm.state, 8)
    k = _assert_steps_parity(spec, states,
                             _draw(spec, 8, 40, 12), 0)
    assert not torch.equal(k.res_n, states.res_n)


def _zif_small(d):
    make_zif_like(d, n_cells=4, a=5.66, n_water=10, fugacity=50.0,
                  cutoff=6.0)


def _mixed_sizes(d):
    make_mixed_sizes(d, n_water=6, n_dimer=6, L=16.0, cutoff=5.0, tol=1e-4,
                     probs=(0.3, 0.2, 0.3, 0.2))


def _fw_mixed(d):
    # framework + two active species with the split (bench.py's mixed shape)
    make_framework_mixed(d, n_cells=3, a=5.66, n_water=3, n_dimer=3,
                         cutoff=5.0, tol=1e-4)


def _mixed_resv(d):
    # two species and a reservoir of both (tests/torch_parity.py's fixture)
    _mixed_sizes(d)
    return make_mixed_reservoir(d, n_water=4, n_dimer=4, L=16.0)


def _tricl(d):
    tiny_system(d, "tricl")


@pytest.mark.parametrize("make", [_fw_mixed, _mixed_sizes, _mixed_resv,
                                  _tricl],
                         ids=["fw_mixed", "mixed_sizes", "mixed_resv",
                              "tricl"])
def test_block_kernel_forms_match_plain(tmp_path, make):
    """The block kernel's two-species form (swaps; with the split, without
    it, and with a reservoir of both species) and its triclinic form
    against the plain block: phase 2's bounds, swaps tried and accepted
    where two species are active, box + reservoir + drops conserved."""
    dev = _device()
    res = make(str(tmp_path))
    sysm = _load(str(tmp_path), dev, 16, reservoir=res)
    spec = sysm.spec
    assert "block: CUDA whole-block kernel" in dispatch_report(spec, dev)
    states = replicate(spec, sysm.state, 8)
    u = _draw(spec, 8, 60, 13)
    n0 = run_block_kernel.launches
    k = _assert_block_parity(spec, states, u)
    assert run_block_kernel.launches == n0 + 1
    acc = k.counters[:, 1].sum(0)
    assert int(acc.sum()) > 0
    if spec.n_active > 1:
        assert int(k.counters[:, 0, 4].sum()) > 0 and int(acc[4]) > 0
    if res is not None:
        total = (k.n_mol[:, :-1].sum(1) + k.res_n[:, :-1].sum(1)
                 + k.extras[:, 1])
        assert torch.equal(total, states.n_mol[:, :-1].sum(1)
                           + states.res_n[:, :-1].sum(1))


@pytest.mark.parametrize("make", [_zif_small, _mixed_sizes, _tricl],
                         ids=["zif", "mixed_sizes", "tricl"])
def test_step_kernel_matches_plain(tmp_path, make):
    """One step, then 40-step chains of the whole-step kernel against the
    plain steps on the same uniforms, from a state 20 plain steps on: the
    same decisions, energies within 5 K, positions within 1e-4 A."""
    dev = _device()
    make(str(tmp_path))
    sysm = _load(str(tmp_path), dev, 16)
    spec = sysm.spec
    states = steps_plain(spec, replicate(spec, sysm.state, 8),
                         _draw(spec, 8, 20, 7))
    _assert_steps_parity(spec, states,
                         _draw(spec, 8, 1, 8), 0)
    k = _assert_steps_parity(spec, states,
                             _draw(spec, 8, 40, 9), 0)
    assert int(k.counters[:, 1].sum()) > 0


def test_resync_single_chain_matches_plain(tmp_path):
    """driver.resync_amplitudes launches the resync kernel at B = 1."""
    dev = _device()
    _zif_small(str(tmp_path))
    sysm = _load(str(tmp_path), dev, 16)
    st = steps_plain(sysm.spec, sysm.state,
                     _draw(sysm.spec, 1, 30, 10))
    n0 = resync_grouped.launches
    k = resync_amplitudes(sysm.spec, st)
    assert resync_grouped.launches == n0 + 1
    p = resync_plain(sysm.spec, st)
    torch.testing.assert_close(k.amp_re, p.amp_re, rtol=0, atol=AMP_TOL)
    torch.testing.assert_close(k.amp_im, p.amp_im, rtol=0, atol=AMP_TOL)
    torch.testing.assert_close(k.energy, p.energy, rtol=E_RTOL, atol=0.05)


def test_onehot_kernel_exact():
    """K5 reads the one-hot columns exactly (f32 FMA, no TF32), and the
    probe's stage 1 passes on the card."""
    dev = _device()
    x, oh, want = onehot_operands()
    n0 = onehot_product.launches
    got = onehot_product(torch.from_numpy(x).to(dev),
                         torch.from_numpy(oh).to(dev))
    assert onehot_product.launches == n0 + 1
    assert np.array_equal(got.cpu().numpy().astype(np.float64), want)
    ok, detail = probe_onehot_exact(dev)
    assert ok, detail


@pytest.mark.parametrize("op", VPU_OPS)
def test_vpu_chain_kernel_matches_plain(op):
    """K7 at the tool's (128, 1280) plane, n = 512, elementwise."""
    dev = _device()
    x = plane(128, 1280, dev)
    n0 = vpu_chain.launches
    k = vpu_chain(x, op, 512)
    assert vpu_chain.launches == n0 + 1
    torch.testing.assert_close(k, vpu_chain_plain(x, op, 512),
                               rtol=VPU_RTOL, atol=0)


@pytest.mark.parametrize("op", VPU_OPS)
def test_vpu_chain_kernel_matches_plain_at_the_range_ends(op):
    """K7 from the ends of vpu_chain's stated range [0, 2^64] and values
    between, n = 512, elementwise (the branch-free primitives' inputs stay
    in their domains from there)."""
    dev = _device()
    x = torch.tensor([0.0, 1e-30, 1e-3, 1.0, 7.5, 1e20, 2.0 ** 64],
                     dtype=torch.float32, device=dev)
    torch.testing.assert_close(vpu_chain(x, op, 512),
                               vpu_chain_plain(x, op, 512), rtol=VPU_RTOL,
                               atol=0)


@pytest.mark.parametrize("name", PRIMS)
def test_prim_check_finds_no_mismatch(name):
    """The exhaustive check of csrc/prims.cuh: every f32 in the
    primitive's domain gives the bits of the expression it replaces, and
    every value of the domain is checked."""
    dev = _device()
    lo, hi = PRIM_DOMAINS[name]
    n0 = prim_check.launches
    res = prim_check(name, dev)
    assert prim_check.launches == n0 + 1
    assert res["mismatches"] == 0, res
    assert res["checked"] == f32_bits(hi) - f32_bits(lo) + 1


@pytest.mark.parametrize("shape,n", [((128, 1280), 512), ((128, 1280), 1),
                                     ((128, 1280), 6), ((128, 1280), 7),
                                     ((128, 1280), 13), ((7, 1001), 512)],
                         ids=["default", "n1", "n6", "n7", "n13", "7x1001"])
@pytest.mark.parametrize("transposed", [False, True],
                         ids=["cpass", "cpassT"])
def test_cpass_kernel_matches_plain(transposed, shape, n):
    """K8 at the tool's (128, 1280) planes, n = 512, elementwise; also at n
    under one group of the seven offsets and across groups, and on rows
    that are not a multiple of a CTA's 256 elements."""
    dev = _device()
    ins = cpass_inputs(*shape, dev)
    n0 = cpass.launches
    k = cpass(*ins, n, transposed)
    assert cpass.launches == n0 + 1
    torch.testing.assert_close(k, cpass_plain(*ins, n, transposed),
                               rtol=CPASS_RTOL, atol=0)


@pytest.mark.parametrize("shape", [(64, 8 * 128), (61, 1000)],
                         ids=["default", "61x1000"])
@pytest.mark.parametrize("variant", GPASS_VARIANTS)
@pytest.mark.parametrize("fl", [2, 0], ids=["full", "coulomb"])
def test_gpass_kernel_matches_plain(variant, fl, shape):
    """K6 at G 64, 8 chunks, 10 steps, with its LJ rows and without them
    (whose closest pairs' terms would hide the Coulomb rows): the scalar
    within 1e-5 of the sum of |terms|; also at an S and a G S that are not
    multiples of a CTA's 128 pairs."""
    dev = _device()
    ins = gpass_inputs(*shape, fl, dev)
    n0 = gpass.launches
    k = float(gpass(*ins, 10, 6, variant))
    assert gpass.launches == n0 + 1
    assert abs(k - float(gpass_plain(*ins, 10, 6, variant))) \
        <= GPASS_RTOL * gpass_scale(*ins, 10, 6, variant)


@pytest.mark.parametrize("variant", GPASS_VARIANTS)
def test_gpass_kernel_is_deterministic(variant):
    """K6 sums its CTAs' partials in a fixed order: two calls on the tool's
    inputs (G 64, 47 chunks, 100 steps) give the same bits."""
    dev = _device()
    ins = gpass_inputs(64, 47 * 128, 2, dev)
    one, two = (gpass(*ins, 100, 6, variant) for _ in range(2))
    assert torch.equal(one, two), (float(one), float(two))


@pytest.mark.parametrize("shape", [(64, 8 * 128), (61, 1000)],
                         ids=["default", "61x1000"])
@pytest.mark.parametrize("variant", GPASS_VARIANTS)
def test_gpass_kernel_lj_rows_match_plain(variant, shape):
    """K6's LJ rows alone (FQ 0) at G 64, 8 chunks, 10 steps, on inputs
    whose eps and sigma^2 differ per row and whose sites all lie 2 A or
    more from the footprint: the sum of |terms| then comes from the typical
    pairs, and a planted LJ fault misses the bound more than 100 times over
    (tests/test_torch_microbench.py); also at G 61, S 1000."""
    dev = _device()
    ins = check_inputs(*shape, 2, 0, 10, dev)
    n0 = gpass.launches
    k = float(gpass(*ins, 10, 0, variant))
    assert gpass.launches == n0 + 1
    assert abs(k - float(gpass_plain(*ins, 10, 0, variant))) \
        <= GPASS_RTOL * gpass_scale(*ins, 10, 0, variant)


def _step_parity(spec, states, seed):
    """The whole-step kernel against the plain steps: one step, then
    40-step chains on the same uniforms, no divergence."""
    dev = states.pos.device
    _assert_steps_parity(spec, states,
                         _draw(spec, states.B, 1, seed), 0)
    _assert_steps_parity(spec, states, _draw(spec, states.B, 40, seed + 1),
                         0)


def _conserved(st):
    """Box + reservoir + dropped molecules per replica."""
    return (st.n_mol[:, :-1].sum(1) + st.res_n[:, :-1].sum(1)
            + st.extras[:, 1])


def _assert_steps_parity(spec, states, u, max_diverged):
    """run_steps_kernel against the plain steps (steps_plain) on the same
    uniforms, with PERF.md section 2's limits: decisions (populations,
    counters, extras, reservoir counts) identical on all but max_diverged
    replicas; on the rest positions, COMs and reservoir rows within 1e-4 A,
    energies within 5 K, the amplitudes the kernel committed within
    AMP_TOL max(1, max|A|) and E_RECIP within 1e-5 relative (chip_smoke.py
    phase 4's limits). The kernel launches once a step, leaves the input
    state as it was, keeps every energy finite and, with a reservoir,
    conserves box + reservoir + drops on every replica. Returns the
    kernel's state."""
    before = {name: v.clone() for name, v in vars(states).items()}
    n0 = run_steps_kernel.launches
    k = run_steps_kernel(spec, states, u)
    assert run_steps_kernel.launches == n0 + u.shape[1]
    for name, v in vars(states).items():
        assert torch.equal(v, before[name]), name
    p = steps_plain(spec, states, u)
    same = ((k.n_mol == p.n_mol).all(1)
            & (k.counters == p.counters).flatten(1).all(1)
            & (k.extras == p.extras).all(1) & (k.res_n == p.res_n).all(1))
    assert int((~same).sum()) <= max_diverged
    for name in ("pos", "com", "res_offset", "res_com"):
        diff = (getattr(k, name) - getattr(p, name))[same]
        assert float(diff.abs().max()) <= POS_TOL, name
    assert float((k.energy - p.energy)[same].abs().max()) <= ENERGY_TOL
    scale = max(1.0, float(torch.maximum(p.amp_re.abs(),
                                         p.amp_im.abs()).max()))
    for name in ("amp_re", "amp_im"):
        diff = (getattr(k, name) - getattr(p, name))[same]
        assert float(diff.abs().max()) <= AMP_TOL * scale, name
    e_k, e_p = k.energy[same, E_RECIP], p.energy[same, E_RECIP]
    assert float(((e_k - e_p).abs() / e_p.abs()).max()) <= 1e-5
    assert bool(torch.isfinite(k.energy).all())
    if spec.has_reservoir:
        assert torch.equal(_conserved(k), _conserved(states))
    return k


# tests/test_torch_stepg.py's CASES (the JAX parity fixtures), built here
# without jax
def _fw_water(d):
    make_framework_water(d, n_cells=2, a=8.0, n_water=6, cutoff=5.0,
                         tol=1e-4, probs=(0.3, 0.2, 0.5, 0.0),
                         fugacity=200.0)


def _mixed_sizes_stepg(d):
    make_mixed_sizes(d, n_water=6, n_dimer=6, L=16.0, cutoff=6.0, tol=1e-4,
                     probs=(0.2, 0.1, 0.3, 0.4), fug_w=500.0, fug_d=500.0)


def _water_gcmc(d):
    make_water_box(d, n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.3, 0.2, 0.5, 0.0), fugacity=20000.0)


def _fw_mixed_split_off(d):
    # tests/test_torch_reservoir.py's fixture: too small a framework for the
    # split, so the inactive framework keeps it outside the block kernel
    make_framework_mixed(d, n_cells=2, a=5.66, n_water=3, n_dimer=3)


@pytest.mark.parametrize("make,capacity", [
    (_fw_water, 12), (_fw_mixed, 12), (_mixed_sizes_stepg, 12),
    (_water_gcmc, 12), (_water, 16), (_tricl, 16), (_fw_mixed_split_off, 16)],
    ids=["fw_water", "fw_mixed", "mixed_sizes", "water_gcmc", "reservoir",
         "tricl", "split_off_inactive"])
def test_step_kernel_systems_match_plain(tmp_path, make, capacity):
    """The whole-step kernel at B = 64 x 50 steps against the plain steps
    on test_torch_stepg.py's four systems (capacity 12, as there), a
    reservoir water box, the triclinic box and a framework without the
    split (an inactive type, a form the block kernel does not take): at
    most 1 of 64 replicas diverged; moves accepted, swaps tried where two
    species are active."""
    dev = _device()
    res = make(str(tmp_path))
    sysm = _load(str(tmp_path), dev, capacity, reservoir=res)
    spec = sysm.spec
    report = dispatch_report(spec, dev)
    assert "step: CUDA per-step kernel" in report
    if make is _fw_mixed_split_off:
        assert not spec.fw_split
        assert "framework split off with inactive types" in report
    states = replicate(spec, sysm.state, 64)
    k = _assert_steps_parity(spec, states,
                             _draw(spec, 64, 50, 41), 1)
    assert int(k.counters[:, 1].sum()) > 0
    if spec.n_active > 1:
        assert int(k.counters[:, 0, 4].sum()) > 0


def test_step_kernel_activity_sweep_matches_plain(tmp_path):
    """A per-replica activity (8 levels x 8 replicas, the isotherm's spec)
    on the framework water system: the kernel reads each replica's table
    (activity stride R), B = 64 x 50 steps against the plain steps, and
    the populations grow with the activity."""
    dev = _device()
    _fw_water(str(tmp_path))
    sysm = _load(str(tmp_path), dev, 12)
    spec = sysm.spec
    scale = torch.tensor([0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0],
                         device=dev).repeat_interleave(8)
    sweep = perturb_activity(spec, spec.type_activity[None, :]
                             * scale[:, None])
    assert "step: CUDA per-step kernel" in dispatch_report(sweep, dev)
    states = replicate(spec, sysm.state, 64)
    k = _assert_steps_parity(sweep, states,
                             _draw(spec, 64, 50, 42), 1)
    n = k.n_mol[:, 1].float().reshape(8, 8).mean(1)
    assert float(n[-1]) > float(n[0])


def test_step_kernel_rejected_overlap_keeps_energies_finite(tmp_path):
    """The block test's overlapping insertion (onto molecule 0's sites)
    through the whole-step kernel: rejected as by the plain step, the
    running energies unchanged."""
    dev = _device()
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.25, 0.25, 0.5, 0.0), fugacity=5000.0)
    sysm = _load(str(tmp_path), dev, 16)
    spec, state = sysm.spec, sysm.state
    com0 = state.com[0, :, 0].double()
    frac = (com0 - spec.bounds[:, 0].double()) @ spec.Hinv.double().T
    u = torch.full((1, 1, 21), 0.37, dtype=torch.float32, device=dev)
    u[0, 0, :3] = torch.tensor([0.7, 0.25, 0.5])   # a creation; u_acc 0.5
    u[0, 0, 6:9] = frac.float()                    # molecule 0's COM
    u[0, 0, 15:17] = torch.tensor([0.0, 0.25])     # the identity rotation
    k = _assert_steps_parity(spec, state, u, 0)
    assert torch.equal(k.energy, state.energy)
    assert int(k.counters[0, 0, 0]) == 1 and int(k.counters[0, 1, 0]) == 0


def test_far_field_ragged_rows_kernels_match_plain(tmp_path):
    """A slit pore (12 x 12 x 30 A, the split on): far rows of uneven
    lengths and kz2 = 31, the largest order the kernels take. K2 against
    the plain block, and K3 against the plain core."""
    dev = _device()
    make_slit_pore(str(tmp_path), fugacity=500.0)
    sysm = _load(str(tmp_path), dev, 16)
    spec = sysm.spec
    assert spec.fw_split and spec.kmax2_xyz[2] == 31
    lens = spec.far_rows[:, 3].cpu()
    assert len(set(lens[lens > 0].tolist())) > 5
    states = replicate(spec, sysm.state, 8)
    u = _draw(spec, 8, 60, 21)
    k1 = _assert_block_parity(spec, states, u)
    assert int(k1.counters[:, 1].sum()) > 0
    _step_parity(spec, steps_plain(spec, states, u), 23)


def test_guest_cutoff_off_kernels_match_plain(tmp_path):
    """tests/test_ggsplit.py's water box with guest_split off: the
    kernels' gg_cut == 0 branch (every mobile pair's erfc(alpha r)/r)
    against the plain path, K2 and K3."""
    dev = _device()
    make_water_box(str(tmp_path), n_water=24, L=24.0, cutoff=8.0,
                   ewald_alpha=0.5, fugacity=40000.0,
                   probs=(0.3, 0.2, 0.5, 0.0), guest_split="off")
    sysm = _load(str(tmp_path), dev, 32)
    spec = sysm.spec
    assert not spec.gg_cut
    states = replicate(spec, sysm.state, 8)
    u = _draw(spec, 8, 60, 31)
    k = _assert_block_parity(spec, states, u)
    assert int(k.counters[:, 1].sum()) > 0
    _step_parity(spec, k, 33)


def test_launch_path_refills_and_refuses():
    """The launchers' tables are refilled on every call: K5 on changing
    operands stays exact each time; the empty kernel takes tables of any
    length; a launch the kernel refuses raises, and the next one runs."""
    dev = _device()
    x, oh, want = onehot_operands()
    xt, oht = torch.from_numpy(x).to(dev), torch.from_numpy(oh).to(dev)
    for k in range(4):
        got = onehot_product(xt[:, k:].contiguous() * (k + 1),
                             oht[k:].contiguous())
        ref = (x[:, k:] * np.float32(k + 1)).astype(np.float64) @ oh[k:]
        assert np.array_equal(got.cpu().numpy().astype(np.float64), ref)
    for n in (0, 3, 60):
        build.launch("noop_launch", [xt.data_ptr()] * n, [1] * n, [2.0] * n,
                     xt.device)
    with pytest.raises(RuntimeError, match="onehot_launch failed"):
        build.launch("onehot_launch", [xt.data_ptr(), oht.data_ptr(),
                                       xt.data_ptr()], [0, 256, 8], [],
                     xt.device)
    torch.cuda.synchronize()
    assert np.array_equal(onehot_product(xt, oht).cpu().numpy(), want)


def test_launch_refuses_tensors_off_the_current_device(tmp_path):
    """The kernels launch on the current CUDA device, so a launch whose
    tensors lie elsewhere raises before it runs and no device is switched:
    the host's tensors, a card index that is not the current one and, on a
    machine with two cards, K5 on cuda:1 while cuda:0 is current. Then
    load_system(device="cuda:0") and one replicated block still launch the
    threefry and block kernels."""
    dev = _device()
    current = torch.cuda.current_device()
    x, oh, want = onehot_operands()
    xt, oht = torch.from_numpy(x), torch.from_numpy(oh)
    ptrs = [xt.data_ptr(), oht.data_ptr(), xt.data_ptr()]
    for where in (torch.device("cpu"), torch.device("cuda", current + 1)):
        with pytest.raises(RuntimeError, match="current CUDA device"):
            build.launch("onehot_launch", ptrs, [8, 256, 8], [], where)
    if torch.cuda.device_count() > 1:
        other = torch.device("cuda",
                             (current + 1) % torch.cuda.device_count())
        with pytest.raises(RuntimeError, match="current CUDA device"):
            onehot_product(xt.to(other), oht.to(other))
    assert torch.cuda.current_device() == current
    torch.cuda.set_device(0)
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.3, 0.2, 0.5, 0.0), fugacity=5000.0)
    sysm = _load(str(tmp_path), "cuda:0", 16)
    n_blk, n_tf = run_block_kernel.launches, split_uniform.launches
    out = run_block_replicated(sysm.spec, replicate(sysm.spec, sysm.state,
                                                    8), 20, True)
    assert run_block_kernel.launches == n_blk + 1
    assert split_uniform.launches == n_tf + 1
    assert out.pos.device == torch.device("cuda", 0)
    assert bool(torch.isfinite(out.energy).all())
    assert np.array_equal(onehot_product(torch.from_numpy(x).to(dev),
                                         torch.from_numpy(oh).to(dev))
                          .cpu().numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_threefry_kernel_matches_plain(dtype):
    """csrc/threefry.cu (split_uniform, one launch) against its plain
    version on the same keys: the next keys and every uniform with the same
    bits, on split keys and on edge keys (all-zero and all-one words)."""
    dev = _device()
    keys = split(prng_key(2**32 + 77), 70).to(dev)
    keys[0] = 0
    keys[1] = 0xFFFFFFFF
    keys[2, 0] = 0xFFFFFFFF
    n0 = split_uniform.launches
    new, u = split_uniform(keys, 400, dtype)
    assert split_uniform.launches == n0 + 1
    want_new, want_u = split_uniform_plain(keys, 400, dtype)
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(new, want_new)
    assert u.shape == want_u.shape == (70, 400, 21)
    assert torch.equal(u.view(bits), want_u.view(bits))


def test_block_kernel_rejected_overlap_keeps_energies(tmp_path):
    """K2 on the overlapping creation of tests/test_torch_moves.py (onto
    molecule 0, the identity rotation, u_acc 0.5; the water box, f32,
    capacity 16): one creation trial, none accepted, and the six energies
    finite and equal to the loaded ones, as JAX's blockg and the plain
    block give them there."""
    dev = _device()
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.25, 0.25, 0.5, 0.0), fugacity=5000.0)
    sysm = _load(str(tmp_path), dev, 16)
    spec, state = sysm.spec, sysm.state
    com0 = state.com[0, :, 0].double()
    frac = (com0 - spec.bounds[:, 0].double()) @ spec.Hinv.double().T
    row = torch.full((21,), 0.37, dtype=torch.float32, device=dev)
    row[0], row[1], row[2] = 0.7, 0.25, 0.5
    row[6:9] = frac.float()
    row[15], row[16] = 0.0, 0.25
    n0 = run_block_kernel.launches
    out = run_block_kernel(spec, state, row[None, None].contiguous())
    assert run_block_kernel.launches == n0 + 1
    assert int(out.counters[0, 0, 0]) == 1
    assert int(out.counters[0, 1].sum()) == 0
    assert bool(torch.isfinite(out.energy).all())
    assert torch.equal(out.energy, state.energy)


def test_step_kernel_f32_delta_e_envelope():
    """chip_smoke.py phase 15a's envelope through the step kernel
    (tools/delta_e_report: the flagship chemistry, 64 replicas from seed 3,
    200 steps, one launch a step): every accepted move's f32 running dE
    against an f64 recompute on the card, within tests/test_precision.py's
    bounds (max 5e-4, mean 1e-4 kcal/mol)."""
    from maniac_tpu_torch.tools.delta_e_report import measure
    _device()
    run_steps_kernel.launches = 0
    rep = measure(200, 3, False, "cuda", 64, "step")
    assert run_steps_kernel.launches == 200
    assert rep["accepted_moves"] > 20
    assert rep["max_abs_dE_err_kcalmol"] < 5e-4, rep
    assert rep["mean_abs_dE_err_kcalmol"] < 1e-4, rep
    assert not torch.backends.cuda.matmul.allow_tf32


def test_block_kernel_bigs_matches_plain():
    """bench.py's bigS (2000 waters in a 40 A box at the bench's capacity,
    2500: S 10240, K 12288, no framework split): the block kernel against
    the plain steps at B = 4 x 20 steps on the same uniforms, decisions
    identical, positions within POS_TOL, and energies within
    bench.energy_bound: 5 K plus one f32 ulp of each component's load-time
    magnitude per accepted step (its Coulomb components are some 1.2e8 K,
    where an ulp is 8 K, and every accepted delta is added to them)."""
    from maniac_tpu_torch import bench
    dev = _device()
    sysm = bench.load("bigS", dev)
    spec = sysm.spec
    assert (spec.S, spec.K) == (10240, 12288)
    assert "block: CUDA whole-block kernel" in dispatch_report(spec, dev)
    states = replicate(spec, sysm.state, 4)
    u = _draw(spec, 4, 20, 5)
    k, p = run_block_kernel(spec, states, u), steps_plain(spec, states, u)
    torch.testing.assert_close(k.n_mol, p.n_mol, rtol=0, atol=0)
    torch.testing.assert_close(k.counters, p.counters, rtol=0, atol=0)
    torch.testing.assert_close(k.extras, p.extras, rtol=0, atol=0)
    assert float((k.pos - p.pos).abs().max()) <= POS_TOL
    assert float((k.com - p.com).abs().max()) <= POS_TOL
    accepted = (k.counters[:, 1] - states.counters[:, 1]).sum(1)
    assert int(accepted.sum()) > 0
    bound = bench.energy_bound(sysm.state.energy[0], accepted)
    assert bool(((k.energy - p.energy).double().abs() <= bound).all())
