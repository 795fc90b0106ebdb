"""maniac_tpu_torch CUDA kernels against their plain torch versions, on a
card. Every test here needs a CUDA device and skips without one.

The file imports no jax (the machine with the card has none), so it runs
without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import ctypes
import dataclasses
import functools
import math
import tempfile

import numpy as np
import pytest
import torch

from box_lengths import BOX_SYSTEMS, box_lengths
from frozen_tiles import kept_share
from zero_uniform import creation_rows
from maniac_tpu_torch import (bench, load_system, replicate,
                              run_block_replicated)
from maniac_tpu_torch.kernels import (IMAGE_REACH_BOXES, dispatch_report,
                                      image_thresholds)
from maniac_tpu_torch.kernels.blockg import run_block_kernel
from maniac_tpu_torch.kernels.gpass import (GPASS_RTOL, GPASS_VARIANTS,
                                            gpass, gpass_plain, gpass_scale)
from maniac_tpu_torch.kernels.hwprobe import onehot_product
from maniac_tpu_torch.kernels.resync import resync_grouped, resync_plain
from maniac_tpu_torch.kernels.stepg import run_steps_kernel
from maniac_tpu_torch.kernels.vpu import (CPASS_RTOL, PRIM_DOMAINS, PRIMS,
                                          VPU_OPS, VPU_RTOL, cpass,
                                          cpass_plain, f32_bits, image_check,
                                          prim_check, prim_check_plain,
                                          vpu_chain, vpu_chain_plain)
from maniac_tpu_torch.kernels.threefry import (split_uniform,
                                               split_uniform_plain)
from maniac_tpu_torch.mc.driver import (block_body_u, draw_uniforms,
                                        drift_report, resync_amplitudes,
                                        sentinel_check, sentinel_passed,
                                        steps_plain)
from maniac_tpu_torch.parallel.replicas import (perturb_activity,
                                                run_block_sweep,
                                                run_block_uniforms)
from maniac_tpu_torch.physics.energy import (active_site_mask,
                                             full_amplitudes, recip_energy,
                                             site_positions)
from maniac_tpu_torch.kernels import build
from maniac_tpu_torch.system import (E_COUL, E_INTRA, E_LJ, E_RECIP, E_SELF,
                                     E_TOT, to_device)
from maniac_tpu_torch.systems import (make_framework_mixed,
                                      make_framework_water,
                                      make_mixed_reservoir, make_mixed_sizes,
                                      make_slit_pore, make_water_box,
                                      make_water_reservoir, make_zif_like,
                                      tiny_system)
from maniac_tpu_torch.tools import gpass_bench
from maniac_tpu_torch.tools.gpass_bench import check_inputs
from maniac_tpu_torch.tools.gpass_bench import inputs as gpass_inputs
from maniac_tpu_torch.tools.kernel_times import isotherm_spec
from maniac_tpu_torch.tools.micro_times import (CPASS_FORMS, GROWTH_MIN,
                                                PAIR_VARIANTS, growth)
from maniac_tpu_torch.tools.resync_times import SYSTEMS as RESYNC_SYSTEMS
from maniac_tpu_torch.tools.resync_times import (edge_replicas, load_cell,
                                                 replica)
from maniac_tpu_torch.tools.vpu_bench import cpass_inputs, plane
from maniac_tpu_torch.utils.hwprobe import (hw_precision_check,
                                            onehot_operands,
                                            probe_onehot_exact)
from maniac_tpu_torch.utils import trace
from maniac_tpu_torch.utils.threefry import prng_key, split, uniform

pytestmark = pytest.mark.gpu

# tests/test_blockg.py's bounds: decisions identical, positions to f32 ulp,
# running energies summed in another order
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
    7, 64 and 1024 (each a tiling of its own on the water boxes), and the
    small framework fixture at B = 8."""
    return [(name, B) for name in RESYNC_SYSTEMS
            for B in (1, 7, 64, 1024)] + [
        ("zif_small", 8)]


@pytest.mark.parametrize("system,B", _resync_cases())
def test_resync_kernel_matches_plain(tmp_path, system, B):
    """The resync kernel against its plain version: amplitudes within
    AMP_TOL, E_RECIP within E_RTOL relative. The small framework fixture
    after 30 plain steps at B = 8 (every energy within E_RTOL relative and
    0.05 K); bench.py's four systems after 10 plain steps with the edge
    replicas (no guests, every covered type at capacity, a charged-site
    count that is not a multiple of the kernel's chunk; at B = 1 each
    alone, and a fourth), where the guests' LJ and real-space Coulomb stay
    as they came in and a replica without guests takes the frozen sites'
    own (spec.fw_pair_energy), E_SELF and E_INTRA (from the populations)
    are the plain version's bit for bit, E_TOT is the sum of the five, the
    replica without guests holds fw_amp exactly, and two launches on one
    input give the same bits."""
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
        k = _resync_twice(spec, st, k_in == 0)
        p = resync_plain(spec, st)
        torch.testing.assert_close(k.amp_re, p.amp_re, rtol=0, atol=AMP_TOL)
        torch.testing.assert_close(k.amp_im, p.amp_im, rtol=0, atol=AMP_TOL)
        torch.testing.assert_close(k.energy[:, E_RECIP],
                                   p.energy[:, E_RECIP], rtol=E_RTOL, atol=0)
        pair = [E_LJ, E_COUL]
        guests = st.n_mol[:, spec.active_type_ids.long()].sum(1) > 0
        assert torch.equal(k.energy[:, pair], torch.where(
            guests[:, None], st.energy[:, pair], spec.fw_pair_energy))
        assert torch.equal(k.energy[:, E_SELF], p.energy[:, E_SELF])
        assert torch.equal(k.energy[:, E_INTRA], p.energy[:, E_INTRA])
        e = k.energy
        assert torch.equal(e[:, E_TOT], e[:, E_RECIP] + e[:, E_LJ]
                           + e[:, E_COUL] + e[:, E_SELF] + e[:, E_INTRA])


def _resync_twice(spec, st, edges):
    """K1 on ``st`` launched twice, which must give the same bits; with
    ``edges`` (edge_replicas' first batch) replica 0, which has no guests,
    holds fw_amp exactly. Returns the result."""
    k, again = resync_grouped(spec, st), resync_grouped(spec, st)
    for f in ("amp_re", "amp_im", "energy"):
        assert torch.equal(getattr(k, f), getattr(again, f)), f
    if edges:
        assert torch.equal(k.amp_re[0], spec.fw_amp_re)
        assert torch.equal(k.amp_im[0], spec.fw_amp_im)
    return k


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
    n0 = trace.counters()
    k = resync_grouped(f32.spec, states)
    assert build.launch_counts(n0)["resync"] == 1
    # without the framework split the resync covers every type region
    p = resync_plain(f32.spec, states)
    torch.testing.assert_close(k.amp_re, p.amp_re, rtol=0, atol=AMP_TOL)
    torch.testing.assert_close(k.energy, p.energy, rtol=E_RTOL, atol=0.05)
    assert "block: CUDA whole-block kernel" in dispatch_report(f32.spec, dev)
    n0 = trace.counters()
    out = run_block_replicated(f32.spec, states, 5, False, True)
    assert build.launch_counts(n0)["blockg"] == 1
    assert build.launch_counts(n0)["stepg"] == 0
    assert build.launch_counts(n0)["resync"] == 1
    assert int(out.counters[:, 0].sum()) == 10
    sweep = perturb_activity(f32.spec, f32.spec.type_activity.expand(2, -1))
    u = _draw(sweep, 2, 5, 4)
    with pytest.raises(ValueError, match="per-replica activity"):
        run_block_kernel(sweep, states, u)
    # the main path on a spec outside the block kernel's gate: the per-step
    # path with the step kernel, the kernel resync, and the report says so
    assert "per-step path (per-replica activity" in dispatch_report(
        sweep, dev)
    n0 = trace.counters()
    out = run_block_sweep(sweep, states, 5, False, True)
    assert build.launch_counts(n0)["blockg"] == 0
    assert build.launch_counts(n0)["stepg"] == 5
    assert build.launch_counts(n0)["resync"] == 1
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
    n0 = trace.counters()
    k = _assert_block_parity(spec, states, u)
    assert build.launch_counts(n0)["blockg"] == 1
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
    n0 = trace.counters()
    k = _assert_block_parity(spec, states, u)
    assert build.launch_counts(n0)["blockg"] == 1
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


@pytest.mark.parametrize("n_cells", [6, 8], ids=["flagship", "two_passes"])
def test_frozen_tile_cull_matches_plain(tmp_path, n_cells):
    """K2 and K3 on make_zif_like frameworks, where a move reaches under
    half of the frozen tiles (tiles_in_reach at the loaded guests), against
    the plain steps on the same uniforms: K2's 60 steps at B = 8 with
    _assert_block_parity's bounds, K3's one step and then 40 with
    _assert_steps_parity's, no replica diverged. bench.py's flagship (some
    2,160 sites in a 34 A box, 135 tiles), and 8 cells a side (5,120 sites,
    320 tiles), which the kernels test in two passes of FW_PASS = 256."""
    dev = _device()
    if n_cells == 6:
        sysm = _bench_cell("flagship")
    else:
        make_zif_like(str(tmp_path), n_cells=n_cells, a=5.66, n_water=32,
                      fugacity=30.0)
        sysm = _load(str(tmp_path), dev, 64)
    spec = sysm.spec
    assert spec.fw_split and spec.far_units.shape[0] > 0
    assert (spec.fw_tile_box.shape[0] > 256) == (n_cells == 8)
    assert 0.0 < kept_share(spec, sysm.state) < 0.5
    states = replicate(spec, sysm.state, 8)
    k = _assert_block_parity(spec, states, _draw(spec, 8, 60, 31))
    assert int(k.counters[:, 1].sum()) > 0
    _step_parity(spec, states, 32)


def test_resync_single_chain_matches_plain(tmp_path):
    """driver.resync_amplitudes launches the resync kernel at B = 1."""
    dev = _device()
    _zif_small(str(tmp_path))
    sysm = _load(str(tmp_path), dev, 16)
    st = steps_plain(sysm.spec, sysm.state,
                     _draw(sysm.spec, 1, 30, 10))
    n0 = trace.counters()
    k = resync_amplitudes(sysm.spec, st)
    assert build.launch_counts(n0)["resync"] == 1
    p = resync_plain(sysm.spec, st)
    torch.testing.assert_close(k.amp_re, p.amp_re, rtol=0, atol=AMP_TOL)
    torch.testing.assert_close(k.amp_im, p.amp_im, rtol=0, atol=AMP_TOL)
    torch.testing.assert_close(k.energy, p.energy, rtol=E_RTOL, atol=0.05)


def test_onehot_kernel_exact():
    """K5 reads the one-hot columns exactly (f32 FMA, no TF32), and the
    probe's stage 1 passes on the card."""
    dev = _device()
    x, oh, want = onehot_operands()
    n0 = trace.counters()
    got = onehot_product(torch.from_numpy(x).to(dev),
                         torch.from_numpy(oh).to(dev))
    assert build.launch_counts(n0)["onehot"] == 1
    assert np.array_equal(got.cpu().numpy().astype(np.float64), want)
    ok, detail = probe_onehot_exact(dev)
    assert ok, detail


@pytest.mark.parametrize("op", VPU_OPS)
def test_vpu_chain_kernel_matches_plain(op):
    """K7 at the tool's (128, 1280) plane, n = 512, elementwise."""
    dev = _device()
    x = plane(128, 1280, dev)
    n0 = trace.counters()
    k = vpu_chain(x, op, 512)
    assert build.launch_counts(n0)["vpu_chain"] == 1
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
    every value of the domain is checked; the plain version of the check
    on the card finds the same."""
    dev = _device()
    lo, hi = PRIM_DOMAINS[name]
    n0 = trace.counters()
    res = prim_check(name, dev)
    assert build.launch_counts(n0)["prim_check"] == 1
    assert res["mismatches"] == 0, res
    assert res["checked"] == f32_bits(hi) - f32_bits(lo) + 1
    plain = prim_check_plain(name, device=dev)
    assert plain["mismatches"] == 0, plain
    assert plain["checked"] == res["checked"]


@pytest.mark.parametrize("case", ["30.0", *BOX_SYSTEMS])
def test_image_check_finds_no_mismatch(case, tmp_path):
    """The exhaustive check of the kernels' minimum image without a
    division (csrc/common.cuh min_image_axis): every f32 |dx| <= t3 and its
    negative give the bits of dx - L rintf(dx / L), for L = 30 and the box
    lengths of the test and bench systems."""
    dev = _device()
    lengths = [30.0] if case == "30.0" else box_lengths(case, tmp_path)
    for length in lengths:
        n0 = trace.counters()
        res = image_check(length, dev)
        assert build.launch_counts(n0)["prim_check"] == 1
        assert res["mismatches"] == 0, (length, res)
        assert res["checked"] == 2 * (
            f32_bits(image_thresholds(length)[2]) + 1)


def test_spec_past_the_image_domain_is_refused_on_the_card(tmp_path):
    """A spec the kernels take whose sites reach past their minimum image
    (kernels.image_failure) is refused where it is moved onto the card,
    and the block and step kernels raise on it: neither the kernels nor
    the plain path run it there."""
    dev = _device()
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=6.0)
    host = _load(tmp_path, "cpu", 16).spec
    L = host.host_box[1]
    reach = (host.image_reach[0], IMAGE_REACH_BOXES * L * 1.01,
             host.image_reach[2])
    with pytest.raises(ValueError, match="along y"):
        to_device(dataclasses.replace(host, image_reach=reach), dev,
                  torch.float32)
    sysm = _load(tmp_path, dev, 16)
    far = dataclasses.replace(sysm.spec, image_reach=reach)
    states = replicate(sysm.spec, sysm.state, 4)
    u = _draw(sysm.spec, 4, 2, 5)
    for run in (run_block_kernel, run_steps_kernel):
        with pytest.raises(ValueError, match="minimum image"):
            run(far, states, u)


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
    n0 = trace.counters()
    k = cpass(*ins, n, transposed)
    assert build.launch_counts(n0)["cpass"] == 1
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
    n0 = trace.counters()
    k = float(gpass(*ins, 10, 6, variant))
    assert build.launch_counts(n0)["gpass"] == 1
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
    n0 = trace.counters()
    k = float(gpass(*ins, 10, 0, variant))
    assert build.launch_counts(n0)["gpass"] == 1
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
    AMP_TOL max(1, max|A|) and E_RECIP within 1e-5 relative. The kernel
    launches once a step, leaves the input state as it was, keeps every
    energy finite and, with a reservoir, conserves box + reservoir + drops
    on every replica. Returns the kernel's state."""
    before = {name: v.clone() for name, v in vars(states).items()}
    n0 = trace.counters()
    k = run_steps_kernel(spec, states, u)
    assert build.launch_counts(n0)["stepg"] == u.shape[1]
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
    n0 = trace.counters()
    out = run_block_replicated(sysm.spec, replicate(sysm.spec, sysm.state,
                                                    8), 20, True)
    assert build.launch_counts(n0)["blockg"] == 1
    assert build.launch_counts(n0)["threefry"] == 1
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
    n0 = trace.counters()
    new, u = split_uniform(keys, 400, dtype)
    assert build.launch_counts(n0)["threefry"] == 1
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
    n0 = trace.counters()
    out = run_block_kernel(spec, state, row[None, None].contiguous())
    assert build.launch_counts(n0)["blockg"] == 1
    assert int(out.counters[0, 0, 0]) == 1
    assert int(out.counters[0, 1].sum()) == 0
    assert bool(torch.isfinite(out.energy).all())
    assert torch.equal(out.energy, state.energy)


@pytest.mark.parametrize("kernel", ["block", "step"])
def test_kernels_take_no_move_of_probability_zero_at_a_zero_uniform(
        tmp_path, kernel):
    """K2 and K3 on tests/zero_uniform.py's two creations at u_acc 0.0:
    the one whose exp(-dE / T) underflows to 0 is rejected and the one of
    positive probability accepted, as by the plain step (the strict rule
    u_acc < p_acc)."""
    dev = _device()
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.25, 0.25, 0.5, 0.0), fugacity=5000.0)
    sysm = _load(str(tmp_path), dev, 16)
    spec, state = sysm.spec, sysm.state
    states = replicate(spec, state, 2)
    u = creation_rows(spec, state)
    k = (_assert_block_parity(spec, states, u) if kernel == "block"
         else _assert_steps_parity(spec, states, u, 0))
    assert k.counters[:, 0, 0].tolist() == [1, 1]
    assert k.counters[:, 1, 0].tolist() == [0, 1]
    assert torch.equal(k.energy[0], state.energy[0])


def test_step_kernel_f32_delta_e_envelope():
    """The f32 dE envelope through the step kernel (tools/delta_e_report:
    the flagship chemistry, 64 replicas from seed 3, 200 steps, one launch
    a step): every accepted move's f32 running dE against an f64
    recompute on the card, within tests/test_precision.py's bounds (max
    5e-4, mean 1e-4 kcal/mol)."""
    from maniac_tpu_torch.tools.delta_e_report import measure
    _device()
    n0 = trace.counters()
    rep = measure(200, 3, False, "cuda", 64, "step")
    assert build.launch_counts(n0)["stepg"] == 200
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


def _bench_config(name, d, dev, seed=2 ** 33 + 11):
    """The benchmark's configuration ``name`` (portbench/configs), written
    by its writer from ``seed`` and loaded on the card in float32."""
    from portbench import run
    cfg = run.read_json(run.PKG / "configs" / f"{name}.json")
    files, _ = run.write_files(cfg, seed, str(d))
    return load_system(files["input"], files["data"], files["params"],
                       capacity=cfg["capacity"], dtype=torch.float32,
                       device=dev, seed=seed)


BENCH_FORMS = {"spce750": "single", "flue_slit": "multi_tiles"}


@pytest.mark.parametrize("name", sorted(BENCH_FORMS))
def test_kernels_match_plain_on_the_benchmark_configs(tmp_path, name):
    """K2 (the no-split form on spce750, the frozen-prefix two-species form
    on the graphite slit) and K3 against the plain steps on the benchmark's
    configurations, B = 8, on the same uniforms: K2's 60 steps with the
    same decisions, positions within POS_TOL and energies within
    bench.energy_bound; K3's 40 steps with _assert_steps_parity's limits,
    no replica diverged. Moves accepted, swaps tried on the slit."""
    from maniac_tpu_torch import bench
    from maniac_tpu_torch.kernels import blockg
    dev = _device()
    sysm = _bench_config(name, tmp_path, dev)
    spec = sysm.spec
    assert blockg.form(spec) == BENCH_FORMS[name]
    states = replicate(spec, sysm.state, 8)
    u = _draw(spec, 8, 60, 21)
    k, p = run_block_kernel(spec, states, u), steps_plain(spec, states, u)
    assert bool(bench.same_decisions(k, p).all())
    accepted = (k.counters[:, 1] - states.counters[:, 1]).sum(1)
    assert int(accepted.sum()) > 0
    pos_err, _, e_ok = bench.block_errors(
        k, p, bench.same_decisions(k, p),
        bench.energy_bound(sysm.state.energy[0], accepted))
    assert pos_err <= POS_TOL and e_ok
    if spec.n_active > 1:
        assert int(k.counters[:, 0, 4].sum()) > 0
    ks = _assert_steps_parity(spec, states, _draw(spec, 8, 40, 22), 0)
    assert int(ks.counters[:, 1].sum()) > 0


def _cluster_case(name, d, dev):
    """A loaded system of each of K3's forms: the benchmark's three
    configurations (the no-split, frozen-tiles and far_tiles forms) and the
    triclinic box."""
    if name == "tricl":
        _tricl(str(d))
        return _load(str(d), dev, 16)
    return _bench_config(name, d, dev)


CLUSTER_FORMS = {"spce750": "single", "flue_slit": "multi_tiles",
                 "nacl001_h2o": "far_tiles", "tricl": "tricl"}


@pytest.mark.parametrize("name", sorted(CLUSTER_FORMS))
def test_step_kernel_cluster_matches_one_cta(tmp_path, name):
    """K3's cluster form (a replica's step on stepg.CLUSTER CTAs) against
    its one-CTA form, pinned through stepg._run's private keyword, at B =
    1 on the same state and uniforms for 400 steps: each step runs both
    forms from the one-CTA chain's state, and at most one of the 400 steps
    takes another decision (a near tie: the sums are taken in another
    order); on the others the energies agree within 1e-5 relative,
    positions, COMs and reservoir rows within POS_TOL and amplitudes
    within AMP_TOL max(1, max|A|), as _assert_steps_parity's. Each launch
    counts as its form's stepg.cluster.<CTAs>."""
    from maniac_tpu_torch.kernels import blockg, stepg
    dev = _device()
    sysm = _cluster_case(name, tmp_path, dev)
    spec = sysm.spec
    assert blockg.form(spec) == CLUSTER_FORMS[name]
    one = replicate(spec, sysm.state, 1)
    u = _draw(spec, 1, 400, 51)
    n0 = trace.counters()
    diverged, accepted = 0, 0
    for k in range(u.shape[1]):
        uk = u[:, k:k + 1].contiguous()
        c = stepg._run(spec, one, uk, _cluster=stepg.CLUSTER)
        o = stepg._run(spec, one, uk, _cluster=1)
        same = (torch.equal(c.n_mol, o.n_mol)
                and torch.equal(c.counters, o.counters)
                and torch.equal(c.extras, o.extras)
                and torch.equal(c.res_n, o.res_n))
        if not same:
            diverged += 1
        else:
            gap = (c.energy - o.energy).abs()
            assert bool((gap <= 1e-5 * o.energy.abs().clamp_min(1.0)).all())
            for field in ("pos", "com", "res_offset", "res_com"):
                diff = getattr(c, field) - getattr(o, field)
                assert float(diff.abs().max()) <= POS_TOL, field
            scale = max(1.0, float(torch.maximum(o.amp_re.abs(),
                                                 o.amp_im.abs()).max()))
            for field in ("amp_re", "amp_im"):
                diff = getattr(c, field) - getattr(o, field)
                assert float(diff.abs().max()) <= AMP_TOL * scale, field
        accepted += int((o.counters[:, 1] - one.counters[:, 1]).sum())
        one = o
    assert diverged <= 1
    assert accepted > 0
    moved = trace.since(n0)
    assert moved[f"stepg.cluster.{stepg.CLUSTER}"] == 400
    assert moved["stepg.cluster.1"] == 400
    assert build.launch_counts(n0)["stepg"] == 800


@pytest.mark.parametrize("B", [1, 16])
def test_step_kernel_cluster_ctas_run_on_distinct_sms(tmp_path, B):
    """Each cluster's stepg.CLUSTER CTAs run on as many SMs (%smid, from
    the library built with -DMANIAC_CLUSTER_SMID), at B = 1 and at 16, the
    most replicas whose clusters of 8 fit the H100's 132 SMs at once."""
    from maniac_tpu_torch.kernels import stepg
    dev = _device()
    _water(str(tmp_path))
    sysm = _load(str(tmp_path), dev, 16)
    spec = sysm.spec
    states = replicate(spec, sysm.state, B)
    smid = np.full(1024, -1, dtype=np.int32)
    with build.variant(("MANIAC_CLUSTER_SMID",)) as lib:
        lib.maniac_cluster_smids.argtypes = [ctypes.c_void_p, ctypes.c_int]
        stepg._run(spec, states, _draw(spec, B, 1, 52),
                   _cluster=stepg.CLUSTER)
        torch.cuda.synchronize()
        assert lib.maniac_cluster_smids(smid.ctypes.data, smid.size) == 0
    per_replica = smid[:B * stepg.CLUSTER].reshape(B, stepg.CLUSTER)
    assert bool((per_replica >= 0).all())
    for row in per_replica:
        assert len(set(row.tolist())) == stepg.CLUSTER, row


@pytest.mark.parametrize("name", sorted(CLUSTER_FORMS))
def test_refresh_graph_matches_the_eager_refresh(tmp_path, name):
    """driver.resync on the card (initialize_state's kernels replayed as
    one CUDA graph) against initialize_state called eagerly, at B = 1
    after each of two 50-step blocks, so that the second replay reads
    moved positions: energies within 1e-6 relative, amplitudes within
    AMP_TOL max(1, max|A|), the rest of the state the block's own. The
    graph is captured once for the spec and its layout."""
    from maniac_tpu_torch.mc import driver
    dev = _device()
    sysm = _cluster_case(name, tmp_path, dev)
    spec = sysm.spec
    st = replicate(spec, sysm.state, 1)
    n0 = trace.counters()
    energies = []
    for seed in (61, 62):
        st = block_body_u(spec, st, _draw(spec, 1, 50, seed), False)
        g, e = driver.resync(spec, st), driver.initialize_state(spec, st)
        gap = (g.energy - e.energy).abs()
        assert bool((gap <= 1e-6 * e.energy.abs().clamp_min(1.0)).all())
        scale = max(1.0, float(torch.maximum(e.amp_re.abs(),
                                             e.amp_im.abs()).max()))
        for field in ("amp_re", "amp_im"):
            diff = getattr(g, field) - getattr(e, field)
            assert float(diff.abs().max()) <= AMP_TOL * scale, field
        for field in ("pos", "com", "n_mol", "counters", "key"):
            assert getattr(g, field) is getattr(st, field), field
        energies.append(g.energy.clone())
        st = g
    assert not torch.equal(energies[0], energies[1])
    assert trace.since(n0).get("refresh.graph_captures") == 1


def _padded_walk_spec(spec):
    """``spec`` with the padded grid's walk for the kernels' mode lists:
    every mode of the (JzP, JxyP) grid in grid order for the k-space
    delta, each with its k_weights entry (0 on a pad mode, whose indices
    are 0), and the real modes in grid order for the commit. Thread t then
    takes the modes m = t + 256 i that the padded loops gave it, in their
    order, and a mode without weight adds an exact zero to its sum: the
    block's bits as the padded walk made them."""
    K = spec.k_weights.numel()
    table = torch.zeros((K, 4), dtype=torch.int32, device=spec.device)
    table[:, 0] = torch.arange(K, dtype=torch.int32, device=spec.device)
    table[spec.k_real_modes[:, 0].long()] = spec.k_real_modes
    return dataclasses.replace(
        spec, k_weighted_modes=table,
        k_weighted_w=spec.k_weights.flatten().contiguous())


@pytest.mark.parametrize("kernel", ["block", "step"])
@pytest.mark.parametrize("name", sorted(BENCH_FORMS))
def test_compact_mode_lists_keep_the_padded_walks_amplitudes(tmp_path, name,
                                                             kernel):
    """K2 (a 400-step block) and K3 (50 steps) at B = 64 on the same
    uniforms, walking the compact mode lists and walking the padded grid
    (_padded_walk_spec): only the k-space delta's summation order differs,
    so at most 2 replicas decide otherwise (a near tie); on the rest the
    positions and COMs are equal and the amplitudes equal bit for bit, pad
    modes untouched, E_RECIP within 1e-5 of the largest |E_RECIP| (a
    running sum of accepted deltas of that size, in f32)."""
    dev = _device()
    sysm = _bench_config(name, tmp_path, dev)
    spec = sysm.spec
    padded = _padded_walk_spec(spec)
    assert padded.k_weighted_modes.shape[0] == spec.k_weights.numel() > \
        spec.k_weighted_modes.shape[0]
    run = run_block_kernel if kernel == "block" else run_steps_kernel
    states = replicate(spec, sysm.state, 64)
    u = _draw(spec, 64, 400 if kernel == "block" else 50, 23)
    c, p = run(spec, states, u), run(padded, states, u)
    from maniac_tpu_torch.bench import same_decisions
    same = same_decisions(c, p)
    assert int((~same).sum()) <= 2
    assert int((c.counters[:, 1] - states.counters[:, 1])[same].sum()) > 0
    for field in ("pos", "com", "amp_re", "amp_im"):
        assert torch.equal(getattr(c, field)[same],
                           getattr(p, field)[same]), field
    pad = torch.ones(spec.k_weights.numel(), dtype=torch.bool, device=dev)
    pad[spec.k_real_modes[:, 0].long()] = False
    for field in ("amp_re", "amp_im"):
        assert torch.equal(getattr(c, field).flatten(1)[:, pad],
                           getattr(states, field).flatten(1)[:, pad])
    e_c, e_p = c.energy[same, E_RECIP], p.energy[same, E_RECIP]
    scale = max(1.0, float(p.energy[:, E_RECIP].abs().max()))
    assert float((e_c - e_p).abs().max()) <= 1e-5 * scale


# ---- the main path's checks at its own sizes -------------------------------
# bench.py's systems at the main path's batch and block; a block of the
# main path; the replicas a K2 or K3 check on its batch may see diverge (a
# Metropolis decision at its threshold may flip under f32 summation order)
MAIN_REPLICAS, MAIN_STEPS = 1024, 400
MAIN_DIVERGED = MAIN_REPLICAS // 64


def _amp_check(amp_re, amp_im, e_recip, ref_re, ref_im, ref_e):
    """Amplitudes against a reference synthesis within 1e-4 max(1,
    max|A_ref|), E_RECIP within 1e-5 relative (an exact match is no
    error, also where E_RECIP is 0)."""
    scale = max(1.0, float(torch.maximum(ref_re.abs(), ref_im.abs()).max()))
    err = float(torch.maximum((amp_re - ref_re).abs(),
                              (amp_im - ref_im).abs()).max())
    assert err <= 1e-4 * scale, (err, scale)
    d_e = (e_recip - ref_e).abs()
    rel = float(torch.where(d_e == 0, 0.0, d_e / ref_e.abs()).max())
    assert rel <= 1e-5, rel


def _recip(st):
    """_amp_check's three arguments of one state."""
    return st.amp_re, st.amp_im, st.energy[:, E_RECIP]


def _resync_check(spec, states):
    """K1 on ``states`` against its plain version (_amp_check), then on
    their edge replicas (tools/resync_times.edge_replicas; at B < 3 each
    alone): two launches on one input give the same bits, and the replica
    without guests holds fw_amp exactly."""
    _amp_check(*_recip(resync_grouped(spec, states)),
               *_recip(resync_plain(spec, states)))
    single = states.B < 3
    edges = edge_replicas(spec, replicate(spec, states, 3) if single
                          else states, seed=states.B)
    for i, st in enumerate([replica(edges, i) for i in range(3)] if single
                           else [edges]):
        _amp_check(*_recip(_resync_twice(spec, st, i == 0)),
                   *_recip(resync_plain(spec, st)))


def _block_check(k, p, max_diverged, e_bound=None):
    """Kernel (k) against plain (p) outputs of one block: the decisions
    (bench.same_decisions) alike on all but max_diverged replicas; on the
    rest positions, COMs and reservoir rows within POS_TOL and energies
    within ENERGY_TOL, or within e_bound (B, 6) where given. Returns the
    mask of the replicas that decided alike."""
    same = bench.same_decisions(k, p)
    assert int((~same).sum()) <= max_diverged, int((~same).sum())
    pos_err, e_err, e_ok = bench.block_errors(k, p, same, e_bound)
    assert pos_err <= POS_TOL and e_ok, (pos_err, e_err)
    return same


def _main_cell(system):
    """bench.py's system on the card, loaded once: the four of
    _bench_cell, ``water_box`` (resv's box without its reservoir) and
    bigS at the bench's capacity (``bigS``) and at the reference's cap of
    5000 a type (``bigS-5000``, src/parameters.f90:8)."""
    if system.startswith("bigS"):
        return _big_cell(5000 if system == "bigS-5000" else None)
    if system == "water_box":
        return _water_box_cell()
    return _bench_cell(system)


@functools.cache
def _big_cell(capacity):
    return bench.load("bigS", torch.device("cuda"), capacity)


@functools.cache
def _water_box_cell():
    with tempfile.TemporaryDirectory() as tmp:
        make_water_box(tmp, **RESYNC_SYSTEMS["resv"][1])
        return _load(tmp, torch.device("cuda"), 192)


@functools.cache
def _main_states(system):
    """MAIN_REPLICAS replicas of ``system`` after one block of the main
    path."""
    sysm = _main_cell(system)
    return run_block_replicated(
        sysm.spec, replicate(sysm.spec, sysm.state, MAIN_REPLICAS),
        MAIN_STEPS, False, True)


@pytest.mark.parametrize("system", ["flagship", "mixed", "resv", "tricl",
                                    "bigS", "bigS-5000"])
def test_main_path_at_its_batch(system):
    """The main path (replicate(B = 1024) -> run_block_replicated(400
    steps, resync=True)) on bench.py's systems: the dispatch names K2 and
    K1 (and K3 with a reservoir); a block launches T, K2 and K1 once each;
    a block drawing its uniforms and the same block on them drawn ahead
    make the same decisions; the state is finite, every population within
    [0, capacity], box + reservoir + drops conserved, and replica 0's
    amplitudes and E_RECIP match a fresh synthesis (_amp_check). At that
    batch K2 holds to the plain steps for 10 steps (_block_check, at most
    B/64 replicas diverged; bigS's energies within bench.energy_bound) and
    K1 to its plain version on the result and its edge replicas. bigS also
    passes bench.kernel_check (8 replicas x 50 steps, at most one
    diverged) with K1 on its result."""
    dev = _device()
    sysm = _main_cell(system)
    spec = sysm.spec
    e_load = sysm.state.energy[0] if system.startswith("bigS") else None
    report = dispatch_report(spec, dev)
    assert "block: CUDA whole-block kernel" in report
    assert "resync: CUDA resync kernel" in report
    if spec.has_reservoir:
        assert "step: CUDA per-step kernel" in report
    start = replicate(spec, sysm.state, MAIN_REPLICAS)
    n0 = trace.counters()
    states = run_block_replicated(spec, start, MAIN_STEPS, False, True)
    launched = build.launch_counts(n0)
    for name in ("threefry", "blockg", "resync"):
        assert launched[name] == 1, launched
    ahead, u = draw_uniforms(spec, start, MAIN_STEPS)
    ahead = run_block_uniforms(spec, ahead, u, False, True)
    assert torch.equal(ahead.n_mol, states.n_mol)
    assert torch.equal(ahead.counters, states.counters)
    assert bench.state_check(spec, start, states)
    ref_re, ref_im = full_amplitudes(
        spec, site_positions(spec, states)[:1],
        active_site_mask(spec, states.n_mol[:1]))
    _amp_check(states.amp_re[:1], states.amp_im[:1],
               states.energy[:1, E_RECIP], ref_re, ref_im,
               recip_energy(spec, ref_re, ref_im))
    st, u = draw_uniforms(spec, states, 10)
    k = run_block_kernel(spec, st, u)
    bound = None if e_load is None else bench.energy_bound(
        e_load, (k.counters[:, 1] - st.counters[:, 1]).sum(1))
    _block_check(k, steps_plain(spec, st, u), MAIN_DIVERGED, bound)
    _resync_check(spec, k)
    if e_load is not None:
        _, _, k = bench.kernel_check(
            spec, replicate(spec, sysm.state, bench.CHECK_REPLICAS), e_load)
        _resync_check(spec, k)


def _step_chains_check(spec, states, max_diverged, n_steps):
    """K3 against the plain steps on the same uniforms: one step, then an
    n_steps chain (none where 0): _block_check's bounds, and on the
    replicas that decided alike the amplitudes the kernel committed and
    E_RECIP within _amp_check's; one launch a step, and the input state
    left as it was."""
    before = {name: v.clone() for name, v in vars(states).items()}
    keyed = states    # the uniforms' keys advance here, not in states
    for n in (1, n_steps) if n_steps else (1,):
        keyed, u = draw_uniforms(spec, keyed, n)
        n0 = trace.counters()
        k = run_steps_kernel(spec, states, u)
        assert build.launch_counts(n0)["stepg"] == n
        p = steps_plain(spec, states, u)
        same = _block_check(k, p, max_diverged)
        _amp_check(k.amp_re[same], k.amp_im[same], k.energy[same, E_RECIP],
                   p.amp_re[same], p.amp_im[same], p.energy[same, E_RECIP])
    for name, v in vars(states).items():
        assert torch.equal(v, before[name]), name


# id: (system, B, replicas that may diverge, chain steps); B = 1024 is
# the main path's states after a block, under the system's spec or the
# isotherm's (8 fugacities x 128 replicas, one activity table a replica)
STEP_CHAINS = {
    "flagship-64": ("flagship", 64, 1, 50),
    "flagship-1": ("flagship", 1, 0, 50),
    "flagship-1024": ("flagship", MAIN_REPLICAS, MAIN_DIVERGED, 0),
    "isotherm-1024": ("isotherm", MAIN_REPLICAS, MAIN_DIVERGED, 50),
    "mixed-64": ("mixed", 64, 1, 50),
    "water_box-64": ("water_box", 64, 1, 50),
    "resv-64": ("resv", 64, 1, 50),
    "tricl-64": ("tricl", 64, 1, 50),
    "tricl-1": ("tricl", 1, 0, 50),
}


@pytest.mark.parametrize("case", sorted(STEP_CHAINS))
def test_step_kernel_chains_on_the_bench_systems(case):
    """K3 against the plain steps on bench.py's systems
    (_step_chains_check): at B = 64, at B = 1 (the single chain's shape,
    no divergence allowed) and at the main path's batch."""
    dev = _device()
    system, B, max_diverged, n_steps = STEP_CHAINS[case]
    sysm = _main_cell("flagship" if system == "isotherm" else system)
    spec = sysm.spec
    if B == MAIN_REPLICAS:
        states = _main_states("flagship")
        if system == "isotherm":
            spec = isotherm_spec(spec)
    else:
        states = replicate(spec, sysm.state, B)
    assert "step: CUDA per-step kernel" in dispatch_report(spec, dev)
    _step_chains_check(spec, states, max_diverged, n_steps)


def test_load_on_the_card_turns_tf32_off(tmp_path):
    """Moving a system onto the card turns TF32 off for matmul and cuDNN,
    though it was on."""
    dev = _device()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        _zif_small(str(tmp_path))
        _load(str(tmp_path), dev, 16)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def test_hw_precision_check_passes():
    """utils/hwprobe.hw_precision_check(blocks=4), K5's caller, returns
    "pass" and launches K5 and K2."""
    _device()
    n0 = trace.counters()
    verdict, detail = hw_precision_check(blocks=4)
    launched = build.launch_counts(n0)
    assert verdict == "pass", detail
    assert launched["onehot"] >= 1 and launched["blockg"] >= 1


def test_sentinel_passes_its_block_and_flags_another():
    """sentinel_check on the flagship (B = 64, 50 steps, the resync): no
    mismatch against the block's own result, and counter mismatches
    against the state one block further on."""
    _device()
    sysm = _bench_cell("flagship")
    spec = sysm.spec
    st, u1 = draw_uniforms(spec, replicate(spec, sysm.state, 64), 50)
    _, u2 = draw_uniforms(spec, st, 50)
    post = run_block_uniforms(spec, st, u1, False, True)
    post2 = run_block_uniforms(spec, post, u2, False, True)
    same = sentinel_check(spec, st, post, u1, False, resync=True)
    assert sentinel_passed(same), same
    other = sentinel_check(spec, st, post2, u1, False, resync=True)
    assert other["counter_mismatch"] > 0, other


@pytest.mark.parametrize("variant", GPASS_VARIANTS)
def test_gpass_kernel_matches_plain_at_the_tools_shape(variant):
    """K6 at tools/gpass_bench's defaults (G 64, 47 x 128 sites, FL 2,
    FQ 6, 100 steps): the full pass, its Coulomb rows alone and its LJ
    rows alone (FQ 0, on check_inputs), each launched once and within
    GPASS_RTOL of the plain version's sum of |terms|."""
    dev = _device()
    G, S, n = gpass_bench.G, gpass_bench.NC * 128, gpass_bench.NSTEP
    fl, fq = gpass_bench.FL, gpass_bench.FQ
    full = gpass_inputs(G, S, fl, dev)
    for ins, q in ((full, fq), ((*full[:4], full[4][:0], full[5][:0]), fq),
                   (check_inputs(G, S, fl, 0, n, dev), 0)):
        n0 = trace.counters()
        k = float(gpass(*ins, n, q, variant))
        assert build.launch_counts(n0)["gpass"] == 1
        assert math.isfinite(k)
        assert abs(k - float(gpass_plain(*ins, n, q, variant))) \
            <= GPASS_RTOL * gpass_scale(*ins, n, q, variant)


@pytest.mark.parametrize("kernel", [*PAIR_VARIANTS, *CPASS_FORMS])
def test_micro_kernel_time_grows_with_its_work(kernel):
    """K6's pair variants at the tool's shape and K8's two forms take at
    least GROWTH_MIN times as long, device-paced, at twice the steps or
    iterations (tools/micro_times.growth): a kernel that hoisted a term
    out of its loop would not."""
    dev = _device()
    if kernel in PAIR_VARIANTS:
        ins = gpass_inputs(gpass_bench.G, gpass_bench.NC * 128,
                           gpass_bench.FL, dev)

        def fn(k):
            return gpass(*ins, k * gpass_bench.NSTEP, gpass_bench.FQ, kernel)
    else:
        ins = cpass_inputs(128, 1280, dev)

        def fn(k):
            return cpass(*ins, k * 512, kernel == "cpassT")
    a, b, ratio = growth(fn, 20)
    assert ratio >= GROWTH_MIN, (a, b)


def test_tabulated_water_box_on_the_card_matches_the_cpu(tmp_path):
    """tests/test_tabulated.py's GCMC water box with use_table, f64, B =
    16, two blocks of 100 steps from one seed, on the card and on the
    CPU: the dispatch names the tabulated potentials (the plain torch
    step), every replica's bookkeeping within 1e-6 K of a recompute, the
    same decisions, and energies within 1e-9 relative of the CPU's."""
    dev = _device()
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.3, 0.2, 0.5, 0.0), fugacity=5000.0,
                   use_table="true")
    runs = {}
    for where in (dev, torch.device("cpu")):
        sysm = load_system(f"{tmp_path}/input.maniac",
                           f"{tmp_path}/topology.data",
                           f"{tmp_path}/parameters.inc", dtype=torch.float64,
                           device=where, seed=1234)
        states = replicate(sysm.spec, sysm.state, 16)
        for _ in range(2):
            states = run_block_replicated(sysm.spec, states, 100, True)
        runs[where.type] = (sysm.spec, states)
    spec, card = runs["cuda"]
    cpu = runs["cpu"][1]
    assert "tabulated potentials" in dispatch_report(spec, dev)
    assert max(drift_report(spec, card, b)["drift_K"]
               for b in range(16)) <= 1e-6
    assert torch.equal(card.n_mol.cpu(), cpu.n_mol)
    assert torch.equal(card.counters.cpu(), cpu.counters)
    rel = (card.energy.cpu() - cpu.energy).abs() / cpu.energy.abs().clamp(
        min=1.0)
    assert float(rel.max()) <= 1e-9
