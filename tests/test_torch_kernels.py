"""maniac_tpu_torch kernel modules: the plain versions behind the CUDA
wrappers against the JAX package, the whole slice, and the dispatch.

On the CPU each wrapper runs its plain torch version (a CUDA kernel has no
CPU mode); the kernels themselves are held to these plain versions on the
card by chip_smoke.py and tests/test_torch_gpu.py."""

import jax
import numpy as np
import pytest
import torch

from maniac_tpu.kernels.resync import resync_pallas_grouped
from maniac_tpu.mc.driver import _recalibrate as jax_recalibrate
from maniac_tpu.mc.driver import refresh_reported_energy as jax_refresh
from maniac_tpu.mc.driver import resync_amplitudes_body
from maniac_tpu_torch.kernels import (dispatch_report, use_block_kernel,
                                      use_resync_kernel)
from maniac_tpu_torch.kernels.blockg import run_block_kernel
from maniac_tpu_torch.kernels.resync import resync_grouped
from maniac_tpu_torch.mc.driver import (_recalibrate, block_body,
                                        refresh_reported_energy)
from maniac_tpu_torch.parallel.replicas import (replicate,
                                                run_block_replicated,
                                                run_block_uniforms)
from maniac_tpu_torch.system import from_numpy, to_device
from maniac_tpu_torch.systems import make_water_box, make_zif_like

from torch_parity import (F32_ENERGY_TOL, F32_POS_TOL, as_np,
                          assert_same_chain, jax_batch, jax_leaves, load_both,
                          uniforms)

torch.set_num_threads(1)

# f32 amplitude / energy agreement of two syntheses of the same positions:
# the tests/test_kernels.py::test_resync_kernel_parity bounds, plus a
# relative bound for E_RECIP ~ 2e5 K summed in f32 over ~6000 modes in
# another order
AMP_TOL = 2e-4
E_TOL = 0.05
E_RTOL = 2e-6


def _zif(d):
    make_zif_like(d, n_cells=4, a=5.66, n_water=10, fugacity=50.0,
                  cutoff=6.0)


@pytest.fixture
def zif32(tmp_path):
    _zif(str(tmp_path))
    return load_both(str(tmp_path), capacity=16, f32=True)


def _counts():
    return run_block_kernel.launches, resync_grouped.launches


def test_resync_plain_matches_pallas_and_xla(zif32):
    """resync_grouped on CPU tensors against JAX resync_pallas_grouped
    (interpret mode) and resync_amplitudes_body, on the same positions."""
    sysm, spec, _ = zif32
    jst = jax_batch(sysm.spec, sysm.state, uniforms(2, 30, seed=2, f32=True))
    _, st = from_numpy(jax_leaves(sysm.spec), jax_leaves(jst), device="cpu",
                       dtype=torch.float32)
    before = _counts()
    out = resync_grouped(spec, st)
    assert _counts() == before
    re_k, im_k, e_k = resync_pallas_grouped(sysm.spec, jst)
    ref = jax.vmap(lambda s: resync_amplitudes_body(sysm.spec, s))(jst)
    for re, im, e in ((re_k, im_k, e_k), (ref.amp_re, ref.amp_im,
                                          ref.energy)):
        np.testing.assert_allclose(out.amp_re.numpy(), np.asarray(re),
                                   atol=AMP_TOL)
        np.testing.assert_allclose(out.amp_im.numpy(), np.asarray(im),
                                   atol=AMP_TOL)
        np.testing.assert_allclose(out.energy.numpy(), np.asarray(e),
                                   rtol=E_RTOL, atol=E_TOL)


def test_block_plain_matches_jax_scan(zif32):
    """run_block_kernel on CPU tensors (its plain version) against a JAX
    scan of mc_step_u on the same uniforms (the XLA reference blockg is
    held to in tests/test_blockg.py)."""
    sysm, spec, state = zif32
    U = uniforms(2, 40, seed=3, f32=True)
    before = _counts()
    out = run_block_kernel(spec, replicate(spec, state, 2),
                           torch.from_numpy(U))
    assert _counts() == before
    jst = jax_batch(sysm.spec, sysm.state, U)
    assert_same_chain(jst, out, pos_tol=F32_POS_TOL,
                      energy_tol=F32_ENERGY_TOL)
    np.testing.assert_allclose(out.amp_re.numpy(), np.asarray(jst.amp_re),
                               atol=AMP_TOL)


def test_slice_matches_jax(zif32):
    """run_block_uniforms(..., resync=True), the whole slice, against the
    JAX step scan followed by resync_amplitudes_body."""
    sysm, spec, state = zif32
    U = uniforms(2, 40, seed=4, f32=True)
    out = run_block_uniforms(spec, replicate(spec, state, 2),
                             torch.from_numpy(U), recalibrate=True,
                             resync=True)
    jst = jax_batch(sysm.spec, sysm.state, U)
    jst = jax.vmap(lambda s: resync_amplitudes_body(sysm.spec, s))(jst)
    assert_same_chain(jst, out, pos_tol=F32_POS_TOL,
                      energy_tol=F32_ENERGY_TOL)
    np.testing.assert_allclose(out.amp_re.numpy(), np.asarray(jst.amp_re),
                               atol=AMP_TOL)
    np.testing.assert_allclose(out.amp_im.numpy(), np.asarray(jst.amp_im),
                               atol=AMP_TOL)
    np.testing.assert_allclose(out.trans_step.numpy(),
                               np.asarray(jst.trans_step))


def test_block_body_draws_like_the_replicated_path(zif32):
    """block_body (one block on the plain path) and run_block_replicated
    draw the same uniforms from equally seeded generators."""
    _, spec, state = zif32
    st = replicate(spec, state, 2)
    a = block_body(spec, st, 6, True, torch.Generator().manual_seed(9))
    b = run_block_replicated(spec, st, 6, True, False,
                             torch.Generator().manual_seed(9))
    for name in ("pos", "n_mol", "energy", "counters", "amp_re"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert int(a.counters[:, 0].sum()) == 12


def test_refresh_reported_energy_matches_jax(tmp_path):
    """Row 0 gets a from-scratch energy and amplitudes (f64), the other
    rows are untouched, as in the JAX driver."""
    _zif(str(tmp_path))
    sysm, spec, _ = load_both(str(tmp_path), capacity=16)
    jst = jax_batch(sysm.spec, sysm.state, uniforms(2, 20, seed=8,
                                                    f32=False))
    _, st = from_numpy(jax_leaves(sysm.spec), jax_leaves(jst), device="cpu",
                       dtype=torch.float64)
    out = refresh_reported_energy(spec, st)
    ref = jax_refresh(sysm.spec, jst)
    np.testing.assert_allclose(out.energy.numpy(), np.asarray(ref.energy),
                               rtol=1e-11, atol=1e-9)
    np.testing.assert_allclose(out.amp_re.numpy(), np.asarray(ref.amp_re),
                               atol=1e-10)
    assert torch.equal(out.energy[1], st.energy[1])


def test_recalibrate_matches_jax(zif32):
    """Step-size recalibration on counters around the target acceptance."""
    sysm, spec, state = zif32
    st = replicate(spec, state, 4)
    trials = torch.tensor([100, 600, 600, 600], dtype=torch.int32)
    accepts = torch.tensor([90, 400, 240, 60], dtype=torch.int32)
    counters = st.counters.clone()
    counters[:, 0, 2:4] = trials[:, None]
    counters[:, 1, 2:4] = accepts[:, None]
    st = st.replace(counters=counters)
    out = _recalibrate(st, True)
    for b in range(4):
        jst = sysm.state.replace(counters=counters[b].numpy())
        ref = jax_recalibrate(jst, True, sysm.spec.dtype)
        np.testing.assert_allclose(out.trans_step[b].item(),
                                   float(ref.trans_step), rtol=1e-7)
        np.testing.assert_allclose(out.rot_step[b].item(),
                                   float(ref.rot_step), rtol=1e-7)
    assert len(set(as_np(out.trans_step).tolist())) == 3  # grow/keep/shrink


def test_dispatch_gate(zif32, tmp_path):
    """Kernels only for CUDA devices and specs inside the gate; the CPU
    always takes the plain path, and the report says which and why."""
    _, spec32, _ = zif32
    spec64 = to_device(spec32, "cpu", torch.float64)
    assert not use_block_kernel(spec32, "cpu")
    assert not use_resync_kernel(spec32, "cpu")
    assert "plain torch path" in dispatch_report(spec32, "cpu")
    # the static gate is evaluated for a CUDA device without needing one
    assert use_block_kernel(spec32, "cuda") and use_resync_kernel(spec32,
                                                                  "cuda")
    assert "CUDA whole-block kernel" in dispatch_report(spec32, "cuda")
    assert not use_block_kernel(spec64, "cuda")
    assert "float64" in dispatch_report(spec64, "cuda")
    water = tmp_path / "water"
    make_water_box(str(water), n_water=8, L=14.0, cutoff=5.0, tol=1e-4)
    _, spec_w, _ = load_both(str(water), capacity=16, f32=True)
    assert not spec_w.fw_split and not use_block_kernel(spec_w, "cuda")
    assert "framework split off" in dispatch_report(spec_w, "cuda")
