"""maniac_tpu_torch CUDA kernels against their plain torch versions, on a
card. Every test here needs a CUDA device and skips without one.

The file imports no jax (the machine with the card has none), so it runs
without the suite's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q
"""

import pytest
import torch

from maniac_tpu_torch import load_system, replicate, run_block_replicated
from maniac_tpu_torch.kernels import dispatch_report
from maniac_tpu_torch.kernels.blockg import block_plain, run_block_kernel
from maniac_tpu_torch.kernels.resync import resync_grouped, resync_plain
from maniac_tpu_torch.mc.driver import draw_uniforms
from maniac_tpu_torch.systems import make_water_box, make_zif_like

pytestmark = pytest.mark.gpu

# the chip_smoke.py / tests/test_blockg.py bounds: decisions identical,
# positions to f32 ulp, running energies summed in another order
POS_TOL = 1e-4      # Angstrom
ENERGY_TOL = 5.0    # Kelvin
AMP_TOL = 2e-4
E_RTOL = 2e-6       # E_RECIP ~ 2e5 K summed in f32 over ~6000 modes


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _load(outdir, dev, capacity, dtype=torch.float32):
    return load_system(f"{outdir}/input.maniac", f"{outdir}/topology.data",
                       f"{outdir}/parameters.inc", capacity=capacity,
                       dtype=dtype, device=dev)


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def _assert_block_parity(spec, states, u):
    k = run_block_kernel(spec, states, u)
    p = block_plain(spec, states, u)
    torch.testing.assert_close(k.n_mol, p.n_mol, rtol=0, atol=0)
    torch.testing.assert_close(k.counters, p.counters, rtol=0, atol=0)
    torch.testing.assert_close(k.extras, p.extras, rtol=0, atol=0)
    assert float((k.pos - p.pos).abs().max()) <= POS_TOL
    assert float((k.com - p.com).abs().max()) <= POS_TOL
    assert float((k.energy - p.energy).abs().max()) <= ENERGY_TOL
    return k


def test_block_kernel_matches_plain(tmp_path):
    dev = _device()
    make_zif_like(str(tmp_path), n_cells=4, a=5.66, n_water=10,
                  fugacity=50.0, cutoff=6.0)
    sysm = _load(str(tmp_path), dev, 16)
    states = replicate(sysm.spec, sysm.state, 8)
    u = draw_uniforms(sysm.spec, 8, 60, _gen(dev, 1))
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
    u = draw_uniforms(sysm.spec, 4, 80, _gen(dev, 2))
    k = _assert_block_parity(sysm.spec, states, u)
    assert int(k.n_mol[:, 1].max()) <= 10
    assert int(k.extras[:, 0].sum()) > 0


def test_resync_kernel_matches_plain(tmp_path):
    dev = _device()
    make_zif_like(str(tmp_path), n_cells=4, a=5.66, n_water=10,
                  fugacity=50.0, cutoff=6.0)
    sysm = _load(str(tmp_path), dev, 16)
    states = replicate(sysm.spec, sysm.state, 8)
    states = block_plain(sysm.spec, states,
                         draw_uniforms(sysm.spec, 8, 30, _gen(dev, 3)))
    k = resync_grouped(sysm.spec, states)
    p = resync_plain(sysm.spec, states)
    torch.testing.assert_close(k.amp_re, p.amp_re, rtol=0, atol=AMP_TOL)
    torch.testing.assert_close(k.amp_im, p.amp_im, rtol=0, atol=AMP_TOL)
    torch.testing.assert_close(k.energy, p.energy, rtol=E_RTOL, atol=0.05)


def test_launch_counts_and_refusals(tmp_path):
    """Each wrapper counts one launch per call on CUDA tensors, and raises
    (no fallback) for a spec outside its kernel; a water box (no framework
    split) runs the plain block and the resync kernel."""
    dev = _device()
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=5.0, tol=1e-4)
    f32 = _load(str(tmp_path), dev, 16)
    states = replicate(f32.spec, f32.state, 2)
    n0 = resync_grouped.launches
    k = resync_grouped(f32.spec, states)
    assert resync_grouped.launches == n0 + 1
    # without the framework split the resync covers every type region
    p = resync_plain(f32.spec, states)
    torch.testing.assert_close(k.amp_re, p.amp_re, rtol=0, atol=AMP_TOL)
    torch.testing.assert_close(k.energy, p.energy, rtol=E_RTOL, atol=0.05)
    u = draw_uniforms(f32.spec, 2, 5, _gen(dev, 4))
    with pytest.raises(ValueError, match="framework split off"):
        run_block_kernel(f32.spec, states, u)
    # the main path on a spec outside the block kernel's gate: plain block,
    # kernel resync, and the report says so
    assert "plain torch path (framework split off)" in dispatch_report(
        f32.spec, dev)
    nb, nr = run_block_kernel.launches, resync_grouped.launches
    out = run_block_replicated(f32.spec, states, 5, False, True,
                               _gen(dev, 5))
    assert run_block_kernel.launches == nb
    assert resync_grouped.launches == nr + 1
    assert int(out.counters[:, 0].sum()) == 10
    f64 = _load(str(tmp_path), dev, 16, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        resync_grouped(f64.spec, replicate(f64.spec, f64.state, 2))
