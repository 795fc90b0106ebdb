"""maniac_tpu_torch host setup: JAX-free import, and load_system against
the JAX package's load_system carried over with from_numpy."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import maniac_tpu_torch
from maniac_tpu_torch.system import tensor_fields, to_device
from maniac_tpu_torch.systems import make_water_box, make_zif_like

from torch_parity import files, load_both

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_leaves_jax_out():
    """The package and the modules outside its import (the probes, the
    micro-benchmark kernels, the tools, Widom and checkpoints, the mesh,
    its launcher and the integration hooks, the validation tools and the
    virial anchor) import neither jax nor the JAX package."""
    code = ("import sys, maniac_tpu_torch, maniac_tpu_torch.utils.hwprobe, "
            "maniac_tpu_torch.kernels.hwprobe, maniac_tpu_torch.kernels.vpu, "
            "maniac_tpu_torch.kernels.gpass, "
            "maniac_tpu_torch.tools.precision_probe, "
            "maniac_tpu_torch.tools.gpass_bench, "
            "maniac_tpu_torch.tools.vpu_bench, "
            "maniac_tpu_torch.tools.launch_cost, "
            "maniac_tpu_torch.tools.section_split, "
            "maniac_tpu_torch.tools.kernel_times, "
            "maniac_tpu_torch.tools.resync_times, "
            "maniac_tpu_torch.tools.micro_times, "
            "maniac_tpu_torch.kernels.threefry, "
            "maniac_tpu_torch.mc.widom, maniac_tpu_torch.io.checkpoint, "
            "maniac_tpu_torch.parallel.mesh, "
            "maniac_tpu_torch.tools.launch_multihost, "
            "maniac_tpu_torch.entry, maniac_tpu_torch.virial, "
            "maniac_tpu_torch.tools.delta_e_report, "
            "maniac_tpu_torch.tools.validate_spce, "
            "maniac_tpu_torch.tools.run_examples, "
            "maniac_tpu_torch.tools.sentinel_rate; "
            "bad = [m for m in sys.modules if m.startswith('jax') "
            "or m.startswith('maniac_tpu.') or m == 'maniac_tpu']; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)


def _zif(outdir):
    # the tests/test_blockg.py framework fixture
    make_zif_like(outdir, n_cells=4, a=5.66, n_water=10, fugacity=50.0,
                  cutoff=6.0)


def _water(outdir):
    make_water_box(outdir, n_water=8, L=14.0, cutoff=5.0, tol=1e-4,
                   probs=(0.3, 0.2, 0.5, 0.0), fugacity=20000.0)


@pytest.mark.parametrize("make", [_zif, _water], ids=["zif", "water"])
def test_load_system_matches_jax(tmp_path, make):
    """Leaf for leaf in f64: integer tables exact, float tables (and the
    initial energies and amplitudes) within 1e-12."""
    make(str(tmp_path))
    _, spec_j, state_j = load_both(str(tmp_path), capacity=16)
    sysm = maniac_tpu_torch.load_system(*files(str(tmp_path)), capacity=16,
                                        device="cpu")
    for obj_p, obj_j in ((sysm.spec, spec_j), (sysm.state, state_j)):
        for (name, a), (_, b) in zip(tensor_fields(obj_p),
                                     tensor_fields(obj_j)):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if a.is_floating_point():
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12,
                                           atol=1e-12, err_msg=name)
            else:
                np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                              err_msg=name)
    for f in ("R", "A_list", "cap_list", "S", "Mtot", "K", "kmax_xyz",
              "amp_shape", "fw_split", "S_frozen", "guest_base",
              "kmax2_xyz", "amp2_shape", "site_base_list", "gg_cut",
              "gg_rcut"):
        assert getattr(sysm.spec, f) == getattr(spec_j, f), f
    if make is _zif:
        assert sysm.spec.fw_split and sysm.spec.n_active == 1


def test_to_device_casts_floats_only(tmp_path):
    _water(str(tmp_path))
    sysm = maniac_tpu_torch.load_system(*files(str(tmp_path)), capacity=16,
                                        device="cpu")
    spec32 = to_device(sysm.spec, "cpu", torch.float32)
    assert spec32.dtype == torch.float32
    for name, t in tensor_fields(spec32):
        if t.is_floating_point():
            assert t.dtype == torch.float32, name
        assert t.is_contiguous(), name
    assert spec32.site_type.dtype == torch.int32
    assert spec32.type_active.dtype == torch.bool
    st32 = to_device(sysm.state, "cpu", torch.float32)
    assert st32.pos.shape == (1, 3, sysm.spec.S)
    assert st32.n_mol.dtype == torch.int32


def test_load_system_defaults_to_cuda(tmp_path):
    """load_system runs on the card unless the caller asks for the CPU: with
    no device given and no card it raises, and never runs on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _water(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        maniac_tpu_torch.load_system(*files(str(tmp_path)), capacity=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        maniac_tpu_torch.load_system(*files(str(tmp_path)), capacity=16,
                                     device="cuda:0")
