"""The whole-block kernel's multi-species (swap) and triclinic forms against
the JAX package's Pallas blockg.

The block kernel has no CPU mode: on CPU tensors run_block_uniforms runs
its plain block (mc_step_u with the plain energy core), which is held here
to maniac_tpu/kernels/blockg.py::run_block_grouped in interpret mode on the
same numpy uniforms (quantity-major, unpacked as maniac_tpu/mc/driver.py::
block_body_group does), then the step-size recalibration and the amplitude
resync of both packages. The CUDA forms are held to the plain block on the
card (tests/test_torch_gpu.py).

The mixed cases are inside both packages' block gates: a framework with
the static split and two active species, and two species with no
framework (every type active), with and without a reservoir of both. The
two-species framework of systems.tiny_system("mixed") is too small for the
split, so its inactive framework keeps it outside both gates."""

import numpy as np
import pytest
import torch

from maniac_tpu_torch import load_system
from maniac_tpu_torch.kernels import (block_gate_failure, dispatch_report,
                                      step_gate_failure)
from maniac_tpu_torch.mc.moves import _core_plain, mc_step_u
from maniac_tpu_torch.parallel.replicas import (perturb_activity, replicate,
                                                run_block_uniforms)
from maniac_tpu_torch.system import to_device
from maniac_tpu_torch.systems import (make_framework_mixed, make_mixed_sizes,
                                      make_triclinic_water, tiny_system)

from torch_parity import (F32_ENERGY_TOL, F32_POS_TOL, as_np,
                          assert_same_chain, files, jax_batch, jax_blockg,
                          load_both, mixed_with_reservoir, uniforms)

torch.set_num_threads(1)

AMP_TOL = 2e-4   # tests/test_torch_kernels.py: two f32 syntheses
SWAP = 4         # the swap's move index in the counters


def _fw_mixed(d):
    # framework + 3 waters + 3 dimers, the split on (tests/test_torch_stepg)
    make_framework_mixed(d, n_cells=3, a=5.66, n_water=3, n_dimer=3,
                         cutoff=5.0, tol=1e-4)


def _mixed_sizes(d):
    make_mixed_sizes(d, n_water=4, n_dimer=4, L=16.0, cutoff=5.0, tol=1e-4,
                     probs=(0.2, 0.1, 0.3, 0.4))


def _tricl(d):
    return tiny_system(d, "tricl")[3]


# name -> (fixture writer returning a reservoir path or None, n_active,
# triclinic)
CASES = {"fw_mixed": (_fw_mixed, 2, False),
         "mixed_sizes": (_mixed_sizes, 2, False),
         "mixed_resv": (mixed_with_reservoir, 2, False),
         "tricl": (_tricl, 1, True)}


@pytest.mark.parametrize("name", list(CASES))
def test_block_matches_pallas_blockg(tmp_path, name):
    """G = 2 replicas x 40 steps: identical decisions (populations,
    counters, extras, reservoir counts), positions and reservoir rows within
    1e-4 A, energies within 5 K, amplitudes within 2e-4 after the resync;
    swaps were tried where two species are active."""
    make, n_active, tricl = CASES[name]
    res = make(str(tmp_path))
    sysm, spec, state = load_both(str(tmp_path), capacity=12, f32=True,
                                  reservoir=res)
    assert (spec.n_active, spec.is_triclinic) == (n_active, tricl)
    assert spec.has_reservoir == (res is not None)
    assert block_gate_failure(spec) is None
    U = uniforms(2, 40, seed=80, f32=True)
    out = run_block_uniforms(spec, replicate(spec, state, 2),
                             torch.from_numpy(U), recalibrate=True,
                             resync=True)
    jst = jax_blockg(sysm, U)
    assert_same_chain(jst, out, pos_tol=F32_POS_TOL,
                      energy_tol=F32_ENERGY_TOL)
    np.testing.assert_array_equal(as_np(out.res_n), np.asarray(jst.res_n))
    for field in ("res_offset", "res_com"):
        err = np.abs(as_np(getattr(out, field))
                     - np.asarray(getattr(jst, field))).max()
        assert err <= F32_POS_TOL, (field, err)
    for field in ("amp_re", "amp_im"):
        np.testing.assert_allclose(as_np(getattr(out, field)),
                                   np.asarray(getattr(jst, field)),
                                   atol=AMP_TOL, err_msg=field)
    np.testing.assert_allclose(out.trans_step.numpy(),
                               np.asarray(jst.trans_step))
    c = out.counters.numpy()
    assert c[:, 1].sum() > 0
    if n_active > 1:
        assert c[:, 0, SWAP].sum() > 0 and c[:, 1, SWAP].sum() > 0
    if res is not None:
        assert not torch.equal(out.res_n, state.res_n.expand(2, -1))


def _conserved(st):
    """Box + reservoir + dropped molecules, per replica, all species."""
    return (st.n_mol[:, :-1].sum(1) + st.res_n[:, :-1].sum(1)
            + st.extras[:, 1])


def test_f64_two_species_reservoir_chain(tmp_path, monkeypatch):
    """f64, B = 2 x 200 steps with the two-species reservoir: box +
    reservoir + drops conserved at every step, and the chain equal to JAX's
    XLA scan (identical decisions and reservoir counts, positions and
    reservoir rows within 1e-10 A)."""
    monkeypatch.setenv("MANIAC_PALLAS", "0")
    res = mixed_with_reservoir(str(tmp_path))
    sysm, spec, state = load_both(str(tmp_path), capacity=12, reservoir=res)
    U = uniforms(2, 200, seed=81, f32=False)
    st = replicate(spec, state, 2)
    total0 = _conserved(st)
    for i in range(U.shape[1]):
        st = mc_step_u(spec, st, torch.from_numpy(U[:, i]), core=_core_plain)
        assert torch.equal(_conserved(st), total0), i
    jst = jax_batch(sysm.spec, sysm.state, U)
    assert_same_chain(jst, st, pos_tol=1e-10, energy_tol=1e-6)
    np.testing.assert_array_equal(as_np(st.res_n), np.asarray(jst.res_n))
    for field in ("res_offset", "res_com"):
        assert np.abs(as_np(getattr(st, field))
                      - np.asarray(getattr(jst, field))).max() <= 1e-10
    c = st.counters.numpy()
    assert c[:, 1, SWAP].sum() > 0            # swaps popped and pushed


def test_block_and_step_gates(tmp_path):
    """bench.py's mixed shape (framework + two species, the split on), two
    species without a framework and a triclinic box are inside the block
    and step gates for the card, and the report names the kernels; f64 and
    a per-replica activity stay outside, with their reasons."""
    specs = {}
    for name, make in (("fw_mixed", _fw_mixed), ("mixed_sizes", _mixed_sizes),
                       ("tricl", _tricl),
                       ("tricl14", lambda d: make_triclinic_water(
                           d, n_water=8, L=14.0, cutoff=5.0, tol=1e-4))):
        make(str(tmp_path / name))
        specs[name] = load_system(*files(str(tmp_path / name)), capacity=12,
                                  dtype=torch.float32, device="cpu").spec
    assert specs["fw_mixed"].fw_split and specs["tricl"].is_triclinic
    for name, spec in specs.items():
        assert block_gate_failure(spec) is None, name
        assert step_gate_failure(spec) is None, name
        assert ("block: CUDA whole-block kernel; step: CUDA per-step kernel;"
                " resync: CUDA resync kernel") in dispatch_report(
                    spec, "cuda"), name
        assert "plain torch path" in dispatch_report(spec, "cpu")
        spec64 = to_device(spec, "cpu", torch.float64)
        assert "float64" in block_gate_failure(spec64)
        assert "float64" in step_gate_failure(spec64)
        sweep = perturb_activity(spec, spec.type_activity.expand(3, -1))
        assert "per-replica activity" in block_gate_failure(sweep)
        assert step_gate_failure(sweep) is None
