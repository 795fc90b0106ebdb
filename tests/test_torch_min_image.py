"""The kernels' minimum image without a division (csrc/common.cuh
min_image_axis), on the CPU: the host's thresholds
(kernels.image_thresholds), the pair reach the spec bounds (system.
_image_reach) and the check that holds it to their domain (kernels.
image_failure, require_image_domain). The card's exhaustive check of every
f32 of the domain is tests/test_torch_gpu.py's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import maniac_tpu
from box_lengths import BOX_SYSTEMS, box_lengths
from maniac_tpu_torch import load_system, systems
from maniac_tpu_torch.kernels import (IMAGE_REACH_BOXES, block_gate_failure,
                                      image_failure, image_thresholds,
                                      require_image_domain,
                                      step_gate_failure)
from maniac_tpu_torch.kernels.vpu import (f32_bits, image_axis_plain,
                                          image_check, prim_check)
from maniac_tpu_torch.system import from_numpy
from torch_parity import jax_leaves

torch.set_num_threads(1)

LENGTHS = ["30.0", "16.0", "33.96", *BOX_SYSTEMS]
SAMPLES = 1_000_000


def _lengths(case, tmp_path):
    return [float(np.float32(float(case)))] if case[0].isdigit() else \
        box_lengths(case, tmp_path)


def _round_count(d: torch.Tensor, L: np.float32) -> torch.Tensor:
    """torch.round(d / L) in f32: what the division's form rounds."""
    return torch.round(d / torch.tensor(L))


def _threshold_count(d: torch.Tensor, t1: float, t2: float) -> torch.Tensor:
    a = d.abs()
    return torch.copysign((a > t1).float() + (a > t2).float(), d)


@pytest.mark.parametrize("case", LENGTHS)
def test_thresholds_reproduce_the_rounding(case, tmp_path):
    """At each threshold, its two f32 neighbours and 10^6 sampled values of
    the domain [-t3, t3] (uniform values and uniform bit patterns), the
    count of thresholds passed is torch.round(d / L); each threshold is
    the last value of its step: the next float rounds one higher."""
    rng = np.random.default_rng(7)
    for length in _lengths(case, tmp_path):
        L = np.float32(length)
        t1, t2, t3 = image_thresholds(length)
        assert t1 < t2 < t3 and float(np.float32(t3) / L) <= 2.5
        edges = []
        for t in (t1, t2, t3):
            t = np.float32(t)
            edges += [np.nextafter(t, np.float32(0)), t,
                      np.nextafter(t, np.float32(np.inf))]
        edges = np.asarray(edges, dtype=np.float32)
        rounded = _round_count(torch.from_numpy(edges), L)
        assert rounded.tolist() == [0, 0, 1, 1, 1, 2, 2, 2, 3], length
        bits = rng.integers(0, f32_bits(t3) + 1, SAMPLES // 2,
                            dtype=np.int64).astype(np.int32)
        uniform = rng.uniform(0.0, t3, SAMPLES // 2).astype(np.float32)
        d = torch.from_numpy(np.concatenate(
            [edges[:-1], bits.view(np.float32), uniform]))
        d = torch.cat([d, -d])
        got = _threshold_count(d, t1, t2)
        assert torch.equal(got, _round_count(d, L)), length
        assert torch.equal(image_axis_plain(d, length),
                           d - torch.tensor(L) * _round_count(d, L))


def test_image_check_plain_scans_both_signs():
    """The plain check of the minimum image: no mismatch over a strided
    scan of its domain, two values a pattern; beyond t3 it finds them."""
    length = 30.0
    _, _, t3 = image_thresholds(length)
    stride = 4099
    res = image_check(length, "cpu", stride=stride)
    assert res["mismatches"] == 0
    assert res["checked"] == 2 * (f32_bits(t3) // stride + 1)
    out = image_check(length, "cpu", lo=t3, hi=4 * length, stride=1 << 10)
    assert out["mismatches"] > 0 and out["above"] > f32_bits(t3)
    with pytest.raises(ValueError):
        image_check(length, "cpu", lo=4 * length, hi=length)
    with pytest.raises(ValueError):
        prim_check("image", "cpu")


def _water(tmp_path, **kw):
    systems.make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=6.0,
                           **kw)
    return load_system(f"{tmp_path}/input.maniac",
                       f"{tmp_path}/topology.data",
                       f"{tmp_path}/parameters.inc", capacity=16,
                       dtype=torch.float32, device="cpu")


def test_image_reach_bounds_the_sites(tmp_path):
    """The spec's reach is the box plus a molecule's extent each side: at
    least the spread of the loaded sites and the box, at most the box and
    two of the largest offsets; the JAX package's leaves carried over with
    from_numpy give the same reach."""
    sysm = _water(tmp_path)
    spec, state = sysm.spec, sysm.state
    n = int(state.n_mol[0, 0])
    pos = state.pos[0, :, :3 * n].double()
    offsets = pos - state.com[0, :, :n].double().repeat_interleave(3, 1)
    rad = float(offsets.norm(dim=0).max())
    for axis in range(3):
        spread = float(pos[axis].max() - pos[axis].min())
        L = spec.host_box[axis]
        assert max(spread, L) <= spec.image_reach[axis]
        assert spec.image_reach[axis] <= L + 2 * rad + 1e-5
    jsys = maniac_tpu.load_system(
        f"{tmp_path}/input.maniac", f"{tmp_path}/topology.data",
        f"{tmp_path}/parameters.inc", capacity=16)
    carried, _ = from_numpy(jax_leaves(jsys.spec), jax_leaves(jsys.state),
                            device="cpu", dtype=torch.float32)
    np.testing.assert_allclose(carried.image_reach, spec.image_reach,
                               rtol=1e-12)


def test_gate_names_a_spec_beyond_the_image_domain(tmp_path):
    """A reach of more than IMAGE_REACH_BOXES box lengths on one axis:
    image_failure names the minimum image and the axis, and
    require_image_domain raises with it, while the step and block gates,
    which decide only on what the kernels cannot express, still take the
    spec; a spec outside the gates (float64) or on a triclinic box (27
    images, no thresholds) is not refused."""
    spec = _water(tmp_path).spec
    assert image_failure(spec) is None and step_gate_failure(spec) is None
    require_image_domain(spec)
    L = spec.host_box[1]
    far = dataclasses.replace(spec, image_reach=(
        spec.image_reach[0], IMAGE_REACH_BOXES * L * 1.01,
        spec.image_reach[2]))
    why = image_failure(far)
    assert why is not None and "minimum image" in why and "along y" in why
    assert step_gate_failure(far) is None and block_gate_failure(far) is None
    with pytest.raises(ValueError, match="along y"):
        require_image_domain(far)
    require_image_domain(dataclasses.replace(far, dtype_name="float64"))
    edge = dataclasses.replace(spec, image_reach=(IMAGE_REACH_BOXES * L,)
                               * 3)
    assert image_failure(edge) is None
    tricl = dataclasses.replace(far, is_triclinic=True)
    assert image_failure(tricl) is None
    require_image_domain(tricl)
