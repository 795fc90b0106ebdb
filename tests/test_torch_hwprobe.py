"""maniac_tpu_torch hardware-precision probe (utils/hwprobe.py) on the
CPU, against the JAX package's probe: stage 1's one-hot exactness and its
verdict on a TF32-rounded product, stages 2-3 at a small size, the
geometry measure on a deformed water, and the command line's refusal
without a card."""

import numpy as np
import pytest
import torch

from maniac_tpu.utils.hwprobe import probe_onehot_exact as jax_probe_onehot
from maniac_tpu_torch import load_system, replicate
from maniac_tpu_torch.systems import make_spce_box
from maniac_tpu_torch.tools.precision_probe import main as probe_main
from maniac_tpu_torch.utils.hwprobe import (RIGID_TOL, onehot_operands,
                                            onehot_verdict,
                                            probe_onehot_exact,
                                            probe_rigid_geometry,
                                            rigid_deviation)

from torch_parity import files

torch.set_num_threads(1)


def _tf32(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to TF32's 10-bit mantissa (nearest, ties away)."""
    bits = a.astype(np.float32).view(np.uint32)
    bits = (bits + np.uint32(1 << 12)) & np.uint32(0xFFFFE000)
    return bits.view(np.float32)


def test_onehot_probe_exact_like_jax():
    """Stage 1 on the CPU: the library product and the kernel's plain
    version read the one-hot columns exactly, as JAX's XLA dot and Pallas
    kernel (interpret mode) do."""
    ok, detail = probe_onehot_exact(device="cpu")
    assert ok, detail
    assert detail == "one-hot read error library=0.000e+00 kernel=0.000e+00"
    ok_j, detail_j = jax_probe_onehot()
    assert ok_j, detail_j


def test_onehot_verdict_flags_tf32_rounding():
    """Negative control: a product whose inputs were rounded to TF32's
    10-bit mantissa (what a TF32 product reads) gives an error > 0 and
    ok=False, from either the library's or the kernel's side."""
    x, oh, want = onehot_operands()
    rounded = _tf32(x) @ oh
    assert np.abs(rounded - want).max() > 0
    for lib, ker in ((rounded, x @ oh), (x @ oh, rounded)):
        ok, detail = onehot_verdict(lib, ker, want)
        assert not ok, detail
    assert onehot_verdict(x @ oh, x @ oh, want)[0]


def test_rigid_geometry_probe_small():
    """Stages 2-3 on the CPU at 50 steps a block: the SPC/E waters stay
    rigid to f32 rounding and the sentinel replay of the plain path agrees
    with itself exactly."""
    ok, detail = probe_rigid_geometry(blocks=1, n_steps=50, device="cpu")
    assert ok, detail
    assert "sentinel n_mol_mm=0 ctr_mm=0" in detail


def test_rigid_deviation_catches_a_stretched_bond(tmp_path):
    """The geometry measure: 1e-10 scale on the f64 input, and a water with
    one O-H bond stretched by 1e-3 A fails the 1e-4 A check."""
    make_spce_box(str(tmp_path), n_water=8, density=0.997, seed=3)
    sysm = load_system(*files(str(tmp_path)), capacity=16, device="cpu")
    spec, states = sysm.spec, replicate(sysm.spec, sysm.state, 2)
    assert rigid_deviation(spec, states) < 1e-9
    pos = states.pos.clone()
    o, h = spec.site_base_list[0] + 3 * 5, spec.site_base_list[0] + 3 * 5 + 2
    pos[1, :, h] = pos[1, :, o] + (pos[1, :, h] - pos[1, :, o]) * (1 + 1e-3)
    dev = rigid_deviation(spec, states.replace(pos=pos))
    assert abs(dev - 1e-3) < 1e-9 and not dev < RIGID_TOL


def test_precision_probe_refuses_without_a_card(capsys):
    """The command line measures the card: without one it exits 1 and
    prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert probe_main(["--blocks", "1"]) == 1
    out = capsys.readouterr()
    assert "RESULT" not in out.out and "no CUDA device" in out.err
