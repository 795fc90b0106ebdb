"""maniac_tpu_torch micro-benchmark kernels' plain versions (kernels/gpass.py,
kernels/vpu.py) on the CPU against the JAX tools' Pallas kernels in
interpret mode (tools/gpass_bench.py, tools/vpu_bench.py), at small shapes
on the same inputs. The tools' module globals set the shapes; the kernel
of run_cpass, a closure, is captured by a stand-in for ``pl`` and run
here. Also K8's bookkeeping: the seven offsets its kernel takes and its
passes in groups of seven."""

import functools
import importlib.util
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from maniac_tpu_torch.kernels import gpass as gp
from maniac_tpu_torch.kernels.gpass import (GPASS_RTOL, GPASS_VARIANTS,
                                            gpass, gpass_scale)
from maniac_tpu_torch.kernels import vpu
from maniac_tpu_torch.kernels.vpu import (CPASS_OFFSETS, CPASS_RTOL,
                                          VPU_OPS, cpass, cpass_plain,
                                          vpu_chain)
from maniac_tpu_torch.tools.gpass_bench import check_inputs
from maniac_tpu_torch.tools.gpass_bench import inputs as gpass_inputs
from maniac_tpu_torch.tools.gpass_bench import kernel_variant
from maniac_tpu_torch.tools.vpu_bench import cpass_inputs, plane

torch.set_num_threads(1)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
# K6 and K8 take the kernels' own bounds against plain (GPASS_RTOL: the
# TPU kernel sums some 25,000 terms in f32, the plain version in f64;
# CPASS_RTOL: 5 passes of positive terms, compared per element, as a row's
# own column 0 holds terms some 1e5 at r2 = 1e-18).
# K7: 5 chained applications, each of up to two roundings and a
# transcendental that may differ by 2 ulp (1.2e-7) between XLA's and
# torch's CPU code, fused or separate multiply-adds
VPU_RTOL = 2e-6


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_gpass(variant, ins, n_steps, fl, fq):
    """The JAX tool's Pallas kernel of ``variant`` in interpret mode on the
    port's inputs, its module globals set to their shapes; eps and sig go
    in as max(fl, 8) rows, which its one-hot etile product selects by
    row r // G."""
    x, y, z, q, eps, sig = (t.numpy() for t in ins)
    gb = _tool("gpass_bench")
    gb.G, gb.S = x.shape
    gb.NC, gb.NSTEP, gb.FL, gb.FQ = gb.S // 128, n_steps, fl, fq
    rows = max(fl, 8)
    pad = np.zeros((rows - fl, gb.S), np.float32)
    etile = (np.arange(rows)[None, :]
             == np.arange(fl * gb.G)[:, None] // gb.G).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, y, z, q[None], np.vstack([eps, pad]),
                                     np.vstack([sig, pad]), etile)]
    return float(pl.pallas_call(
        gb.make_kernel(variant),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        interpret=True)(*args)[0, 0])


@pytest.mark.parametrize("variant", GPASS_VARIANTS)
def test_gpass_plain_matches_jax(variant):
    """K6 at G 4, NC 2, NSTEP 3, FL 2, FQ 6: the scalar of each variant
    that computes its own number."""
    ins = gpass_inputs(4, 256, 2, "cpu")
    want = _jax_gpass(variant, ins, 3, 2, 6)
    got = float(gpass(*ins, 3, 6, variant))
    scale = gpass_scale(*ins, 3, 6, variant)
    assert abs(got - want) <= GPASS_RTOL * scale, (got, want, scale)


@pytest.mark.parametrize("variant", ("cur", "noerfc", "nowrap"))
def test_gpass_plain_matches_jax_per_row(variant):
    """K6 at G 4, NC 2, NSTEP 3, FL 2, FQ 6 on check_inputs: eps and
    sigma^2 differ per row, so the plain version's row r // G is held
    against the TPU kernel's one-hot selection, and no pair sits near the
    r2 floor, so the LJ rows weigh in the bound."""
    ins = check_inputs(4, 256, 2, 6, 3, "cpu")
    want = _jax_gpass(variant, ins, 3, 2, 6)
    got = float(gpass(*ins, 3, 6, variant))
    scale = gpass_scale(*ins, 3, 6, variant)
    assert abs(got - want) <= GPASS_RTOL * scale, (got, want, scale)
    swapped = (*ins[:4], ins[4].flip(0), ins[5].flip(0))
    assert abs(float(gpass(*swapped, 3, 6, variant)) - want) \
        > 100 * GPASS_RTOL * scale


def _lj_faulty(x, y, z, eps, sig, n_steps, fault):
    """The LJ rows' sum (FQ 0) with one planted fault."""
    G, fl = x.shape[0], eps.shape[0]
    e, sg = eps.repeat_interleave(G, 0), sig.repeat_interleave(G, 0)
    if fault == "eps_row0":
        e = eps[:1].expand(fl * G, -1)
    elif fault == "sig_row0":
        sg = sig[:1].expand(fl * G, -1)
    elif fault == "row_r_mod_fl":
        e = eps.repeat(G, 1)
    total = 0.0
    for s in range(n_steps):
        r2 = gp._r2(x.repeat(fl, 1), y.repeat(fl, 1), z.repeat(fl, 1),
                    gp._rows(fl, G, s, x), True)
        sr6 = (sg / r2) ** 3
        lj = 4.0 * e * (sr6 * sr6 - (0.0 if fault == "no_sr6" else sr6))
        if fault != "no_rc2":
            lj = torch.where(r2 < gp.RC2, lj, 0.0)
        total += float(lj.sum(dtype=torch.float64))
    return total


@pytest.mark.parametrize("fault", ["no_sr6", "no_rc2", "eps_row0",
                                   "sig_row0", "row_r_mod_fl"])
def test_gpass_lj_check_rejects_faults(fault):
    """The LJ-rows check that tests/test_torch_gpu.py and chip_smoke.py
    make (check_inputs, FQ 0, GPASS_RTOL x gpass_scale) rejects a pass
    that drops the -sr6 attraction, skips the RC2 select, reads eps or
    sigma^2 of row 0 only, or takes row r % FL for r // G, by more than
    100 times its bound, at test_torch_gpu.py's shape (G 64, 8 chunks, 10
    steps)."""
    x, y, z, q, eps, sig = check_inputs(64, 8 * 128, 2, 0, 10, "cpu")
    ref = float(gpass(x, y, z, q, eps, sig, 10, 0, "cur"))
    scale = gpass_scale(x, y, z, q, eps, sig, 10, 0, "cur")
    assert abs(_lj_faulty(x, y, z, eps, sig, 10, "none") - ref) \
        <= GPASS_RTOL * scale
    assert abs(_lj_faulty(x, y, z, eps, sig, 10, fault) - ref) \
        > 100 * GPASS_RTOL * scale


def test_gpass_layout_variants_run_cur():
    """The JAX tool's TPU layout variants compute cur's number: the port's
    tool runs cur for them, and refuses a name it does not know."""
    for name in ("rep", "mrg", "nodyn", "noeps", "w4"):
        assert kernel_variant(name) == "cur"
    for name in GPASS_VARIANTS:
        assert kernel_variant(name) == name
    with pytest.raises(ValueError):
        kernel_variant("wx")


@pytest.mark.parametrize("op", VPU_OPS)
def test_vpu_chain_plain_matches_jax(op):
    """K7 at (8, 128), n 5: elementwise."""
    vb = _tool("vpu_bench")
    x = plane(8, 128, "cpu")
    want = pl.pallas_call(
        functools.partial(vb.kernel, op=vb._ops(op), n=5),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(vpu_chain(x, op, 5).numpy(),
                               np.asarray(want), rtol=VPU_RTOL, atol=0)


class _Captured(Exception):
    pass


@pytest.mark.parametrize("transposed", [False, True],
                         ids=["cpass", "cpassT"])
def test_cpass_plain_matches_jax(transposed, monkeypatch):
    """K8 at (8, 128), n 5: the kernel of run_cpass (captured from its
    pallas_call) on the port's inputs, elementwise."""
    vb = _tool("vpu_bench")
    monkeypatch.setattr(vb, "ROWS", 8)
    monkeypatch.setattr(vb, "COLS", 128)
    monkeypatch.setattr(vb, "N", 5)
    kernels = []

    def capture(kern, **_):
        kernels.append(kern)
        raise _Captured

    monkeypatch.setattr(vb, "pl", SimpleNamespace(pallas_call=capture,
                                                  BlockSpec=pl.BlockSpec))
    with pytest.raises(_Captured):
        vb.run_cpass(transposed=transposed)
    ins = cpass_inputs(8, 128, "cpu")
    want = pl.pallas_call(
        kernels[0], out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)(*[jnp.asarray(t.numpy()) for t in ins])
    got = cpass(*ins, 5, transposed).numpy()
    assert np.count_nonzero(got) > 100    # elements inside the cut-off
    np.testing.assert_allclose(got, np.asarray(want), rtol=CPASS_RTOL,
                               atol=0)


def test_cpass_offsets_match_jax():
    """The seven offsets K8's kernel takes (CPASS_OFFSETS, its float
    table, iteration k taking CPASS_OFFSETS[k % 7]) are the plain
    version's _offset(k) and the JAX tool's (i % 7).astype(f32) * 0.1, bit
    for bit, over three groups."""
    i = jnp.arange(21, dtype=jnp.int32)
    want = np.asarray((i % 7).astype(jnp.float32) * 0.1)
    got = np.array([CPASS_OFFSETS[k % 7] for k in range(21)], np.float32)
    assert got.tobytes() == want.tobytes()
    assert [vpu._offset(k) for k in range(21)] == [CPASS_OFFSETS[k % 7]
                                                   for k in range(21)]


@pytest.mark.parametrize("n", [1, 6, 7, 13, 20])
@pytest.mark.parametrize("transposed", [False, True],
                         ids=["cpass", "cpassT"])
def test_cpass_plain_sums_in_groups_of_seven(n, transposed):
    """cpass_plain over n = 7 m + r passes equals, in f64, the sum taken in
    the kernel's loop order: m groups of the seven offsets, then the first
    r of them (the regrouping's bookkeeping; each element adds its terms
    in the same order either way, so the sums are equal)."""
    ins = tuple(t.double() for t in cpass_inputs(8, 128, "cpu"))
    m, r = divmod(n, 7)
    acc = torch.zeros_like(ins[0])
    for _ in range(m):
        for j in range(7):
            acc = acc + vpu._cpass_term(*ins, CPASS_OFFSETS[j], transposed)
    for j in range(r):
        acc = acc + vpu._cpass_term(*ins, CPASS_OFFSETS[j], transposed)
    assert torch.equal(acc, cpass_plain(*ins, n, transposed))
    assert np.count_nonzero(acc.numpy()) > 100
