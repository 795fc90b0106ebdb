"""The branch-free primitives of csrc/prims.cuh and K7's use of them, on
the CPU (the primitives themselves run only on the card: the exhaustive
check is tests/test_torch_gpu.py's).

  * the inputs K7's plain chain gives each primitive over all 512
    applications of every op, on the JAX tool's plane (linspace(0.1, 3.0)
    over (128, 1280)), stay inside the primitive's stated domain; so do
    those from the ends of the range vpu_chain's docstring states, [0,
    2^64];
  * prims.cuh states the domains kernels/vpu.PRIM_DOMAINS holds, each
    covering [2^-64, 2^64], and vpu.cu's PrimId order is vpu.PRIMS;
  * the plain check's scan: its span and count of values, and the
    correctly rounded reciprocal against torch's f32 one over the domain.
"""

import re
from pathlib import Path

import pytest
import torch

from maniac_tpu_torch.kernels import build
from maniac_tpu_torch.kernels.vpu import (_PLAIN_OPS, PRIM_DOMAINS, PRIMS,
                                          VPU_OPS, f32_bits, prim_check)
from maniac_tpu_torch.tools.vpu_bench import plane

torch.set_num_threads(1)

CSRC = Path(build.__file__).resolve().parent / "csrc"
N = 512
TWO64 = 2.0 ** 64
# per chained op, the input it gives each primitive (csrc/vpu.cu apply_op)
PRIM_INPUTS = {
    "div": {"rcp": lambda x: x + 1.0},
    "rsqrt": {"rsqrt": lambda x: x + 1.0},
    "sqrt": {"sqrt": lambda x: x + 1.0},
    "erfc": {"rcp": lambda x: 1.0 + 0.3275911 * x},
}


def prim_inputs_range(x, op, n):
    """{primitive: (least, largest) input} that the plain chain of op
    gives the primitives over its n applications to x."""
    taps = PRIM_INPUTS.get(op, {})
    lo = {p: float("inf") for p in taps}
    hi = {p: -float("inf") for p in taps}
    for _ in range(n):
        for p, tap in taps.items():
            y = tap(x)
            lo[p] = min(lo[p], float(y.min()))
            hi[p] = max(hi[p], float(y.max()))
        x = _PLAIN_OPS[op](x)
    return {p: (lo[p], hi[p]) for p in taps}


def _inside(name, lo, hi):
    d_lo, d_hi = PRIM_DOMAINS[name]
    return d_lo <= lo and hi <= d_hi


@pytest.mark.parametrize("op", VPU_OPS)
def test_chain_inputs_stay_in_the_domains(op):
    """Every input the plain chain of op gives a primitive, over all N
    applications on the JAX tool's plane, lies in the primitive's domain;
    the ops with primitives are div, rsqrt, sqrt and erfc."""
    ranges = prim_inputs_range(plane(128, 1280, "cpu"), op, N)
    assert bool(ranges) == (op in ("div", "rsqrt", "sqrt", "erfc"))
    for name, (lo, hi) in ranges.items():
        assert _inside(name, lo, hi), (op, name, lo, hi)


@pytest.mark.parametrize("op", sorted(PRIM_INPUTS))
def test_chain_range_ends_stay_in_the_domains(op):
    """From the ends of vpu_chain's stated range [0, 2^64] (and values
    between), the chain's primitive inputs stay in their domains."""
    x = torch.tensor([0.0, 1e-30, 1e-3, 1.0, 7.5, 1e20, TWO64],
                     dtype=torch.float32)
    for name, (lo, hi) in prim_inputs_range(x, op, N).items():
        assert _inside(name, lo, hi), (op, name, lo, hi)


def test_prims_header_states_the_domains():
    """prims.cuh's domain lines are PRIM_DOMAINS, each domain covers
    [2^-64, 2^64] (K2's floored r2 and its reciprocal), and the check
    kernel's PrimId enum follows PRIMS."""
    text = (CSRC / "prims.cuh").read_text()
    stated = {m.group(1): (float.fromhex(m.group(2)),
                           float.fromhex(m.group(3)))
              for m in re.finditer(r"// domain prim_(\w+): \[(\S+), (\S+)\]",
                                   text)}
    assert stated == PRIM_DOMAINS
    for name in PRIMS:
        assert re.search(rf"float prim_{name}\(float y\)", text), name
        assert _inside(name, 2.0 ** -64, TWO64), name
    enum = re.search(r"enum PrimId \{([^}]*)\}",
                     (CSRC / "vpu.cu").read_text()).group(1)
    assert [e.strip() for e in enum.split(",")] == [
        f"PR_{p.upper()}" for p in PRIMS] + ["PR_COUNT"]


@pytest.mark.parametrize("name", PRIMS)
def test_prim_check_plain_scans_the_span(name):
    """The plain check counts the values lo, lo + stride, ... <= hi of the
    primitive's domain (and of a given interval) as the kernel's scan."""
    lo, hi = PRIM_DOMAINS[name]
    stride = 1 << 16
    res = prim_check(name, "cpu", stride=stride)
    assert res["checked"] == (f32_bits(hi) - f32_bits(lo)) // stride + 1
    sub = prim_check(name, "cpu", 1.0, 4.0, stride=1 << 8)
    assert sub["checked"] == (f32_bits(4.0) - f32_bits(1.0)) // 256 + 1
    with pytest.raises(ValueError):
        prim_check(name, "cpu", 4.0, 1.0)


def test_prim_check_plain_reciprocal_is_correctly_rounded():
    """On the domain of prim_rcp, torch's f32 reciprocal is the correctly
    rounded one (f64, then rounded to f32), which the branch-free form
    must give on the card: no mismatch over a strided scan of it."""
    res = prim_check("rcp", "cpu", stride=(1 << 12) + 1)
    assert res["mismatches"] == 0 and res["below"] is None
    assert res["above"] is None and res["checked"] > 500_000
