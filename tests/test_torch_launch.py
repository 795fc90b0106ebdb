"""The kernels' launch path (maniac_tpu_torch/kernels/build.py) on the CPU,
with a stub in place of the kernel library: each launcher's preallocated
tables are refilled with exactly the bytes the per-call ctypes arrays of
the earlier path held, a refusal raises, a variant build takes the
launches only within build.variant, and the block and step wrappers'
tables have the lengths and entries of the kernels' enums (csrc/*.cu)."""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from maniac_tpu_torch import load_system, replicate
from maniac_tpu_torch.kernels import blockg, build, stepg
from maniac_tpu_torch.mc.driver import draw_uniforms
from maniac_tpu_torch.mc.moves import _propose
from maniac_tpu_torch.systems import make_water_box, make_zif_like

torch.set_num_threads(1)

CSRC = Path(build.__file__).resolve().parent / "csrc"
STREAM = 0x7F00DEAD


class _StubLib:
    """Stands in for the kernel library: every ``*_launch`` records the
    bytes of its three tables (read at the addresses it is given), the
    counts and the stream, and returns ``ret``."""

    def __init__(self):
        self.calls = []
        self.ret = 0

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)

        def launcher(p, n_p, i, n_i, f, n_f, stream):
            self.calls.append((name, ctypes.string_at(p, 8 * n_p), n_p,
                               ctypes.string_at(i, 4 * n_i), n_i,
                               ctypes.string_at(f, 4 * n_f), n_f, stream))
            return self.ret
        return launcher

    def maniac_error_string(self, err):
        return f"stub error {err}".encode()


@pytest.fixture
def stub(monkeypatch):
    lib = _StubLib()
    monkeypatch.setattr(build, "library", lambda defines=(): lib)
    monkeypatch.setattr(build, "_launchers", {})
    monkeypatch.setattr(build, "current_stream", lambda: STREAM)
    return lib


def _before(ptrs, ints, floats):
    """The tables as the earlier path built them on every call."""
    return (bytes((ctypes.c_void_p * len(ptrs))(*ptrs)),
            bytes((ctypes.c_int * len(ints))(*ints)),
            bytes((ctypes.c_float * len(floats))(*floats)))


def test_launch_packs_the_tables_as_before(stub):
    """Calls of one launcher with new values, a new table length and an
    empty float table: each call passes the earlier path's bytes, the
    counts and the current stream."""
    calls = [([0x7F0000001000, 0, 2**63 + 8], [3, -1, 2**31 - 1],
              [0.1, -2.5e-8, 1e30]),
             ([0x1234, 0x7F0000002000, 4096], [7, 0, -5], [3.0, 0.0, 1e-40]),
             ([1, 2, 3, 4, 5], [9] * 8, []),
             ([0x10] * 60, list(range(-12, 12)), [float(k) / 7 for k in
                                                   range(12)])]
    for ptrs, ints, floats in calls:
        build.launch("blockg_launch", ptrs, ints, floats)
    assert len(build._launchers) == 1
    for (ptrs, ints, floats), got in zip(calls, stub.calls):
        p, i, f = _before(ptrs, ints, floats)
        assert got == ("blockg_launch", p, len(ptrs), i, len(ints), f,
                       len(floats), STREAM)


def test_launch_raises_on_refusal(stub):
    """A launcher's nonzero return raises with its code and message; the
    next call launches again."""
    stub.ret = 100002
    with pytest.raises(RuntimeError, match=r"stepg_launch failed: error "
                                           r"100002 \(stub error 100002\)"):
        build.launch("stepg_launch", [1], [2], [3.0])
    stub.ret = 0
    build.launch("stepg_launch", [1], [2], [3.0])
    assert len(stub.calls) == 2


def _enum(source, name):
    """{entry: index} of ``enum name { ... }`` in a csrc file."""
    text = (CSRC / source).read_text()
    body = re.search(r"enum %s \{(.*?)\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return {e.strip(): k for k, e in enumerate(body.split(",")) if e.strip()}


def _unpack(call):
    _, p, n_p, i, n_i, f, n_f, _ = call
    return (list((ctypes.c_uint64 * n_p).from_buffer_copy(p)),
            list((ctypes.c_int * n_i).from_buffer_copy(i)),
            list((ctypes.c_float * n_f).from_buffer_copy(f)))


def test_variant_takes_launches_within_its_block(monkeypatch):
    """Within build.variant(defines) a launcher runs from the library built
    with those macros; before and after it, and after an error inside it,
    from the production build."""
    libs = {(): _StubLib(), ("MANIAC_SECTION_CLOCKS",): _StubLib()}
    monkeypatch.setattr(build, "library", lambda defines=(): libs[defines])
    monkeypatch.setattr(build, "_launchers", {})
    monkeypatch.setattr(build, "current_stream", lambda: STREAM)
    build.launch("blockg_launch", [1], [2], [3.0])
    with build.variant(("MANIAC_SECTION_CLOCKS",)) as lib:
        assert lib is libs[("MANIAC_SECTION_CLOCKS",)]
        build.launch("blockg_launch", [4], [5], [6.0])
    with pytest.raises(KeyError):
        with build.variant(("MANIAC_SECTION_CLOCKS",)):
            raise KeyError("inside")
    build.launch("blockg_launch", [7], [8], [9.0])
    assert [_unpack(c)[0] for c in libs[()].calls] == [[1], [7]]
    assert [_unpack(c)[0] for c in
            libs[("MANIAC_SECTION_CLOCKS",)].calls] == [[4]]


def _load_cpu(d, capacity):
    return load_system(f"{d}/input.maniac", f"{d}/topology.data",
                       f"{d}/parameters.inc", capacity=capacity,
                       dtype=torch.float32, device="cpu")


@pytest.fixture
def zif32(tmp_path):
    make_zif_like(str(tmp_path), n_cells=4, a=5.66, n_water=10,
                  fugacity=50.0, cutoff=6.0)
    sysm = _load_cpu(tmp_path, 16)
    assert sysm.spec.far_units.shape[0] > 0
    return sysm


@pytest.fixture
def water32(tmp_path):
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=6.0,
                   fugacity=400.0, probs=(0.3, 0.2, 0.5, 0.0))
    sysm = _load_cpu(tmp_path, 16)
    assert sysm.spec.far_units.shape[0] == 0
    return sysm


@pytest.mark.parametrize("system", ["zif32", "water32"])
def test_block_tables_match_the_kernel(stub, system, request):
    """run_block_kernel's tables against csrc/blockg.cu's enums: lengths,
    the far table's pointers and tile count (none on a water box)."""
    sysm = request.getfixturevalue(system)
    spec = sysm.spec
    states = replicate(spec, sysm.state, 4)
    gen = torch.Generator().manual_seed(1)
    blockg._launch(spec, states, draw_uniforms(spec, 4, 3, gen))
    ptrs, ints, floats = _unpack(stub.calls[-1])
    bp = _enum("blockg.cu", "BlockPtr")
    bi = _enum("blockg.cu", "BlockInt")
    bf = _enum("blockg.cu", "BlockFloat")
    assert (len(ptrs), len(ints), len(floats)) == (
        bp["BP_COUNT"], bi["BI_COUNT"], bf["BF_COUNT"])
    for key, t in (("BP_U", None), ("BP_POS_IN", states.pos),
                   ("BP_FAR_COEF", spec.far_coef),
                   ("BP_FAR_ROWS", spec.far_rows),
                   ("BP_FAR_UNITS", spec.far_units),
                   ("BP_IMG", spec.image_shifts)):
        if t is not None:
            assert ptrs[bp[key]] == t.data_ptr(), key
    assert ints[bi["BI_B"]] == 4 and ints[bi["BI_NSTEPS"]] == 3
    assert ints[bi["BI_N_FAR_TILES"]] == spec.far_units.shape[0]
    assert ints[bi["BI_KY2"]] == spec.kmax2_xyz[1]
    assert floats[bf["BF_FW_D0"]] == pytest.approx(
        spec.host_scalars["fw_d0"], rel=1e-6)


def test_step_tables_match_the_kernel(stub, zif32):
    """step_core's tables against csrc/stepg.cu's enums."""
    spec = zif32.spec
    states = replicate(spec, zif32.state, 4)
    gen = torch.Generator().manual_seed(2)
    pre = _propose(spec, states, draw_uniforms(spec, 4, 1, gen)[:, 0])
    stepg._launch(spec, states, pre)
    ptrs, ints, floats = _unpack(stub.calls[-1])
    sp = _enum("stepg.cu", "StepPtr")
    si = _enum("stepg.cu", "StepInt")
    sf = _enum("stepg.cu", "StepFloat")
    assert (len(ptrs), len(ints), len(floats)) == (
        sp["SP_COUNT"], si["SI_COUNT"], sf["SF_COUNT"])
    assert ptrs[sp["SP_FAR_COEF"]] == spec.far_coef.data_ptr()
    assert ptrs[sp["SP_FAR_UNITS"]] == spec.far_units.data_ptr()
    assert ptrs[sp["SP_IMG"]] == spec.image_shifts.data_ptr()
    assert ints[si["SI_N_FAR_TILES"]] == spec.far_units.shape[0]
    assert ints[si["SI_TRICLINIC"]] == 0


def test_launch_cost_tables_match_the_kernels():
    """tools/launch_cost.py prices tables of the lengths the kernels take."""
    from maniac_tpu_torch.tools.launch_cost import TABLES
    for key, src, names in (
            ("K5", "hwprobe.cu", ("OnehotPtr", "OnehotInt", None)),
            ("K3", "stepg.cu", ("StepPtr", "StepInt", "StepFloat")),
            ("K2", "blockg.cu", ("BlockPtr", "BlockInt", "BlockFloat"))):
        want = tuple(len(_enum(src, n)) - 1 if n else 0 for n in names)
        assert TABLES[key] == want, key
