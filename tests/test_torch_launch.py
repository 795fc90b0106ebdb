"""The kernels' launch path (maniac_tpu_torch/kernels/build.py) on the CPU,
with a stub in place of the kernel library: each launcher's preallocated
tables are refilled with exactly the bytes the per-call ctypes arrays of
the earlier path held, a refusal raises, a variant build takes the
launches only within build.variant, the block and step wrappers' tables
have the lengths and entries of the kernels' enums (csrc/*.cu), and the
step wrapper launches each step of a block on one clone of the state; the
micro-benchmarks K6 and K8 pass their shapes, K6 a scratch of one partial
a CTA and K8 its seven offsets, and the primitive check its scan."""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from maniac_tpu_torch import load_system, replicate
from maniac_tpu_torch.kernels import blockg, build, gpass, stepg, vpu
from maniac_tpu_torch.mc.driver import draw_uniforms
from maniac_tpu_torch.parallel.replicas import perturb_activity
from maniac_tpu_torch.systems import (make_water_box, make_water_reservoir,
                                      make_zif_like)
from maniac_tpu_torch.utils.threefry import prng_key, uniform

torch.set_num_threads(1)

CSRC = Path(build.__file__).resolve().parent / "csrc"
STREAM = 0x7F00DEAD
# the device of the stub launches' tensors (no card is touched)
DEV = torch.device("cuda", 0)


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
    monkeypatch.setattr(build, "current_stream", lambda device: STREAM)
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
        build.launch("blockg_launch", ptrs, ints, floats, DEV)
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
        build.launch("stepg_launch", [1], [2], [3.0], DEV)
    stub.ret = 0
    build.launch("stepg_launch", [1], [2], [3.0], DEV)
    assert len(stub.calls) == 2


def test_launch_refuses_a_device_that_is_not_current(monkeypatch):
    """The launchers run on the current CUDA device, so a launch whose
    tensors lie on another device (another card, or the host) raises
    before the launcher is called, and no device is switched; tensors on
    the current device launch on its current stream."""
    lib = _StubLib()
    monkeypatch.setattr(build, "library", lambda defines=(): lib)
    monkeypatch.setattr(build, "_launchers", {})
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 1,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: STREAM + index, raising=False)
    for device in (torch.device("cuda", 0), torch.device("cuda", 2),
                   torch.device("cpu")):
        with pytest.raises(RuntimeError, match=r"current CUDA device is "
                                               r"cuda:1; call torch\.cuda"
                                               r"\.set_device"):
            build.launch("blockg_launch", [1], [2], [3.0], device)
    assert lib.calls == []
    build.launch("blockg_launch", [1], [2], [3.0], torch.device("cuda", 1))
    assert [c[-1] for c in lib.calls] == [STREAM + 1]
    assert torch._C._cuda_getDevice() == 1


def _enum(source, name):
    """{entry: value} of ``enum name { ... }`` in a csrc file; an entry
    ``= NAME`` takes the value of csrc/step_body.cuh's NAME."""
    text = (CSRC / source).read_text()
    body = re.search(r"enum %s \{(.*?)\};" % name, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    out, k = {}, 0
    for e in (e.strip() for e in body.split(",")):
        if "=" in e:
            e, start = (x.strip() for x in e.split("="))
            k = _shared()[start]
        if e:
            out[e] = k
            k += 1
    return out


def _shared():
    """csrc/step_body.cuh's tables, which both step kernels take first:
    {entry: value} of StepPtr, StepInt and StepFloat."""
    return {k: v for n in ("StepPtr", "StepInt", "StepFloat")
            for k, v in _enum("step_body.cuh", n).items()}


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
    monkeypatch.setattr(build, "current_stream", lambda device: STREAM)
    build.launch("blockg_launch", [1], [2], [3.0], DEV)
    with build.variant(("MANIAC_SECTION_CLOCKS",)) as lib:
        assert lib is libs[("MANIAC_SECTION_CLOCKS",)]
        build.launch("blockg_launch", [4], [5], [6.0], DEV)
    with pytest.raises(KeyError):
        with build.variant(("MANIAC_SECTION_CLOCKS",)):
            raise KeyError("inside")
    build.launch("blockg_launch", [7], [8], [9.0], DEV)
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
def resv32(tmp_path):
    make_water_box(str(tmp_path), n_water=8, L=14.0, cutoff=5.0,
                   fugacity=2000.0, probs=(0.2, 0.2, 0.6, 0.0))
    res = make_water_reservoir(str(tmp_path), n_water=12)
    sysm = load_system(f"{tmp_path}/input.maniac",
                       f"{tmp_path}/topology.data",
                       f"{tmp_path}/parameters.inc", reservoir_file=res,
                       capacity=16, dtype=torch.float32, device="cpu")
    assert sysm.spec.has_reservoir
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
    """run_block_kernel's tables against csrc/step_body.cuh's and
    blockg.cu's enums: lengths, the outputs and then the input state, the
    far table's pointers and tile count (none on a water box)."""
    sysm = request.getfixturevalue(system)
    spec = sysm.spec
    states = replicate(spec, sysm.state, 4)
    _, u = draw_uniforms(spec, states, 3)
    out = blockg._launch(spec, states, u)
    ptrs, ints, floats = _unpack(stub.calls[-1])
    sh, bp = _shared(), _enum("blockg.cu", "BlockPtr")
    bi = _enum("blockg.cu", "BlockInt")
    assert (len(ptrs), len(ints), len(floats)) == (
        bp["BP_COUNT"], bi["BI_COUNT"], sh["SF_COUNT"])
    for key, t in (("SP_POS", out.pos), ("SP_AMPRE", out.amp_re),
                   ("BP_POS_IN", states.pos), ("BP_AMPRE_IN", states.amp_re),
                   ("BP_RES_N_IN", states.res_n),
                   ("SP_FAR_COEF", spec.far_coef),
                   ("SP_FAR_ROWS", spec.far_rows),
                   ("SP_FAR_UNITS", spec.far_units),
                   ("SP_IMG", spec.image_shifts)):
        assert ptrs[sh.get(key, bp.get(key))] == t.data_ptr(), key
    assert out.pos.data_ptr() != states.pos.data_ptr()
    assert ints[sh["SI_B"]] == 4 and ints[sh["SI_NSTEPS"]] == 3
    assert ints[sh["SI_N_FAR_TILES"]] == spec.far_units.shape[0]
    assert ints[sh["SI_KY2"]] == (spec.kmax2_xyz[1] if spec.fw_split else 0)
    assert floats[sh["SF_FW_D0"]] == pytest.approx(
        spec.host_scalars["fw_d0"] if spec.fw_split else 0.0, rel=1e-6)


def _step_calls(stub, spec, states, n_steps, seed):
    """run_steps_kernel's launches (stepg._run on CPU tensors) of one
    n_steps block: (the returned state, the uniforms, the unpacked tables
    of each launch, (csrc/step_body.cuh's shared entries, csrc/stepg.cu's
    own ints))."""
    u = uniform(prng_key(seed), (states.B, n_steps, 21), spec.dtype)
    n0, calls0 = stepg.run_steps_kernel.launches, len(stub.calls)
    out = stepg._run(spec, states, u)
    calls = [_unpack(c) for c in stub.calls[calls0:]]
    assert stepg.run_steps_kernel.launches == n0 + n_steps == n0 + len(calls)
    assert all(c[0] == "stepg_launch" for c in stub.calls[calls0:])
    return out, u, calls, (_shared(), _enum("stepg.cu", "StepgInt"))


def test_step_tables_match_the_kernel(stub, zif32):
    """run_steps_kernel's tables against csrc/step_body.cuh's and
    stepg.cu's enums: lengths, the block's uniform pointer, the step index
    0..n-1 in order, one activity table (stride 0), the far table's
    pointers and tile count."""
    spec = zif32.spec
    states = replicate(spec, zif32.state, 4)
    _, u, calls, (sh, si) = _step_calls(stub, spec, states, 3, 2)
    for k, (ptrs, ints, floats) in enumerate(calls):
        assert (len(ptrs), len(ints), len(floats)) == (
            sh["SP_SHARED"], si["SI_COUNT"], sh["SF_COUNT"])
        assert ptrs[sh["SP_U"]] == u.data_ptr()
        assert ints[si["SI_STEP"]] == k and ints[sh["SI_NSTEPS"]] == 3
        assert ints[sh["SI_B"]] == 4 and ints[si["SI_ACT_STRIDE"]] == 0
        assert ptrs[sh["SP_TYPE_ACTIVITY"]] == spec.type_activity.data_ptr()
        assert ptrs[sh["SP_FAR_COEF"]] == spec.far_coef.data_ptr()
        assert ptrs[sh["SP_FAR_UNITS"]] == spec.far_units.data_ptr()
        assert ptrs[sh["SP_IMG"]] == spec.image_shifts.data_ptr()
        assert ints[sh["SI_N_FAR_TILES"]] == spec.far_units.shape[0]
        assert ints[sh["SI_TRICLINIC"]] == 0
        assert floats[sh["SF_FW_D0"]] == pytest.approx(
            spec.host_scalars["fw_d0"], rel=1e-6)


def test_step_tables_sweep_activity_stride(stub, zif32):
    """A perturb_activity spec (one activity table per replica, (B, R)):
    the kernel reads it with stride R."""
    spec = zif32.spec
    sweep = perturb_activity(spec, spec.type_activity.expand(4, -1) * 2.0)
    states = replicate(spec, zif32.state, 4)
    _, _, calls, (sh, si) = _step_calls(stub, sweep, states, 2, 3)
    for ptrs, ints, _ in calls:
        assert ints[si["SI_ACT_STRIDE"]] == spec.R
        assert ptrs[sh["SP_TYPE_ACTIVITY"]] == sweep.type_activity.data_ptr()


@pytest.mark.parametrize("system", ["zif32", "resv32"])
def test_step_kernel_launches_on_one_clone(stub, system, request):
    """Every launch of a block updates one working copy: the state
    pointers differ from the input state's and stay the same across the
    block, the returned state is that copy (equal to the input, since the
    stub writes nothing), and the input state's tensors are unchanged; the
    reservoir is cloned only where there is one."""
    sysm = request.getfixturevalue(system)
    spec = sysm.spec
    states = replicate(spec, sysm.state, 4)
    before = {k: v.clone() for k, v in vars(states).items()}
    out, _, calls, (sp, _) = _step_calls(stub, spec, states, 4, 4)
    keys = {"SP_POS": "pos", "SP_COM": "com", "SP_AMPRE": "amp_re",
            "SP_AMPIM": "amp_im", "SP_NMOL": "n_mol", "SP_ENERGY": "energy",
            "SP_COUNTERS": "counters", "SP_EXTRAS": "extras",
            "SP_RES_OFF": "res_offset", "SP_RES_COM": "res_com",
            "SP_RES_N": "res_n", "SP_TSTEP": "trans_step",
            "SP_RSTEP": "rot_step"}
    cloned = {"trans_step": False, "rot_step": False,
              **{k: spec.has_reservoir for k in ("res_offset", "res_com",
                                                 "res_n")}}
    for entry, name in keys.items():
        ptr = {c[0][sp[entry]] for c in calls}
        assert ptr == {getattr(out, name).data_ptr()}, entry
        assert (ptr != {getattr(states, name).data_ptr()}) == cloned.get(
            name, True), entry
    for k, v in vars(states).items():
        assert torch.equal(v, before[k]), k
        assert torch.equal(getattr(out, k), before[k]), k


def test_launch_cost_tables_match_the_kernels():
    """tools/launch_cost.py prices tables of the lengths the kernels take."""
    from maniac_tpu_torch.tools.launch_cost import TABLES
    sh = _shared()
    k5 = tuple(len(_enum("hwprobe.cu", n)) - 1
               for n in ("OnehotPtr", "OnehotInt")) + (0,)
    assert TABLES["K5"] == k5
    assert TABLES["K3"] == (sh["SP_SHARED"],
                            _enum("stepg.cu", "StepgInt")["SI_COUNT"],
                            sh["SF_COUNT"])
    assert TABLES["K2"] == (_enum("blockg.cu", "BlockPtr")["BP_COUNT"],
                            _enum("blockg.cu", "BlockInt")["BI_COUNT"],
                            sh["SF_COUNT"])


@pytest.mark.parametrize("shape", [(128, 1280), (7, 1001)],
                         ids=["default", "7x1001"])
@pytest.mark.parametrize("transposed", [False, True],
                         ids=["cpass", "cpassT"])
def test_cpass_tables_match_the_kernel(stub, transposed, shape):
    """K8's tables against csrc/vpu.cu's enums: the planes, the row table
    and the output in order, the shape, n and the form, and the seven
    offsets as the float table."""
    R, C = shape
    ins = [torch.zeros((R, C)) for _ in range(4)] + [torch.zeros((4, R))]
    out = vpu._cpass_launch(*ins, 13, transposed)
    ptrs, ints, floats = _unpack(stub.calls[-1])
    kp, ki = _enum("vpu.cu", "CpassPtr"), _enum("vpu.cu", "CpassInt")
    n_t = int(re.search(r"constexpr int CPASS_T = (\d+);",
                        (CSRC / "vpu.cu").read_text()).group(1))
    assert stub.calls[-1][0] == "cpass_launch"
    assert (len(ptrs), len(ints), len(floats)) == (kp["KP_COUNT"],
                                                   ki["KI_COUNT"], n_t)
    assert ptrs == [t.data_ptr() for t in ins + [out]]
    assert ints == [R, C, 13, int(transposed)]
    assert floats == list(vpu.CPASS_OFFSETS)


@pytest.mark.parametrize("span", [(None, None, 1), (1.0, 4.0, 3)],
                         ids=["domain", "1-4"])
@pytest.mark.parametrize("name", vpu.PRIMS)
def test_prim_check_tables_match_the_kernel(stub, name, span):
    """The primitive check's tables against csrc/vpu.cu's enums: the
    tallies' buffer, then the primitive, its first bit pattern, the count
    of values and the stride."""
    lo, hi, stride = span
    out = torch.zeros(4, dtype=torch.int64)
    vpu._prim_check_launch(name, out, lo, hi, stride)
    ptrs, ints, floats = _unpack(stub.calls[-1])
    qp, qi = _enum("vpu.cu", "CheckPtr"), _enum("vpu.cu", "CheckInt")
    d_lo, d_hi = vpu.PRIM_DOMAINS[name]
    lo_b = vpu.f32_bits(d_lo if lo is None else lo)
    hi_b = vpu.f32_bits(d_hi if hi is None else hi)
    assert stub.calls[-1][0] == "prim_check_launch"
    assert (len(ptrs), len(ints), len(floats)) == (qp["QP_COUNT"],
                                                   qi["QI_COUNT"], 0)
    assert ptrs == [out.data_ptr()]
    assert ints == [vpu.PRIMS.index(name), lo_b,
                    (hi_b - lo_b) // stride + 1, stride]


@pytest.mark.parametrize("shape", [(64, 47 * 128), (61, 1000), (1, 1)],
                         ids=["default", "61x1000", "1x1"])
@pytest.mark.parametrize("variant", gpass.GPASS_VARIANTS)
def test_gpass_tables_match_the_kernel(stub, variant, shape):
    """K6's tables against csrc/gpass.cu's enums: the inputs, a scratch of
    one f64 partial a CTA of THREADS (a pair a thread) and the 0-d f64
    result, the shape, steps, variant and the scratch's length, and the
    box, cut-offs and alpha."""
    (G, S), fl = shape, 2
    ins = [torch.zeros((G, S)) for _ in range(3)] + [torch.zeros(S)] \
        + [torch.zeros((fl, S)) for _ in range(2)]
    out = gpass._launch(*ins, 10, 6, variant)
    ptrs, ints, floats = _unpack(stub.calls[-1])
    gp, gi = _enum("gpass.cu", "GpassPtr"), _enum("gpass.cu", "GpassInt")
    gf = _enum("gpass.cu", "GpassFloat")
    threads = int(re.search(r"constexpr int THREADS = (\d+);",
                            (CSRC / "gpass.cu").read_text()).group(1))
    assert gpass.GPASS_THREADS == threads
    assert stub.calls[-1][0] == "gpass_launch"
    assert (len(ptrs), len(ints), len(floats)) == (
        gp["GP_COUNT"], gi["GI_COUNT"], gf["GF_COUNT"])
    assert ptrs[:gp["GP_PARTIAL"]] == [t.data_ptr() for t in ins]
    assert ptrs[gp["GP_OUT"]] == out.data_ptr()
    assert out.shape == () and out.dtype == torch.float64
    ctas = -(-G * S // threads)
    assert ints == [G, S, fl, 6, 10, gpass.GPASS_VARIANTS.index(variant),
                    ctas]
    assert ints[gi["GI_VARIANT"]] == _enum("gpass.cu", "GpassVariant")[
        "GV_" + variant.upper()]
    assert ints[gi["GI_PARTIALS"]] == ctas
    assert floats == pytest.approx([gpass.BOX_L, gpass.RC2, gpass.GGR2,
                                    gpass.ALPHA], rel=1e-7)
