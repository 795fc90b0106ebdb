"""tools/micro_times's readers on the CPU: the SASS parser, the slow-path
and innermost-loop finders, the instruction mix a pair with its issue-slot
floor, K7's mix an application of its op and its pass floor, and the ptxas
register lines, on small hand-written listings in cuobjdump's and ptxas's
formats."""

import collections

import pytest

from maniac_tpu_torch.tools import micro_times as mt

# a loop 0x10-0xb0 with one rsqrt pair, an IEEE reciprocal whose slow path
# (0x50-0x60: the call and the branch past the fast path) normal operands
# never run, and a function whose backward branch names a label
SASS = """
\tFunction : kern_a
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   MOV R1, c[0x0][0x28] ;   /* 0x0 */
        /*0010*/                   FFMA R2, R3, R4, R5 ;    /* 0x0 */
        /*0020*/                   MUFU.RSQ R6, R2 ;        /* 0x0 */
        /*0030*/                   FMUL R7, R6, R6 ;        /* 0x0 */
        /*0040*/               @P0 BRA 0x70 ;               /* 0x0 */
        /*0050*/                   CALL.REL.NOINC 0x100 ;   /* 0x0 */
        /*0060*/                   BRA 0x80 ;               /* 0x0 */
        /*0070*/                   MUFU.RCP R8, R7 ;        /* 0x0 */
        /*0080*/                   FRND R9, R8 ;            /* 0x0 */
        /*0090*/                   IADD3 R10, R10, 0x1, RZ ; /* 0x0 */
        /*00a0*/                   ISETP.GE.AND P1, PT, R10, R11, PT ;
        /*00b0*/              @!P1 BRA 0x10 ;               /* 0x0 */
        /*00c0*/                   EXIT ;                   /* 0x0 */
        /*0100*/                   RET.REL.NODEC R20 0x0 ;  /* 0x0 */
\tFunction : kern_b
.L_x_0:
        /*0000*/                   FADD R2, R2, R3 ;        /* 0x0 */
        /*0010*/                   MUFU.EX2 R4, R2 ;        /* 0x0 */
        /*0020*/              @!P0 BRA `(.L_x_0) ;          /* 0x0 */
        /*0030*/                   EXIT ;                   /* 0x0 */
"""


def test_parse_sass_reads_functions_and_branch_targets():
    """Each function's instructions with their addresses, opcodes and
    predication; branch targets given as addresses or as labels."""
    funcs = mt.parse_sass(SASS)
    assert set(funcs) == {"kern_a", "kern_b"}
    a = funcs["kern_a"]
    assert [op for _, op, _, _ in a][:3] == ["MOV", "FFMA", "MUFU.RSQ"]
    branches = {addr: (t, pred) for addr, op, t, pred in a
                if op == "BRA"}
    assert branches == {0x40: (0x70, True), 0x60: (0x80, False),
                        0xb0: (0x10, True)}
    assert [(op, t) for _, op, t, _ in funcs["kern_b"]
            if op == "BRA"] == [("BRA", 0x0)]


def test_innermost_loop_leaves_out_the_slow_path():
    """The loop runs from the backward branch's target to the branch; the
    reciprocal's slow path (the call and its branch) is not counted."""
    insns = mt.parse_sass(SASS)["kern_a"]
    assert mt.slow_paths(insns) == {0x50, 0x60}
    (start, end, ops), = mt.innermost_loops(insns)
    assert (start, end) == (0x10, 0xb0)
    assert ops == collections.Counter({"FFMA": 1, "MUFU.RSQ": 1, "FMUL": 1,
                                       "BRA": 2, "MUFU.RCP": 1, "FRND": 1,
                                       "IADD3": 1, "ISETP.GE.AND": 1})
    (s2, e2, ops2), = mt.innermost_loops(mt.parse_sass(SASS)["kern_b"])
    assert (s2, e2) == (0x0, 0x20) and ops2["MUFU.EX2"] == 1


def test_loop_mix_classes_and_issue_floor():
    """A pair is a loop's MUFU.RSQ (else its MUFU.RCP); the floor is the
    larger of all instructions over 128 and the MUFU and conversion
    results over 16, in SM clocks a pair."""
    (_, _, ops), = mt.innermost_loops(mt.parse_sass(SASS)["kern_a"])
    pairs, per, floor = mt.loop_mix(ops)
    assert pairs == 1
    assert per == {"control": 2.0, "conversion": 1.0, "fp32": 2.0,
                   "integer": 2.0, "mufu": 2.0}
    assert floor == pytest.approx(max(9 / 128, 3 / 16))
    many = collections.Counter({"FFMA": 600, "MUFU.RCP": 2})
    assert mt.loop_mix(many) == (2, {"fp32": 300.0, "mufu": 1.0},
                                 pytest.approx(301 / 128))
    assert mt.loop_mix(collections.Counter({"FFMA": 4})) == (0, {}, 0.0)


@pytest.mark.parametrize("op,cls", [
    ("MUFU.EX2", "mufu"), ("FRND.FLOOR", "conversion"),
    ("I2F.S32", "conversion"), ("FSETP.GEU.AND", "fp32"), ("FSEL", "fp32"),
    ("LDG.E", "memory"),
    ("BSSY", "control"), ("ULDC.64", "uniform"), ("DADD", "fp64"),
    ("IMAD.WIDE", "integer"), ("LOP3.LUT", "integer")])
def test_classify_opcodes(op, cls):
    """Each opcode's class by its base name."""
    assert mt._classify(op) == cls


def test_registers_reads_the_pass_kernels(capsys):
    """The K6 and K8 kernels' registers and spills from a ptxas -v log;
    other kernels are left out."""
    cpass = "_Z12cpass_kernelILb0EEv9CpassArgs"
    gpass = "_Z12gpass_kernelILb1ELb1EEv9GpassArgs"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{cpass}' for 'sm_90a'",
        f"ptxas info    : Function properties for {cpass}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 55 registers, 0 bytes smem, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_Z12chain_kernelILi0EEvPKfPfii' for 'sm_90a'",
        "ptxas info    : Used 8 registers, 380 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{gpass}' for 'sm_90a'",
        f"ptxas info    : Function properties for {gpass}",
        "    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 37 registers, 32 bytes smem, 432 bytes cmem[0]"])
    mt.registers(log)
    out = capsys.readouterr().out.splitlines()
    assert out == [f"ptxas {cpass}: 55 registers, 0 bytes spilled",
                   f"ptxas {gpass}: 37 registers, 4 bytes spilled"]


@pytest.mark.parametrize("op,ops,apps,floor", [
    # the reciprocal chain: FADD, MUFU.RCP and two FFMA an application;
    # 16 SFU results over 16 a clock
    ("div", {"FADD": 16, "MUFU.RCP": 16, "FFMA": 32, "IADD3": 1, "BRA": 1},
     16, 1 / 16),
    # two FMUL an application, issue-bound
    ("mul2", {"FMUL": 32, "ISETP.GE.AND": 1, "BRA": 1}, 16, 34 / 16 / 128),
    # erfc marks its applications by its exp
    ("erfc", {"MUFU.EX2": 16, "MUFU.RCP": 16, "FFMA": 240}, 16,
     272 / 16 / 128),
    ("round", {"FMUL": 16, "FRND": 16, "FADD": 16}, 16, 1 / 16),
    ("cmpsel", {"FSETP.GT.AND": 8, "FSEL": 8, "FMUL": 8}, 8, 3 / 128),
    ("fma", {"FADD": 4}, 0, 0.0)])
def test_chain_mix_an_application(op, ops, apps, floor):
    """K7's loop mix: the applications are the op's marks over the marks
    an application issues; the floor in SM clocks an application."""
    n, per, f = mt.chain_mix(collections.Counter(ops), op)
    assert n == apps and f == pytest.approx(floor)
    if apps:
        assert sum(per.values()) == pytest.approx(sum(ops.values()) / apps)


def test_chain_op_and_pass_floor():
    """A chain_kernel<OP> instantiation's op, and a pass's floor in ms."""
    assert mt.chain_op("_ZN38_GLOBAL__N__6_vpu_cu12chain_kernelILi8EEEvPKfPfii"
                       ) == "erfc"
    assert mt.chain_op("_Z12cpass_kernelILb0EEv9CpassArgs") is None
    # 1/16 clock an application, 128 x 1280 x 512 element-ops on 132 SMs
    # at 1980 MHz: the SFU floor of 0.020 ms
    assert mt.chain_floor_ms(1 / 16, 128 * 1280 * 512, 132, 1980.0) == \
        pytest.approx(0.02007, rel=1e-3)


# T's shape (csrc/threefry.cu): a preamble every warp runs, warp 0's split
# that a predicated forward branch skips for the other warps, the value's
# path after the barrier, an early predicated EXIT, and the padding after
# the last EXIT
T_SASS = """
\tFunction : _ZN11_threefry_cu15threefry_kernelIfEEvPKxPxPT_i
        /*0000*/                   S2R R2, SR_TID.X ;
        /*0010*/                   ISETP.GT.U32.AND P0, PT, R2, 0x1f, PT ;
        /*0020*/               @P0 BRA 0x60 ;
        /*0030*/                   IMAD.IADD R8, R4, 0x1, R9 ;
        /*0040*/                   SHF.L.W.U32.HI R9, R9, 0xd, R9 ;
        /*0050*/                   STS.64 [UR4], R8 ;
        /*0060*/                   BSYNC B0 ;
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0080*/               @P0 EXIT ;
        /*0090*/                   IMAD.IADD R6, R4, 0x1, R3 ;
        /*00a0*/                   SHF.L.W.U32.HI R3, R3, 0xd, R3 ;
        /*00b0*/                   LOP3.LUT R3, R6, R3, RZ, 0x3c, !PT ;
        /*00c0*/                   IADD3 R5, R4, 0x5, R5 ;
        /*00d0*/                   LEA.HI R5, R5, 0x3f800000, RZ, 0x17 ;
        /*00e0*/                   FADD R0, R5, -1 ;
        /*00f0*/                   STG.E desc[UR6][R4.64], R3 ;
        /*0100*/                   EXIT ;
        /*0110*/                   BRA 0x110;
        /*0120*/                   NOP;
"""


def test_threefry_mix_splits_warp0_and_floors_by_pipe():
    """T's SASS: every thread's instructions up to the last unpredicated
    EXIT by pipe, warp 0's split apart; the floor is the busiest pipe's
    (here the ALU's: 5 of 14 over 64 lanes), the split spread over a CTA's
    8 warps."""
    insns, = mt.parse_sass(T_SASS).values()
    every, warp0 = mt.threefry_mix(insns)
    assert every == {"special": 1, "alu": 5, "control": 5, "imad": 1,
                     "fp32": 1, "memory": 1}
    assert warp0 == {"imad": 1, "alu": 1, "memory": 1}
    bare, split = mt.threefry_floor(every, warp0)
    assert bare == pytest.approx(max(14 / 128, 5 / 64))
    assert split == pytest.approx(max((14 + 3 / 8) / 128, (5 + 1 / 8) / 64))
    assert mt.pipe("IMAD.WIDE") == "imad" and mt.pipe("VIADD") == "alu"
    assert mt.pipe("S2UR") == "special" and mt.pipe("ULEA") == "uniform"
