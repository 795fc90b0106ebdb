"""Times of the micro-benchmark kernels K6 (csrc/gpass.cu), K7 and K8
(csrc/vpu.cu) on the card, each two ways, so that two trees of the
package are timed alike.

    python -m maniac_tpu_torch.tools.micro_times [--reps 20] [--sass DIR]

At the JAX tools' default shapes (K6: G 64, 47 x 128 sites, FL 2, FQ 6,
100 steps, tools/gpass_bench.inputs; K7 and K8: (128, 1280) planes,
n 512, tools/vpu_bench), per call: device-paced (kernel_times.device_ms:
the calls queued behind a spin kernel, so the card runs them back to
back) and host-paced (cuda_ms: CUDA events around the calls as the host
enqueues them); device-paced times are the smallest of three passes
(device_min_ms). K6's cur, noerfc and nowrap and K8's two forms are also
timed device-paced at twice the work (200 steps; n 1024), with the ratio,
which is near 2 when every step and iteration is computed (GROWTH_MIN is
the least chip_smoke.py accepts). ``--sass DIR`` writes
``cuobjdump -sass`` of the K6 and K8 kernels into DIR and prints, for
each innermost loop, its instructions a pair by class (FP32 pipe, MUFU,
conversions, integer and the rest; the out-of-line slow paths that
normal operands never run left out) and the issue-slot floor they give
at 128 instructions and 16 MUFU or conversion results per SM a clock.
It also reads the SM clock and power draw while K6 runs. A run that
builds the library prints the K6 and K8 kernels' registers and spills.

The file imports only what the package has had since K6-K8 were ported
and kernel_times.device_ms, so a copy of it in an earlier tree times that
tree the same way.
"""

from __future__ import annotations

import argparse
import collections
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from . import card_label, cuda_ms, require_cuda
from .kernel_times import device_ms

GROWTH_MIN = 1.8
PASSES = 3
PAIR_VARIANTS = ("cur", "noerfc", "nowrap")
CPASS_FORMS = ("cpass", "cpassT")


def device_min_ms(fn, reps: int, passes: int = PASSES) -> float:
    """The smallest of ``passes`` device-paced means (device_ms). The spin
    kernel that covers the host's issue is sized from a clock read just
    before; a pass whose host issue outlasts it (the clock still ramping
    from idle, a host stall) reads high (K8's cpassT once read 0.306 ms
    against 0.181 on an H100), so one pass alone is not taken."""
    return min(device_ms(fn, reps) for _ in range(passes))


def growth(fn, reps: int) -> tuple[float, float, float]:
    """fn(1) and fn(2) (a call and the same call with twice the work),
    device-paced (device_min_ms): (ms, ms at twice the work, their
    ratio)."""
    a = device_min_ms(lambda: fn(1), reps)
    b = device_min_ms(lambda: fn(2), reps)
    return a, b, b / a


def _k6(dev):
    from . import gpass_bench
    G, S = gpass_bench.G, gpass_bench.NC * 128
    return gpass_bench.inputs(G, S, gpass_bench.FL, dev), gpass_bench.NSTEP, \
        gpass_bench.FQ


def _k8(dev):
    from . import vpu_bench
    return vpu_bench.cpass_inputs(vpu_bench.ROWS, vpu_bench.COLS, dev), \
        vpu_bench.N


def kernel_times(dev, reps: int, label: str) -> None:
    """K6, K8 and K7 at the tools' default shapes, both ways, and the
    growth at twice the work."""
    from ..kernels.gpass import GPASS_VARIANTS, gpass
    from ..kernels.vpu import VPU_OPS, cpass, vpu_chain
    from . import vpu_bench
    ins, n_steps, fq = _k6(dev)
    for v in GPASS_VARIANTS:
        dms = device_min_ms(lambda: gpass(*ins, n_steps, fq, v), reps)
        hms = cuda_ms(lambda: gpass(*ins, n_steps, fq, v), reps)
        line = f"K6 gpass {v:7s} device {dms:.4f} ms, host {hms:.4f} ms"
        if v in PAIR_VARIANTS:
            _, b, ratio = growth(
                lambda k: gpass(*ins, k * n_steps, fq, v), reps)
            line += f"; {2 * n_steps} steps {b:.4f} ms, x{ratio:.3f}"
        print(f"{line} ({label})", flush=True)
    cins, n = _k8(dev)
    for name in CPASS_FORMS:
        tr = name == "cpassT"
        dms = device_min_ms(lambda: cpass(*cins, n, tr), reps)
        hms = cuda_ms(lambda: cpass(*cins, n, tr), reps)
        _, b, ratio = growth(lambda k: cpass(*cins, k * n, tr), reps)
        print(f"K8 {name:6s} device {dms:.4f} ms, host {hms:.4f} ms; n "
              f"{2 * n} {b:.4f} ms, x{ratio:.3f} ({label})", flush=True)
    x = vpu_bench.plane(vpu_bench.ROWS, vpu_bench.COLS, dev)
    for op in VPU_OPS:
        dms = device_min_ms(lambda: vpu_chain(x, op, n), reps)
        hms = cuda_ms(lambda: vpu_chain(x, op, n), reps)
        print(f"K7 {op:6s} device {dms:.4f} ms, host {hms:.4f} ms "
              f"({label})", flush=True)


def clock_under_load(dev, seconds: float = 1.5) -> str:
    """nvidia-smi's SM clock and power draw while the card runs K6's cur
    pass back to back for about ``seconds``."""
    from ..kernels.gpass import gpass
    ins, n_steps, fq = _k6(dev)
    calls = max(1, int(seconds / (device_ms(
        lambda: gpass(*ins, n_steps, fq, "cur"), 5) * 1e-3)))
    for _ in range(calls):
        gpass(*ins, n_steps, fq, "cur")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    torch.cuda.synchronize()
    return out.strip()


# ---- SASS ------------------------------------------------------------------
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
FP32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FSET", "FCHK",
        "FSWZADD"}
SLOW = {"MUFU", "FRND", "I2F", "F2I", "F2F"}
MEMORY = {"LDG", "STG", "LDS", "STS", "LDC", "LDL", "STL", "SHFL", "ATOM",
          "ATOMG", "RED", "LD", "ST"}
CONTROL = {"BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "BAR", "WARPSYNC",
           "NOP", "BMOV", "YIELD"}


def _classify(op: str) -> str:
    base = op.split(".")[0]
    if base == "MUFU":
        return "mufu"
    if base in SLOW:
        return "conversion"
    if base in FP32:
        return "fp32"
    if base in MEMORY:
        return "memory"
    if base in CONTROL:
        return "control"
    if base.startswith("U"):
        return "uniform"
    if base.startswith("D"):
        return "fp64"
    return "integer"


def parse_sass(text: str) -> dict:
    """{function: [(address, opcode, branch target or None, predicated)]}
    from cuobjdump -sass, branch targets given as addresses ("0x1a0") or
    labels (".L_x_3") resolved to addresses."""
    funcs, name, labels, pending = {}, None, {}, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name], labels[name] = [], {}
            continue
        if name is None:
            continue
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for p in pending:
                labels[name][p] = addr
            pending = []
            funcs[name].append((addr, m.group(3), m.group(4).strip(),
                                bool(m.group(2))))
    out = {}
    for fn, insns in funcs.items():
        resolved = []
        for addr, op, args, pred in insns:
            target = None
            if op.split(".")[0] == "BRA":
                t = re.search(r"0x([0-9a-f]+)", args)
                lab = re.search(r"(\.L_x_\d+)", args)
                if lab and lab.group(1) in labels[fn]:
                    target = labels[fn][lab.group(1)]
                elif t:
                    target = int(t.group(1), 16)
            resolved.append((addr, op, target, pred))
        out[fn] = resolved
    return out


SLOW_PATH_MAX = 8


def slow_paths(insns) -> set:
    """Addresses of the slow paths that normal operands never run (the
    IEEE reciprocal's, for one): at most SLOW_PATH_MAX instructions that a
    predicated forward branch jumps over, which call a subroutine and end
    in an unpredicated branch past the fast path."""
    out = set()
    for k, (a, op, t, pred) in enumerate(insns):
        if not (pred and t is not None and t > a):
            continue
        skipped = [x for x in insns[k + 1:k + 2 + SLOW_PATH_MAX] if x[0] < t]
        if (skipped and len(skipped) <= SLOW_PATH_MAX
                and any(x[1].startswith("CALL") for x in skipped)
                and skipped[-1][1] == "BRA" and not skipped[-1][3]
                and (len(insns) == k + 1 + len(skipped)
                     or insns[k + 1 + len(skipped)][0] == t)):
            out.update(x[0] for x in skipped)
    return out


def innermost_loops(insns) -> list:
    """[(start, end, Counter of the opcodes that run)] of the loops (a
    backward branch and its target) that hold no other loop, without
    their slow paths."""
    loops = [(t, a) for a, op, t, _ in insns if t is not None and t <= a]
    inner = [(s, e) for s, e in loops
             if not any(s <= s2 and e2 <= e and (s2, e2) != (s, e)
                        for s2, e2 in loops)]
    slow = slow_paths(insns)
    return [(s, e, collections.Counter(op for a, op, *_ in insns
                                       if s <= a <= e and a not in slow))
            for s, e in sorted(set(inner))]


def loop_mix(ops: collections.Counter) -> tuple[int, dict, float]:
    """(pairs in the loop body: its MUFU.RSQ, else its MUFU.RCP; the
    instructions a pair by class; the issue-slot floor in SM clocks a
    pair: the larger of all instructions over 128 and the MUFU and
    conversion results over 16)."""
    pairs = ops.get("MUFU.RSQ", 0) or ops.get("MUFU.RCP", 0)
    if not pairs:
        return 0, {}, 0.0
    mix = collections.Counter()
    for op, k in ops.items():
        mix[_classify(op)] += k
    per = {c: k / pairs for c, k in sorted(mix.items())}
    total = sum(per.values())
    slow = per.get("mufu", 0.0) + per.get("conversion", 0.0)
    return pairs, per, max(total / 128.0, slow / 16.0)


def _cuobjdump() -> str:
    for path in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if path and Path(path).exists():
            return path
    raise RuntimeError("cuobjdump not found")


def registers(log: str) -> None:
    """The K6 and K8 kernels' registers and spills from a ptxas -v log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"entry function '(\S*(?:cpass|gpass)\S*kernel\S*)'",
                      line)
        if m:
            info = " ".join(x.strip() for x in lines[i + 1:i + 4]
                            if "registers" in x or "spill" in x)
            regs = re.search(r"Used (\d+) registers", info)
            spill = re.search(r"(\d+) bytes spill stores", info)
            print(f"ptxas {m.group(1)}: {regs.group(1) if regs else '?'} "
                  f"registers, {spill.group(1) if spill else '?'} bytes "
                  f"spilled", flush=True)


def sass_report(out_dir: str) -> None:
    """cuobjdump -sass of the K6 and K8 kernels into out_dir, and each
    innermost loop's mix a pair."""
    from ..kernels import build
    text = subprocess.run(
        [_cuobjdump(), "-sass", str(build.library_path())],
        capture_output=True, text=True, check=True).stdout
    d = Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    funcs = parse_sass(text)
    keep = [f for f in funcs if "cpass_kernel" in f or "gpass_kernel" in f]
    blocks = text.split("Function : ")
    (d / "micro_kernels.sass").write_text("".join(
        "Function : " + b for b in blocks[1:]
        if any(b.startswith(f) for f in keep)))
    for fn in keep:
        for start, end, ops in innermost_loops(funcs[fn]):
            pairs, per, floor = loop_mix(ops)
            if not pairs:
                continue
            mufu = {op: k for op, k in sorted(ops.items())
                    if op.split(".")[0] in SLOW}
            print(f"sass {fn} loop 0x{start:x}-0x{end:x}: {pairs} pairs, "
                  f"a pair " + ", ".join(f"{c} {v:.2f}"
                                         for c, v in per.items())
                  + f"; slow ops {mufu}; issue floor {floor:.4f} SM "
                    f"clocks a pair", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m maniac_tpu_torch.tools.micro_times",
        description="K6-K8 on the card, device- and host-paced")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", metavar="DIR",
                    help="write the K6 and K8 kernels' SASS into DIR and "
                         "print their loops' instruction mix")
    args = ap.parse_args(argv)
    if not require_cuda("micro_times"):
        return 1
    from ..kernels import build
    dev = torch.device("cuda")
    label = card_label()
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"# device: {label}; SM clock, max: {clocks.strip()}", flush=True)
    build.library()
    registers(build.build_log)    # empty when the build was cached
    kernel_times(dev, args.reps, label)
    print(f"# SM clock, power draw under K6 cur: {clock_under_load(dev)}",
          flush=True)
    if args.sass:
        sass_report(args.sass)
    return 0


if __name__ == "__main__":
    sys.exit(main())
