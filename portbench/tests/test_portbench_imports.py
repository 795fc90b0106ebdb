"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run

PKG = run.PKG
# the plain reference and the yardstick's counting
REFERENCE = [p for p in PKG.rglob("*.py") if "ref" in p.relative_to(PKG)
             .parts] + [PKG / "bounds.py", PKG / "systems.py",
                        PKG / "oracle.py", PKG / "compare.py",
                        PKG / "tests" / "framework.py"] + sorted(
                            (PKG / "writers").glob("*.py"))


def top_level_imports(path: Path) -> set:
    """Top-level names of every absolute import in a file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        bad = top_level_imports(path) & set(run.FORBIDDEN)
        assert not bad, f"{path.relative_to(PKG)} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE:
        names = top_level_imports(path)
        assert "maniac_tpu_torch" not in names, path
        assert not names & set(run.FORBIDDEN), path


def test_forbidden_names_compare_whole():
    """maniac_tpu_torch starts with maniac_tpu and is not refused."""
    assert run.forbidden_modules(["maniac_tpu_torch.api", "numpy"]) == []
    assert run.forbidden_modules(["maniac_tpu.api", "jax.numpy",
                                  "flax"]) == ["flax", "jax", "maniac_tpu"]


RUNS = {
    "tiny": "root = tiny.make_copy(Path(TMP)); bench = None\n"
            "cell = 'tiny_spce.tiny_replicas'\n",
    "framework": "root, bench = framework.make_copy(Path(TMP), 'small')\n"
                 "cell = framework.cell_name('fw_mixed', 'small')\n",
}


@pytest.mark.parametrize("kind", sorted(RUNS))
def test_a_run_loads_no_jax(tmp_path, kind):
    """A whole rehearsal run in a fresh process (the tiny water box, and
    the framework with two guest types through the residue writer, the
    generalised oracle and comparison), then the modules it loaded, by
    top-level name."""
    code = (
        "import sys, json\n"
        "from pathlib import Path\n"
        "from types import SimpleNamespace\n"
        "from portbench import run\n"
        "from portbench.tests import framework, tiny\n"
        f"TMP = {str(tmp_path)!r}\n" + RUNS[kind] +
        "a = SimpleNamespace(workload=cell, seed=3, seconds=0.1, trace=1)\n"
        "run.run(a, root=root, device='cpu', bench=bench)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(__import__("json").loads(out.stdout.splitlines()[-1]))
    assert "maniac_tpu_torch" in loaded
    assert not loaded & set(run.FORBIDDEN)
