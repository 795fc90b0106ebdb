"""maniac_tpu_torch/bench.py, the port's bench, on the CPU.

  * ``python -m maniac_tpu_torch.bench`` exits non-zero without a card and
    prints no result line; the module and tools/bounds.py import no jax;
  * each of SYSTEMS writes the files that bench.py's own calls
    (bench.py:91-110, copied here literally) write with maniac_tpu.systems,
    byte for byte, the deck knobs included;
  * bigS at the bench's capacity loads in f64 to the JAX package's initial
    energies within 1e-9 relative;
  * run() rehearses the bench at a tiny size on the CPU: every key of the
    JSON line, the plain path named, its checks passed (for resv molecules
    conserved), and the f64 canary without the kernel check.
"""

import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maniac_tpu
from maniac_tpu.systems import (make_framework_mixed, make_triclinic_water,
                                make_water_box, make_water_reservoir,
                                make_zif_like)
from maniac_tpu_torch import bench

from torch_parity import files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every key of the bench's JSON line
KEYS = {"metric", "value", "unit", "system", "device", "dispatch",
        "hw_precision", "kernel_check", "state_check", "replicas", "steps",
        "blocks", "dtype", "capacity", "S", "K", "mean_N", "elapsed_s",
        "ms_per_step", "setup_s", "build_s", "warmup_s", "peak_mem_bytes",
        "launches", "layers"}
# bench.py's deck knobs (MANIAC_BENCH_FW_RCUT2, FW_ALPHA2, EWALD_ALPHA)
KNOBS = dict(fw_rcut2=30.0, fw_alpha2=0.35, ewald_alpha=0.3)


def _jax_bench_system(system, tmp, **fw_kw):
    """bench.py:90-110's build(), as it writes the files (a literal copy of
    its calls); returns the reservoir file or None."""
    res_file = None
    if system == "zif":
        make_zif_like(tmp, n_cells=6, a=5.66, n_water=32,
                      fugacity=30.0, **fw_kw)
    elif system == "mixed":
        make_framework_mixed(tmp, n_cells=6, a=5.66, n_water=24,
                             n_dimer=12, cutoff=8.5, tol=1e-5,
                             probs=(0.25, 0.15, 0.4, 0.2))
    elif system == "resv":
        make_water_box(tmp, n_water=48, L=24.0, cutoff=8.0, tol=1e-5,
                       probs=(0.3, 0.2, 0.5, 0.0), fugacity=4000.0)
        res_file = make_water_reservoir(tmp, n_water=96, L=24.0)
    elif system == "tricl":
        make_triclinic_water(tmp, n_water=24, L=22.0,
                             tilt=(2.0, 1.2, 0.8), cutoff=7.0,
                             tol=1e-5, probs=(0.3, 0.2, 0.5, 0.0),
                             fugacity=4000.0)
    elif system == "bigS":
        make_water_box(tmp, n_water=2000, L=40.0, cutoff=8.5,
                       tol=1e-5, probs=(0.3, 0.2, 0.5, 0.0),
                       fugacity=4000.0)
    return res_file


def test_bench_refuses_without_a_card():
    """python -m maniac_tpu_torch.bench exits non-zero and prints no
    metric when torch.cuda.is_available() is false."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "maniac_tpu_torch.bench"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"metric"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_bench_imports_no_jax():
    code = ("import sys, maniac_tpu_torch.bench, "
            "maniac_tpu_torch.tools.bounds; "
            "bad = [m for m in sys.modules if m.startswith('jax') "
            "or m.startswith('maniac_tpu.') or m == 'maniac_tpu']; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)


@pytest.mark.parametrize("system,knobs", [
    ("zif", {}), ("zif", KNOBS), ("mixed", {}), ("resv", {}), ("tricl", {}),
    ("bigS", {})], ids=["zif", "zif-knobs", "mixed", "resv", "tricl",
                        "bigS"])
def test_systems_write_bench_py_files(tmp_path, system, knobs):
    """bench.write_system writes the bytes bench.py's build() writes with
    the JAX package's builders: deck, data, pair coefficients and the
    reservoir, the deck knobs on zif's deck."""
    port, ref = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    ref.mkdir()
    res = bench.write_system(system, str(port), **knobs)
    res_ref = _jax_bench_system(system, str(ref), **knobs)
    assert (res is None) == (res_ref is None)
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(ref))
    assert "input.maniac" in names and "topology.data" in names
    for name in names:
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    if knobs:
        deck = (port / "input.maniac").read_text()
        assert all(k in deck for k in knobs)


def test_bigs_load_energy_matches_jax(tmp_path):
    """bigS at the bench's capacity (2500) in f64: the port's load-time
    energy row within 1e-9 relative of maniac_tpu.load_system's, and the
    sizes the bench reports (S 10240, K 12288)."""
    cap = bench.default_capacity("bigS")
    assert cap == 2500
    _jax_bench_system("bigS", str(tmp_path))
    ref = maniac_tpu.load_system(*files(str(tmp_path)), capacity=cap,
                                 dtype=jnp.float64)
    want = np.asarray(ref.state.energy, np.float64).reshape(-1)
    sysm = bench.load("bigS", "cpu", cap, torch.float64)
    got = sysm.state.energy[0].numpy()
    assert (sysm.spec.S, sysm.spec.K) == (10240, 12288)
    assert not sysm.spec.fw_split and int(sysm.state.n_mol[0, 0]) == 2000
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)


@pytest.mark.parametrize("system", ["zif", "resv"])
def test_run_rehearses_on_cpu(system):
    """run() on the CPU at B = 2, 5 steps, 1 block: every key of the JSON
    line (json-serializable), the plain path named, the state and kernel
    checks passed (resv: box + reservoir + drops conserved), no launch
    counted (the wrappers run their plain versions), no card numbers."""
    lines = []

    class Log:
        def write(self, s):
            lines.append(s)

    r = bench.run(system, device="cpu", replicas=2, steps=5, blocks=1,
                  hwcheck=False, log=Log())
    assert KEYS <= set(r), KEYS - set(r)
    json.loads(json.dumps(r))
    assert r["metric"] == bench.metric_name(system)
    assert r["metric"].startswith("port_mc_steps_per_sec_")
    assert "plain torch path" in r["dispatch"]
    assert r["state_check"] == "pass" and r["kernel_check"] == "pass"
    assert r["hw_precision"] == "skipped"
    assert r["device"]["platform"] == "cpu"
    assert r["build_s"] is None and r["peak_mem_bytes"] is None
    assert set(r["launches"].values()) == {0}
    assert (r["replicas"], r["steps"], r["blocks"], r["dtype"],
            r["capacity"]) == (2, 5, 1, "f32", 192)
    assert r["value"] > 0 and 0 <= r["mean_N"] <= 192
    assert r["layers"]["clock"] == "host clock"
    assert "block_bound_ms" in r["layers"] and "resync_ms" in r["layers"]
    text = "".join(lines)
    assert "# kernel_check=pass" in text and "# layers" in text
    if system == "resv":
        assert "box + reservoir + drops conserved" in text


def test_run_f64_canary_on_cpu():
    """The f64 canary: no resync, no kernel check, the plain path."""
    r = bench.run("tricl", device="cpu", replicas=2, steps=3, blocks=1,
                  dtype="f64", hwcheck=False, log=io.StringIO())
    assert r["dtype"] == "f64" and r["kernel_check"].startswith("skipped")
    assert "resync_ms" not in r["layers"]
    assert "block_bound_ms" not in r["layers"]


def test_energy_bound_counts_one_ulp_an_accepted_step():
    """bench.energy_bound: 5 K plus one f32 ulp of each component's
    load-time magnitude per accepted step (bigS's 1.18e8 K: 8 K)."""
    e_load = torch.tensor([1.04e6, 3.86e6, 2.86e5, -1.18e8, 1.17e8, 3.9e6])
    b = bench.energy_bound(e_load, torch.tensor([0, 10]))
    assert b.shape == (2, 6)
    assert torch.equal(b[0], torch.full((6,), 5.0, dtype=torch.float64))
    assert float(b[1, 3]) == 5.0 + 10 * 8.0
    assert float(b[1, 0]) == 5.0 + 10 * 0.0625    # 1.04e6 < 2^20
