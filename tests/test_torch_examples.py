"""maniac_tpu_torch's validation tools on the CPU: tools/run_examples.py
against examples/run_examples.py, and the card-first tools' refusal
without a card.

  * the port's CASES are the JAX runner's: the same system writers (by
    name), their arguments and command-line flags;
  * the isotherm (one replica a fugacity scale, f64 on the CPU) prints the
    same table as the JAX runner's run_isotherm: one seed walks one chain
    in both packages;
  * a case runs through ``python -m maniac_tpu_torch.cli`` with the tool's
    --platform and an extra flag passed on (NaCl with --sentinel 1): exit 0
    and "Simulation Completed";
  * validate_spce's system and estimator walk the JAX script's: SPC/E (64
    waters, f64), 4 replicas, 2 recalibrating blocks of 100 steps, then
    widom_block_replicated against jax.vmap(widom_block) on the script's
    keys: energies within 1e-9 relative, counters and step sizes equal,
    log factors within 1e-9;
  * run_examples, validate_spce and delta_e_report exit 1 without a card
    unless --platform cpu is given; sentinel_rate (card only) exits 1.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maniac_tpu
from maniac_tpu.mc.widom import widom_block as jax_widom_block
from maniac_tpu.parallel.replicas import replicate as jax_replicate
from maniac_tpu.parallel.replicas import \
    run_block_replicated as jax_run_block_replicated
from maniac_tpu_torch import load_system
from maniac_tpu_torch.mc.widom import widom_block_replicated
from maniac_tpu_torch.parallel.replicas import replicate, run_block_replicated

from maniac_tpu_torch.tools import (delta_e_report, run_examples,
                                    sentinel_rate, validate_spce)
from maniac_tpu_torch.utils.threefry import prng_key, split

from torch_parity import build_both, files

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import run_examples as jax_run_examples  # noqa: E402

torch.set_num_threads(1)


def test_cases_match_the_jax_runner():
    jax_cases = jax_run_examples.CASES
    assert list(run_examples.CASES) == list(jax_cases)
    for name, (make, kw, flags) in run_examples.CASES.items():
        jax_make, jax_kw, jax_flags = jax_cases[name]
        assert make.__name__ == jax_make.__name__, name
        assert kw == jax_kw and flags == jax_flags, name


def _table(text):
    return [ln for ln in text.splitlines() if "x ->" in ln]


def test_isotherm_matches_the_jax_runner(capsys):
    means = run_examples.isotherm("cpu")
    port = _table(capsys.readouterr().out)
    assert jax_run_examples.run_isotherm() == 0
    assert port == _table(capsys.readouterr().out)
    assert len(port) == len(means) == len(run_examples.ISOTHERM_SCALES)


def test_case_runs_through_the_command_line(capsys):
    assert run_examples.main(["NaCl", "--platform", "cpu",
                              "--sentinel", "1"]) == 0
    out = capsys.readouterr().out
    assert "== NaCl: OK" in out and "--sentinel 1" in out
    assert "kernel dispatch: plain torch path (device cpu)" in out


def test_spce_chains_and_widom_match_jax(tmp_path):
    d = build_both("make_spce_box", tmp_path / "spce", n_water=64,
                   density=0.997, temp=298.0, cutoff=7.0, tol=1e-5,
                   probs=(0.5, 0.5, 0.0, 0.0), tstep=0.25, rstep=0.4,
                   recal=True)
    jax_sysm = maniac_tpu.load_system(*files(d), dtype=jnp.float64)
    sysm = load_system(*files(d), dtype=torch.float64, device="cpu")
    jspec, spec = jax_sysm.spec, sysm.spec
    jst = jax_replicate(jspec, jax_sysm.state, 4)
    st = replicate(spec, sysm.state, 4)
    for _ in range(2):
        jst = jax_run_block_replicated(jspec, jst, 100, True)
        st = run_block_replicated(spec, st, 100, True)
    np.testing.assert_allclose(st.energy.numpy(), np.asarray(jst.energy),
                               rtol=1e-9, atol=1e-9)
    for name in ("counters", "trans_step", "rot_step"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(jst, name)))
    _, sub = split(prng_key(validate_spce.WIDOM_SEED))
    _, jsub = jax.random.split(jax.random.PRNGKey(validate_spce.WIDOM_SEED))
    want = np.asarray(jax.jit(jax.vmap(
        lambda s, k: jax_widom_block(jspec, s, 16, k)))(
            jst, jax.random.split(jsub, 4)))
    got = widom_block_replicated(spec, st, 16, split(sub, 4)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("tool,argv", [
    (run_examples, ["NaCl"]),
    (validate_spce, []),
    (delta_e_report, []),
    (sentinel_rate, []),
], ids=["run_examples", "validate_spce", "delta_e_report", "sentinel_rate"])
def test_tools_refuse_without_a_card(monkeypatch, capsys, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
