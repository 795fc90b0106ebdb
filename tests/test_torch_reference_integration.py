"""Black-box runs of maniac_tpu_torch's command line on the reference's
own data fixtures: tests/test_reference_integration.py's 4 cases, run on
the port.

The reference's contract is "run the binary on a fixture, grep the log"
(tests/readers/data/run-test.sh:13-51 greps "Simulation Completed" on
good-*.data and "(Error|STOP)" on bad-*.data; tests/integration/energy/
H2O-gas/run-test.sh:14-20 gates the final TotEng row to 0.01 kcal/mol).
These cases hold the port's CLI (--platform cpu) to it on the reference's
readers/data fixtures (the JAX test's REF directory), add the startup
energy against the independent oracle (scripts/oracle.py) and the f64
bookkeeping against a recompute, and skip when that tree is absent, as
the JAX cases do.
"""

import os
import sys

import numpy as np
import pytest
import torch

from maniac_tpu_torch import load_system
from maniac_tpu_torch.cli import main as cli_main
from maniac_tpu_torch.constants import COULOMB_K, KB_KCALMOL
from maniac_tpu_torch.mc.driver import block_body, drift_report
from maniac_tpu_torch.physics.energy import site_positions
from maniac_tpu_torch.system import E_TOT

from test_reference_integration import REF

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

needs_ref = pytest.mark.skipif(not os.path.isdir(REF),
                               reason="reference fixtures not present")


@pytest.fixture(scope="module")
def ref_inc(tmp_path_factory):
    """parameters.inc rebuilt from good-01.data's Pair Coeffs block (eps
    kcal/mol, sigma A per atom type; cross terms by Lorentz-Berthelot, as
    the reference's parameter reader builds them)."""
    lines = open(f"{REF}/good-01.data").read().splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith("Pair Coeffs"))
    out = []
    for ln in lines[start + 1:]:
        ln = ln.strip()
        if not ln:
            if out:
                break
            continue
        t, eps, sig = ln.split()
        out.append(f"pair_coeff {t} {t} {eps} {sig}")
    assert len(out) == 14
    p = tmp_path_factory.mktemp("inc") / "parameters.inc"
    p.write_text("\n".join(out) + "\n")
    return str(p)


def _deck_with(tmp_path, **overrides):
    """The reference deck with scalar keywords overridden."""
    text = open(f"{REF}/input.maniac").read()
    for key, val in overrides.items():
        found = False
        lines = []
        for ln in text.splitlines():
            if ln.split() and ln.split()[0] == key:
                lines.append(f"{key} {val}")
                found = True
            else:
                lines.append(ln)
        assert found, key
        text = "\n".join(lines)
    p = tmp_path / "input.maniac"
    p.write_text(text + "\n")
    return str(p)


@needs_ref
@pytest.mark.parametrize("data", ["good-01.data", "good-02.data"])
def test_reference_good_data_cli_contract(tmp_path, data, ref_inc):
    """run-test.sh's contract: the reference's own input.maniac (nb_block
    0) on the fixture, and the log carries the completion banner."""
    out = str(tmp_path / "outputs") + "/"
    rc = cli_main(["-i", f"{REF}/input.maniac", "-d", f"{REF}/{data}",
                   "-p", ref_inc, "-o", out,
                   "--platform", "cpu", "--dtype", "f64"])
    assert rc == 0
    log = open(f"{out}log.maniac").read()
    assert "Simulation Completed" in log       # the grep in run-test.sh:21
    assert "FATAL" not in log


@needs_ref
@pytest.mark.parametrize("data", ["bad-01", "bad-02", "bad-03", "bad-04"])
def test_reference_bad_data_cli_contract(tmp_path, data, ref_inc):
    """run-test.sh's contract for bad fixtures: a nonzero exit and an error
    block in the log (grep -E "(Error|STOP)", run-test.sh:38)."""
    out = str(tmp_path / "outputs") + "/"
    rc = cli_main(["-i", f"{REF}/input.maniac", "-d", f"{REF}/{data}.data",
                   "-p", ref_inc, "-o", out,
                   "--platform", "cpu", "--dtype", "f64"])
    assert rc != 0
    log = open(f"{out}log.maniac").read()
    assert "ERROR" in log or "Error" in log


@needs_ref
@pytest.mark.parametrize("data", ["good-01.data", "good-02.data"])
def test_reference_good_data_energy_vs_oracle(tmp_path, data, ref_inc):
    """The fixture's startup energy against the independent oracle, within
    the reference's LAMMPS tolerance (run-test.sh:16-17)."""
    from oracle import oracle_total

    sysm = load_system(f"{REF}/input.maniac", f"{REF}/{data}", ref_inc,
                       capacity=8, device="cpu")
    spec, state = sysm.spec, sysm.state
    pos = site_positions(spec, state)[0].double().numpy()
    q = spec.site_q.double().numpy()
    mol = spec.site_mol.numpy()
    active = (spec.site_midx < state.n_mol[0][spec.site_type.long()]).numpy()
    pos, q, mol = pos[active], q[active], mol[active]
    cls = spec.site_cls.numpy()[active]
    eps = spec.eps_cls.numpy()[np.ix_(cls, cls)]
    sig = spec.sig_cls.numpy()[np.ix_(cls, cls)]
    # L = 100 box, 28 atoms: a small alpha keeps the oracle's k-sum
    # tractable while 3 image shells converge its real-space sum
    ref = oracle_total(pos, q, mol, 100.0, eps, sig, cutoff=17.0,
                       alpha=0.22, n_images=3, kmax=24,
                       coulomb_k=COULOMB_K)
    got = float(state.energy[0, E_TOT])
    diff_kcal = abs(got - ref) * KB_KCALMOL
    assert diff_kcal < 0.01, (got, ref, diff_kcal)


@needs_ref
def test_reference_good01_gcmc_and_toteng_grep(tmp_path, ref_inc):
    """A short GCMC run on good-01 through the CLI keeps the final-TotEng
    awk contract, and the same fixture in the library keeps bookkeeping ==
    recompute in f64."""
    deck = _deck_with(tmp_path, nb_block=2, nb_step=40)
    out = str(tmp_path / "outputs") + "/"
    rc = cli_main(["-i", deck, "-d", f"{REF}/good-01.data", "-p", ref_inc,
                   "-o", out, "--platform", "cpu", "--dtype", "f64",
                   "--capacity", "8", "--audit"])
    assert rc == 0
    log = open(f"{out}log.maniac").read()
    assert "Simulation Completed" in log
    lines = log.splitlines()
    idx = max(i for i, ln in enumerate(lines) if "TotEng" in ln)
    float(lines[idx + 1].lstrip("| ").split()[1])  # awk $2 parses

    sysm = load_system(deck, f"{REF}/good-01.data", ref_inc, capacity=8,
                       dtype=torch.float64, device="cpu")
    st = block_body(sysm.spec, sysm.state, 80, True)
    rep = drift_report(sysm.spec, st)
    assert rep["drift_K"] < 1e-6, rep  # measured ~1e-9 K in the JAX package
