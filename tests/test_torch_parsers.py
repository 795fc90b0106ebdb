"""maniac_tpu_torch's parsers (io/deck.py, io/lammps_data.py,
io/pair_coeffs.py) against the JAX package: tests/test_parsers.py's 17
cases, run on the port.

Every case that parses a file also parses it with maniac_tpu.io and
asserts the two results equal field by field and exactly
(torch_parity.assert_same_fields). The fuzz case sends the JAX test's 122
mutations, from the same random.Random(7), through both packages: each
must abort in both with the same error class or parse equal in both. The
reference fixtures' cases read the JAX test's REF directory and skip
without it, as the JAX ones do. Inputs are written by
maniac_tpu_torch.systems, and by the JAX package's system writers from
the same arguments, byte for byte (torch_parity.build_both).
"""

import os
import random

import numpy as np
import pytest

from maniac_tpu.io.deck import parse_deck as jax_parse_deck
from maniac_tpu.io.lammps_data import parse_lammps_data as jax_parse_data
from maniac_tpu.io.pair_coeffs import parse_pair_coeffs as jax_parse_coeffs
from maniac_tpu.utils.errors import ManiacError as JaxManiacError
from maniac_tpu_torch.constants import KB_KCALMOL
from maniac_tpu_torch.io.deck import parse_deck
from maniac_tpu_torch.io.lammps_data import parse_lammps_data
from maniac_tpu_torch.io.pair_coeffs import parse_pair_coeffs
from maniac_tpu_torch.utils.errors import ManiacError
from maniac_tpu_torch.utils.logger import Logger

from test_parsers import REF
from torch_parity import assert_same_fields, build_both


def _deck(path, logger=None):
    """The port's deck, held equal to the JAX package's parse."""
    deck = parse_deck(path, logger)
    assert_same_fields(deck, jax_parse_deck(path))
    return deck


def _data(path, deck_path):
    """The port's parse of a data file, held equal to the JAX package's."""
    parsed = parse_lammps_data(path, parse_deck(deck_path))
    assert_same_fields(parsed, jax_parse_data(path, jax_parse_deck(deck_path)))
    return parsed


def _aborts_in_both(parse, jax_parse):
    """Both packages raise their ManiacError."""
    with pytest.raises(ManiacError):
        parse()
    with pytest.raises(JaxManiacError):
        jax_parse()


@pytest.fixture(scope="module")
def water_dir(tmp_path_factory):
    return build_both("make_water_box", tmp_path_factory.mktemp("water") / "w",
                      n_water=8)


def test_deck_basic(water_dir):
    deck = _deck(f"{water_dir}/input.maniac")
    assert deck.nb_block == 1 and deck.nb_step == 0
    assert deck.temp_K == 300.0
    assert deck.seed == 12345
    assert deck.real_space_cutoff == 8.0
    assert len(deck.residues) == 1
    res = deck.residues[0]
    assert res.name == "wat" and res.active and res.nb_atoms == 4
    assert res.types == [1, 2, 3]
    assert abs(deck.proba.total() - 1.0) < 1e-12


def test_deck_rescaling(tmp_path):
    d = build_both("make_water_box", tmp_path / "w",
                   probs=(0.2, 0.2, 0.1, 0.0))
    deck = _deck(f"{d}/input.maniac")
    assert abs(deck.proba.total() - 1.0) < 1e-12
    assert abs(deck.proba.translation - 0.4) < 1e-12


def test_deck_swap_folded_with_one_active_species(tmp_path, capsys):
    """swap_proba with <2 active species folds into insertion/deletion
    with a warning (DIVERGENCES.md #23), in the port as in the JAX
    package."""
    d = build_both("make_water_box", tmp_path / "w",
                   probs=(0.3, 0.3, 0.2, 0.2))
    deck = _deck(f"{d}/input.maniac", Logger())
    assert deck.proba.swap == 0.0
    assert abs(deck.proba.insertion_deletion - 0.4) < 1e-12
    assert abs(deck.proba.total() - 1.0) < 1e-12
    assert "folding the probability into" in capsys.readouterr().out


def test_deck_swap_kept_with_two_active_species(tmp_path):
    d = build_both("make_lj_gas", tmp_path / "lj", two_species=True,
                   probs=(0.3, 0.3, 0.2, 0.2))
    deck = _deck(f"{d}/input.maniac")
    assert abs(deck.proba.swap - 0.2) < 1e-12


def test_deck_missing_required(tmp_path):
    p = tmp_path / "bad.maniac"
    p.write_text("nb_block 1\nnb_step 1\ntranslation_proba 1.0\n")
    _aborts_in_both(lambda: parse_deck(str(p)),
                    lambda: jax_parse_deck(str(p)))


def test_deck_negative_cutoff(tmp_path):
    d = build_both("make_water_box", tmp_path / "w")
    text = open(f"{d}/input.maniac").read().replace(
        "real_space_cutoff 8.0", "real_space_cutoff -8.0")
    (tmp_path / "bad.maniac").write_text(text)
    bad = str(tmp_path / "bad.maniac")
    _aborts_in_both(lambda: parse_deck(bad), lambda: jax_parse_deck(bad))


def test_deck_active_without_fugacity(tmp_path):
    d = build_both("make_water_box", tmp_path / "w")
    lines = open(f"{d}/input.maniac").read().splitlines()
    lines = [ln for ln in lines if "fugacity" not in ln]
    (tmp_path / "bad.maniac").write_text("\n".join(lines))
    bad = str(tmp_path / "bad.maniac")
    _aborts_in_both(lambda: parse_deck(bad), lambda: jax_parse_deck(bad))


def test_deck_residue_sorting(tmp_path):
    d = build_both("make_lj_gas", tmp_path / "lj", two_species=True)
    text = open(f"{d}/input.maniac").read()
    # swap declaration order; the parser must sort back by min atom type
    a = text.index("begin_residue")
    head, blocks = text[:a], text[a:]
    first, rest = blocks.split("end_residue", 1)
    reordered = head + rest.lstrip("\n ") + "\n" + first + "end_residue\n"
    (tmp_path / "re.maniac").write_text(reordered)
    deck = _deck(str(tmp_path / "re.maniac"))
    assert [r.name for r in deck.residues] == ["lja", "ljb"]


def test_data_roundtrip(water_dir):
    parsed = _data(f"{water_dir}/topology.data", f"{water_dir}/input.maniac")
    assert parsed.num_atoms == 32
    assert parsed.n_mol == [8]
    assert parsed.mol_com[0].shape == (8, 3)
    assert parsed.site_offset[0].shape == (8, 4, 3)
    np.testing.assert_allclose(parsed.atom_charges[0],
                               [0.0, 0.5564, 0.5564, -1.1128])
    # absolute positions reconstruct (the box is centered and the molecules
    # lie inside it, so com == centroid here)
    with open(f"{water_dir}/topology.data") as fh:
        lines = [ln.split() for ln in fh if len(ln.split()) == 10]
    ref_pos = np.array([[float(x) for x in ln[4:7]] for ln in lines])
    got = (parsed.mol_com[0][:, None, :] + parsed.site_offset[0]).reshape(-1, 3)
    np.testing.assert_allclose(got, ref_pos, atol=1e-9)


def test_data_pbc_repair(tmp_path):
    """A molecule straddling the boundary must be made whole."""
    d = build_both("make_water_box", tmp_path / "w", n_water=1, L=10.0)
    with open(f"{d}/topology.data") as fh:
        text = fh.read().splitlines()
    out = []
    for ln in text:
        toks = ln.split()
        if len(toks) == 10 and toks[0].isdigit():
            x = float(toks[4]) + 5.0   # push toward the boundary
            x = ((x + 5.0) % 10.0) - 5.0  # wrap the atom into the box
            toks[4] = f"{x:.10f}"
            out.append(" ".join(toks))
        else:
            out.append(ln)
    (tmp_path / "wrapped.data").write_text("\n".join(out) + "\n")
    parsed = _data(str(tmp_path / "wrapped.data"), f"{d}/input.maniac")
    # offsets must be small (whole molecule), not box-sized
    assert np.max(np.abs(parsed.site_offset[0])) < 2.0


def test_pair_coeffs_lorentz_berthelot(tmp_path):
    d = build_both("make_lj_gas", tmp_path / "lj", two_species=True)
    parsed = _data(f"{d}/topology.data", f"{d}/input.maniac")
    eps, sig = parse_pair_coeffs(f"{d}/parameters.inc", parsed)
    jax_parsed = jax_parse_data(f"{d}/topology.data",
                                jax_parse_deck(f"{d}/input.maniac"))
    assert_same_fields((eps, sig), jax_parse_coeffs(f"{d}/parameters.inc",
                                                    jax_parsed))
    np.testing.assert_allclose(eps[0][0][0, 0] * KB_KCALMOL, 0.2)
    np.testing.assert_allclose(sig[0][0][0, 0], 3.4)
    # Lorentz-Berthelot cross terms
    np.testing.assert_allclose(sig[0][1][0, 0], 0.5 * (3.4 + 3.0))
    np.testing.assert_allclose(eps[0][1][0, 0] * KB_KCALMOL,
                               np.sqrt(0.2 * 0.3), rtol=1e-12)
    np.testing.assert_allclose(eps[1][0][0, 0], eps[0][1][0, 0])


# --------------------------------------------------------------------------
# black-box parity with the reference's own reader fixtures
# --------------------------------------------------------------------------

needs_ref = pytest.mark.skipif(not os.path.isdir(REF),
                               reason="reference fixtures not mounted")


@needs_ref
def test_reference_good_inputs():
    for name in ("good-input-01.maniac", "good-input-02.maniac"):
        deck = _deck(f"{REF}/inputs/{name}")
        assert deck.n_residue_types == 3
        assert deck.nb_block == 1
        # sorted by min atom type: zif(1..7), moh(8..11), wat(12..14)
        assert [r.name for r in deck.residues] == ["zif", "moh", "wat"] or \
               [r.name for r in deck.residues] == ["zif", "wat", "moh"]
        assert min(deck.residues[0].types) < min(deck.residues[1].types) \
            < min(deck.residues[2].types)


@needs_ref
@pytest.mark.parametrize("name", ["bad-input-02", "bad-input-03",
                                  "bad-input-04"])
def test_reference_bad_inputs(name):
    path = f"{REF}/inputs/{name}.maniac"
    _aborts_in_both(lambda: parse_deck(path), lambda: jax_parse_deck(path))


@needs_ref
def test_reference_bad_input_01_leading_space_accepted():
    """Divergence (DIVERGENCES.md #19): a leading space before a keyword is
    accepted, so bad-input-01 parses as good-input-01 does."""
    deck = _deck(f"{REF}/inputs/bad-input-01.maniac")
    good = _deck(f"{REF}/inputs/good-input-01.maniac")
    assert deck.n_residue_types == good.n_residue_types == 3
    assert deck.proba.translation == good.proba.translation > 0


@needs_ref
def test_reference_good_data():
    for name in ("good-01.data", "good-02.data"):
        parsed = _data(f"{REF}/data/{name}", f"{REF}/data/input.maniac")
        assert parsed.num_atoms == 28
        assert sum(parsed.n_mol) == 7  # 3 methanol + 4 water


@needs_ref
@pytest.mark.parametrize("name", ["bad-01", "bad-02", "bad-03", "bad-04"])
def test_reference_bad_data(name):
    deck_path, path = f"{REF}/data/input.maniac", f"{REF}/data/{name}.data"
    _aborts_in_both(
        lambda: parse_lammps_data(path, parse_deck(deck_path)),
        lambda: jax_parse_data(path, jax_parse_deck(deck_path)))


def _outcome(parse, error_class):
    """("ok", result) or ("abort", the error's class name)."""
    try:
        return "ok", parse()
    except error_class as e:
        return "abort", type(e).__name__


def test_parser_fuzz_clean_aborts(tmp_path):
    """tests/test_parsers.py's deterministic fuzz through both packages:
    each of the 122 mutated decks and data files (dropped lines, scrambled
    tokens, a number made text, truncation, binary junk; random.Random(7)
    as in the JAX test) parses in both, to equal results, or aborts in both
    with a typed ManiacError of the same class name; never an unhandled
    traceback (the reference's AbortRun contract, src/output_utils.f90:
    535-562)."""
    d = build_both("make_water_box", tmp_path / "sys", n_water=4, L=12.0,
                   cutoff=5.0, tol=1e-3)
    deck_text = open(f"{d}/input.maniac").read()
    data_text = open(f"{d}/topology.data").read()
    rng = random.Random(7)

    def mutations(text):
        lines = text.splitlines(keepends=True)
        out = []
        for _ in range(20):                      # drop a random line
            i = rng.randrange(len(lines))
            out.append("".join(lines[:i] + lines[i + 1:]))
        for _ in range(20):                      # scramble one line's tokens
            i = rng.randrange(len(lines))
            toks = lines[i].split()
            rng.shuffle(toks)
            out.append("".join(lines[:i]) + " ".join(toks) + "\n"
                       + "".join(lines[i + 1:]))
        for _ in range(10):                      # replace a number with text
            out.append(text.replace(str(rng.randrange(1, 9)), "x", 1))
        for _ in range(10):                      # truncate
            out.append(text[:rng.randrange(1, len(text))])
        out.append("\x00\xff garbage \x01\n" * 5)
        return out

    ok = aborted = 0
    fuzz_deck, fuzz_data = f"{tmp_path}/fuzz.maniac", f"{tmp_path}/fuzz.data"
    for mut in mutations(deck_text):
        open(fuzz_deck, "w").write(mut)
        got = _outcome(lambda: parse_deck(fuzz_deck), ManiacError)
        want = _outcome(lambda: jax_parse_deck(fuzz_deck), JaxManiacError)
        assert got[0] == want[0], (mut, got, want)
        assert_same_fields(got[1], want[1])
        ok, aborted = ok + (got[0] == "ok"), aborted + (got[0] == "abort")
    deck = parse_deck(f"{d}/input.maniac")
    jax_deck = jax_parse_deck(f"{d}/input.maniac")
    for mut in mutations(data_text):
        open(fuzz_data, "w").write(mut)
        got = _outcome(lambda: parse_lammps_data(fuzz_data, deck),
                       ManiacError)
        want = _outcome(lambda: jax_parse_data(fuzz_data, jax_deck),
                        JaxManiacError)
        assert got[0] == want[0], (mut, got, want)
        assert_same_fields(got[1], want[1])
        ok, aborted = ok + (got[0] == "ok"), aborted + (got[0] == "abort")
    # the fuzz classes are harsh: most mutations must be caught, and every
    # outcome must be one of the two contract cases above
    assert aborted > 40 and ok + aborted == 122, (ok, aborted)
