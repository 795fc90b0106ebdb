"""High-level loading API: files -> (SystemSpec, SimState) on a device.

Counterpart of maniac_tpu/api.py, with the reference's startup sequence
(src/main.f90:15-27): ReadInput -> ReadSystemData -> ReadParameters ->
PrepareSimulationParameters -> ComputeSystemEnergy. Parsing and the system
build run in float64 numpy on the host; the built tables then move to
``device`` in ``dtype`` and the initial energy is computed there.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .ewald import EwaldSetup, log_ewald_parameters, setup_ewald
from .io.deck import InputDeck, log_input_summary, parse_deck
from .io.lammps_data import ParsedSystem, parse_lammps_data
from .io.pair_coeffs import parse_pair_coeffs
from .mc.driver import initialize_state
from .system import SimState, SystemSpec, build_spec_and_state, to_device
from .utils.logger import Logger, default_logger


@dataclass
class LoadedSystem:
    deck: InputDeck
    parsed: ParsedSystem
    ewald: EwaldSetup
    spec: SystemSpec
    state: SimState   # B = 1


def load_system(input_file: str, data_file: str, params_file: str, *,
                capacity: int | None = None,
                dtype: torch.dtype = torch.float64,
                device: str | torch.device = "cpu",
                logger: Logger | None = None,
                compute_initial_energy: bool = True) -> LoadedSystem:
    """Parse the deck, data and pair-coefficient files, set up Ewald, build
    the system and compute its initial energy on ``device``."""
    logger = logger or default_logger()
    deck = parse_deck(input_file, logger)
    log_input_summary(deck, input_file, logger)
    parsed = parse_lammps_data(data_file, deck, logger, is_primary=True)
    eps, sig = parse_pair_coeffs(params_file, parsed, logger)
    ewald = setup_ewald(parsed.box, deck.real_space_cutoff,
                        deck.ewald_tolerance, logger,
                        alpha_override=deck.ewald_alpha)
    log_ewald_parameters(ewald, logger)
    spec, state = build_spec_and_state(deck, parsed, eps, sig, ewald,
                                       capacity=capacity)
    spec = to_device(spec, device, dtype)
    state = to_device(state, device, dtype)
    if compute_initial_energy:
        state = initialize_state(spec, state)
    return LoadedSystem(deck=deck, parsed=parsed, ewald=ewald, spec=spec,
                        state=state)
