"""High-level loading API: files -> (SystemSpec, SimState) on a device.

Counterpart of maniac_tpu/api.py, with the reference's startup sequence
(src/main.f90:15-27): ReadInput -> ReadSystemData -> ReadParameters ->
PrepareSimulationParameters -> ComputeSystemEnergy. Parsing and the system
build run in float64 numpy on the host; the built tables then move to
``device`` in ``dtype`` and the initial energy is computed there. The device
is the CUDA card unless the caller asks for the CPU; there is no fallback.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .ewald import EwaldSetup, log_ewald_parameters, setup_ewald
from .io.deck import InputDeck, log_input_summary, parse_deck
from .io.lammps_data import ParsedSystem, parse_lammps_data
from .io.pair_coeffs import parse_pair_coeffs
from .mc.driver import initialize_state
from .system import SimState, SystemSpec, build_spec_and_state, to_device
from .utils import trace
from .utils.logger import Logger, default_logger


@dataclass
class LoadedSystem:
    deck: InputDeck
    parsed: ParsedSystem
    reservoir: ParsedSystem | None
    ewald: EwaldSetup
    spec: SystemSpec
    state: SimState   # B = 1


def load_system(input_file: str, data_file: str, params_file: str,
                reservoir_file: str | None = None, *,
                capacity: int | None = None,
                dtype: torch.dtype = torch.float64,
                device: str | torch.device = "cuda",
                logger: Logger | None = None,
                compute_initial_energy: bool = True,
                seed: int | None = None) -> LoadedSystem:
    """Parse the deck, data, pair-coefficient and (optional) reservoir
    files, set up Ewald, build the system and compute its initial energy on
    ``device`` (default: the CUDA card; pass ``device="cpu"`` for the
    CPU). ``seed`` replaces the deck's seed, as the JAX package's
    load_system does; the state's key is its prng_key. Raises RuntimeError
    for a CUDA device when there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_system: no CUDA device is available (pass "
                           "device='cpu' to run on the CPU)")
    logger = logger or default_logger()
    with trace.span("load_system"):
        with trace.span("load.parse"):
            deck = parse_deck(input_file, logger)
            if seed is not None:
                deck.seed = seed
            log_input_summary(deck, input_file, logger)
            parsed = parse_lammps_data(data_file, deck, logger,
                                       is_primary=True)
            reservoir = None
            if reservoir_file:
                reservoir = parse_lammps_data(reservoir_file, deck, logger,
                                              is_primary=False)
                _check_consistency(parsed, reservoir, logger)
            eps, sig = parse_pair_coeffs(params_file, parsed, logger)
        with trace.span("load.ewald"):
            ewald = setup_ewald(parsed.box, deck.real_space_cutoff,
                                deck.ewald_tolerance, logger,
                                alpha_override=deck.ewald_alpha)
            log_ewald_parameters(ewald, logger)
        with trace.span("load.build"):
            spec, state = build_spec_and_state(deck, parsed, eps, sig, ewald,
                                               reservoir=reservoir,
                                               capacity=capacity)
        _count_loaded(spec, state)
        with trace.span("load.to_device"):
            spec = to_device(spec, device, dtype)
            state = to_device(state, device, dtype)
        if compute_initial_energy:
            with trace.span("load.energy"):
                state = initialize_state(spec, state)
    return LoadedSystem(deck=deck, parsed=parsed, reservoir=reservoir,
                        ewald=ewald, spec=spec, state=state)


def _count_loaded(spec: SystemSpec, state: SimState) -> None:
    """Counters of what the load built: ``load.frozen_sites`` (live sites of
    the frozen types), ``load.frozen_tiles`` (the tiles the footprint
    kernels sweep them in; 0 without the framework split),
    ``load.frozen_charged_sites`` (those of them with a charge),
    ``load.far_coefficients`` (the far table's nonzero coefficients),
    ``load.far_units`` (its work units, which the footprint kernels' far
    sweep walks), ``load.kspace_modes`` and ``load.commit_modes`` (the
    weighted and the real k-space modes the footprint kernels walk, of the
    spec's (JzP, JxyP) grid) and ``load.active_types``."""
    frozen = charged = 0
    for r in range(spec.R):
        if not spec.active_list[r]:
            n = int(state.n_mol[0, r]) * spec.A_list[r]
            base = spec.site_base_list[r]
            frozen += n
            charged += int((spec.site_q[base:base + n] != 0).sum())
    trace.count("load.frozen_sites", frozen)
    trace.count("load.frozen_charged_sites", charged)
    trace.count("load.frozen_tiles", int(spec.fw_tile_box.shape[0]))
    trace.count("load.far_coefficients", int((spec.far_coef != 0).sum()))
    trace.count("load.far_units", int((spec.far_units[..., 2] > 0).sum()))
    trace.count("load.kspace_modes", int(spec.k_weighted_modes.shape[0]))
    trace.count("load.commit_modes", int(spec.k_real_modes.shape[0]))
    trace.count("load.active_types", spec.n_active)


def _check_consistency(primary: ParsedSystem, reservoir: ParsedSystem,
                       logger: Logger) -> None:
    """Warn on primary-vs-reservoir mass mismatches
    (reference: src/check_utils.f90:57-88)."""
    for r in range(len(primary.atom_masses)):
        a = primary.atom_masses[r]
        b = reservoir.atom_masses[r]
        if a.shape == b.shape and np.any(np.abs(a - b) > 1e-6):
            logger.warn("Reservoir and system mass don't match.")
