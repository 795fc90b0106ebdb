"""The box lengths of the test and bench systems, as the kernels take them:
read off the data files the builders of maniac_tpu_torch/systems.py write
(xhi - xlo, ..., rounded to f32). Imports no jax, so the card's tests
(test_torch_gpu.py) use it too."""

import numpy as np

from maniac_tpu_torch import systems

# name -> (builder, keyword arguments): the water box, the two-species box
# and the frameworks of the tests, bench.py's systems and the benchmark's
# spce750 (750 waters at 0.83 g/cm^3)
BOX_SYSTEMS = {
    "water_box": ("make_water_box", {}),
    "mixed_sizes": ("make_mixed_sizes", {}),
    "framework_water": ("make_framework_water", {}),
    "zif_small": ("make_zif_like", dict(n_cells=4, n_water=10)),
    "zif": ("make_zif_like", dict(n_cells=6, n_water=32)),
    "slit_pore": ("make_slit_pore", {}),
    "resv": ("make_water_box", dict(n_water=48, L=24.0)),
    "bigS": ("make_water_box", dict(n_water=2000, L=40.0)),
    "spce750": ("make_spce_box", dict(n_water=750, density=0.83)),
}


def box_lengths(name: str, outdir) -> list[float]:
    """The distinct f32 box lengths of BOX_SYSTEMS[name], built in
    ``outdir``."""
    make, kw = BOX_SYSTEMS[name]
    getattr(systems, make)(str(outdir), **kw)
    lengths = set()
    with open(f"{outdir}/topology.data") as f:
        for line in f:
            words = line.split()
            if len(words) == 4 and words[2][1:] == "lo" and words[3][1:] \
                    == "hi":
                lengths.add(float(np.float32(float(words[1])
                                             - float(words[0]))))
    assert len(lengths) >= 1, name
    return sorted(lengths)
