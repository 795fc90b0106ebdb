"""maniac-tpu on PyTorch and CUDA: grand-canonical Monte Carlo for one GPU.

A port of the JAX package ``maniac_tpu`` (which stays the reference): the
same flat padded system layout, the same unified MC step over explicit
uniforms, replicas as a leading batch axis, and hand-written CUDA kernels
(kernels/csrc) for the whole-block MC step, the energy core of a single MC
step and the per-block amplitude resync. The command line is
``python -m maniac_tpu_torch.cli``. Importing the package imports torch,
numpy and scipy, never jax.
"""

from .api import LoadedSystem, load_system                     # noqa: F401
from .mc.driver import drift_report, initialize_state          # noqa: F401
from .parallel.replicas import (replicate, run_block_replicated,  # noqa: F401
                                run_block_uniforms)
from .system import SimState, SystemSpec, from_numpy, to_device  # noqa: F401
