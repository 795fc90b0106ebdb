"""The benchmark's own tests (not collected by the repository's tier-1
run): ``python -m pytest portbench/tests -q``. Tests marked ``gpu`` need a
CUDA card and skip without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return torch.device("cuda", 0)
