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


@pytest.fixture
def blocks(monkeypatch):
    """``blocks(n)`` makes an untraced run's window run n blocks, whatever
    the clock reads: run.window's own loop, one block a call."""
    from portbench import run
    window = run.window

    def fix(n):
        def fixed(drv, tracer, seconds, judged_blocks):
            out = [window(drv, tracer, 0.0, judged_blocks) for _ in range(n)]
            return (n, sum(o[1] for o in out), [r for o in out for r in o[2]],
                    [b for o in out for b in o[3]][-judged_blocks:])
        monkeypatch.setattr(run, "window", fixed)
    return fix
