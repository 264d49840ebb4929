"""The benchmark's tests: the harness's code path at a tiny size on the CPU
(plain kernel versions), and the control on the card."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips elsewhere")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def shrink(cfg: dict) -> dict:
    """The cell at a size the CPU holds: 64^2 crops, 2 pairs, a pool of 4."""
    cfg["data"].update(image_size=64, pairs_per_step=2, videos=2, frames_per_video=8)
    if cfg["data"]["object"] == "uv_sphere":
        cfg["data"]["object_faces"] = 60
    cfg["traffic"]["pool"] = 4
    return cfg


@pytest.fixture
def tiny(monkeypatch):
    """``run.run`` on the CPU at ``shrink``'s size."""
    import torch

    import run

    torch.set_num_threads(1)
    orig = run.load_cell
    monkeypatch.setattr(run, "load_cell", lambda name: (shrink(orig(name)[0]), orig(name)[1]))

    def go(name, trace=False, fault=None, seed=2**31 + 12345):
        return run.run(name, seed, 0.5, trace, "cpu", fault=fault)

    return go
