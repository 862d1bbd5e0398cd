"""CPU tests of the benchmark: ``python -m pytest benchmark/tests -q``.

Tests that need the card carry the ``card`` marker and skip without one
(the ``card`` fixture decides, at run time)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# small versions of the configurations, for runs on the CPU
TINY = {
    "rx_chain": {"chain": {"channels": 8, "audio_block": 256}},
    "pfb_rx": {"pipeline": {"n_chan": 256, "block": 16384},
               "listen_channels": 16},
}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """One thread a test process: the CPU runs here time their windows,
    and workers that each spin up a thread per core starve each other."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def manifest():
    from qbench.manifest import Manifest
    return Manifest()


def tiny(manifest, cell: str) -> dict:
    """The override that shrinks cell ``cell``'s configuration."""
    cfg = manifest.config(manifest.workload(cell)["config"])
    return TINY[cfg["system"]]
