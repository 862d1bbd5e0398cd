"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have (no cell exchanges between chips)."""

from __future__ import annotations

import time

import pytest

from conftest import tiny
from qbench import cell as cellmod
from qbench.faults import FAULTS

CELLS = ["rx960k_8192ch.resident", "pfb4096_196M.fed"]


def _run(manifest, cell, fault=None):
    return cellmod.run(cell, 5, 2.0, False, t_process=time.perf_counter(),
                       device="cpu", override=tiny(manifest, cell),
                       fault=fault)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(manifest, cell, fault):
    res = _run(manifest, cell, fault)
    assert res["correct"] is False
    assert res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(manifest, cell):
    res = _run(manifest, cell)
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
