"""The control (the reference in TF32 in the program's place) fails each
cell's limits, and the program passes them, at a size a test run holds.
On the card, ``python3 benchmark/control.py --workload <cell> --seeds ...``
reads the control at the cell's own size."""

from __future__ import annotations

import time

import pytest

from conftest import tiny
from qbench import cell as cellmod

CELLS = ["rx960k_8192ch.resident", "pfb4096_196M.resident"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_passes(manifest, cell):
    import control
    ov = tiny(manifest, cell)
    limits = manifest.config(manifest.workload(cell)["config"])["limits"]
    got = control.control(cell, 21, 2, "cpu", ov, first=30, last=60)
    assert any(got[k] > limits[k] for k in limits), got
    res = cellmod.run(cell, 21, 1.5, False, t_process=time.perf_counter(),
                      device="cpu", override=ov)
    assert res["correct"], res["checks"]
