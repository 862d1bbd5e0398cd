"""The command fails without a card and prints no result; on a card its
last line is the contract's result."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT


def _run(*extra, timeout=600):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "pfb4096_196M.fed", "--seed", str(2 ** 31 + 5), "--seconds", "2",
         *extra], capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run("--trace", "0")
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.card
@pytest.mark.parametrize("traced", [0, 1])
def test_result_line_on_card(card, traced):
    out = _run("--trace", str(traced))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert res["correct"] is True
    if traced:
        assert res["device"]["busy_s"] > 0 and "breakdown" in res
