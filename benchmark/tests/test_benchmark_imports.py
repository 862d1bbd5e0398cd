"""Nothing of the benchmark imports JAX or the JAX package; the reference
imports nothing of the program; a run's own check names what it finds."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
from qbench import cell as cellmod

FORBIDDEN = {"jax", "jaxlib", "flax", "quisk_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    for path in BENCH.rglob("*.py"):
        assert not FORBIDDEN & set(_imports(path)), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "qref").glob("*.py"):
        assert "quisk_tpu_torch" not in set(_imports(path)), path


def test_forbidden_names_compared_whole(monkeypatch):
    for name in ("quisk_tpu_torch", "quisk_tpu_torch.rx", "jaxfoo"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert cellmod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "quisk_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert cellmod.forbidden_modules() == ["jaxlib", "quisk_tpu.ops"]


def test_a_run_loads_none(manifest):
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from qbench import cell\n"
        "r = cell.run('pfb4096_196M.resident', 1, 0.5, False,"
        " t_process=time.perf_counter(), device='cpu',"
        " override={'pipeline': {'n_chan': 256, 'block': 16384},"
        " 'listen_channels': 16})\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(BENCH), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "quisk_tpu_torch" in loaded and not FORBIDDEN & loaded


@pytest.mark.card
def test_cell_on_card_loads_none(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "pfb4096_196M.resident", "--seed", "7", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
