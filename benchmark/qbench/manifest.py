"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<file>``), its traffic mix
(``benchmark/mixes/<traffic>.json``), its system
(``qbench/systems/<system>.py``) and each per-layer metric's reader
(``benchmark/metrics/<name>.py``).  Adding any of them is adding a file
and an entry; nothing here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / "benchmark"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                cfg = json.loads((self.root / c["file"]).read_text())
                cfg["name"] = name
                return cfg
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def mix(self, traffic: str) -> dict:
        return json.loads((self.bench_dir / "mixes" / f"{traffic}.json")
                          .read_text())

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics read in this cell: those that list it,
        and those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in e2e
                                 else [])]

    def reader(self, metric: str):
        """The ``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def system_module(name: str):
    """``qbench.systems.<name>``: the adapter of a configuration's
    ``system``."""
    return importlib.import_module(f"qbench.systems.{name}")
