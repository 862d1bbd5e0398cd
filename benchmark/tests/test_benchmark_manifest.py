"""BENCHMARK.json meets its contract's shape, and every file it names is
found by name; a configuration, a mix, a cell and a per-layer metric added
to a copy are taken with no edit of the harness."""

from __future__ import annotations

import json
import re
import shutil
import time
import types

import pytest

from conftest import ROOT, tiny
from qbench import cell as cellmod
from qbench import trace
from qbench.manifest import Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_manifest_shape(manifest):
    d = manifest.data
    assert set(d) == TOP
    assert d["command"] == ["python3", "benchmark/run.py"]
    assert d["paths"] == ["benchmark"]
    assert 1 <= d["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    used = {w["config"] for w in d["workloads"]}
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = set()
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in d["end_to_end"]}
    assert {"input_msps", "block_ms_p95", "setup_s"} == e2e
    for m in d["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] == "host_clock"
        assert 0.01 <= m["bound"] <= 0.25
    for m in d["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] == "input_msps" and m["source"] == "device_trace"
        assert set(m["workloads"]) <= {w["name"] for w in d["workloads"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in d[k]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  Manifest().data["workloads"]])
def test_cell_files_found_by_name(manifest, cell):
    w = manifest.workload(cell)
    cfg = manifest.config(w["config"])
    mix = manifest.mix(w["traffic"])
    assert mix["placement"] in ("resident", "fed")
    assert mix["in_flight"] > mix["prefetch"]
    assert set(cfg["limits"]) and cfg["check_blocks"] >= 1
    assert cfg["reduced"] == [] and "assumed" in cfg and "source" in cfg
    from qbench.manifest import system_module
    mod = system_module(cfg["system"])
    assert hasattr(mod, "System") and hasattr(mod, "check")
    layer = manifest.per_layer(cell)
    assert layer and all(callable(manifest.reader(m["name"])) for m in layer)


def _copy(tmp_path):
    root = tmp_path / "repo"
    (root / "benchmark").mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("configs", "mixes", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, root / "benchmark" / sub)
    return root


def test_added_files_taken_without_edit(tmp_path):
    root = _copy(tmp_path)
    d = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "benchmark/configs/rx960k_1024ch.json")
                     .read_text())
    cfg["chain"].update(channels=8, audio_block=256)
    (root / "benchmark/configs/rx960k_8ch.json").write_text(json.dumps(cfg))
    (root / "benchmark/mixes/resident1.json").write_text(json.dumps(
        {"placement": "resident", "loop": "closed", "in_flight": 1,
         "prefetch": 0, "ring_blocks": 3}))
    (root / "benchmark/metrics/loop.blocks_traced.py").write_text(
        "def read(ctx):\n    return ctx.trace.blocks or None\n")
    d["configs"].append({"name": "rx960k_8ch", "source": "x",
                         "file": "benchmark/configs/rx960k_8ch.json",
                         "reduced": [], "why": "x"})
    d["workloads"].append({"name": "rx960k_8ch.resident1",
                           "config": "rx960k_8ch", "traffic": "resident1",
                           "chips": 1, "why": "x"})
    d["per_layer"].append({"name": "loop.blocks_traced", "unit": "blocks",
                           "better": "higher", "source": "program_counter",
                           "layer": "harness", "moves": "input_msps",
                           "workloads": ["rx960k_8ch.resident1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(d))

    man = Manifest(root)
    assert [m["name"] for m in man.per_layer("rx960k_8ch.resident1")] == [
        "loop.blocks_traced"]
    tr = trace.Trace(device=[], spans=[], lo=0, hi=10, blocks=5)
    ctx = types.SimpleNamespace(trace=tr)
    assert man.reader("loop.blocks_traced")(ctx) == 5
    res = cellmod.run("rx960k_8ch.resident1", 3, 2.0, False,
                      t_process=time.perf_counter(), device="cpu",
                      manifest=man)
    assert res["correct"] and res["attempted"] > 0
    assert set(res["metrics"]) == {"input_msps", "block_ms_p95", "setup_s"}


def test_tiny_override_matches_configs(manifest):
    for w in manifest.data["workloads"]:
        assert tiny(manifest, w["name"])
