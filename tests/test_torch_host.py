"""The port's host-side modules equal the JAX package's: decimation plans,
block sizes and designed taps bit for bit; and importing the port loads
neither JAX nor the JAX package."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from quisk_tpu.modes import CW_PITCH as J_CW_PITCH
from quisk_tpu.modes import DEFAULT_BANDWIDTH as J_BW
from quisk_tpu.modes import Mode as JMode
from quisk_tpu.ops import design as jdesign
from quisk_tpu.rx import planner as jplanner

from quisk_tpu_torch.modes import CW_PITCH, DEFAULT_BANDWIDTH, Mode
from quisk_tpu_torch.ops import design
from quisk_tpu_torch.rx import planner

RATES = [48e3, 192e3, 384e3, 960e3, 250e3]


def test_modes_equal():
    assert [(m.name, int(m)) for m in Mode] == [(m.name, int(m))
                                               for m in JMode]
    assert {int(k): v for k, v in DEFAULT_BANDWIDTH.items()} == {
        int(k): v for k, v in J_BW.items()}
    assert CW_PITCH == J_CW_PITCH
    for m in Mode:
        assert m.is_ssb_like == JMode(int(m)).is_ssb_like
        assert m.is_lower == JMode(int(m)).is_lower


@pytest.mark.parametrize("fs", RATES)
@pytest.mark.parametrize("audio_block", [512, 2048])
def test_plan_equal(fs, audio_block):
    p = planner.plan_decimation(fs)
    q = jplanner.plan_decimation(fs)
    assert (p.fs_in, p.fs_out_nominal, p.fs_out, p.stages, p.frac,
            p.fs_mid) == (q.fs_in, q.fs_out_nominal, q.fs_out, q.stages,
                          q.frac, q.fs_mid)
    assert p.stage_rates() == q.stage_rates()
    assert p.int_decim == q.int_decim
    assert (planner.plan_block_sizes(p, audio_block)
            == jplanner.plan_block_sizes(q, audio_block))


def test_250k_plan_has_frac():
    p = planner.plan_decimation(250e3)
    assert p.stages == (5,)
    assert (p.frac.numerator, p.frac.denominator) == (25, 24)


@pytest.mark.parametrize("fs", RATES)
def test_decimator_taps_equal(fs):
    plan = planner.plan_decimation(fs)
    for d, fs_stage in zip(plan.stages, plan.stage_rates()):
        if d == 2:
            a, b = design.halfband(45), jdesign.halfband(45)
        else:
            a = design.decimator(d, fs_stage, atten_db=100.0)
            b = jdesign.decimator(d, fs_stage, atten_db=100.0)
        assert np.array_equal(a, b)


@pytest.mark.parametrize("band", [(300.0, 3100.0), (-3100.0, -300.0),
                                  (-3000.0, 3000.0), (-6250.0, 6250.0),
                                  (350.0, 850.0)])
def test_channel_taps_equal(band):
    for fs in (48e3, 50e3):
        assert np.array_equal(design.bandpass_analytic(1025, *band, fs),
                              jdesign.bandpass_analytic(1025, *band, fs))
    notches = ((1000.0, 100.0), (9000.0, 50.0))
    assert np.array_equal(
        design.bandpass_with_notches(1025, *band, 48e3, notches),
        jdesign.bandpass_with_notches(1025, *band, 48e3, notches))


def test_import_loads_no_jax():
    code = ("import sys, pkgutil, importlib, quisk_tpu_torch\n"
            "for m in pkgutil.walk_packages(quisk_tpu_torch.__path__, "
            "'quisk_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'flax', 'quisk_tpu.')) "
            "or m == 'quisk_tpu']\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=Path(__file__).resolve().parents[1])
    assert r.returncode == 0, r.stderr


def _port_sources():
    root = Path(__file__).resolve().parents[1]
    return sorted((root / "quisk_tpu_torch").rglob("*.py")) + [
        root / "chip_smoke.py"] + sorted(
        (root / "examples").glob("torch_*.py"))


def test_port_sources_cover_the_featured_modules():
    names = {p.name for p in _port_sources()}
    assert {"noise.py", "nr.py", "squelch.py", "scanutil.py", "agc.py",
            "iir.py", "fused_front.py", "wcpagc.py", "chain.py",
            "convert.py", "chip_smoke.py"} <= names


def test_port_sources_cover_the_pfb_and_conditioner_modules():
    names = {p.name for p in _port_sources()}
    assert {"channelizer.py", "pfb_kernels.py", "ewscan.py", "frontend.py",
            "demod.py"} <= names
    csrc = Path(__file__).resolve().parents[1] / "quisk_tpu_torch" / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {
        "fused_tune_decimate.cu", "pfb_poly.cu", "pfb_demod.cu",
        "pll_demod.cu", "agc_scan.cu", "agc_delay.cu", "biquad.cu",
        "mixed_demod.cu", "tx_place.cu"}
    for cu in csrc.glob("*.cu"):               # hand kernels: no library
        text = cu.read_text()
        assert "cublas" not in text.lower() and "cufft" not in text.lower()
        assert "torch/" not in text


def test_port_sources_cover_the_tx_and_spectrum_modules():
    root = Path(__file__).resolve().parents[1] / "quisk_tpu_torch"
    rel = {str(p.relative_to(root)) for p in root.rglob("*.py")}
    assert {"tx/chain.py", "tx/eer.py", "tx/ptt.py", "tx/puresignal.py",
            "tx/__init__.py", "ops/compress.py", "ops/eq.py",
            "ops/spectrum.py"} <= rel


def test_port_sources_cover_the_remaining_dsp_modules():
    root = Path(__file__).resolve().parents[1] / "quisk_tpu_torch"
    rel = {str(p.relative_to(root)) for p in root.rglob("*.py")}
    assert {"ops/pll.py", "ops/diversity.py", "utils/profiling.py",
            "utils/__init__.py", "oracle/dsp.py"} <= rel
    assert (root / "csrc" / "pll_demod.cu").exists()


def test_port_sources_cover_the_host_edge_modules():
    root = Path(__file__).resolve().parents[1] / "quisk_tpu_torch"
    rel = {str(p.relative_to(root)) for p in root.rglob("*.py")}
    assert {"io/__init__.py", "io/wav.py", "io/sources.py", "io/feed.py",
            "app/__init__.py", "app/flags.py", "app/status.py",
            "app/notchdb.py", "app/config.py", "app/graph.py", "app/cw.py",
            "app/rigctl.py", "app/radio.py", "app/cli.py", "hw/__init__.py",
            "hw/base.py"} <= rel


def test_cli_import_loads_no_jax():
    code = ("import sys, quisk_tpu_torch.app.cli, quisk_tpu_torch.app.radio\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'flax', 'quisk_tpu.')) "
            "or m == 'quisk_tpu']\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=Path(__file__).resolve().parents[1])
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(
                             Path(__file__).resolve().parents[1])))
def test_no_source_imports_jax_or_the_jax_package(path):
    """Walk the syntax tree of every module of the port and of
    chip_smoke.py: no import of jax, flax or quisk_tpu, at any depth."""
    import ast
    banned = ("jax", "flax", "quisk_tpu")
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in banned, (path.name, m)
