"""The rooflines' counts reproduce PERF.md's kernel-table figures for the
shapes they share: kernel #1 at the flagship shape (11.92 GFLOP, 364.0 MB
with its [C, B/d] output) and kernel #4 at K=4096, 2^25 a block
(2.15 GFLOP, 805.7 MB with its v [n_out, 2, K] output)."""

from __future__ import annotations

import importlib.util

import pytest

from conftest import BENCH
from qbench import peaks

FLAGSHIP = {"channels": 1024, "block_in": 40960, "block_audio": 2048,
            "decim": 20, "front_taps": 1421, "filter_taps": 1025,
            "agc_lookahead": 720, "families": ["ssb", "ssb", "am", "fm"] * 256}
PFB = {"n_chan": 4096, "block_in": 2 ** 25, "n_out": 16384,
       "taps_per_branch": 8,
       "families": ["ssb"] * 2048 + ["am"] * 1024 + ["fm"] * 1024}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "t_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rx_counts_match_kernel_one():
    c = _load("rx.kernels_roofline_pct").counts(FLAGSHIP)
    assert round(c["fir_ops"] / 1e9, 2) == 11.92
    C, T, Ba = 1024, 1421, 2048
    kernel1 = c["input_bytes"] + C * (T - 1) * 8 + C * Ba * 8
    assert round(kernel1 / 1e6, 1) == 364.0
    least, by = peaks.least_ms(c["bytes"], c["ops"])
    assert by == "operations" and 0.18 < least < 0.2


def test_pfb_counts_match_kernel_four():
    c = _load("pfb.kernels_roofline_pct").counts(PFB)
    assert round(c["poly_ops"] / 1e9, 2) == 2.15
    K, P, n_out = 4096, 8, 16384
    kernel4 = (c["input_bytes"] + (P * K - K // 2) * 8
               + n_out * 2 * K * 4 + P * K * 4)
    assert round(kernel4 / 1e6, 1) == 805.7
    least, by = peaks.least_ms(c["bytes"], c["ops"])
    assert by == "bytes" and 0.15 < least < 0.17


@pytest.mark.parametrize("name,system,shapes", [
    ("rx.kernels_roofline_pct", "rx_chain", FLAGSHIP),
    ("pfb.kernels_roofline_pct", "pfb_rx", PFB)])
def test_roofline_share_reads_busy(name, system, shapes):
    import types
    from qbench.trace import Activity, Trace
    mod = _load(name)
    least, _ = peaks.least_ms(*(mod.counts(shapes)[k]
                                for k in ("bytes", "ops")))
    busy_ns = int(least * 1e6 * 4)             # a step at 25% of roofline
    tr = Trace(device=[Activity(0, busy_ns, "k", "kernel", 7)],
               spans=[], lo=0, hi=busy_ns * 2, blocks=1)
    ctx = types.SimpleNamespace(trace=tr, shapes=shapes,
                                cfg={"system": system})
    assert mod.read(ctx) == pytest.approx(25.0, rel=1e-5)
    ctx.cfg = {"system": "other"}
    assert mod.read(ctx) is None
