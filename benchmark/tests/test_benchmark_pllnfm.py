"""The narrowband-FM receiver's cell (``pllnfm192k_8192ch.resident``) on
the CPU: its reference (``qref/pllnfm.py``) against a direct float64
loop, sample by sample from the stream's start, at C = 4; the adapter's
shapes and its draw of checked channels; the roofline's counts at the
cell's shapes; the manifest's configuration, cell and metrics; the
metrics' readers on a synthetic trace; and the cell run at a small size,
sound, with a planted fault, and with the control in the program's place.

The roofline's counts at the cell's shapes (C 8192, B_in 8192, T 133,
Ba 2048, Tbp 1025, W 720), from ``nfm.kernels_roofline_pct.counts``:

- bytes: input 536.9 MB + audio 67.1 MB + state 2 x 8192 (132 x 8 +
  1024 x 8 + 720 x 4 + 32) = 199.2 MB + taps 67.2 MB = 870.4 MB,
  0.2598 ms at 3.35 TB/s;
- operations: mix 8 x 8192 x 8192 = 0.537 G, the FIR 4 x 133 x 8192 x
  2048 = 8.925 G, the filter 8192 (2 x 5 x 4096 x 12 + 6 x 4096) =
  4.228 G, and 8192 x 2048 times 19 (PLL) + 3 (de-emphasis) + 9 (notch) +
  11 (AGC) + 7 (squelch) = 0.822 G: 14.51 GFLOP, 0.2166 ms at
  67 TFLOP/s;

so the bytes bound the block at 0.2598 ms.  Kernel #1's share at 1024
channels is the kernel table's NFM row: 4 x 133 x 1024 x 2048 =
1.12 GFLOP over 85.0 MB (its input, history and [C, Ba] complex64
output).
"""

from __future__ import annotations

import importlib.util
import math
import time
import types

import numpy as np
import pytest
import torch

import conftest
from conftest import BENCH, tiny
from qbench import cell as cellmod
from qbench import peaks
from qbench.nfm_signals import pllnfm_ring, stations
from qbench.program import Launched, Program
from qbench.trace import Activity, Trace, window
from qref.pllnfm import PllNfmReference

CELL = "pllnfm192k_8192ch.resident"
METRICS = ("nfm.step_busy_ms", "nfm.front_ms", "nfm.filter_ms",
           "nfm.demod_ms", "nfm.agc_ms", "nfm.fm_sq_ms", "nfm.pll_ms",
           "nfm.deemph_ms", "nfm.ctcss_ms", "nfm.launches_per_block",
           "nfm.host_syncs_per_block", "nfm.kernels_roofline_pct")
# The cell at a size a CPU test runs (conftest's table of small sizes gets
# this system's entry here): 4 channels, one idle, without the AGC.  The
# program's loop acquires on the filters' first outputs, under its float32
# FFT's rounding, so its first blocks are its own; the AGC carries that
# start for ~12 blocks of 2048 and the notch for ~5, and a CPU run's window
# ends before 12.  The AGC's reference is held to the direct loop below.
conftest.TINY.setdefault("rx_pllnfm", {
    "chain": {"channels": 4, "agc": False}, "check_channels": 4})

SMALL = {
    "chain": {"sample_rate": 192000.0, "channels": 4, "audio_block": 2048,
              "agc": True, "fused_frontend": True, "ext_demod": "pll_fm",
              "fm_deviation_hz": 5000.0, "ctcss_hz": 100.0,
              "fm_squelch": True, "fm_squelch_db": -2.0},
    "tune": {"first_hz": -42000.0, "step_hz": 24000.0},
    "modes": {"cycle": ["EXT"]},
    "signal": {"noise_rms": 1.0, "level_db": [6.0, 18.0], "idle_every": 4,
               "voice_hz": 1000.0, "voice_deviation_hz": 3000.0,
               "ctcss_hz": 100.0, "ctcss_deviation_hz": 500.0},
}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "t_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------ the direct loop
def _direct(ref: PllNfmReference, x: np.ndarray) -> np.ndarray:
    """The chain over the whole stream x [C, N] (complex128, from stream
    sample 0), one sample at a time in float64 NumPy after the filters
    (taken as the FFT convolutions of the reference's own taps)."""
    rx = ref.rx
    C, N = x.shape
    s = np.arange(N, dtype=np.int64)
    ang = ((rx.words[:, None] * s[None, :]) % (1 << 32)) * (
        2.0 * np.pi / 2 ** 32)
    mixed = x * np.exp(-1j * ang)
    y = np.stack([np.convolve(m, rx.h_front)[:N][::rx.decim]
                  for m in mixed])
    z = np.stack([np.convolve(v, rx.bp[0])[:y.shape[1]] for v in y])
    n_out = z.shape[1]
    audio = np.zeros((C, n_out))
    ph = np.zeros(C)
    fr = np.zeros(C)
    de = np.zeros(C)
    b0, b1, b2, a1, a2 = ref.notch
    x1 = x2 = y1 = y2 = np.zeros(C)
    for n in range(n_out):
        v = z[:, n] * np.exp(-1j * ph)
        err = np.arctan2(v.imag, v.real)
        fr = np.clip(fr + ref.beta * err, -ref.max_freq, ref.max_freq)
        ph = ph + fr + ref.alpha * err
        ph = np.where(ph > np.pi, ph - 2 * np.pi,
                      np.where(ph < -np.pi, ph + 2 * np.pi, ph))
        a = (fr + ref.alpha * err) * ref.gain
        de = ref.de_a * de + (1.0 - ref.de_a) * a
        yn = b0 * de + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
        x2, x1, y2, y1 = x1, de, y1, yn
        audio[:, n] = yn
    # the lookahead AGC
    W = rx.W
    delayed = np.concatenate([np.zeros((C, W)), audio], axis=1)
    lg = np.zeros(C)
    out = np.zeros((C, n_out))
    for n in range(n_out):
        env = np.abs(delayed[:, n:n + W]).max(-1)
        limit = np.minimum(np.log(rx.target / np.maximum(env, 1e-9)),
                           rx.max_lg)
        lg = np.minimum(lg + rx.inc, limit)
        out[:, n] = delayed[:, n] * np.exp(lg)
    # the squelch, block by block
    Ba = rx.block_audio
    t = np.arange(Ba)
    frac = 0.5 - 0.5 * np.cos(np.pi * np.minimum(t / ref.ramp, 1.0))
    hold = np.zeros(C, np.int64)
    g = np.zeros(C)
    for b in range(n_out // Ba):
        seg = slice(b * Ba, (b + 1) * Ba)
        db = 10 * np.log10(np.mean(np.abs(z[:, seg]) ** 2, -1) + 1e-20)
        hold = np.where(db > ref.squelch_db, ref.hold_blocks,
                        np.maximum(hold - 1, 0))
        gb = g[:, None] + ((hold > 0) - g)[:, None] * frac
        g = gb[:, -1]
        out[:, seg] *= gb
    return out


@pytest.fixture(scope="module")
def small_stream():
    ref = PllNfmReference.create(SMALL)
    gen = torch.Generator().manual_seed(3)
    R = 5
    ring = pllnfm_ring(SMALL, 3, R, ref.rx.block_in, "cpu", gen)
    k_far = PllNfmReference.create(SMALL).burn + 16 + 1   # j0 = 1
    x = torch.cat([ring[j % R] for j in range(k_far + 1)], dim=1)
    return ref, ring, k_far, _direct(ref, x.numpy().astype(np.complex128))


@pytest.mark.parametrize("which", ["exact", "replayed"])
def test_reference_matches_direct_loop(small_stream, which):
    ref, ring, k_far, want = small_stream
    R = len(ring)
    # the exact path replays from the stream's start (j0 = 0), as the
    # direct loop runs: the two loops acquire on the filters' first
    # outputs, where FFT and direct sums differ in relative terms, and the
    # AGC carries that start for ~12 blocks, so both are compared past it
    k = 25 if which == "exact" else k_far
    Ba = ref.rx.block_audio
    rows = np.arange(4)
    got, rf = ref.blocks(lambda j: ring[j % R], [k], rows)[k]
    w = want[:, k * Ba:(k + 1) * Ba]
    on, _ = stations(SMALL, 3)
    assert (w[~on] == 0).all() and (got[~on] == 0).all()
    gap = np.abs(got[on] - w[on]).max(-1) / np.abs(w[on]).max(-1)
    assert gap.max() < 1e-9, gap
    assert rf[on].min() > -2.0 + 3.0 and rf[~on].max() < -2.0 - 3.0


def test_reference_settles_within_burn():
    ref = PllNfmReference.create(SMALL)
    # the notch's pole pair r = 0.9987: 1e-13 of a start in ~0.55 s
    assert 24000 < ref.settle < 30000
    assert ref.burn * ref.rx.block_audio >= ref.settle + ref.rx.W
    assert ref.burn >= ref.hold_blocks + 2
    # the audio bound: the PLL's (max_freq + alpha pi) gain through the
    # notch's l1 norm
    lo = (ref.max_freq + ref.alpha * math.pi) * ref.gain
    assert lo < ref.bound < 3.0 * lo


# --------------------------------------------------------- the adapter
def test_adapter_shapes(manifest):
    from qbench.systems import rx_pllnfm
    cfg = cellmod._merge(manifest.config("pllnfm192k_8192ch"),
                         tiny(manifest, CELL))
    sysm = rx_pllnfm.System(cfg, 7, "cpu")
    assert sysm.block_shape == (4, 8192)
    assert sysm.samples_per_block == 4 * 8192
    assert sysm.out_shapes == [((4, 2048), torch.float32)]
    s = sysm.shapes()
    assert (s["channels"], s["block_in"], s["block_audio"], s["decim"],
            s["front_taps"], s["filter_taps"], s["agc_lookahead"]) == (
                4, 8192, 2048, 4, 133, 1025, 720)
    assert s["notch"] and s["squelch"]
    ring = sysm.make_ring(2, torch.Generator().manual_seed(7))
    assert [tuple(b.shape) for b in ring] == [(4, 8192)] * 2
    assert ring[0].dtype == torch.complex64


def test_checked_channels_drawn_in_their_shares(manifest):
    from qbench.systems import rx_pllnfm
    cfg = manifest.config("pllnfm192k_8192ch")
    rows = rx_pllnfm.checked(cfg, 2 ** 31 + 11)
    on, _ = stations(cfg, 2 ** 31 + 11)
    assert rows.size == cfg["check_channels"] == 2048
    assert (on[rows].sum(), (~on[rows]).sum()) == (1536, 512)
    assert np.array_equal(rows, np.unique(rows))
    assert not np.array_equal(rows, rx_pllnfm.checked(cfg, 5))


# --------------------------------------------------------- the roofline
def test_roofline_counts_at_the_cells_shapes():
    mod = _load("nfm.kernels_roofline_pct")
    s = {"channels": 8192, "block_in": 8192, "block_audio": 2048,
         "front_taps": 133, "filter_taps": 1025, "agc_lookahead": 720,
         "notch": True, "squelch": True}
    c = mod.counts(s)
    assert round(c["bytes"] / 1e6, 1) == 870.4
    assert round(c["ops"] / 1e9, 2) == 14.51
    least, by = peaks.least_ms(c["bytes"], c["ops"])
    assert by == "bytes" and round(least, 4) == 0.2598
    # kernel #1 at 1024 channels: the kernel table's NFM row
    c1 = mod.counts(dict(s, channels=1024))
    assert round(c1["fir_ops"] / 1e9, 2) == 1.12
    C, B, T, Ba = 1024, 8192, 133, 2048
    assert round((C * B * 8 + C * (T - 1) * 8 + C * Ba * 8) / 1e6, 1) == 85.0
    # without the notch and the squelch their operations go
    c0 = mod.counts(dict(s, notch=False, squelch=False))
    assert c["ops"] - c0["ops"] == (9 + 7) * 8192 * 2048


# --------------------------------------------------------- the manifest
def test_manifest_has_the_cell(manifest):
    d = manifest.data
    cfgs = [c for c in d["configs"] if c["name"] == "pllnfm192k_8192ch"]
    assert len(cfgs) == 1 and cfgs[0]["reduced"] == []
    w = manifest.workload(CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "pllnfm192k_8192ch", "resident", 1)
    cfg = manifest.config(w["config"])
    assert cfg["system"] == "rx_pllnfm" and cfg["reduced"] == []
    assert cfg["chain"]["ctcss_hz"] == 100.0
    assert cfg["chain"]["ext_demod"] == "pll_fm"
    names = [m["name"] for m in manifest.per_layer(CELL)]
    assert set(METRICS) <= set(names) and "device.idle_pct" in names
    for m in d["per_layer"]:
        if m["name"] in METRICS:
            assert m["workloads"] == [CELL]
            assert m["source"] == "device_trace"
            assert m["moves"] == "input_msps"
    # no other cell reads them
    for other in d["workloads"]:
        if other["name"] != CELL:
            assert not set(METRICS) & {m["name"] for m in
                                       manifest.per_layer(other["name"])}


# ------------------------------------------------------------ the readers
STAGES = ("rx.front", "rx.filter", "rx.demod", "rx.agc", "rx.fm_sq")


def _synthetic():
    """Two steps in a 0-200 ns window: each stage launches one kernel a
    step, the demod's parts one each inside rx.demod, plus one kernel of
    the families; one sync a step in rx.demod."""
    dev, spans, calls = [], [], []
    for b, t0 in enumerate((0, 100)):
        spans.append((t0 + 1, t0 + 60, "rx.step", 1))
        t = t0 + 2
        for st in STAGES:
            spans.append((t, t + 9, st, 1))
            if st == "rx.demod":
                for i, part in enumerate(("rx.pll", "rx.deemph",
                                          "rx.ctcss")):
                    spans.append((t + 1 + 2 * i, t + 2 + 2 * i, part, 1))
                    calls.append((t + 1 + 2 * i, "cudaLaunchKernel", 1))
                calls.append((t + 8, "cudaStreamSynchronize", 1))
            calls.append((t, "cudaLaunchKernel", 1))
            t += 10
    # device work: each launch runs 3 ns, back to back from 61 ns into its
    # step
    clock = {0: 61, 100: 161}
    for at, name, _ in sorted(calls):
        if name.startswith("cudaLaunch"):
            base = 0 if at < 100 else 100
            start = clock[base]
            clock[base] += 3
            dev.append(Launched(start, start + 3, f"k{at}", "kernel", 7, at,
                                1))
    handoffs = [(0, 1, "handoff"), (100, 101, "handoff"),
                (200, 201, "handoff")]
    tr = window(Trace([Activity(a.start, a.end, a.name, a.kind, a.stream)
                       for a in dev], handoffs))
    tr.program = Program(dev, spans, sorted(calls))
    return tr


def _ctx(tr, system="rx_pllnfm"):
    return types.SimpleNamespace(
        trace=tr, cfg={"system": system},
        shapes={"channels": 8, "block_in": 1024, "block_audio": 256,
                "front_taps": 133, "filter_taps": 1025, "agc_lookahead": 720,
                "notch": True, "squelch": True})


def test_readers_on_a_synthetic_trace():
    tr = _synthetic()
    got = {m: _load(m).read(_ctx(tr)) for m in METRICS}
    assert all(v is not None for v in got.values()), got
    stages = sum(got[f"nfm.{s[3:]}_ms"] for s in STAGES)
    assert stages == pytest.approx(got["nfm.step_busy_ms"], rel=1e-3)
    parts = got["nfm.pll_ms"] + got["nfm.deemph_ms"] + got["nfm.ctcss_ms"]
    assert parts <= got["nfm.demod_ms"]
    assert got["nfm.launches_per_block"] == 8.0
    assert got["nfm.host_syncs_per_block"] == 1.0
    assert got["nfm.kernels_roofline_pct"] > 0
    # another system's cell, and a program with no spans, read nothing
    assert all(_load(m).read(_ctx(tr, "rx_chain")) is None for m in METRICS)
    bare = _synthetic()
    bare.program = Program(bare.program.device, [], bare.program.calls)
    for m in METRICS:
        if m not in ("nfm.step_busy_ms", "nfm.kernels_roofline_pct"):
            assert _load(m).read(_ctx(bare)) is None, m


# ------------------------------------------------------- the cell, small
def _run(manifest, fault=None):
    return cellmod.run(CELL, 2 ** 31 + 3, 1.5, False,
                       t_process=time.perf_counter(), device="cpu",
                       override=tiny(manifest, CELL), fault=fault)


def test_small_cell_is_correct(manifest):
    res = _run(manifest)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["checks"]["audio_gap"]["value"] < 1e-4


@pytest.mark.parametrize("fault", ["stale_state", "altered_answer"])
def test_small_cell_fault_is_not_correct(manifest, fault):
    res = _run(manifest, fault)
    assert res["correct"] is False and res["failed"] >= 1


def test_control_fails_small(manifest):
    import control
    got = control.control(CELL, 21, 1, "cpu", tiny(manifest, CELL),
                          first=20, last=40)
    assert got["audio_gap"] > 10 * 1e-4, got
