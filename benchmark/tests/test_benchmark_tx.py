"""The transmit chain's cell (``tx96k_8192ch.resident``) on the CPU: its
reference (``qref/tx.py``) against the program's ``TxChain`` over 8
blocks of 2048 at C = 10 (every mode twice), with the ALC's gain moving
in every mode, and in replay steps of any span; the event-stepped ALC
against the sample-by-sample loop; the
CTCSS carry against the program's; the adapter's shapes and its draw of
checked channels; the roofline's counts at the cell's shapes; the
manifest's configuration, cell and metrics; the readers on a synthetic
trace; and the cell run at a small size, sound, with each planted fault,
and with the control in the program's place.

The roofline's counts at the cell's shapes (C 8192, B 2048, L 2, T 513,
nfft 4096, A 960, Tu 117, modes in fifths), from
``tx.kernels_roofline_pct.counts``:

- bytes: mic 67.1 MB + I/Q 268.4 MB + state 2 x 8192 (512 x 4 + 960 x 8
  + 59 x 8 + 48) = 167.9 MB + taps 33.6 MB = 537.1 MB, 0.1603 ms at
  3.35 TB/s;
- operations: the filter 8192 (2 x 5 x 4096 x 12 + 6 x 4096) = 4.228 G,
  the interpolator 4 x 59 x 8192 x 4096 = 7.919 G, the modulators 2048 (1
  x 1639 + 2 x 1638 + 8 x 1638) = 0.037 G, 8192 x 2048 (2 + 12 + 22) =
  0.604 G a mic sample and 8192 x 4096 (10 + 4) = 0.470 G a TX sample:
  13.26 GFLOP, 0.1979 ms at 67 TFLOP/s;

so the operations bound the block at 0.1979 ms.
"""

from __future__ import annotations

import importlib.util
import json
import time
import types
from fractions import Fraction

import numpy as np
import pytest
import torch

import conftest
from conftest import BENCH, tiny
from qbench import cell as cellmod
from qbench import peaks
from qbench.program import Launched, Program
from qbench.systems import tx_chain
from qbench.trace import Activity, Trace, window
from qbench.tx_signals import levels, mic_ring, symbols
from qref import tx as qtx
from qref.spec import rx_modes, rx_tunes
from qref.tx import TxReference

CELL = "tx96k_8192ch.resident"
CONFIG = "tx96k_8192ch"
METRICS = ("tx.step_busy_ms", "tx.condition_ms", "tx.filter_ms",
           "tx.modulate_ms", "tx.alc_ms", "tx.interp_ms", "tx.place_ms",
           "tx.launches_per_block", "tx.host_syncs_per_block",
           "tx.kernels_roofline_pct")
STAGES = ("tx.condition", "tx.filter", "tx.modulate", "tx.alc",
          "tx.interp", "tx.place")
# The cell at a size a CPU test runs (conftest's table of small sizes gets
# this system's entry here): 10 channels, every mode twice, blocks of 256,
# every channel checked.
conftest.TINY.setdefault("tx_chain", {
    "chain": {"channels": 10, "audio_block": 256}, "check_channels": 10})


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "t_" + name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small(manifest, **chain) -> dict:
    cfg = manifest.config(CONFIG)
    cfg = json.loads(json.dumps(cfg))
    cfg["chain"].update(channels=10, **chain)
    return cfg


# ------------------------------------------------- the program, 8 blocks
@pytest.fixture(scope="module")
def program_run(manifest):
    """The program's I/Q over 8 blocks of 2048 at C = 10 and each
    channel's ALC gain at each block's end."""
    from quisk_tpu_torch.modes import Mode
    from quisk_tpu_torch.tx.chain import TxChain, TxChainConfig
    cfg = _small(manifest)
    ring = mic_ring(cfg, 11, 8, "cpu", torch.Generator().manual_seed(11))
    tx = TxChain.create(TxChainConfig(**cfg["chain"]),
                        mode=[int(Mode[m]) for m in rx_modes(cfg)],
                        device="cpu").set_tune(rx_tunes(cfg))
    st = tx.init_state()
    outs, gains = [], [np.ones(10)]
    for j in range(8):
        st, y = tx.step(st, ring[j])
        outs.append(y.numpy().astype(np.complex128))
        gains.append(st["alc"]["gain_now"].gather(
            1, tx.mode[:, None])[:, 0].numpy().astype(np.float64))
    return cfg, ring, outs, np.array(gains), st


def test_reference_matches_program(program_run):
    cfg, ring, outs, gains, _ = program_run
    # within 8 blocks no row's ALC has left the reference's orbit: every
    # row is held to the FM rows' limit
    limit = cfg["limits"]["fm_iq_gap"]
    modes = np.array(rx_modes(cfg))
    # every mode's ALC gain moves over the blocks compared
    moved = np.abs(np.diff(gains, axis=0)).max(0) > 1e-6
    assert all(moved[modes == m].all() for m in qtx.MODES)
    ref = TxReference.create(cfg)
    ks = list(range(2, 8))
    want = ref.blocks(lambda j: ring[j], ks, np.arange(10))
    for k in ks:
        g = tx_chain.gaps(outs[k], want[k])
        assert g["iq"].max() < limit, (k, g["iq"])
        assert g["phase"][modes != "FM"].max() < cfg["limits"]["phase_gap"], (
            k, g["phase"])
    assert ref.ramps > len(ks) * 10 // 2


def test_phase_gap_is_blind_to_the_gain(program_run, monkeypatch):
    """A slow real gain on the ALC's output, as two orbits of the ALC give,
    moves ``iq_gap`` and not ``phase_gap``, through the interpolator; a
    phase error of 1e-4 shows in ``phase_gap``."""
    cfg, ring, _, _, _ = program_run
    modes = np.array(rx_modes(cfg))
    ks, rows = [5, 7], np.arange(10)
    want = TxReference.create(cfg).blocks(lambda j: ring[j], ks, rows)
    run = qtx.Alc.run

    def wobbled(self, st, m, ix0, per):
        g, c = run(self, st, m, ix0, per)
        n = torch.arange(ix0, ix0 + g.shape[1], dtype=torch.float64)
        return g * (1.0 + 0.01 * torch.sin(2 * np.pi * n / 5000.0)), c
    monkeypatch.setattr(qtx.Alc, "run", wobbled)
    got = TxReference.create(cfg).blocks(lambda j: ring[j], ks, rows)
    for k in ks:
        g = tx_chain.gaps(got[k], want[k])
        assert g["iq"][modes != "FM"].max() > 1e-3
        assert g["phase"].max() < 1e-7          # 100 x under the limit
        turned = tx_chain.gaps(want[k] * np.exp(1e-4j), want[k])
        assert np.allclose(turned["phase"], 1e-4, rtol=1e-6)


def test_reference_replays_in_steps_of_any_span(program_run, monkeypatch):
    """Steps of one block and of the whole stream give the same blocks."""
    cfg, ring, _, _, _ = program_run
    got = {}
    for span in (1, 3, 8):
        monkeypatch.setattr(qtx, "SPAN", span)
        got[span] = TxReference.create(cfg).blocks(lambda j: ring[j],
                                                   [0, 5, 7], np.arange(10))
    for k in (0, 5, 7):
        for span in (1, 3):
            assert np.abs(got[span][k] - got[8][k]).max() < 1e-12


def test_ctcss_carry_is_the_programs(program_run):
    cfg, _, _, _, st = program_run
    ref = TxReference.create(cfg)
    got = ref.carry(np.array([8]))[0]
    assert got == float(st["ctcss_phase"][0])
    assert (st["ctcss_phase"] == st["ctcss_phase"][0]).all()


def _alc_direct(m: np.ndarray, A: int, d_limit: float, ix0: int):
    """process_alc sample by sample over magnitudes m [R, N] from rest, the
    ALC index (ix0 + n) mod A: the gain each sample sees."""
    R, N = m.shape
    g, gc, fg = np.ones(R), np.zeros(R), np.zeros(R)
    nc, cnt, flt = np.full(R, 1e10), np.zeros(R), np.zeros(R)
    bi = np.zeros(R, np.int64)
    out = np.empty((R, N))
    for n in range(N):
        mm, ix = m[:, n], (ix0 + n) % A
        tm = qtx.TARGET / np.maximum(mm, 1e-9)
        sil = mm < qtx.MIN_MAGN
        clip = mm * (g + gc * A) > qtx.CLIP
        blk = bi == ix
        out[:, n] = g
        fg1 = np.clip(tm, qtx.GAIN_MIN, qtx.GAIN_MAX)
        r = np.where(flt < A - 10, np.minimum(nc, d_limit), gc)
        fg2 = np.clip(g + r * A, qtx.GAIN_MIN, qtx.GAIN_MAX)
        cnt1 = cnt + ~sil
        nc1 = np.where(sil, nc,
                       np.minimum(nc, (tm - fg) / np.maximum(cnt1, 1)))
        gc = np.where(clip, (fg1 - g) / A, np.where(blk, (fg2 - g) / A, gc))
        fg = np.where(clip, fg1, np.where(blk, fg2, fg))
        rst = clip | blk
        nc = np.where(rst, 1e10, nc1)
        cnt = np.where(rst, 0.0, cnt1)
        flt = np.where(rst, 0.0, flt + sil)
        bi = np.where(clip, ix, bi)
        g = g + gc
    return out


@pytest.mark.parametrize("B", [2048, 700])
def test_event_stepped_alc_is_the_per_sample_loop(B):
    rng = np.random.default_rng(B)
    R, nb, A = 6, 5, 960
    level = np.array([0.3, 0.5, 0.7, 0.2, 0.9, 0.05])[:, None]
    m = np.abs(rng.standard_normal((R, nb * B))
               + 1j * rng.standard_normal((R, nb * B))) * level
    m[:, 3000:4500] *= 1e-4                    # a silent stretch
    m *= 1.0 + 0.6 * ((np.arange(nb * B) // 1500) % 3)   # louder bursts
    d_limit = 1.0 / (48000.0 * 5.0)
    want = _alc_direct(m, A, d_limit, 0)
    alc = qtx.Alc(A=A, d_limit=d_limit)
    # block by block, and the whole stream in one step
    st = alc.rest(R, "cpu")
    got, clips = [], []
    for j in range(nb):
        g, c = alc.run(st, torch.as_tensor(m[:, j * B:(j + 1) * B]),
                       (j * B) % A, B)
        got.append(g.numpy())
        clips.append(c.numpy()[:, 0])
    got = np.concatenate(got, 1)
    assert np.abs(got - want).max() < 1e-11
    whole, c_whole = alc.run(alc.rest(R, "cpu"), torch.as_tensor(m), 0, B)
    assert np.abs(whole.numpy() - want).max() < 1e-11
    clips = np.array(clips).T
    assert np.array_equal(c_whole.numpy(), clips)
    assert clips.sum() >= 6 and clips.any(1).sum() >= 3
    assert np.ptp(want, 1).min() > 1e-3


def test_event_stepped_alc_takes_clip_runs_whole():
    """A rising envelope sets off a clip at sample after sample: the runs
    are stepped whole and still give the sample-by-sample gains."""
    R, B, nb, A = 4, 2048, 4, 960
    n = np.arange(nb * B)
    rise = 1.0 + 0.25 * ((n % 1500) / 1500.0) ** np.array(
        [1.0, 2.0, 0.5, 3.0])[:, None]
    m = np.array([0.9, 1.0, 1.1, 1.3])[:, None] * rise
    d_limit = 1.0 / (48000.0 * 5.0)
    want = _alc_direct(m, A, d_limit, 0)
    alc = qtx.Alc(A=A, d_limit=d_limit)
    got, _ = alc.run(alc.rest(R, "cpu"), torch.as_tensor(m), 0, B)
    assert np.abs(got.numpy() - want).max() < 1e-11
    # runs of clips: the gain falls on most samples of each rise
    falls = (np.diff(want, axis=1) < 0).sum(1)
    assert falls.min() > nb * B // 4


# --------------------------------------------------------- the adapter
def test_adapter_shapes(manifest):
    cfg = cellmod._merge(manifest.config(CONFIG), tiny(manifest, CELL))
    sysm = tx_chain.System(cfg, 7, "cpu")
    assert sysm.block_shape == (10, 256)
    assert sysm.samples_per_block == 10 * 256
    assert sysm.out_shapes == [((10, 512), torch.complex64)]
    s = sysm.shapes()
    assert (s["channels"], s["block"], s["block_tx"], s["interp"],
            s["filter_taps"], s["nfft"], s["interp_taps"],
            s["alc_delay"]) == (10, 256, 512, 2, 513, 1024, 117, 960)
    assert s["modes"] == {m: 2 for m in qtx.MODES}
    # the chain's own tune words are the reference's
    words = sysm.chain.tune.word.numpy()
    assert np.array_equal(words, TxReference.create(cfg).words)
    ring = sysm.make_ring(2, torch.Generator().manual_seed(7))
    assert [tuple(b.shape) for b in ring] == [(10, 256)] * 2
    assert ring[0].dtype == torch.float32


def test_signal_levels(manifest):
    cfg = _small(manifest)
    digital, level = levels(cfg, 3)
    assert digital.tolist() == [m == "DGT_U" for m in rx_modes(cfg)]
    ring = mic_ring(cfg, 3, 8, "cpu", torch.Generator().manual_seed(3))
    x = torch.cat(ring, 1).double()
    rms = x.square().mean(1).sqrt().numpy()
    peak = x.abs().amax(1).numpy()
    # the converter's full scale clips the loudest voice rows' peaks (4.6%
    # of the samples of noise at -6 dBFS rms); the tone stays under it
    assert peak.max() <= 1.0
    assert (rms[~digital] <= level[~digital] * (1 + 1e-5)).all()
    assert (rms[~digital] >= level[~digital] * 0.95).all()
    assert np.allclose(peak[digital], level[digital], rtol=1e-3)
    lo, hi = cfg["signal"]["voice_rms_db"]
    db = 20 * np.log10(level[~digital])
    assert (db >= lo).all() and (db <= hi).all()
    lo, hi = cfg["signal"]["dgt_amp_db"]
    db = 20 * np.log10(level[digital])
    assert (db >= lo).all() and (db <= hi).all() and hi <= 0.0
    # the 8-FSK tone turns a whole number of times over the ring, so the
    # ring wraps with no jump of phase
    sig = cfg["signal"]
    S, N = sig["fsk_symbol"], x.shape[1]
    n = np.minimum(S, N - S * np.arange(-(-N // S)))
    for row in symbols(cfg, 3, N)[digital]:
        turns = sum(Fraction(sig["fsk_base_hz"] + sig["fsk_step_hz"] * int(v))
                    * int(k) for v, k in zip(row, n)) / 48000
        assert turns.denominator == 1
    # the voice rows' power lies in the band, but for what the clipping
    # spreads out of it
    spec = np.abs(np.fft.rfft(x.numpy())) ** 2
    f = np.fft.rfftfreq(x.shape[1], 1 / 48000.0)
    share = spec[:, (f < 300.0) | (f > 2700.0)].sum(1) / spec.sum(1)
    clean = ~digital & (peak < 1.0)
    assert clean.sum() >= 2 and (share[clean] < 1e-6).all()
    assert (share[~digital] < 1e-2).all()


def test_checked_channels_drawn_in_their_shares(manifest):
    cfg = manifest.config(CONFIG)
    rows = tx_chain.checked(cfg, 2 ** 31 + 11)
    modes = np.array(rx_modes(cfg))
    assert rows.size == cfg["check_channels"] == 2048
    counts = {m: int((modes[rows] == m).sum()) for m in qtx.MODES}
    assert sum(counts.values()) == 2048
    assert max(counts.values()) - min(counts.values()) <= 1
    assert np.array_equal(rows, np.unique(rows))
    assert not np.array_equal(rows, tx_chain.checked(cfg, 5))


# --------------------------------------------------------- the roofline
def test_roofline_counts_at_the_cells_shapes():
    mod = _load("tx.kernels_roofline_pct")
    modes = {"USB": 1639, "LSB": 1639, "AM": 1638, "FM": 1638, "DGT_U": 1638}
    s = {"channels": 8192, "block": 2048, "block_tx": 4096, "interp": 2,
         "filter_taps": 513, "nfft": 4096, "interp_taps": 117,
         "alc_delay": 960, "modes": modes}
    c = mod.counts(s)
    assert round(c["bytes"] / 1e6, 1) == 537.1
    assert round(c["ops"] / 1e9, 2) == 13.26
    least, by = peaks.least_ms(c["bytes"], c["ops"])
    assert by == "operations" and round(least, 4) == 0.1979
    assert round(c["interp_ops"] / 1e9, 3) == 7.919
    # without the ALC its operations go
    c0 = mod.counts(dict(s, alc_delay=0))
    assert c["ops"] - c0["ops"] == 22 * 8192 * 2048


# --------------------------------------------------------- the manifest
def test_manifest_has_the_cell(manifest):
    d = manifest.data
    cfgs = [c for c in d["configs"] if c["name"] == CONFIG]
    assert len(cfgs) == 1 and cfgs[0]["reduced"] == []
    w = manifest.workload(CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (CONFIG, "resident",
                                                       1)
    cfg = manifest.config(CONFIG)
    assert cfg["system"] == "tx_chain" and cfg["reduced"] == []
    ch = cfg["chain"]
    assert (ch["channels"], ch["audio_rate"], ch["tx_rate"],
            ch["audio_block"], ch["compress_db"], ch["preemphasis"],
            ch["alc"], ch["fm_deviation_hz"], ch["ctcss_hz"]) == (
                8192, 48000.0, 96000.0, 2048, 6.0, 0.3, True, 5000.0, 100.0)
    assert cfg["modes"]["cycle"] == list(qtx.MODES)
    # channel c's offset: -fs/4 + (c + 1/2) fs / (2 C) at 96 kS/s
    t = rx_tunes(cfg)
    c = np.arange(8192)
    assert np.array_equal(t, -24000.0 + (c + 0.5) * 96000.0 / 16384)
    names = [m["name"] for m in manifest.per_layer(CELL)]
    assert set(METRICS) <= set(names) and "device.idle_pct" in names
    for m in d["per_layer"]:
        if m["name"] in METRICS:
            assert m["workloads"] == [CELL]
            assert m["source"] == "device_trace"
            assert m["moves"] == "input_msps"
    for other in d["workloads"]:
        if other["name"] != CELL:
            assert not set(METRICS) & {m["name"] for m in
                                       manifest.per_layer(other["name"])}


# ------------------------------------------------------------ the readers
def _synthetic():
    """Two steps in a 0-200 ns window: each stage launches one kernel a
    step, the ALC's stage two; no sync."""
    dev, spans, calls = [], [], []
    for t0 in (0, 100):
        spans.append((t0 + 1, t0 + 60, "tx.step", 1))
        t = t0 + 2
        for st in STAGES:
            spans.append((t, t + 8, st, 1))
            calls.append((t, "cudaLaunchKernel", 1))
            if st == "tx.alc":
                calls.append((t + 1, "cuLaunchKernel", 1))
            t += 9
    clock = {0: 61, 100: 161}
    for at, name, _ in sorted(calls):
        base = 0 if at < 100 else 100
        start = clock[base]
        clock[base] += 3
        dev.append(Launched(start, start + 3, f"k{at}", "kernel", 7, at, 1))
    handoffs = [(0, 1, "handoff"), (100, 101, "handoff"),
                (200, 201, "handoff")]
    tr = window(Trace([Activity(a.start, a.end, a.name, a.kind, a.stream)
                       for a in dev], handoffs))
    tr.program = Program(dev, spans, sorted(calls))
    return tr


def _ctx(tr, system="tx_chain"):
    return types.SimpleNamespace(
        trace=tr, cfg={"system": system},
        shapes={"channels": 8, "block": 256, "block_tx": 512, "interp": 2,
                "filter_taps": 513, "nfft": 1024, "interp_taps": 117,
                "alc_delay": 960, "modes": {"USB": 4, "FM": 4}})


def test_readers_on_a_synthetic_trace():
    tr = _synthetic()
    got = {m: _load(m).read(_ctx(tr)) for m in METRICS}
    assert all(v is not None for v in got.values()), got
    stages = sum(got[f"tx.{s[3:]}_ms"] for s in STAGES)
    assert stages == pytest.approx(got["tx.step_busy_ms"], rel=1e-9)
    assert got["tx.alc_ms"] == pytest.approx(2 * got["tx.filter_ms"])
    assert got["tx.launches_per_block"] == 7.0
    assert got["tx.host_syncs_per_block"] == 0.0
    assert got["tx.kernels_roofline_pct"] > 0
    # another system's cell, and a program with no spans, read nothing
    assert all(_load(m).read(_ctx(tr, "rx_pllnfm")) is None
               for m in METRICS)
    bare = _synthetic()
    bare.program = Program(bare.program.device, [], bare.program.calls)
    for m in METRICS:
        if m not in ("tx.step_busy_ms", "tx.kernels_roofline_pct"):
            assert _load(m).read(_ctx(bare)) is None, m


# ------------------------------------------------------- the cell, small
def _run(manifest, fault=None):
    return cellmod.run(CELL, 2 ** 31 + 3, 1.5, False,
                       t_process=time.perf_counter(), device="cpu",
                       override=tiny(manifest, CELL), fault=fault)


def test_small_cell_is_correct(manifest):
    res = _run(manifest)
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["checks"]["iq_gap"]["value"] < 1e-4
    assert res["checks"]["fm_iq_gap"]["value"] < 1e-4
    assert res["checks"]["phase_gap"]["value"] < 1e-6
    assert set(res["metrics"]) == {"input_msps", "block_ms_p95", "setup_s"}


@pytest.mark.parametrize("fault", ["stale_state", "half_batch",
                                   "altered_answer"])
def test_small_cell_fault_is_not_correct(manifest, fault):
    res = _run(manifest, fault)
    assert res["correct"] is False and res["failed"] >= 1


def test_control_fails_small(manifest):
    import control
    limits = manifest.config(CONFIG)["limits"]
    got = control.control(CELL, 21, 1, "cpu", tiny(manifest, CELL),
                          first=20, last=40)
    assert got["fm_iq_gap"] > 5 * limits["fm_iq_gap"], got
    assert got["phase_gap"] > 10 * limits["phase_gap"], got
