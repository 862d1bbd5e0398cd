"""The WDSP narrowband-FM receiver on the port (``RxChainConfig(ext_demod=
"pll_fm", ctcss_hz=..., fm_squelch=True)`` at 192 kS/s) against the plain
float64 reference ``quisk_tpu_torch/oracle/pllnfm.py``, on the CPU.

C = 8 channels at full widths (192 kS/s in, the folded /4 front, the
1025-tap EXT filter, 2048-sample audio blocks, the 100 Hz CTCSS notch,
the lookahead AGC, the FM squelch): on six an FM station (a 1 kHz tone at
3 kHz deviation and the 100 Hz tone at 500 Hz, 6-18 dB over unit-rms
noise on each rail), channels 3 and 7 noise alone.

Both start from rest.  The PLL acquires on the filters' first outputs,
which are smaller than the program's float32 FFT rounding, so the two
loops take different paths for the first few samples and their audio
differs there by up to full scale.  The notch (pole radius 0.9987) rings
with that difference for ~5 blocks, and the AGC, which drops its gain at
the start transient and releases at 60 dB/s, carries it until its gain
has climbed back, ~0.5 s (9 blocks here).  Past ``SETTLED`` blocks the
two agree to float32 rounding.
"""

import numpy as np
import pytest
import torch

from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops import demod
from quisk_tpu_torch.ops.demod import PLLFMDemod
from quisk_tpu_torch.oracle.pllnfm import PllNfmOracle
from quisk_tpu_torch.rx import RxChain, RxChainConfig
from quisk_tpu_torch.utils.profiling import NULL_SPAN, PREFIX, span

FS = 192000.0
C = 8
BLOCKS = 14
SETTLED = 10                  # blocks compared: SETTLED .. BLOCKS - 1
IDLE = (3, 7)
SQUELCH_DB = -2.0             # idle channels ~-9.8 dB, stations >= +6 dB
# The program's float32 against the float64 reference: 4e-7 of a block's
# peak before the notch; the notch's state, carried between blocks in
# float32 and rung up by its resonance (1 / sin(w0) ~ 76), and the AGC's
# float32 log gain leave up to 5.3e-6 here.  The TF32 control lands at 0.37
# and over (the notch's coefficients in TF32 move its zero and poles); with
# the FIR filters alone in TF32 it reads 1.3-1.6e-4.
TOL = 5e-5
CHAIN = dict(sample_rate=FS, channels=C, audio_block=2048, agc=True,
             fused_frontend=True, ext_demod="pll_fm", fm_deviation_hz=5000.0,
             ctcss_hz=100.0, fm_squelch=True, fm_squelch_db=SQUELCH_DB)
TUNE = [-FS / 4 + (c + 0.5) * FS / (2 * C) for c in range(C)]


def _capture(n: int) -> np.ndarray:
    """[C, n] complex64: unit-rms noise on each rail, and on every channel
    but ``IDLE`` an FM station on its dial, 6-18 dB."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((C, n)) + 1j * rng.standard_normal((C, n))
    t = np.arange(n) / FS
    phase = (3.0 * np.sin(2 * np.pi * 1000.0 * t)
             + 5.0 * np.sin(2 * np.pi * 100.0 * t))
    level = 10.0 ** (rng.uniform(6.0, 18.0, C) / 20.0)
    for c in range(C):
        if c not in IDLE:
            x[c] += level[c] * np.exp(1j * (phase + 2 * np.pi * TUNE[c] * t))
    return x.astype(np.complex64)


def _oracle(**kw):
    ch = {k: v for k, v in CHAIN.items()
          if k not in ("sample_rate", "channels", "fused_frontend",
                       "ext_demod")}
    return PllNfmOracle.create(FS, TUNE, **ch, **kw)


@pytest.fixture(scope="module")
def stream():
    """The program's audio, the reference's run and the control's audio
    over BLOCKS blocks of one capture."""
    chain = RxChain.create(RxChainConfig(**CHAIN), tune_hz=TUNE,
                           mode=int(Mode.EXT), device="cpu")
    x = _capture(BLOCKS * chain.block_in)
    st, outs = chain.init_state(), []
    for j in range(BLOCKS):
        st, a = chain.step(st, torch.as_tensor(
            x[:, j * chain.block_in:(j + 1) * chain.block_in]))
        outs.append(a.numpy())
    ref = _oracle().run(torch.as_tensor(x))
    ctl = _oracle(lowp=True).run(torch.as_tensor(x))
    return np.concatenate(outs, -1), ref, ctl["audio"].numpy()


def _gaps(got, want, Ba=2048):
    """[blocks, C]: each block's widest gap as a share of the channel's
    largest reference sample in it (0 where both are silent)."""
    nb = want.shape[-1] // Ba
    g = np.abs(got - want).reshape(C, nb, Ba).max(-1)
    w = np.abs(want).reshape(C, nb, Ba).max(-1)
    return (g / np.maximum(w, 1e-30)).T


def test_chain_matches_reference_past_settling(stream):
    got, ref, _ = stream
    want = ref["audio"].numpy()
    gaps = _gaps(got, want)[SETTLED:]
    assert gaps.max() < TOL, gaps.max(0)
    # every squelch decision: stations open, idle channels closed in every
    # block, and a block's audio exactly zero in the program where and
    # only where it is in the reference
    opened = ref["open"].numpy()
    assert opened[[c for c in range(C) if c not in IDLE]].all()
    assert not opened[list(IDLE)].any()
    silent = lambda a: (a.reshape(C, BLOCKS, -1) == 0).all(-1)  # noqa: E731
    assert np.array_equal(silent(got), silent(want))
    assert np.array_equal(silent(want), ~opened)
    # the decisions have margin: 3 dB and more on each side of the level
    rf = ref["rf_db"].numpy()
    assert rf[list(IDLE)].max() < SQUELCH_DB - 3.0
    station = [c for c in range(C) if c not in IDLE]
    assert rf[station].min() > SQUELCH_DB + 3.0


def test_tf32_control_fails(stream):
    got, ref, ctl = stream
    want = ref["audio"].numpy()
    gaps = _gaps(ctl, want)[SETTLED:]
    assert gaps.max() > 10 * TOL, gaps.max(0)


def test_pll_fm_built_without_registration(monkeypatch):
    monkeypatch.setattr(demod, "_EXT_DEMODS", {})
    small = dict(CHAIN, channels=2, audio_block=256)
    ch = RxChain.create(RxChainConfig(**small), tune_hz=TUNE[:2],
                        mode=int(Mode.EXT), device="cpu")
    ext = ch.demod.ext
    assert isinstance(ext, PLLFMDemod) and ext.notch is not None
    want = PLLFMDemod.create(48000.0, deviation_hz=5000.0, ctcss_hz=100.0,
                             device="cpu")
    for f in ("alpha", "beta", "gain", "max_freq"):
        assert torch.equal(getattr(ext, f), getattr(want, f)), f
    for f in ("b0", "b1", "b2", "a1", "a2"):
        assert torch.equal(getattr(ext.notch, f), getattr(want.notch, f)), f
    ch0 = RxChain.create(RxChainConfig(**dict(small, ctcss_hz=0.0,
                                              fm_deviation_hz=2500.0)),
                         tune_hz=TUNE[:2], mode=int(Mode.EXT), device="cpu")
    assert ch0.demod.ext.notch is None
    assert float(ch0.demod.ext.gain) == pytest.approx(48000.0 / (
        2 * np.pi * 2500.0), rel=1e-6)
    st, a = ch.step(ch.init_state(), torch.as_tensor(_capture(1024)[:2]))
    assert a.shape == (2, 256) and bool(torch.isfinite(a).all())


def test_registered_name_still_used(monkeypatch):
    monkeypatch.setattr(demod, "_EXT_DEMODS", {})

    class Neg:
        def init_state(self, channels):
            return ()

        def __call__(self, state, x):
            return state, -x.real

    demod.register_ext_demod("neg", lambda fs, c, dev: Neg())
    cfg = RxChainConfig(sample_rate=48000.0, channels=2, audio_block=256,
                        agc=False, ext_demod="neg")
    ch = RxChain.create(cfg, mode=int(Mode.EXT), device="cpu")
    assert isinstance(ch.demod.ext, Neg)
    with pytest.raises(KeyError):
        RxChain.create(RxChainConfig(sample_rate=48000.0, channels=2,
                                     ext_demod="unknown"), device="cpu")
    with pytest.raises(ValueError, match="ctcss_hz"):
        RxChain.create(RxChainConfig(sample_rate=48000.0, channels=2,
                                     ext_demod="neg", ctcss_hz=100.0),
                       device="cpu")


def test_demod_spans_under_a_profiler_and_none_without():
    small = dict(CHAIN, channels=2, audio_block=256)
    ch = RxChain.create(RxChainConfig(**small), tune_hz=TUNE[:2],
                        mode=int(Mode.EXT), device="cpu")
    x = torch.as_tensor(_capture(1024)[:2])
    for name in ("rx.pll", "rx.deemph", "rx.ctcss"):
        assert span(name) is NULL_SPAN
    ref = ch.step(ch.init_state(), x)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        got = ch.step(ch.init_state(), x)
    spans = sorted((e.start_ns(), e.end_ns(), e.name()[len(PREFIX):])
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(PREFIX))
    assert torch.equal(ref[1], got[1])
    d0, d1 = next((a, b) for a, b, n in spans if n == "rx.demod")
    inner = [n for a, b, n in spans if d0 <= a <= b <= d1 and n != "rx.demod"]
    assert inner == ["rx.pll", "rx.deemph", "rx.ctcss"]
    names = [n for _, _, n in spans]
    assert names.index("rx.demod") < names.index("rx.agc") < names.index(
        "rx.fm_sq")
